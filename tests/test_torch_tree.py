"""The port's tree helpers over dicts, lists and tuples, and a ResNet-shaped
parameter tree (stages are lists of block dicts) carried from numpy to
torch and back by `convert.py`."""

import numpy as np
import pytest
import torch

from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


def _tree():
    rng = np.random.default_rng(0)
    return {
        "stem": {"conv": rng.normal(size=(7, 7, 3, 4)).astype(np.float32)},
        "stage0": [{"conv0": rng.normal(size=(1, 1, 4, 4)).astype(
                        np.float32),
                    "scale0": np.ones(4, np.float32)},
                   {"conv0": rng.normal(size=(3, 3, 4, 4)).astype(
                       np.float32)}],
        "heads": ({"cls": np.arange(6, dtype=np.float32)},
                  [np.zeros(2, np.int32), np.ones((2, 2), np.float64)]),
    }


def test_tree_map_keeps_lists_and_tuples():
    t = tree_map(lambda a: a.shape, _tree())
    assert isinstance(t["stage0"], list) and len(t["stage0"]) == 2
    assert isinstance(t["heads"], tuple) and isinstance(t["heads"][1], list)
    assert t["stage0"][1]["conv0"] == (3, 3, 4, 4)
    assert t["heads"][1][1] == (2, 2)


def test_tree_map_zips_several_trees():
    a = _tree()
    total = tree_map(lambda x, y: x + y, a, a)
    for x, y in zip(tree_leaves(total), tree_leaves(a)):
        np.testing.assert_array_equal(x, 2 * y)


def test_tree_leaves_order_and_unflatten():
    tree = _tree()
    leaves = tree_leaves(tree)
    assert len(leaves) == 7
    assert leaves[1] is tree["stage0"][0]["conv0"]
    assert leaves[-1] is tree["heads"][1][1]
    back = tree_unflatten(tree, [i for i in range(len(leaves))])
    assert back["heads"][1] == [5, 6] and back["stage0"][1] == {"conv0": 3}


def test_list_tree_round_trips_through_convert():
    tree = _tree()
    got = convert.params_from_jax(tree, "cpu")
    assert isinstance(got["stage0"], list)
    assert isinstance(got["stage0"][0]["conv0"], torch.Tensor)
    assert got["heads"][1][0].dtype == torch.int32
    back = convert.params_to_numpy(got)
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_convert_casts_every_leaf_of_a_list_tree(dtype):
    got = convert.params_from_jax(
        {"blocks": [np.ones(3, np.float32), np.ones(2, np.float32)]}, "cpu",
        dtype=dtype)
    assert [t.dtype for t in got["blocks"]] == [dtype, dtype]
