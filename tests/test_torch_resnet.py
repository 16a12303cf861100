"""Port parity: cloudtik_tpu_torch.models.resnet and ops.conv vs JAX.

Parameters come from the JAX `init_params` through `convert.py` (stages
are lists of block dicts), images from a numpy seed, all in f32.  Each
stage's feature map agrees to 1e-4: batch-statistics BN rescales the f32
summation-order error of the convs.  Odd image sizes pin XLA's asymmetric
SAME padding of the stride-2 convs and of the -inf max-pool.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import resnet as JR
from cloudtik_tpu.ops import conv as JC
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import resnet as TR
from cloudtik_tpu_torch.ops import conv as TC

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

TOL = 1e-4
_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("name", sorted(JR.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JR.PRESETS[name], TR.PRESETS[name]
    for field in dataclasses.fields(JR.ResNetConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.flops_per_image() == jcfg.flops_per_image()


@pytest.mark.parametrize("size,k,stride", [(512, 7, 2), (128, 3, 2),
                                           (33, 3, 2), (16, 1, 2),
                                           (15, 3, 1)])
def test_same_pads_are_xla_s(size, k, stride):
    low, high = TC.same_pads(size, k, stride)
    pads = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert (low, high) == tuple(pads)


@pytest.mark.parametrize("k,stride,groups,size", [
    (7, 2, 1, 20), (3, 2, 1, 9), (1, 2, 1, 8), (3, 1, 2, 7)])
def test_conv_nhwc_matches_jax(k, stride, groups, size):
    rng = np.random.default_rng(k * 10 + size)
    x = rng.normal(size=(2, size, size + 1, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4 // groups, 6)).astype(np.float32)
    want = JC.conv_nhwc(jnp.asarray(x), jnp.asarray(w), stride=stride,
                        dtype=jnp.float32, groups=groups)
    got = TC.conv_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                       stride=stride, dtype=torch.float32, groups=groups)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _params(jcfg):
    jp = JR.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# resnet18 at 32 ends in a 1x1 map, where BN normalises each channel over
# the batch's B values alone and amplifies an f32 difference by up to
# 1/sqrt(eps): B=2 leaves 0.14 there, B=8 under 1e-4.
@pytest.mark.parametrize("name,size,batch", [
    ("tiny", 32, 2), ("tiny", 35, 2), ("resnet18", 32, 8),
    ("resnet18", 37, 2)])
def test_forward_features_match_jax(name, size, batch):
    jcfg = JR.config(name, image_size=size, dtype=jnp.float32)
    tcfg = TR.config(name, image_size=size, dtype=torch.float32)
    jp, tp = _params(jcfg)
    images = np.random.default_rng(size).normal(
        size=(batch, size, size, 3)).astype(np.float32)
    want = JR.forward_features(jp, jnp.asarray(images), jcfg)
    got = TR.forward_features(tp, torch.from_numpy(images), tcfg)
    assert len(got) == len(want)
    for stage, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, stage
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"stage {stage}")
    # stopping early gives the same first stages
    first = TR.forward_features(tp, torch.from_numpy(images), tcfg,
                                last_stage=0)
    assert len(first) == 1
    torch.testing.assert_close(first[0], got[0], rtol=0, atol=0)


def test_forward_logits_match_jax():
    jcfg = JR.config("tiny", dtype=jnp.float32)
    tcfg = TR.config("tiny", dtype=torch.float32)
    jp, tp = _params(jcfg)
    images = np.random.default_rng(1).normal(
        size=(3, 32, 32, 3)).astype(np.float32)
    want = JR.forward(jp, jnp.asarray(images), jcfg)
    got = TR.forward(tp, torch.from_numpy(images), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["tiny", "resnet18", "resnext50_32x4d"])
def test_init_params_has_the_jax_tree(name):
    jcfg = JR.config(name)
    tcfg = TR.config(name)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TR.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.zeros((), np.float32), got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))))
    assert flat_got.keys() == flat_want.keys()
    leaves = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    for (path, w), t in zip(flat_want.items(), leaves):
        assert tuple(t.shape) == w.shape, path
        assert t.dtype == torch.float32
