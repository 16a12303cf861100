"""The model zoo and BERT on a mesh: BERT, DLRM, RNN-T and GraphSAGE train
through the port's `Trainer` on gloo CPU ranks as the JAX Trainer trains
them on the same CPU mesh (tests/torch_family_mesh.py has the harness and
the ceilings).

One spawn of 8 ranks runs every case: each family at data=2 x fsdp=2
(BERT's MLM loss over the global count of valid labels, GraphSAGE's over
the global train mask, link prediction's `auc_proxy` over every pair);
DLRM also at data=2 x fsdp=2 x expert=2, its tables gathered for the
lookup; BERT at tensor=2 and at pipe=2 against the port on one rank;
GraphSAGE at data=2 on a block whose every node's neighbours lie on the
other rank.  Planted: BERT's loss as a mean of per-rank means, and
GraphSAGE reading only its own rows; both must miss the ceilings.
"""

import jax
import pytest
import torch

from tests import torch_family_mesh as H
from cloudtik_tpu_torch.models import bert as TB
from cloudtik_tpu_torch.parallel import fsdp

torch.set_num_threads(1)

SPAWN_DEADLINE_S = 240
# name: (family, objective, mesh, world) against the JAX Trainer
JAX_CASES = {
    "bert_data2_fsdp2": ("bert", None, H.DATA2_FSDP2, 4),
    "dlrm_data2_fsdp2": ("dlrm", None, H.DATA2_FSDP2, 4),
    "dlrm_data2_fsdp2_expert2": ("dlrm", None,
                                 dict(data=2, fsdp=2, expert=2), 8),
    "rnnt_data2_fsdp2": ("rnnt", None, H.DATA2_FSDP2, 4),
    "graphsage_data2_fsdp2": ("graphsage", "supervised", H.DATA2_FSDP2, 4),
    "graphsage_link_pred_data2_fsdp2": ("graphsage", "link_pred",
                                        H.DATA2_FSDP2, 4),
    "graphsage_cross_rank_data2": ("graphsage", "supervised",
                                   dict(data=2, fsdp=1), 2),
}
# name: (mesh, world) of BERT against the port on one rank
ONE_RANK = {"bert_tensor2": (dict(tensor=2, fsdp=1), 2),
            "bert_pipe2": (dict(pipe=2, fsdp=1), 2)}
# planted fault: the clean case it is held to
FAULTS = {"per_rank_mean": "bert_data2_fsdp2",
          "sage_no_gather": "graphsage_cross_rank_data2"}
ZOO = ("bert", "dlrm", "rnnt", "graphsage")


def _data(name):
    family, objective, _, _ = JAX_CASES[name]
    if name == "graphsage_cross_rank_data2":
        return [H.cross_rank_block(seed=4), H.cross_rank_block(seed=5)]
    return H.batches(family, objective)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_mesh")
    trainers = {name: H.jax_trainer(family, _data(name), mesh, world,
                                    objective)
                for name, (family, objective, mesh, world)
                in JAX_CASES.items()}
    cases = [H.case(name, family, mesh, world, _data(name), objective)
             for name, (family, objective, mesh, world) in JAX_CASES.items()]
    cases += [H.case(name, "bert", mesh, world, H.batches("bert"))
              for name, (mesh, world) in ONE_RANK.items()]
    for fault, clean in FAULTS.items():
        family, objective, mesh, world = JAX_CASES[clean]
        cases.append(H.case(f"fault_{fault}", family, mesh, world,
                            _data(clean), objective, fault=fault))
    refs = {}

    def meanwhile():
        for name, trainer in trainers.items():
            refs[name] = H.jax_fit(trainer, _data(name))
        refs["one_rank"] = H.one_rank("bert", H.batches("bert"))

    got = H.spawn(cases, out, 8, SPAWN_DEADLINE_S, meanwhile)
    got["refs"] = refs
    return got


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_family_on_a_mesh_matches_jax(spawned, name):
    family = JAX_CASES[name][0]
    hist, params = spawned["refs"][name]
    gaps = H.gaps(spawned[name], hist, params, H.jax_params(family))
    assert H.within(gaps), gaps
    assert spawned[name]["grad_sum_axes"] == sorted(
        a for a in ("data", "fsdp") if JAX_CASES[name][2].get(a, 1) > 1)


def test_tables_and_layers_are_sharded(spawned):
    """DLRM's table stack splits its tables over expert and its embedding
    columns over fsdp; BERT's stack its embed rows over fsdp."""
    local = spawned["dlrm_data2_fsdp2_expert2"]["local"]
    assert local["embeddings"] == (2, 100, 8)
    assert spawned["dlrm_data2_fsdp2"]["local"]["embeddings"] == (4, 100, 8)
    layers = spawned["bert_data2_fsdp2"]["local"]["layers"]
    assert layers["wq"] == (2, 32, 4, 16)
    assert layers["ln1_scale"] == (2, 64)
    assert spawned["bert_pipe2"]["local"]["layers"]["wq"] == (1, 64, 4, 16)
    assert spawned["bert_tensor2"]["local"]["layers"]["wq"] == (2, 64, 2, 16)


@pytest.mark.parametrize("name", sorted(ONE_RANK))
def test_bert_on_tensor_and_pipe_matches_one_rank(spawned, name):
    got = spawned[name]
    hist, params = spawned["refs"]["one_rank"]
    for h, o in zip(got["history"], hist):
        for k in ("loss", "grad_norm", "mlm_accuracy"):
            assert H.rel(h[k], o[k]) <= H.REL, (k, h[k], o[k])
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert H.rel(a.numpy(), b.detach().numpy()) <= H.REL
    assert got["grad_sum_axes"] == []


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_are_caught(spawned, fault):
    clean = FAULTS[fault]
    hist, params = spawned["refs"][clean]
    gaps = H.gaps(spawned[f"fault_{fault}"], hist, params,
                  H.jax_params(JAX_CASES[clean][0]))
    assert not H.within(gaps), gaps


@pytest.mark.parametrize("family", ZOO)
def test_param_logical_axes_equal_jax(family):
    assert H.axes_equal(family)


def test_bert_layers_read_lazily_from_shards():
    """A stack holding `LayerShards` gives `LazyLayer` views (gathered
    where read); a plain stack gives each layer's slices."""
    layers = {"wq": fsdp.LayerShards(torch.zeros(2, 4), ()),
              "bo": torch.ones(2, 3)}
    lazy = TB.layer_params({"layers": layers}, 1)
    assert isinstance(lazy, fsdp.LazyLayer)
    assert torch.equal(lazy["bo"], torch.ones(3))
    plain = TB.layer_params({"layers": {"bo": torch.arange(6).view(2, 3)}},
                            1)
    assert torch.equal(plain["bo"], torch.tensor([3, 4, 5]))
