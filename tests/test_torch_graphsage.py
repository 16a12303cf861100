"""Port parity: cloudtik_tpu_torch.models.graphsage against the JAX model.

Parameters come from the JAX `init_params` through `convert.py`, graph
blocks from `synthetic_graph_batches` (the same numpy draws in both
packages), all in f32 on one intra-op thread: the embeddings, logits and
both losses within 1e-5 relative, every gradient leaf within 1e-4
relative L2, for the supervised objective and for link prediction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import graphsage as JG
from cloudtik_tpu.train import data as JD
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import graphsage as TG

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name", sorted(JG.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JG.PRESETS[name], TG.PRESETS[name]
    for field in dataclasses.fields(JG.GraphSAGEConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.flops_per_node() == jcfg.flops_per_node()


def _setup(N=24, seed=0):
    jcfg = JG.config("tiny", dtype=jnp.float32)
    tcfg = TG.config("tiny", dtype=torch.float32)
    jp = JG.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = next(JD.synthetic_graph_batches(N, jcfg.in_dim, jcfg.num_classes,
                                            jcfg.max_degree, seed=seed))
    rng = np.random.default_rng(seed + 1)
    for k in ("src", "dst", "neg_dst"):
        batch[k] = rng.integers(0, N, (N // 2,), dtype=np.int32)
    return jcfg, tcfg, jp, tp, batch


def test_aggregate_matches_jax_with_isolated_rows():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((5, 4)).astype(np.float32)
    neighbors = rng.integers(0, 5, (5, 3)).astype(np.int32)
    mask = rng.uniform(size=(5, 3)) < 0.5
    mask[2] = False                          # no valid neighbour
    want = np.asarray(JG._aggregate(jnp.asarray(h), jnp.asarray(neighbors),
                                    jnp.asarray(mask)))
    got = TG._aggregate(torch.from_numpy(h), torch.from_numpy(neighbors),
                        torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[2] == 0).all()


def test_embed_and_forward_match_jax():
    jcfg, tcfg, jp, tp, b = _setup()
    args = [b["features"], b["neighbors"], b["neighbor_mask"]]
    want = np.asarray(JG.embed(jp, *map(jnp.asarray, args), jcfg))
    got = TG.embed(tp, *map(torch.from_numpy, args), tcfg)
    assert rel_l2(got.numpy(), want) <= 1e-5
    want = np.asarray(JG.forward(jp, *map(jnp.asarray, args), jcfg))
    got = TG.forward(tp, *map(torch.from_numpy, args), tcfg)
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("objective", ["supervised", "link_pred"])
def test_loss_and_every_gradient_leaf_match_jax(objective):
    jcfg, tcfg, jp, tp, batch = _setup(seed=5)
    jloss = JG.loss_fn if objective == "supervised" else JG.link_pred_loss
    tloss = TG.loss_fn if objective == "supervised" else TG.link_pred_loss
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss(p, jbatch, jcfg), has_aux=True)(jp)
    leaves = jax.tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, tm = tloss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                     tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5)
    # link prediction never reads `out`: a zero gradient, as jax.grad's
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    for g, j in zip(grads, jax.tree.leaves(jg)):
        if not np.asarray(j).any():
            assert not g.any()
            continue
        assert rel_l2(g.numpy(), np.asarray(j)) <= 1e-4


def test_bool_masks_reach_the_loss_as_bools():
    """The trainer's `_as_long` leaves bools alone: a mask cast to int64
    would still compute, so this pins the dtype the loss sees."""
    from cloudtik_tpu_torch.train import trainer as TTR

    _, _, _, _, batch = _setup()
    out = TTR._as_long(batch)
    assert out["neighbor_mask"].dtype == np.bool_
    assert out["train_mask"].dtype == np.bool_
    assert out["neighbors"].dtype == np.int64
