"""Port parity: cloudtik_tpu_torch.models.dlrm against the JAX DLRM.

Parameters come from the JAX `init_params` through `convert.py`, batches
from `synthetic_dlrm_batches` (the same numpy draws in both packages), all
in f32 on one intra-op thread: logits and the loss within 1e-5 relative,
every gradient leaf (the dense table gradient included) within 1e-4
relative L2.  The interaction's upper-triangle order and the gather are
pinned on their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import dlrm as JDL
from cloudtik_tpu.train import data as JD
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import dlrm as TDL
from cloudtik_tpu_torch.train import data as TD

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name", sorted(JDL.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JDL.PRESETS[name], TDL.PRESETS[name]
    for field in dataclasses.fields(JDL.DLRMConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.interaction_dim() == jcfg.interaction_dim()
    assert tcfg.flops_per_example() == jcfg.flops_per_example()


def test_criteo_terabyte_sizes():
    """335.2M params, 333M of them in the 26 tables; 14.8 MFLOP an
    example by the reference's count."""
    cfg = TDL.config("criteo_terabyte")
    assert round(cfg.num_params() / 1e6, 1) == 335.2
    assert cfg.num_tables * cfg.rows_per_table * cfg.embed_dim == 332_800_000
    assert round(cfg.flops_per_example() / 1e6, 1) == 14.8


def test_triu_order_is_jax_row_major():
    for f in (2, 5, 27):
        iu, ju = torch.triu_indices(f, f, 1)
        jiu, jju = jnp.triu_indices(f, k=1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))


def test_gather_embed_matches_jax():
    rng = np.random.default_rng(0)
    tables = rng.standard_normal((3, 7, 4)).astype(np.float32)
    ids = rng.integers(0, 7, (5, 3), dtype=np.int32)
    want = np.asarray(JDL._gather_embed(jnp.asarray(tables),
                                        jnp.asarray(ids)))
    got = TDL.gather_embed(torch.from_numpy(tables), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[2, 1].tolist() == tables[1, ids[2, 1]].tolist()


def _setup(B=16, seed=4):
    jcfg = JDL.config("tiny", dtype=jnp.float32)
    tcfg = TDL.config("tiny", dtype=torch.float32)
    jp = JDL.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = next(JD.synthetic_dlrm_batches(B, jcfg.num_dense,
                                           jcfg.num_tables,
                                           jcfg.rows_per_table, seed=seed))
    return jcfg, tcfg, jp, tp, batch


def test_forward_and_loss_match_jax():
    jcfg, tcfg, jp, tp, batch = _setup()
    want = np.asarray(JDL.forward(jp, jnp.asarray(batch["dense"]),
                                  jnp.asarray(batch["sparse_ids"]), jcfg))
    got = TDL.forward(tp, torch.from_numpy(batch["dense"]),
                      torch.from_numpy(batch["sparse_ids"]), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_l2(got.numpy(), want) <= 1e-5
    jl, jm = JDL.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         jcfg)
    tl, tm = TDL.loss_fn(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"])


def test_every_gradient_leaf_matches_jax_and_the_table_grad_is_dense():
    jcfg, tcfg, jp, tp, batch = _setup(seed=7)
    jg = jax.grad(lambda p: JDL.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jp)
    leaves = jax.tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = TDL.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    for g, j in zip(grads, jax.tree.leaves(jg)):
        assert not g.is_sparse and tuple(g.shape) == j.shape
        assert rel_l2(g.numpy(), np.asarray(j)) <= 1e-4
    # rows no id touched get exactly zero
    table_grad = grads[[i for i, leaf in enumerate(leaves)
                        if leaf is tp["embeddings"]][0]]
    touched = np.zeros(table_grad.shape[:2], bool)
    for t in range(jcfg.num_tables):
        touched[t, batch["sparse_ids"][:, t]] = True
    assert (table_grad.numpy()[~touched] == 0).all()


def test_bf16_gathers_from_the_cast_table():
    """The reference's order: the whole table cast to bf16, then gathered;
    the table's gradient reaches the f32 leaf through the cast."""
    cfg = TDL.config("tiny")
    params = TDL.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    batch = next(TD.synthetic_dlrm_batches(8, cfg.num_dense, cfg.num_tables,
                                           cfg.rows_per_table, seed=1))
    loss, _ = TDL.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
    (g,) = torch.autograd.grad(loss, [params["embeddings"]])
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    e = TDL.gather_embed(params["embeddings"].to(torch.bfloat16),
                         torch.from_numpy(batch["sparse_ids"]))
    assert e.dtype == torch.bfloat16
