"""Port parity: the chunked training loss and its gradients against JAX.

`cloudtik_tpu_torch.models.transformer.loss_fn` (value, n_tokens, accuracy)
and every gradient leaf against JAX `loss_fn` + `jax.grad` on `tiny` in f32,
under each remat policy, with weights from the JAX `init_params` and
batches from a numpy seed.  Tolerance 1e-4 (abs and rel): f32 on both sides,
sums taken in another order; the gradients of `tiny` are O(1e-1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.ops import flash_attention as FA

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _batch(B, S, vocab, seed=0, ignore=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    if ignore:
        labels[:, :ignore] = -100
    return {"tokens": tokens, "labels": labels}


def _jax_loss_and_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(jp)
    return loss, metrics, jax.tree.map(np.asarray, grads)


def _torch_loss_and_grads(tcfg, tp, batch):
    tp = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tp.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, metrics = TT.loss_fn(tp, tb, tcfg)
    loss.backward()
    grads = {k: ({n: w.grad for n, w in v.items()} if isinstance(v, dict)
                 else v.grad) for k, v in tp.items()}
    return loss, metrics, convert.params_to_numpy(grads)


def _assert_grads_close(got, want):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, w in flat_want.items():
        np.testing.assert_allclose(flat_got[path], w, err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("policy,impl,S", [
    ("save_attn", None, 24),
    ("full", None, 24),
    ("dots", None, 24),
    ("save_attn", "flash", 24),        # the port's flash Function, CPU plain
    ("save_attn", None, 640),          # S > 512: two chunks of 320
], ids=["save_attn", "full", "dots", "save_attn-flash", "chunked-640"])
def test_loss_and_grads_match_jax(policy, impl, S):
    jcfg = JT.config("tiny", dtype=jnp.float32, remat=True,
                     remat_policy=policy)
    tcfg = TT.config("tiny", dtype=torch.float32, remat=True,
                     remat_policy=policy, attention_impl=impl)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(2 if S < 512 else 1, S, jcfg.vocab_size, ignore=3)
    jloss, jm, jgrads = _jax_loss_and_grads(jcfg, jp, batch)
    before = (FA.LAUNCHES, FA.LAUNCHES_DQ, FA.LAUNCHES_DKV)
    tloss, tm, tgrads = _torch_loss_and_grads(tcfg, tp, batch)
    assert (FA.LAUNCHES, FA.LAUNCHES_DQ, FA.LAUNCHES_DKV) == before
    assert TT._chunk_size(S) == (320 if S == 640 else S)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"])
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               **TOL)
    assert not tm["loss"].requires_grad
    _assert_grads_close(tgrads, jgrads)


def test_remat_policies_give_identical_grads():
    """The three policies recompute, never change, what is computed."""
    tcfg = TT.config("tiny", dtype=torch.float32, remat=True)
    jcfg = JT.config("tiny", dtype=jnp.float32)
    tp = convert.params_from_jax(jax.tree.map(
        np.asarray, JT.init_params(jax.random.PRNGKey(1), jcfg)), "cpu")
    batch = _batch(2, 32, tcfg.vocab_size, seed=2)
    runs = [_torch_loss_and_grads(
        dataclasses.replace(tcfg, remat_policy=p, attention_impl="flash"),
        tp, batch) for p in ("save_attn", "full", "dots")]
    runs.append(_torch_loss_and_grads(
        dataclasses.replace(tcfg, remat=False, attention_impl="flash"),
        tp, batch))
    for loss, _, grads in runs[1:]:
        assert loss.item() == runs[0][0].item()
        for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(runs[0][2])):
            np.testing.assert_array_equal(a, b)


def test_unknown_remat_policy_raises():
    tcfg = TT.config("tiny", dtype=torch.float32, remat=True,
                     remat_policy="nope")
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(1, 8, tcfg.vocab_size).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        TT.loss_fn(tp, batch, tcfg)
    with torch.no_grad():        # no gradient: no remat, no policy read
        loss, _ = TT.loss_fn(tp, batch, tcfg)
    assert torch.isfinite(loss)


def test_all_labels_ignored_counts_one_token():
    tcfg = TT.config("tiny", dtype=torch.float32)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    labels = torch.full((1, 8), -100, dtype=torch.long)
    loss, m = TT.loss_fn(tp, {"tokens": tokens, "labels": labels}, tcfg)
    assert loss.item() == 0.0 and int(m["n_tokens"]) == 1
    assert float(m["accuracy"]) == 0.0


@pytest.mark.parametrize("S,want", [(24, 24), (512, 512), (2048, 512),
                                    (640, 320), (1000, 500), (1031, 1031)])
def test_chunk_size_matches_jax(S, want):
    assert TT._chunk_size(S) == JT._chunk_size(S) == want


def test_bf16_loss_and_grads_match_jax_loosely():
    """bf16 activations: both frameworks round at different places, so the
    loss agrees to 1e-2 and each gradient leaf to 5% relative L2."""
    jcfg = JT.config("tiny", remat=True)
    tcfg = TT.config("tiny", remat=True)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(2, 24, jcfg.vocab_size, seed=3)
    jloss, _, jgrads = _jax_loss_and_grads(jcfg, jp, batch)
    tloss, _, tgrads = _torch_loss_and_grads(tcfg, tp, batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-2)
    for a, b in zip(jax.tree.leaves(tgrads), jax.tree.leaves(jgrads)):
        b = np.asarray(b, np.float32)
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b)
