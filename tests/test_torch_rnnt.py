"""Port parity: cloudtik_tpu_torch.ops.transducer and models.rnnt against
the JAX package.

The transducer loss (the port walks the lattice by anti-diagonals, the
reference by rows with an associative scan) agrees with JAX's and with
the float64 oracle within 1e-5, including a row with no labels and one
with a single frame, and its gradient with `jax.grad`'s within 1e-4
relative L2, zero on padded cells.  The model's encoder, predictor, joint,
loss and every gradient leaf agree at `tiny` in f32 (parameters from the
JAX `init_params` through `convert.py`), and `greedy_decode` gives the
same tokens.  A lattice row shifted by one label shows the oracle check's
power.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import rnnt as JN
from cloudtik_tpu.ops import transducer as JX
from cloudtik_tpu.train import data as JD
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import rnnt as TN
from cloudtik_tpu_torch.ops import transducer as TX

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _lattice_case(B=4, T=7, U=5, V=6, seed=0):
    """Random log-probs with one full row, a row with no labels and a row
    with a single frame."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.integers(1, V, (B, U), dtype=np.int32)
    in_len = np.clip([T, T - 2, 1, 3], 1, T).astype(np.int32)[:B]
    lab_len = np.clip([U, 0, 2, U - 1], 0, U).astype(np.int32)[:B]
    return lp, labels, in_len, lab_len


# --------------------------------------------------------------- transducer

@pytest.mark.parametrize("shape", [(4, 7, 5, 6), (4, 1, 3, 4),
                                   (4, 9, 1, 3), (4, 12, 8, 5)])
def test_transducer_loss_matches_jax_and_the_oracle(shape):
    B, T, U, V = shape
    lp, labels, in_len, lab_len = _lattice_case(B, T, U, V, seed=T * U)
    want = np.asarray(JX.transducer_loss(
        jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(in_len),
        jnp.asarray(lab_len)))
    oracle = TX.transducer_loss_reference(lp, labels, in_len, lab_len)
    jax_oracle = np.asarray(JX.transducer_loss_reference(
        jnp.asarray(lp), jnp.asarray(labels), in_len, lab_len))
    got = TX.transducer_loss(torch.from_numpy(lp), torch.from_numpy(labels),
                             torch.from_numpy(in_len),
                             torch.from_numpy(lab_len)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(oracle, jax_oracle, rtol=1e-6)


def test_transducer_loss_closed_forms():
    """No labels: the blanks down column 0; one frame: the labels along
    row 0, then its blank."""
    lp, labels, in_len, lab_len = _lattice_case()
    got = TX.transducer_loss(torch.from_numpy(lp), torch.from_numpy(labels),
                             torch.from_numpy(in_len),
                             torch.from_numpy(lab_len)).numpy()
    blanks = -lp[1, :in_len[1], 0, 0].sum()
    np.testing.assert_allclose(got[1], blanks, rtol=1e-5)
    row0 = -(lp[2, 0, 0, labels[2, 0]] + lp[2, 0, 1, labels[2, 1]]
             + lp[2, 0, 2, 0])
    np.testing.assert_allclose(got[2], row0, rtol=1e-5)


def test_transducer_gradient_matches_jax_and_is_zero_on_padding():
    lp, labels, in_len, lab_len = _lattice_case(seed=9)
    jg = np.asarray(jax.grad(lambda x: JX.transducer_loss(
        x, jnp.asarray(labels), jnp.asarray(in_len),
        jnp.asarray(lab_len)).sum())(jnp.asarray(lp)))
    x = torch.from_numpy(lp).requires_grad_(True)
    TX.transducer_loss(x, torch.from_numpy(labels), torch.from_numpy(in_len),
                       torch.from_numpy(lab_len)).sum().backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    assert rel_l2(g, jg) <= 1e-4
    for b in range(lp.shape[0]):
        assert (g[b, in_len[b]:] == 0).all()           # frames past T_b
        assert (g[b, :, lab_len[b] + 1:] == 0).all()   # labels past U_b


def test_oracle_flags_a_row_shifted_by_one():
    """The check's power: every label read one position on (the lattice
    row shifted by one) moves each loss far past 1e-5."""
    lp, labels, in_len, lab_len = _lattice_case(seed=2)
    oracle = TX.transducer_loss_reference(lp, labels, in_len, lab_len)
    shifted = np.roll(labels, 1, axis=1)
    got = TX.transducer_loss(torch.from_numpy(lp), torch.from_numpy(shifted),
                             torch.from_numpy(in_len),
                             torch.from_numpy(lab_len)).numpy()
    moved = np.abs(got - oracle) / np.abs(oracle)
    assert (moved[lab_len > 0] > 1e-3).all()


def test_transducer_rejects_mismatched_labels():
    lp, labels, in_len, lab_len = _lattice_case()
    with pytest.raises(ValueError, match="labels"):
        TX.transducer_loss(torch.from_numpy(lp),
                           torch.from_numpy(labels[:, :-1]),
                           torch.from_numpy(in_len),
                           torch.from_numpy(lab_len))


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", sorted(JN.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JN.PRESETS[name], TN.PRESETS[name]
    for field in dataclasses.fields(JN.RNNTConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.flops_per_frame() == jcfg.flops_per_frame()
    shapes = jax.eval_shape(lambda: JN.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    assert TN.num_params(tcfg) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_rnnt_preset_has_47_3m_params():
    assert round(TN.num_params(TN.config("rnnt")) / 1e6, 1) == 47.3


def test_init_params_tree_and_forget_bias():
    cfg = TN.config("tiny")
    jp = jax.eval_shape(lambda: JN.init_params(jax.random.PRNGKey(0),
                                               JN.config("tiny")))
    tp = TN.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    assert [tuple(a.shape) for a in tl] == [b.shape for b in jl]
    H = cfg.enc_hidden
    b = tp["encoder"][0]["b"]
    assert (b[H:2 * H] == 1).all() and (b[:H] == 0).all() \
        and (b[2 * H:] == 0).all()


def _setup(B=3, frames=12, max_labels=4, seed=1):
    jcfg = JN.config("tiny", dtype=jnp.float32)
    tcfg = TN.config("tiny", dtype=torch.float32)
    jp = JN.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = next(JD.synthetic_speech_batches(
        B, frames, jcfg.feature_dim, jcfg.vocab_size, max_labels, seed=seed))
    return jcfg, tcfg, jp, tp, batch


def test_encode_predict_joint_match_jax():
    jcfg, tcfg, jp, tp, batch = _setup()
    feats = batch["features"]
    want_enc = JN.encode(jp, jnp.asarray(feats), jcfg)
    got_enc = TN.encode(tp, torch.from_numpy(feats), tcfg)
    assert tuple(got_enc.shape) == want_enc.shape
    assert rel_l2(got_enc.numpy(), want_enc) <= 1e-5
    want_pred = JN.predict(jp, jnp.asarray(batch["labels"]), jcfg)
    got_pred = TN.predict(tp, torch.from_numpy(batch["labels"]), tcfg)
    assert rel_l2(got_pred.numpy(), want_pred) <= 1e-5
    want = JN.joint(jp, want_enc, want_pred, jcfg)
    got = TN.joint(tp, got_enc, got_pred, tcfg)
    assert rel_l2(got.numpy(), want) <= 1e-5


def test_loss_and_every_gradient_leaf_match_jax():
    jcfg, tcfg, jp, tp, batch = _setup(seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: JN.loss_fn(p, jbatch, jcfg)[0])(jp)
    leaves = jax.tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = TN.loss_fn(tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(metrics["loss"]) == float(loss.detach())
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, j in zip(grads, jleaves):
        assert rel_l2(g.numpy(), np.asarray(j)) <= 1e-4


@pytest.mark.parametrize("max_symbols", [64, 3])
def test_greedy_decode_tokens_equal_jax(max_symbols):
    """The blank's bias moved so the joint emits on some frames and not
    on others; the tokens (0-padded past max_symbols) are equal."""
    jcfg, tcfg, jp, _, batch = _setup(B=4, frames=16, seed=2)
    jp["joint"]["out_bias"] = jp["joint"]["out_bias"].at[0].set(0.05)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    feats = batch["features"]
    want = np.asarray(JN.greedy_decode(jp, jnp.asarray(feats), jcfg,
                                       max_symbols=max_symbols))
    got = TN.greedy_decode(tp, torch.from_numpy(feats), tcfg,
                           max_symbols=max_symbols)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    emitted = (want != 0).sum(axis=1)
    assert emitted.max() == min(max_symbols, emitted.max()) > 0
    if max_symbols == 64:
        assert 0 < emitted.min() and emitted.max() < 8   # not every frame


def test_bf16_loss_is_finite_and_close():
    jcfg = JN.config("tiny")
    tcfg = TN.config("tiny")
    jp = JN.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = next(JD.synthetic_speech_batches(3, 12, jcfg.feature_dim,
                                             jcfg.vocab_size, 4, seed=6))
    jl, _ = JN.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg)
    tl, _ = TN.loss_fn(tp, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, tcfg)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=0.02)
