"""Port parity: mixture-of-experts (ops/moe.py and the MoE transformer,
generation and paged engine) against the JAX package.

Parameters come from the JAX `init_params` of `tiny_moe` through
`convert.py`, inputs from a numpy seed, everything in f32 on one intra-op
thread.  Ceilings: outputs, losses and router metrics within 1e-5
relative; every gradient leaf within 1e-4 relative L2 (the reference
differentiates the same einsums through XLA, which sums in another
order); greedy tokens equal.  Dispatch and combine are held exactly
(they are 0/1 masks and copies of router probabilities).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.ops import moe as JM
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.ops import moe as TM
from cloudtik_tpu_torch.serve import engine as TE

torch.set_num_threads(1)

REL = 1e-5
GRAD_REL_L2 = 1e-4
JCFG = JT.config("tiny_moe", dtype=jnp.float32, attention_impl="reference")
TCFG = TT.config("tiny_moe", dtype=torch.float32,
                 attention_impl="reference")
WAIT = 60


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _probs(B, S, E, seed):
    logits = np.random.default_rng(seed).standard_normal((B, S, E))
    return np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


@pytest.mark.parametrize("B, S, E, k, cf", [
    (2, 8, 4, 2, 2.0),      # generous: every token gets its k slots
    (2, 16, 4, 2, 0.5),     # tight: drops
    (3, 7, 8, 1, 1.0),
    (1, 1, 8, 2, 1.25),     # a decode step: capacity 1
    (2, 12, 4, 4, 1.25),    # top_k == num_experts
])
def test_dispatch_and_combine_match_jax(B, S, E, k, cf):
    cfg_j = JM.MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    cfg_t = TM.MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    assert cfg_t.capacity(S) == cfg_j.capacity(S)
    probs = _probs(B, S, E, seed=B * 100 + S)
    d_j, c_j, f_j = JM._top_k_dispatch(jnp.asarray(probs), cfg_j,
                                       cfg_j.capacity(S))
    d_t, c_t, counts = TM._top_k_dispatch(torch.from_numpy(probs), cfg_t,
                                          cfg_t.capacity(S))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(counts.numpy() / (B * S), np.asarray(f_j),
                               rtol=REL)


def test_ties_take_the_first_expert_as_jax_does():
    probs = np.full((1, 4, 4), 0.25, np.float32)
    probs[0, 1] = [0.1, 0.4, 0.4, 0.1]
    cfg = dict(num_experts=4, top_k=2, capacity_factor=2.0)
    d_j, _, _ = JM._top_k_dispatch(jnp.asarray(probs), JM.MoEConfig(**cfg),
                                   4)
    d_t, _, _ = TM._top_k_dispatch(torch.from_numpy(probs),
                                   TM.MoEConfig(**cfg), 4)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert d_t[0, 0].sum(-1).tolist() == [1.0, 1.0, 0.0, 0.0]


def test_capacity_drops_overflow():
    cfg = TM.MoEConfig(num_experts=2, top_k=1, capacity_factor=0.5)
    probs = torch.tensor([[0.9, 0.1]]).repeat(8, 1).reshape(1, 8, 2)
    capacity = cfg.capacity(8)
    dispatch, _, _ = TM._top_k_dispatch(probs, cfg, capacity)
    assert capacity == 2 and dispatch.sum().item() == capacity
    # the first tokens of the row keep their slots
    assert dispatch[0, :2, 0].sum().item() == 2


def test_top_k_above_num_experts_is_refused():
    with pytest.raises(ValueError, match="top_k"):
        TM.MoEConfig(num_experts=2, top_k=3)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_output_and_metrics_match_jax(cf):
    rng = np.random.default_rng(7)
    B, S, d, f, E = 2, 16, 32, 64, 4
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((d, E), 0.3), ((E, d, f), 0.1), ((E, d, f), 0.1),
        ((E, f, d), 0.1))]
    y_j, m_j = JM.moe_ffn(jnp.asarray(x), *map(jnp.asarray, ws),
                          JM.MoEConfig(num_experts=E, capacity_factor=cf))
    y_t, m_t = TM.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws),
                          TM.MoEConfig(num_experts=E, capacity_factor=cf))
    assert _rel(y_t.numpy(), y_j) <= REL
    for k in ("moe_aux_loss", "moe_z_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
    if cf < 1:
        assert float(m_t["moe_drop_fraction"]) > 0.1


def test_moe_ffn_gradients_match_jax():
    rng = np.random.default_rng(8)
    B, S, d, f, E = 2, 8, 16, 32, 4
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in (
        (d, E), (E, d, f), (E, d, f), (E, f, d))]
    cfg_j = JM.MoEConfig(num_experts=E)

    def jloss(x, *w):
        y, m = JM.moe_ffn(x, *w, cfg_j)
        return (y ** 2).sum() + m["moe_aux_loss"] + m["moe_z_loss"]

    want = jax.grad(jloss, argnums=tuple(range(5)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    args = [torch.from_numpy(a).requires_grad_(True) for a in [x] + ws]
    y, m = TM.moe_ffn(*args, TM.MoEConfig(num_experts=E))
    loss = (y ** 2).sum() + m["moe_aux_loss"] + m["moe_z_loss"]
    got = torch.autograd.grad(loss, args)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= GRAD_REL_L2


def test_bf16_moe_ffn_rounds_the_gates_as_jax():
    """dispatch and combine are cast to the compute dtype before the
    einsums: in bf16 the output agrees to a bf16 step, not better."""
    rng = np.random.default_rng(9)
    B, S, d, f, E = 2, 8, 32, 64, 4
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in (
        (d, E), (E, d, f), (E, d, f), (E, f, d))]
    y_j, _ = JM.moe_ffn(jnp.asarray(x, jnp.bfloat16),
                        *map(jnp.asarray, ws), JM.MoEConfig(num_experts=E))
    y_t, _ = TM.moe_ffn(torch.from_numpy(x).bfloat16(),
                        *map(torch.from_numpy, ws),
                        TM.MoEConfig(num_experts=E))
    assert y_t.dtype == torch.bfloat16
    assert _rel(y_t.float().numpy(), np.asarray(y_j, np.float32)) <= 2e-2


def test_param_logical_axes_and_init_match_jax():
    assert TT.param_logical_axes(TCFG) == JT.param_logical_axes(JCFG)
    dense = (JT.config("tiny"), TT.config("tiny"))
    assert TT.param_logical_axes(dense[1]) == JT.param_logical_axes(dense[0])
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 JCFG))
    got = TT.init_params(torch.Generator().manual_seed(0), TCFG, "cpu")
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_w)) == sorted(map(str, flat_g))
    for path, w in flat_w.items():
        assert tuple(flat_g[path].shape) == w.shape, path


def _batch(B=2, S=16, seed=3, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab_size, (B, S))
    labels = rng.integers(0, JCFG.vocab_size, (B, S))
    if masked:
        labels[0, :5] = -100
    return tokens, labels


def test_forward_logits_and_aux_match_jax(params):
    jp, tp = params
    tokens, _ = _batch()
    want, aux_j = JT.forward(jp, jnp.asarray(tokens, jnp.int32), JCFG,
                             return_aux=True)
    got, aux_t = TT.forward(tp, torch.from_numpy(tokens), TCFG,
                            return_aux=True)
    assert _rel(got.numpy(), want) <= REL
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=REL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("remat_policy", [None, "save_attn", "full"])
def test_loss_and_every_gradient_match_jax(params, remat_policy):
    jp, tp = params
    jcfg, tcfg = JCFG, TCFG
    if remat_policy:
        jcfg = JT.config("tiny_moe", dtype=jnp.float32,
                         attention_impl="reference", remat=True,
                         remat_policy=remat_policy)
        tcfg = TT.config("tiny_moe", dtype=torch.float32,
                         attention_impl="reference", remat=True,
                         remat_policy=remat_policy)
    tokens, labels = _batch()
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jbatch, jcfg), has_aux=True)(jp)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels)}
    tl, tm = TT.loss_fn(tp, tbatch, tcfg)
    leaves = jax.tree.leaves(tp)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=REL)
    for k in ("loss", "loss_with_aux", "moe_aux_loss", "moe_z_loss",
              "moe_drop_fraction", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"])
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(jg)]
    for path, g, w in zip(paths, tg, jax.tree.leaves(jg)):
        assert _rel(g.numpy(), w) <= GRAD_REL_L2, path


def test_greedy_generate_matches_jax(params):
    jp, tp = params
    prompt = np.random.default_rng(5).integers(0, JCFG.vocab_size, (2, 9))
    want = np.asarray(JG.generate(jp, jnp.asarray(prompt, jnp.int32), JCFG,
                                  max_new_tokens=10))
    got = TG.generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)


def _engine_tokens(M, eng, prompts, new):
    reqs = [eng.submit(M.Request(p, max_new_tokens=new)) for p in prompts]
    return [r.wait(timeout=WAIT) for r in reqs], \
        [r.prefill_chunks for r in reqs]


def test_engine_tokens_match_the_jax_engine(params):
    """Chunked prefill routes each chunk by its own length, as the
    reference engine does, so the engine is held to the JAX engine (not to
    `generate`, whose one-shot prefill routes the whole prompt at once)."""
    jp, tp = params
    ec = dict(slots=3, max_len=96, prefill_buckets=(8, 16), block_size=8)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 23, 12, 40)]
    engines = {JE: JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**ec)),
               TE: TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec),
                                   device="cpu")}
    out = {}
    try:
        for M, eng in engines.items():
            eng.start()
            out[M] = _engine_tokens(M, eng, prompts, 8)
    finally:
        for eng in engines.values():
            eng.stop()
    assert out[TE] == out[JE]
    assert max(out[TE][1]) > 1            # some prompt was chunked


def test_param_count_vs_dense():
    dense, moe = TT.config("tiny"), TT.config("tiny_moe")
    assert moe.num_params() > dense.num_params()
    assert moe.num_params(active_only=True) < moe.num_params()
    full = TT.config("tpu_moe_8x1b")
    assert full.num_params() == JT.config("tpu_moe_8x1b").num_params()
    assert 4.7e9 < full.num_params() < 4.8e9
