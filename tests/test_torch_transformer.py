"""Port parity: cloudtik_tpu_torch.models.transformer vs the JAX model.

Parameters come from the JAX `init_params` through `convert.py`, inputs
from a numpy seed.  fp32 logits agree to atol 1e-4; a bf16 run agrees to
atol 0.08 (|logits| <= ~3.3 on `tiny`): both frameworks round the bf16
activations, but at different places (XLA keeps some elementwise chains
in f32 between the einsums).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import transformer as TT

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _params(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


@pytest.mark.parametrize("name", sorted(JT.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JT.PRESETS[name], TT.PRESETS[name]
    for field in dataclasses.fields(JT.TransformerConfig):
        want = getattr(jcfg, field.name)
        got = getattr(tcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert got == want, field.name
    assert tcfg.head_dim == jcfg.head_dim
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.num_params(include_embed=False, active_only=True) == \
        jcfg.num_params(include_embed=False, active_only=True)
    assert tcfg.flops_per_token() == jcfg.flops_per_token()


def test_config_overrides():
    cfg = TT.config("tiny", dtype=torch.float32, n_layers=3)
    assert cfg.dtype == torch.float32 and cfg.n_layers == 3
    assert TT.PRESETS["tiny"].n_layers == 2


@pytest.mark.parametrize("overrides", [{}, {"tie_embeddings": True},
                                       {"param_dtype": "bf16"}])
def test_init_params_keys_shapes_dtypes(overrides):
    jover, tover = dict(overrides), dict(overrides)
    if overrides.get("param_dtype") == "bf16":
        jover["param_dtype"], tover["param_dtype"] = \
            jnp.bfloat16, torch.bfloat16
    jcfg, tcfg = JT.config("tiny", **jover), TT.config("tiny", **tover)
    want = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = TT.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_want)) == sorted(map(str, flat_got))
    for path, w in flat_want.items():
        t = flat_got[path]
        assert tuple(t.shape) == w.shape, path
        assert t.dtype == _DTYPES[w.dtype.type], path


def test_init_params_distribution_and_seed():
    cfg = TT.config("tiny")
    p = TT.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    q = TT.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    r = TT.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
    assert torch.equal(p["layers"]["wq"], q["layers"]["wq"])
    assert not torch.equal(p["layers"]["wq"], r["layers"]["wq"])
    wq = p["layers"]["wq"] * cfg.d_model ** 0.5     # truncated N(0, 1)
    assert wq.abs().max() <= 2.0
    assert 0.75 < wq.std().item() < 1.0             # 0.88 for [-2, 2]
    assert torch.equal(p["layers"]["ln_attn"],
                       torch.ones(cfg.n_layers, cfg.d_model))


def test_forward_fp32_matches_jax():
    jcfg = JT.config("tiny", dtype=jnp.float32)
    tcfg = TT.config("tiny", dtype=torch.float32)
    jp, tp = _params(jcfg)
    toks = _tokens(2, 24, jcfg.vocab_size)
    want = JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_forward_with_positions_and_hidden_states():
    jcfg = JT.config("tiny", dtype=jnp.float32)
    tcfg = TT.config("tiny", dtype=torch.float32)
    jp, tp = _params(jcfg)
    toks = _tokens(2, 16, jcfg.vocab_size, seed=1)
    pos = np.tile(np.arange(5, 21), (2, 1))
    want, _ = JT.hidden_states(jp, jnp.asarray(toks, jnp.int32), jcfg,
                               jnp.asarray(pos, jnp.int32))
    got, aux = TT.hidden_states(tp, torch.from_numpy(toks), tcfg,
                                torch.from_numpy(pos))
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_forward_bf16_matches_jax_loosely():
    jcfg, tcfg = JT.config("tiny"), TT.config("tiny")
    jp, tp = _params(jcfg)
    toks = _tokens(2, 24, jcfg.vocab_size, seed=2)
    want = np.asarray(JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32       # f32 logits from bf16 operands
    np.testing.assert_allclose(got.numpy(), want, atol=0.08, rtol=0)


def test_flash_implementation_on_cpu_matches_reference():
    tcfg = TT.config("tiny", dtype=torch.float32)
    _, tp = _params(JT.config("tiny", dtype=jnp.float32))
    toks = torch.from_numpy(_tokens(1, 32, tcfg.vocab_size, seed=3))
    ref = TT.forward(tp, toks, tcfg)
    flash = TT.forward(tp, toks, dataclasses.replace(
        tcfg, attention_impl="flash"))
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_tied_embeddings_match_jax():
    jcfg = JT.config("tiny", dtype=jnp.float32, tie_embeddings=True)
    tcfg = TT.config("tiny", dtype=torch.float32, tie_embeddings=True)
    jp, tp = _params(jcfg)
    toks = _tokens(1, 8, jcfg.vocab_size, seed=4)
    want = JT.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_moe_is_not_ported_yet(tmp_path):
    """MoE is ported (tests/test_torch_moe.py), a seq-sharded mesh
    included: two gloo ranks holding half the sequence each give the
    logits of one process, each row one routing group with the whole
    row's capacity."""
    from cloudtik_tpu_torch.parallel.launch import run_ranks

    cfg = TT.config("tiny_moe", dtype=torch.float32)
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.as_tensor(_tokens(2, 16, cfg.vocab_size))
    with torch.no_grad():
        want = TT.forward(params, tokens, cfg)
    want = want[0] if isinstance(want, tuple) else want
    torch.save({"cases": [dict(kind="moe_seq", name="forward", world=2,
                                what="forward", model="tiny_moe",
                                params=params, tokens=tokens.numpy())]},
               tmp_path / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(tmp_path / "cases.pt"),
               str(tmp_path)], 2, 120, cwd=str(ROOT))
    for r in range(2):
        got = torch.load(tmp_path / f"forward.rank{r}.pt",
                         weights_only=False)["logits"]
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_round_trip_through_numpy():
    jcfg = JT.config("tiny", param_dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    back = convert.params_to_numpy(tp)
    np.testing.assert_array_equal(
        back["layers"]["wq"],
        np.asarray(jp["layers"]["wq"]).astype(np.float32))
    assert back["embed"].dtype == np.float32
