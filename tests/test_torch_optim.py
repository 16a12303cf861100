"""Port parity: the port's AdamW, SGD, Adafactor and Lion + clipping +
schedules against the JAX package's `make_optimizer` (optax), over 5
updates on identical grads.

f32 params: updates and params agree to 1e-6 relative (both compute in f32;
pow and sqrt may differ in the last bit).  bf16 params with bf16 moments:
XLA keeps some of the elementwise chain in f32 where torch rounds each of
~6 ops to bf16, so an lr-sized update may differ by a few bf16 steps of
itself (2**-5 relative): after 5 updates each param agrees to one bf16
step of itself (2**-7 relative) plus 5 * 2**-5 * lr absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.train import optim as JO
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.tree import tree_map

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

SHAPES = {"embed": (16, 8), "layers": {"wq": (2, 8, 4), "ln": (2, 8)},
          "final_norm": (8,)}


# Adafactor's cases: "stack" factors over its two largest axes, 1 and 3,
# which are not the trailing two (as a stacked wq [L, d, H, Dh] does);
# "mat" over its trailing two; "narrow" has one axis under 128 and keeps a
# full v; "ties" has two equal largest axes (np.argsort picks them);
# "bias" is 1-D
FACTOR_SHAPES = {"stack": (2, 160, 3, 130), "mat": (130, 144),
                 "narrow": (6, 200), "ties": (128, 5, 128),
                 "bias": (130,)}


def _tree(rng, scale=1.0, shapes=SHAPES):
    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict)
                else leaf(v)) for k, v in shapes.items()}


def _run_both(cfg, param_dtype, grad_scale, steps=5, shapes=SHAPES):
    rng = np.random.default_rng(0)
    params_np = _tree(rng, shapes=shapes)
    grads_np = [_tree(rng, grad_scale, shapes) for _ in range(steps)]
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    jopt = JO.make_optimizer(cfg)
    jstate = jopt.init(jp)
    tdt = getattr(torch, param_dtype)
    tp = convert.params_from_jax(params_np, "cpu", tdt)
    topt = TO.make_optimizer(TO.OptimizerConfig(**vars(cfg)))
    tstate = topt.init(tp)
    for g_np in grads_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np)
        ju, jstate = jopt.update(jg, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        tg = convert.params_from_jax(g_np, "cpu", tdt)
        tu, tstate, _ = topt.update(tg, tstate, tp)
        tp = tree_map(lambda p, u: p + u.to(p.dtype), tp, tu)
    return (jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            convert.params_to_numpy(tp), jax.tree.map(
                lambda a: np.asarray(a, np.float32), ju),
            convert.params_to_numpy(tu), tstate)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0],
                         ids=["unclipped", "clipped"])
def test_adamw_matches_optax_f32(schedule, grad_scale):
    cfg = JO.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                             total_steps=6, schedule=schedule)
    jp, tp, ju, tu, state = _run_both(cfg, "float32", grad_scale)
    assert state["count"] == 5
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(tu), jax.tree.leaves(ju)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("grad_scale", [0.01, 3.0],
                         ids=["unclipped", "clipped"])
def test_adamw_bf16_moments_match_optax(grad_scale):
    cfg = JO.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                             total_steps=6, moment_dtype="bfloat16")
    jp, tp, _, _, state = _run_both(cfg, "float32", grad_scale)
    assert state["mu"]["embed"].dtype == torch.bfloat16
    assert state["nu"]["embed"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_adamw_bf16_params_match_optax_loosely():
    cfg = JO.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                             total_steps=6, moment_dtype="bfloat16")
    jp, tp, _, _, state = _run_both(cfg, "bfloat16", 3.0)
    assert state["mu"]["embed"].dtype == torch.bfloat16
    assert state["nu"]["embed"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=2 ** -7,
                                   atol=5 * 2 ** -5 * 1e-2)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_match_optax(schedule):
    for warmup, total in ((10, 100), (0, 50), (5, 5)):
        cfg = JO.OptimizerConfig(learning_rate=3e-4, warmup_steps=warmup,
                                 total_steps=total, schedule=schedule)
        if schedule == "cosine" and total == warmup:
            with pytest.raises(ValueError):
                JO.make_schedule(cfg)
            with pytest.raises(ValueError):
                TO.make_schedule(TO.OptimizerConfig(**vars(cfg)))
            continue
        js = JO.make_schedule(cfg)
        ts = TO.make_schedule(TO.OptimizerConfig(**vars(cfg)))
        for count in (0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                      total - 1, total, total + 7):
            np.testing.assert_allclose(ts(count), float(js(count)),
                                       rtol=1e-6, atol=1e-12)
        assert ts(0) == 0.0 or warmup == 0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        TO.make_optimizer(TO.OptimizerConfig(name="nope"))


def test_every_optimizer_shares_the_update_contract():
    for name in ("adamw", "sgd", "adafactor", "lion"):
        opt = TO.make_optimizer(TO.OptimizerConfig(name=name))
        assert isinstance(opt, TO.Optimizer)
        params = {"w": torch.ones(3, 2)}
        state = opt.init(params)
        assert state["count"] == 0
        updates, state, g_norm = opt.update(
            {"w": torch.full((3, 2), 0.5)}, state, params)
        assert state["count"] == 1 and updates["w"].shape == (3, 2)
        np.testing.assert_allclose(float(g_norm), 0.5 * 6 ** 0.5,
                                   rtol=1e-6)


@pytest.mark.parametrize("shape", [
    (), (7,), (130,), (127, 300), (128, 128), (130, 129), (2, 160, 3, 130),
    (128, 5, 128), (16, 2048, 16, 128), (16, 16, 128, 2048),
    (32000, 2048), (5, 5, 300, 128, 128)])
def test_factored_dims_match_optax(shape):
    from optax._src import factorized

    assert TO.factored_dims(shape) == factorized._factored_dims(
        shape, True, 128)


# f32: the same arithmetic in the same order, except pow and the means'
# summation order (Adafactor) and the global norm's (the clip), a
# last-bit difference of an update: params and updates within 1e-6 / 1e-5
# relative as AdamW's.  bf16 moments (SGD's trace, Lion's mu): both round
# the stored moment to bf16 at the same points, but a last-bit difference
# of its f32 input may flip one rounding, which moves that element's
# update by one bf16 step of the moment (2**-8 of it) times lr, carried
# into the later updates: params also within steps * lr * 2**-8 *
# max|moment| absolute.  Adafactor has no moment: moment_dtype must change
# nothing.
NEW_OPTIMIZERS = ("sgd", "adafactor", "lion")


def _state_leaves(state):
    return {k: [np.asarray(x, np.float32) for x in jax.tree.leaves(
        convert.params_to_numpy(v))]
        for k, v in state.items() if k != "count"}


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"],
                         ids=["f32_moments", "bf16_moments"])
@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", NEW_OPTIMIZERS)
def test_optimizer_matches_optax_f32(name, clip, moment_dtype):
    # grads of global norm ~40 (clipped to 1 when clipping is on)
    cfg = JO.OptimizerConfig(name=name, learning_rate=1e-2, warmup_steps=2,
                             total_steps=6, grad_clip_norm=clip,
                             moment_dtype=moment_dtype)
    jp, tp, ju, tu, state = _run_both(cfg, "float32", 0.1,
                                      shapes=FACTOR_SHAPES)
    assert state["count"] == 5
    moments = {"sgd": "trace", "lion": "mu"}.get(name)
    flip = 0.0
    if moments and moment_dtype:
        flip = 5 * cfg.learning_rate * 2 ** -8 * max(
            float(t.abs().max()) for t in jax.tree.leaves(state[moments]))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7 + flip)
    for a, b in zip(jax.tree.leaves(tu), jax.tree.leaves(ju)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9 + flip)
    if moments:
        want = getattr(torch, moment_dtype) if moment_dtype \
            else torch.float32
        assert all(t.dtype == want for t in
                   jax.tree.leaves(state[moments]))
    else:
        assert all(t.dtype == torch.float32 for k in ("v_row", "v_col", "v")
                   for t in jax.tree.leaves(state[k]))


def _jax_state_after(cfg, shapes, steps):
    """(numpy params, numpy grads list, the JAX state after `steps`
    updates, the JAX params after them)."""
    rng = np.random.default_rng(0)
    params_np = _tree(rng, shapes=shapes)
    grads_np = [_tree(rng, 0.1, shapes) for _ in range(5)]
    jopt = JO.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jp)
    for g in grads_np[:steps]:
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
    return jopt, grads_np, jstate, jp


@pytest.mark.parametrize("name", ("adamw",) + NEW_OPTIMIZERS)
def test_opt_state_from_jax_continues_the_jax_run(name):
    """3 JAX updates, the state carried over, 2 more on each side (f32
    moments: the bf16 ones' dtypes are held by the test above and by
    tests/test_torch_checkpoint.py)."""
    cfg = JO.OptimizerConfig(name=name, learning_rate=1e-2, warmup_steps=2,
                             total_steps=6)
    jopt, grads_np, jstate, jp = _jax_state_after(cfg, FACTOR_SHAPES, 3)
    tstate = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        "cpu")
    assert tstate["count"] == 3 and isinstance(tstate["count"], int)
    topt = TO.make_optimizer(TO.OptimizerConfig(**vars(cfg)))
    want = topt.init(convert.params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))
    assert set(tstate) == set(want)
    for k in want:
        if k != "count":
            for a, b in zip(jax.tree.leaves(tstate[k]),
                            jax.tree.leaves(want[k])):
                assert a.shape == b.shape and a.dtype == b.dtype, k
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for g in grads_np[3:]:
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, tstate, _ = topt.update(convert.params_from_jax(g, "cpu"),
                                    tstate, tp)
        tp = tree_map(lambda p, u: p + u, tp, tu)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    got = _state_leaves(tstate)
    want = _state_leaves(convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu"))
    # the moments sum scaled grads whose clip differs in the last bit (the
    # global norm's summation order), and may cancel: within 1e-5 relative
    # of themselves or 1e-6 of the leaf's largest entry
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=k)


def test_config_fields_match_jax():
    assert vars(JO.OptimizerConfig()) == vars(TO.OptimizerConfig())


def test_global_norm_is_accurate_on_a_large_cpu_leaf():
    """The clip's norm over 2**24 entries within 1e-6 of an f64 sum (a
    serial f32 sum loses ~1e-3 there; XLA's and the card's do not)."""
    x = torch.randn(2 ** 24, generator=torch.Generator().manual_seed(0))
    want = float(np.sqrt(np.sum(x.double().numpy() ** 2)))
    got = TO.global_norm({"w": x, "b": torch.ones(3)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), np.sqrt(want ** 2 + 3),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor", "lion"])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_update_in_place_equals_update_then_add(name, moment_dtype):
    """`update_` (the trainer's: leaf by leaf, params and state written in
    place) is bit for bit `update` followed by p + u, over 3 steps with
    the clip engaged on the first."""
    shapes = FACTOR_SHAPES if name == "adafactor" else SHAPES
    cfg = TO.OptimizerConfig(name=name, learning_rate=1e-2, warmup_steps=1,
                             schedule="constant", grad_clip_norm=1.0,
                             moment_dtype=moment_dtype)
    rng = np.random.default_rng(3)
    params = tree_map(torch.from_numpy, _tree(rng, shapes=shapes))
    grads = [tree_map(torch.from_numpy, _tree(rng, scale=s, shapes=shapes))
             for s in (10.0, 0.1, 0.1)]
    opt = TO.make_optimizer(cfg)
    p_ref = tree_map(torch.clone, params)
    s_ref = opt.init(p_ref)
    p_in = tree_map(torch.clone, params)
    s_in = opt.init(p_in)
    for g in grads:
        updates, s_ref, n_ref = opt.update(g, s_ref, p_ref)
        p_ref = tree_map(lambda p, u: p + u.to(p.dtype), p_ref, updates)
        s_in, n_in = opt.update_(g, s_in, p_in)
        assert torch.equal(n_in, n_ref)
    for a, b in zip(jax.tree.leaves(p_in), jax.tree.leaves(p_ref)):
        assert torch.equal(a, b)
    assert s_in["count"] == s_ref["count"] == 3
    for key in s_ref:
        if key != "count":
            for a, b in zip(jax.tree.leaves(s_in[key]),
                            jax.tree.leaves(s_ref[key])):
                assert a.dtype == b.dtype and torch.equal(a, b), key
