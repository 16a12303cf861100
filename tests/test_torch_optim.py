"""Port parity: the port's AdamW + clipping + schedules against the JAX
package's `make_optimizer` (optax), over 5 updates on identical grads.

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


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict)
                else leaf(v)) for k, v in SHAPES.items()}


def _run_both(cfg, param_dtype, grad_scale, steps=5):
    rng = np.random.default_rng(0)
    params_np = _tree(rng)
    grads_np = [_tree(rng, grad_scale) for _ in range(steps)]
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


@pytest.mark.parametrize("name", ["sgd", "adafactor", "lion"])
def test_other_optimizers_are_not_ported_yet(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        TO.make_optimizer(TO.OptimizerConfig(name=name))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        TO.make_optimizer(TO.OptimizerConfig(name="nope"))


def test_config_fields_match_jax():
    assert vars(JO.OptimizerConfig()) == vars(TO.OptimizerConfig())
