"""Port parity: cloudtik_tpu_torch.models.diffusion against the JAX UNet.

Parameters come from the JAX `init_params` through `convert.py`, inputs
from a numpy seed, all in f32 on one intra-op thread.  The forward and the
loss agree to 1e-5 relative and every gradient leaf to 1e-4 relative L2;
GroupNorm, the nearest upsample and the timestep embedding are pinned one
by one, and a planted unbiased variance shows the GroupNorm check's power.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import diffusion as JU
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import diffusion as TU

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name", sorted(JU.PRESETS))
def test_presets_match_jax(name):
    jcfg, tcfg = JU.PRESETS[name], TU.PRESETS[name]
    for field in dataclasses.fields(JU.UNetConfig):
        want = getattr(jcfg, field.name)
        if field.name in ("dtype", "param_dtype"):
            want = _DTYPES[want]
        assert getattr(tcfg, field.name) == want, field.name
    assert tcfg.flops_per_image() == jcfg.flops_per_image()


def test_sdxl_mini_flops_per_image():
    """570.3 GFLOP an image by the reference's count."""
    assert round(TU.config("sdxl_mini").flops_per_image() / 1e9, 1) == 570.3


def _params(jcfg):
    jp = JU.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", ["tiny", "sdxl_mini"])
def test_init_params_tree_matches_jax(name):
    jcfg = JU.config(name)
    want = jax.eval_shape(lambda: JU.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TU.init_params(torch.Generator(), TU.config(name),
                         torch.device("meta"))
    jl, jdef = jax.tree.flatten(want)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32


def test_timestep_embedding_matches_jax_cos_first():
    t = np.array([0.0, 3.5, 250.0, 999.0], np.float32)
    want = np.asarray(JU.timestep_embedding(jnp.asarray(t), 64))
    got = TU.timestep_embedding(torch.from_numpy(t), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # t = 0: every cosine is 1 and every sine 0
    assert (got[0, :32] == 1).all() and (got[0, 32:] == 0).all()


@pytest.mark.parametrize("groups,channels", [(8, 32), (32, 320), (8, 4)])
def test_group_norm_matches_jax(groups, channels):
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 5, 3, channels)) * 3 + 1).astype(
        np.float32)
    scale = rng.standard_normal(channels).astype(np.float32)
    want = np.asarray(JU._group_norm(jnp.asarray(x), jnp.asarray(scale),
                                     groups))
    got = TU._group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         groups).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_group_norm_with_the_unbiased_variance_is_caught():
    """The check's power: the unbiased variance over a group of 5x3x4
    values moves the output by ~1.7% (sqrt(60/59)), far past 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = np.ones(32, np.float32)
    want = np.asarray(JU._group_norm(jnp.asarray(x), jnp.asarray(scale), 8))
    x32 = torch.from_numpy(x).reshape(2, 5, 3, 8, 4)
    var, mean = torch.var_mean(x32, dim=(1, 2, 4), keepdim=True)
    wrong = ((x32 - mean) * torch.rsqrt(var + 1e-5)).reshape(2, 5, 3, 32)
    assert not np.allclose(wrong.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w", [(4, 4), (3, 5)])
def test_nearest_upsample_is_jax_image_resize(h, w):
    x = np.arange(2 * h * w * 3, dtype=np.float32).reshape(2, h, w, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * h, 2 * w, 3),
                                       "nearest"))
    got = TU.upsample_nearest_2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _batch(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.image_size, cfg.image_size, cfg.in_channels)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "noise": rng.standard_normal(shape).astype(np.float32),
            "t": rng.uniform(0, 1, (B,)).astype(np.float32)}


def test_forward_and_loss_match_jax():
    jcfg = JU.config("tiny", dtype=jnp.float32)
    tcfg = TU.config("tiny", dtype=torch.float32)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    want = np.asarray(JU.forward(jp, jnp.asarray(batch["latents"]),
                                 jnp.asarray(batch["t"] * 1000.0), jcfg))
    got = TU.forward(tp, torch.from_numpy(batch["latents"]),
                     torch.from_numpy(batch["t"]) * 1000.0, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_l2(got.detach().numpy(), want) <= 1e-5
    jl, _ = JU.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg)
    tl, metrics = TU.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(metrics["loss"]) == float(tl)


def test_every_gradient_leaf_matches_jax():
    jcfg = JU.config("tiny", dtype=jnp.float32)
    tcfg = TU.config("tiny", dtype=torch.float32)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, seed=3)
    jg = jax.grad(lambda p: JU.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jp)
    leaves = jax.tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = TU.loss_fn(tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, j in zip(grads, jleaves):
        assert rel_l2(g.numpy(), np.asarray(j)) <= 1e-4


def test_bf16_forward_is_finite_and_close():
    """The training dtype on the CPU: bf16 compute over f32 params stays
    near the JAX package's bf16 forward (both round every conv)."""
    jcfg = JU.config("tiny")
    tcfg = TU.config("tiny")
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, seed=5)
    want = np.asarray(JU.forward(jp, jnp.asarray(batch["latents"]),
                                 jnp.asarray(batch["t"]), jcfg))
    got = TU.forward(tp, torch.from_numpy(batch["latents"]),
                     torch.from_numpy(batch["t"]), tcfg).numpy()
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= 0.05
