"""Port parity: cloudtik_tpu_torch.ops.attention vs the JAX package.

`reference_attention` follows the JAX one (grouped einsum for GQA, causal
mask aligned on the Skv - S diagonal, segment ids, f32 softmax): fp32
inputs, atol/rtol 1e-5.  The auto-dispatch rule is a pure function of
(device type, dtype, shapes, causal), checked here without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.ops.attention import reference_attention as jax_ref
from cloudtik_tpu_torch.ops import flash_attention as FA
from cloudtik_tpu_torch.ops.attention import (
    attention, reference_attention, use_flash_kernel)

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, H, Hkv, S, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,S,Skv,D,causal", [
    (2, 4, 2, 32, 32, 16, True),      # GQA
    (2, 4, 4, 32, 32, 16, False),
    (1, 4, 1, 8, 32, 16, True),       # causal, S < Skv: diagonal-aligned
    (1, 2, 2, 1, 24, 16, True),       # one decode row
])
def test_reference_matches_jax(B, H, Hkv, S, Skv, D, causal):
    q, k, v = _qkv(B, H, Hkv, S, Skv, D)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    got = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Hkv,causal", [(4, True), (2, True), (2, False)])
def test_segment_ids_match_jax(Hkv, causal):
    B, H, S, D = 2, 4, 24, 16
    q, k, v = _qkv(B, H, Hkv, S, S, D, seed=1)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 8, axis=1)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, segment_ids=jnp.asarray(seg))
    got = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal,
                              segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("device,dtype,q_shape,kv_shape,causal,want", [
    ("cuda", torch.bfloat16, (4, 16, 2048, 128), (4, 16, 2048, 128), True,
     True),                                           # the tpu_1b forward
    ("cuda", torch.float16, (1, 8, 100, 64), (1, 2, 100, 64), True, True),
    ("cpu", torch.bfloat16, (1, 8, 128, 128), (1, 8, 128, 128), True,
     False),
    ("cuda", torch.float32, (1, 8, 128, 128), (1, 8, 128, 128), True,
     False),
    ("cuda", torch.bfloat16, (1, 8, 128, 96), (1, 8, 128, 96), True,
     False),                                          # head_dim 96
    ("cuda", torch.bfloat16, (1, 8, 8, 128), (1, 8, 64, 128), True,
     False),                                          # causal, S != Skv
    ("cuda", torch.bfloat16, (1, 8, 8, 128), (1, 8, 64, 128), False,
     True),
])
def test_dispatch_rule(device, dtype, q_shape, kv_shape, causal, want):
    assert use_flash_kernel(device, dtype, q_shape, kv_shape,
                            causal) is want


def test_auto_on_cpu_is_the_reference():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 16, 64))
    out, lse = attention(q, k, v, return_residuals=True)
    assert lse is None
    assert torch.equal(out, reference_attention(q, k, v))
    assert torch.equal(attention(q, k, v, implementation="reference"), out)


def test_explicit_flash_takes_the_plain_kernel_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 16, 64))
    out, lse = attention(q, k, v, implementation="flash",
                         return_residuals=True)
    o_ref, lse_ref = FA.flash_attention_reference(q, k, v)
    assert torch.equal(out, o_ref) and torch.equal(lse, lse_ref)
    np.testing.assert_allclose(out.numpy(),
                               reference_attention(q, k, v).numpy(), **TOL)


def test_unported_and_unknown_implementations_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 16))
    # "ring" is ported (tests/test_torch_ring_attention.py); without a
    # mesh that splits seq there is no ring to run
    with pytest.raises(ValueError, match="ring attention needs"):
        attention(q, k, v, implementation="ring")
    with pytest.raises(ValueError, match="unknown"):
        attention(q, k, v, implementation="xla")
