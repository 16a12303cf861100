"""Port parity: cloudtik_tpu_torch flash attention vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU; the port's plain version
(`flash_attention_reference`, what its CUDA kernel is held to on the card)
must give the same o and lse.  fp32 inputs, atol/rtol 2e-5: the same bar
the JAX package's own kernel test holds its kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.ops.flash_attention import flash_attention as jax_flash
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B, H, Hkv, S, D, Skv=None, seed=0):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [
    # (B, H, Hkv, S, Skv, D, causal, block): tests/test_flash_attention.py
    (1, 2, 2, 256, 256, 64, True, 128),
    (1, 2, 2, 256, 256, 64, False, 128),
    (2, 4, 1, 256, 256, 64, True, 128),    # GQA group=4
    (1, 2, 1, 512, 512, 64, True, 256),    # GQA group=2, 2x2 blocks
    (1, 1, 1, 384, 384, 64, True, 128),    # non-power-of-two seq
    # S < Skv: pins the kernel's absolute-position causal mask
    (1, 2, 2, 128, 256, 64, True, 128),
]


@pytest.mark.parametrize("B,H,Hkv,S,Skv,D,causal,block", CASES)
def test_plain_version_matches_jax_kernel(B, H, Hkv, S, Skv, D, causal,
                                          block):
    q, k, v = _qkv(B, H, Hkv, S, D, Skv)
    o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, block_q=block, block_k=block,
                           interpret=True, return_lse=True)
    o_t, lse_t = FA.flash_attention_reference(*_torch(q, k, v),
                                              causal=causal)
    assert lse_t.shape == (B, H, S, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_cpu_tensor_takes_plain_version():
    q, k, v = _torch(*_qkv(1, 4, 2, 96, 64))
    before = FA.LAUNCHES
    o, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = FA.flash_attention_reference(q, k, v, causal=True)
    assert FA.LAUNCHES == before       # no kernel launch on the CPU
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert torch.equal(FA.flash_attention(q, k, v, causal=True), o)


def test_sm_scale_and_bf16_dtype():
    q, k, v = _torch(*_qkv(1, 2, 2, 64, 64))
    o, lse = FA.flash_attention(q, k, v, sm_scale=0.3, return_lse=True)
    o_j, lse_j = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           sm_scale=0.3, block_q=64, block_k=64,
                           interpret=True, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ob, lseb = FA.flash_attention(qb, kb, vb, return_lse=True)
    assert ob.dtype == torch.bfloat16 and lseb.dtype == torch.float32


def test_rejects_bad_heads():
    q, k, v = _torch(*_qkv(1, 3, 2, 64, 64))
    with pytest.raises(ValueError, match="divisible"):
        FA.flash_attention(q, k, v)


def test_backward_raises_and_names_next_kernels():
    q, k, v = _torch(*_qkv(1, 2, 2, 64, 64))
    q.requires_grad_(True)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    assert not lse.requires_grad        # a statistic, not an output
    with pytest.raises(NotImplementedError, match="_dq_kernel"):
        o.sum().backward()


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _torch(*_qkv(1, 2, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        FA._kernel_fwd(q, k, v, True, 0.125)


def test_missing_nvcc_raises_only_at_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_kernels, "_loaded", {})
    with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
        _kernels.library("flash_fwd")
    assert not (tmp_path / "build").exists()


def test_build_key_tracks_the_source():
    target = _kernels._target("flash_fwd")
    assert target.parent == _kernels.BUILD_DIR
    assert target.name.startswith("libflash_fwd-")
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
