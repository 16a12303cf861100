"""Port parity: cloudtik_tpu_torch flash attention vs the JAX Pallas kernels.

The JAX kernels run in interpret mode on the CPU; the port's plain versions
(`flash_attention_reference` and `flash_attention_bwd_reference`, what its
CUDA kernels are held to on the card) must give the same o and lse, and the
same dq, dk, dv as `jax.vjp` through the Pallas backward kernels.  fp32
inputs, atol/rtol 2e-5: the same bar the JAX package's own kernel test
holds its kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.ops.flash_attention import flash_attention as jax_flash
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.ops import flash_attention as FA

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

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


@pytest.mark.parametrize("B,H,Hkv,S,Skv,D,causal,block", CASES)
def test_plain_backward_matches_jax_kernels(B, H, Hkv, S, Skv, D, causal,
                                            block):
    q, k, v = _qkv(B, H, Hkv, S, D, Skv, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, causal=causal,
                                     block_q=block, block_k=block,
                                     interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _torch(q, k, v, do)
    o, lse = FA.flash_attention_reference(tq, tk, tv, causal=causal)
    got = FA.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                           causal=causal)
    for name, g, w, ref in zip("qkv", got, want, (tq, tk, tv)):
        assert g.shape == ref.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_autograd_takes_the_plain_backward_on_cpu():
    q, k, v = (t.requires_grad_(True) for t in _torch(*_qkv(2, 4, 2, 96, 64)))
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 96, 64)).astype(np.float32))
    before = (FA.LAUNCHES_DQ, FA.LAUNCHES_DKV)
    o, lse = FA.flash_attention(q, k, v, causal=True, return_lse=True)
    assert not lse.requires_grad        # a statistic, not an output
    o.backward(do)
    assert (FA.LAUNCHES_DQ, FA.LAUNCHES_DKV) == before
    want = FA.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse, do, causal=True)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_plain_backward_is_the_gradient_of_softmax_attention():
    """Independent of JAX: ragged S, GQA, bf16 inputs, against autograd
    through plain f32 softmax attention with the absolute causal mask.
    bf16: p and ds are rounded to bf16 before their products (as the
    kernels do), so agreement is to 2e-2 of the largest gradient."""
    B, H, Hkv, S, D = 1, 4, 2, 50, 64
    q, k, v = _torch(*_qkv(B, H, Hkv, S, D, seed=4))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, H, S, D)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kk, vv = (t.repeat_interleave(H // Hkv, dim=1) for t in leaves[1:])
    s = torch.einsum("bhsd,bhtd->bhst", leaves[0], kk) * D ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    (torch.softmax(s, -1) @ vv).backward(do)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
        o, lse = FA.flash_attention_reference(qd, kd, vd, causal=True)
        got = FA.flash_attention_bwd_reference(qd, kd, vd, o, lse, dod,
                                               causal=True)
        for g, leaf in zip(got, leaves):
            assert g.dtype == dtype
            scale = leaf.grad.abs().max()
            assert (g.float() - leaf.grad).abs().max() <= tol * scale


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = _torch(*_qkv(1, 2, 2, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        FA._kernel_fwd(q, k, v, True, 0.125)
    o, lse = FA.flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        FA._kernel_bwd(q, k, v, o, lse, o, True, 0.125)


def test_bwd_kernel_signatures_are_registered():
    sig = _kernels._SIGNATURES["flash_bwd"]
    assert set(sig) == {"tik_flash_bwd_dq", "tik_flash_bwd_dkv",
                        "tik_cuda_error_string"}
    # 7 pointers for dq (q, k, v, do, lse, delta, dq), 8 for dk/dv
    assert len(sig["tik_flash_bwd_dq"][0]) == 2 + 7 + 5 + 5 + 3
    assert len(sig["tik_flash_bwd_dkv"][0]) == 2 + 8 + 5 + 6 + 3
    assert (_kernels.CSRC / "flash_bwd.cu").is_file()


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
