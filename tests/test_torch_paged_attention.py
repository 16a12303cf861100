"""Paged decode attention (ops/paged_attention.py, csrc/paged_attn.cu).

On the CPU: the plain version against an independent per-lane loop that
walks each lane's block table position by position (GQA groups 1, 2, 4;
head_dim 16, 64, 128; blocks of 4 and 16; lengths 0, bs - 1, bs and
M * bs - 1, an inactive lane, two lanes sharing a prefix block); the
append lands only at each active lane's (table[len // bs], len % bs); the
wrapper takes the plain version for CPU tensors and launches nothing; a
Python model of the kernel's split-and-merge arithmetic equals the plain
version at every split size; the engine's decode steps carry the launch
count, 0 here.  On the card (marked `chip`, skipped without one): the
kernel against the plain version at Mistral-7B's and tpu_1b's shapes in
bf16, its launch count, and an engine's `serve.decode_step` spans.
"""

import numpy as np
import pytest
import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.ops import paged_attention as PA
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import kvcache
from cloudtik_tpu_torch.telemetry import core

torch.set_num_threads(1)

M = 4                     # table slots a lane
# bf16 output: both versions round an f32 result once; their f32 sums
# differ in order by ~1e-6 relative, which can move that rounding by one
# bf16 step, at most 2**-7 of the value (plus a floor for values near 0)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def _lanes(bs: int):
    """(tables, lengths, active) of six lanes over a pool of 1 + 9 blocks:
    lengths 0, bs - 1, bs and M * bs - 1; an inactive lane on the null
    block; and a lane sharing lane 3's first (full) block, appending into
    a block of its own."""
    tables = np.zeros((6, M), np.int64)
    tables[0, 0] = 1
    tables[1, 0] = 2
    tables[2, :2] = (3, 4)
    tables[3, :] = (5, 6, 7, 8)
    tables[5, :2] = (5, 9)
    lengths = np.array([0, bs - 1, bs, M * bs - 1, 7, bs + 3], np.int64)
    active = np.array([True, True, True, True, False, True])
    return (torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(active))


def _inputs(group: int, head_dim: int, bs: int, dtype=torch.float32,
            device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    B, Hkv = 6, 2
    H = Hkv * group
    N = 10

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    q, k, v = t(B, 1, H, head_dim), t(B, 1, Hkv, head_dim), \
        t(B, 1, Hkv, head_dim)
    ck, cv = t(N, bs, Hkv, head_dim), t(N, bs, Hkv, head_dim)
    tables, lengths, active = (x.to(device) for x in _lanes(bs))
    return q, k, v, ck, cv, tables, lengths, active


def _loop_oracle(q, k, v, ck, cv, tables, lengths, active, bs):
    """Per active lane and query head: walk the table position by
    position up to the lane's length (the new k/v at the length itself,
    the untouched pool before it), f32 softmax and weighted sum."""
    B, _, H, D = q.shape
    group = H // ck.shape[2]
    out = {}
    for b in range(B):
        if not bool(active[b]):
            continue
        n = int(lengths[b]) + 1
        for hq in range(H):
            hk = hq // group
            keys, vals = [], []
            for p in range(n):
                if p == n - 1:
                    keys.append(k[b, 0, hk].float())
                    vals.append(v[b, 0, hk].float())
                else:
                    blk = int(tables[b, p // bs])
                    keys.append(ck[blk, p % bs, hk].float())
                    vals.append(cv[blk, p % bs, hk].float())
            s = torch.stack(keys) @ q[b, 0, hq].float() * D ** -0.5
            p = torch.softmax(s, dim=0)
            out[(b, hq)] = p @ torch.stack(vals)
    return out


CASES = [(g, d, bs) for g in (1, 2, 4) for d in (16, 64, 128)
         for bs in (4, 16)]


@pytest.mark.parametrize("group,head_dim,bs", CASES)
def test_plain_version_matches_a_per_lane_loop(group, head_dim, bs):
    args = _inputs(group, head_dim, bs)
    q, k, v, ck, cv, tables, lengths, active = args
    want = _loop_oracle(*(a.clone() for a in args), bs)
    got = PA.paged_attention_reference(*args, bs)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert len(want) == 5 * q.shape[2]          # five active lanes
    for (b, hq), o in want.items():
        torch.testing.assert_close(got[b, 0, hq], o, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bs", [4, 16])
def test_append_lands_only_at_each_active_lanes_position(bs):
    args = _inputs(4, 64, bs)
    q, k, v, ck, cv, tables, lengths, active = args
    ck0, cv0 = ck.clone(), cv.clone()
    PA.paged_attention_reference(*args, bs)
    expect_k, expect_v = ck0.clone(), cv0.clone()
    for b in range(q.shape[0]):
        if bool(active[b]):
            n = int(lengths[b])
            blk = int(tables[b, n // bs])
            expect_k[blk, n % bs] = k[b, 0]
            expect_v[blk, n % bs] = v[b, 0]
    # the null block is garbage that inactive lanes may write
    real = slice(kvcache.NULL_BLOCK + 1, None)
    assert torch.equal(ck[real], expect_k[real])
    assert torch.equal(cv[real], expect_v[real])


def test_wrapper_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for CPU tensors")

    monkeypatch.setattr(_kernels, "library", no_build)
    launches = PA.LAUNCHES
    args = _inputs(2, 64, 16)
    twin = [a.clone() for a in args]
    got = PA.paged_attention(*args, 16)
    want = PA.paged_attention_reference(*twin, 16)
    assert torch.equal(got, want)
    assert torch.equal(args[3], twin[3]) and torch.equal(args[4], twin[4])
    assert PA.LAUNCHES == launches


def test_wrapper_refuses_other_devices_and_the_kernel_cpu_tensors():
    meta = [a.to("meta") for a in _inputs(1, 64, 16)]
    with pytest.raises(ValueError, match="no paged attention for device"):
        PA.paged_attention(*meta, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        PA._kernel(*_inputs(1, 64, 16), 16)


def test_kernel_signature_is_registered():
    sig = _kernels._SIGNATURES["paged_attn"]
    assert set(sig) == {"tik_paged_attn", "tik_cuda_error_string"}
    assert len(sig["tik_paged_attn"][0]) == 22


@pytest.mark.parametrize("batch,kv_heads,capacity,sms,want", [
    (32, 8, 1024, 132, (256, 4)),     # Mistral-7B in the chat cell
    (8, 16, 512, 132, (64, 8)),       # tpu_1b on 8 lanes
    (1, 1, 8192, 132, (64, 128)),     # one long lane: the least splits
    (32, 8, 32768, 132, (512, 64)),   # long lanes: splits of the most
    (256, 64, 64, 132, (64, 1)),      # a wide short batch: one split
    (2, 2, 40, 132, (64, 1)),
])
def test_split_plan(batch, kv_heads, capacity, sms, want):
    per, n = PA.split_plan(batch, kv_heads, capacity, sms)
    assert (per, n) == want
    assert per % PA.SPLIT_QUANTUM == 0 and per <= PA.MAX_SPLIT
    assert (n - 1) * per < capacity <= n * per


def _split_model(q, k, v, ck, cv, tables, lengths, active, bs, split):
    """The kernel's arithmetic in PyTorch: the append, then per (lane, KV
    head, split) the scores of the split's positions for the group's
    query heads, the split's max m and sum l of exp(s - m) and its
    unnormalised P.V, then the splits merged under their common max."""
    B, _, H, D = q.shape
    Hkv = ck.shape[2]
    G = H // Hkv
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        if not bool(active[b]):
            continue
        n = int(lengths[b]) + 1
        blk = int(tables[b, (n - 1) // bs])
        ck[blk, (n - 1) % bs] = k[b, 0]
        cv[blk, (n - 1) % bs] = v[b, 0]
        pos = torch.arange(n)
        phys = tables[b, pos // bs]
        keys, vals = ck[phys, pos % bs], cv[phys, pos % bs]   # [n, Hkv, D]
        for h in range(Hkv):
            qs = q[b, 0, h * G:(h + 1) * G].float()           # [G, D]
            parts = []
            for p0 in range(0, n, split):
                kk = keys[p0:p0 + split, h].float()
                s = (qs @ kk.T) * D ** -0.5                   # [G, cnt]
                m = s.max(dim=1).values
                e = torch.exp(s - m[:, None])
                parts.append((m, e.sum(1), e @ vals[p0:p0 + split, h]
                              .float()))
            mm = torch.stack([p[0] for p in parts]).max(0).values
            w = [torch.exp(p[0] - mm) for p in parts]
            l = sum(p[1] * wi for p, wi in zip(parts, w))
            o = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
            out[b, 0, h * G:(h + 1) * G] = o / l[:, None]
    return out


@pytest.mark.parametrize("split", [1, 3, 16, 64])
@pytest.mark.parametrize("bs", [4, 16])
def test_split_and_merge_model_equals_the_plain_version(split, bs):
    args = _inputs(4, 16, bs, seed=3)
    twin = [a.clone() for a in args]
    want = PA.paged_attention_reference(*args, bs)
    got = _split_model(*twin, bs, split)
    act = args[7]
    torch.testing.assert_close(got[act], want[act], rtol=1e-5, atol=1e-6)
    real = slice(kvcache.NULL_BLOCK + 1, None)
    assert torch.equal(twin[3][real], args[3][real])
    assert torch.equal(twin[4][real], args[4][real])


# ------------------------------------------------------------- engine --

@pytest.fixture
def telemetry_on():
    was = core.STATE.enabled
    core.enable()
    core.reset()
    try:
        yield
    finally:
        core.reset()
        core.STATE.enabled = was


def _decode_spans(cfg, device, prompts, new=4):
    params = TT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    eng = TE.DecodeEngine(params, cfg, TE.EngineConfig(
        slots=3, max_len=64, prefill_buckets=(8, 16, 32)), device=device)
    reqs = [eng.submit(TE.Request(p, max_new_tokens=new)) for p in prompts]
    eng.start()
    try:
        outs = [r.wait(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert [len(o) for o in outs] == [new] * len(prompts)
    return [s for s in telemetry.spans() if s["name"] == "serve.decode_step"]


def test_engine_steps_count_no_launch_on_the_cpu(telemetry_on):
    cfg = TT.config("tiny", dtype=torch.float32)
    steps = _decode_spans(cfg, "cpu", [[5, 6, 7], list(range(9, 30))])
    assert steps
    assert all(s["attrs"]["paged_attn_launches"] == 0 for s in steps)


# --------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda", 0)


def _shape_inputs(B, H, Hkv, D, bs, M, lengths, seed, device):
    """Lanes with their own blocks (a shuffled pool of B * M + 1), the
    given lengths, every fourth lane from lane 1 inactive."""
    gen = torch.Generator(device=device).manual_seed(seed)
    N = B * M + 1

    def t(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    perm = torch.randperm(N - 1, generator=gen, device=device) + 1
    tables = perm.reshape(B, M).to(torch.int64)
    lengths = torch.tensor(lengths, dtype=torch.int64, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    active[1::4] = False
    return (t(B, 1, H, D), t(B, 1, Hkv, D), t(B, 1, Hkv, D),
            t(N, bs, Hkv, D), t(N, bs, Hkv, D), tables, lengths, active)


SHAPES = {
    # Mistral-7B in the chat cell: 32 lanes, 8 KV heads of 128, group 4
    "mistral7b": dict(B=32, H=32, Hkv=8, D=128, bs=16, M=64),
    # tpu_1b as chip_smoke's engine serves it: group 1
    "tpu_1b": dict(B=8, H=16, Hkv=16, D=128, bs=16, M=32),
    "d64_group2": dict(B=4, H=4, Hkv=2, D=64, bs=4, M=40),
}


@pytest.mark.chip
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_the_plain_version_on_the_card(cuda_device, shape):
    c = SHAPES[shape]
    cap = c["M"] * c["bs"]
    lengths = np.linspace(0, cap - 1, c["B"]).round().astype(int).tolist()
    args = _shape_inputs(c["B"], c["H"], c["Hkv"], c["D"], c["bs"], c["M"],
                         lengths, 7, cuda_device)
    twin = [a.clone() for a in args]
    before = PA.LAUNCHES
    got = PA.paged_attention(*args, c["bs"])
    _, n_splits = PA.split_plan(c["B"], c["Hkv"], cap,
                                PA._sm_count(cuda_device))
    assert PA.LAUNCHES - before == (1 if n_splits == 1 else 2)
    want = PA.paged_attention_reference(*twin, c["bs"])
    torch.cuda.synchronize()
    act = args[7]
    assert bool((got[~act] == 0).all())
    err = (got[act].float() - want[act].float()).abs()
    assert bool((err <= BF16_ATOL + BF16_RTOL * want[act].float().abs())
                .all()), err.max().item()
    # the append is a copy: the pools equal bit for bit off the null block
    real = slice(kvcache.NULL_BLOCK + 1, None)
    assert torch.equal(args[3][real], twin[3][real])
    assert torch.equal(args[4][real], twin[4][real])


@pytest.mark.chip
def test_engine_steps_go_through_the_kernel_on_the_card(cuda_device,
                                                        telemetry_on):
    cfg = TT.TransformerConfig(vocab_size=256, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=512,
                               max_seq_len=64)      # head_dim 64, group 2
    steps = _decode_spans(cfg, cuda_device, [[5, 6, 7], list(range(9, 30))])
    assert steps
    counts = {s["attrs"]["paged_attn_launches"] for s in steps}
    per_layer = 1 if PA.split_plan(
        3, 2, 64, PA._sm_count(cuda_device))[1] == 1 else 2
    assert counts == {cfg.n_layers * per_layer}
