"""`chip_smoke.py` rehearsed on the CPU: its serve, engine, spec, lora,
disagg, fabric, forward, training, detection and (among the cluster
phases) control phases run end to end at `tiny` size on
the plain kernel versions, its kernel_det case list at CPU size, its bound
arithmetic and its tie-aware greedy check are pinned, and without a card
it fails and prints no result."""

import dataclasses
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cloudtik_tpu_torch.ops import detection as D
from cloudtik_tpu_torch.ops import flash_attention as FA
from cloudtik_tpu_torch.runtimes.ai.runtime import AIRuntime

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_without_a_card_it_fails_and_prints_no_result(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_phase_rehearsal():
    out = chip_smoke.phase_serve("tiny", "cpu")
    assert out["greedy_b1"]["equals_direct_generate"]
    assert out["greedy_b2"]["equals_direct_generate"]
    assert out["topk_seeded"]["repeatable"]
    assert out["error_paths"] == {"bad_request": [400, 400, 400],
                                  "not_found": 404, "draining": 503}


def test_forward_main_rehearsal_takes_no_kernel_on_cpu():
    before = FA.LAUNCHES
    cfg, _, tokens, logits = chip_smoke.forward_main("tiny", 2, 16, "cpu")
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert tuple(tokens.shape) == (2, 16)
    assert FA.LAUNCHES == before


def test_attention_bound_at_the_main_shape():
    main = chip_smoke.ATTN_CASES[0]
    assert (main.B, main.H, main.S, main.D, main.causal) == \
        (4, 16, 2048, 128, True)
    bound_ms, bound_by, flops, nbytes = chip_smoke.attention_bound(main)
    assert flops == 4 * 4 * 16 * (2048 * 2049 // 2) * 128  # 68.75 GFLOP
    assert nbytes == 2 * 4 * 4 * 16 * 2048 * 128 + 4 * 4 * 16 * 2048
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(flops / 989e12 * 1e3)
    ragged = next(c for c in chip_smoke.ATTN_CASES
                  if c.name == "ragged_causal")
    assert chip_smoke.attention_bound(ragged)[1] == "bytes"


def test_train_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_train("tiny", 2, 16, "cpu", warmup=1, steps=2)
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["mfu"] is None and out["peak_mem_gb"] is None
    assert out["measured_steps"] == 2 and out["remat_policy"] == "save_attn"
    assert out["tokens_per_s"] > 0


def test_train_grads_rehearsal():
    out = chip_smoke.phase_train_grads("tiny", 2, 2, 32, "cpu",
                                       loss_steps=10)
    rel = out["grad_rel_l2_flash_vs_reference"]
    assert len(rel) == 12 and "layers.wq" in rel and "lm_head" in rel
    assert max(rel.values()) <= chip_smoke.GRADS_REL_L2
    losses = out["repeated_batch_losses"]
    assert len(losses) == 10 and losses[-1] < losses[0] - 0.1


def test_attention_bwd_bound_at_the_training_shape():
    main = chip_smoke.BWD_CASES[0]
    assert (main.B, main.H, main.Hkv, main.S, main.D, main.causal,
            main.layout) == (8, 16, 16, 2048, 128, True, "bshd")
    bound = chip_smoke.attention_bwd_bound(main)
    pairs = 2048 * 2049 // 2                      # 2,098,176 per head
    assert bound["dq"]["flops"] == 6 * 8 * 16 * pairs * 128    # 206 GFLOP
    assert bound["dkv"]["flops"] == 8 * 8 * 16 * pairs * 128   # 275 GFLOP
    elems = 8 * 16 * 2048 * 128
    stats = 2 * 4 * 8 * 16 * 2048
    assert bound["dq"]["bytes"] == 2 * 5 * elems + stats
    assert bound["dkv"]["bytes"] == 2 * 6 * elems + stats
    for name in ("dq", "dkv"):
        assert bound[name]["bound_by"] == "operations"
        assert bound[name]["bound_ms"] == pytest.approx(
            bound[name]["flops"] / 989e12 * 1e3)
    assert bound["dq"]["bound_ms"] == pytest.approx(0.2085, abs=1e-4)
    assert bound["dkv"]["bound_ms"] == pytest.approx(0.2780, abs=1e-4)
    assert [c.name for c in chip_smoke.BWD_CASES[1:]] == \
        [c.name for c in chip_smoke.ATTN_CASES[1:]]


def test_attention_cases_cover_the_kernels_tiling():
    """Beyond the main shapes: causal S != Skv under the absolute mask,
    D = 64, causal GQA of group 4, an S that 64 divides and 128 does not;
    the backward runs the same cases after its own main shape."""
    cases = {c.name: c for c in chip_smoke.ATTN_CASES}
    assert list(cases) == [
        "forward_b4", "tpu_1b_b1", "gqa_noncausal", "ragged_causal",
        "fp16_causal", "cross_causal", "d64_causal", "gqa_causal",
        "s1088_causal", "bert_large_b32"]
    cross = cases["cross_causal"]
    assert cross.causal and (cross.S, cross.Skv) == (384, 1024)
    assert all(c.Skv == c.S for n, c in cases.items() if n != "cross_causal")
    d64 = cases["d64_causal"]
    assert (d64.D, d64.dtype, d64.causal) == (64, "bfloat16", True)
    gqa = cases["gqa_causal"]
    assert gqa.causal and gqa.H // gqa.Hkv == 4
    s1088 = cases["s1088_causal"]
    assert s1088.causal and s1088.S % 64 == 0 and s1088.S % 128 != 0
    assert [c.name for c in chip_smoke.BWD_CASES] == \
        ["train_b8"] + list(cases)[1:]


@pytest.mark.parametrize("S, Skv", [(384, 1024), (1024, 384), (1000, 1000),
                                    (1, 7)])
def test_live_pairs_count_the_absolute_causal_mask(S, Skv):
    """Row q sees min(q + 1, Skv) keys; the bounds count those pairs."""
    c = chip_smoke.AttnCase("pairs", 2, 4, 2, S, 64, True, Skv=Skv)
    pairs = sum(min(q + 1, Skv) for q in range(S))
    assert chip_smoke.live_pairs(c) == pairs
    assert chip_smoke.live_pairs(dataclasses.replace(c, causal=False)) == \
        S * Skv
    assert chip_smoke.attention_bound(c)[2] == 4 * 2 * 4 * pairs * 64
    bound = chip_smoke.attention_bwd_bound(c)
    assert bound["dq"]["flops"] == 6 * 2 * 4 * pairs * 64
    assert bound["dkv"]["flops"] == 8 * 2 * 4 * pairs * 64
    kv_bytes = 2 * 2 * 2 * Skv * 64
    assert bound["dkv"]["bytes"] - bound["dq"]["bytes"] == \
        2 * kv_bytes - 2 * 2 * 4 * S * 64


def test_cross_causal_bound_at_its_shape():
    c = next(c for c in chip_smoke.ATTN_CASES if c.name == "cross_causal")
    pairs = 384 * 385 // 2                          # every row sees q + 1
    assert chip_smoke.live_pairs(c) == pairs == 73_920
    _, _, flops, nbytes = chip_smoke.attention_bound(c)
    assert flops == 4 * 2 * 16 * pairs * 128
    assert nbytes == 2 * (2 * 2 * 16 * 384 * 128 + 2 * 2 * 16 * 1024 * 128) \
        + 4 * 2 * 16 * 384


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__9f827cb3_12_flash_bwd_cu_797fbb8020flash_bwd_dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__9f827cb3_12_flash_bwd_cu_797fbb8020flash_bwd_dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__9f827cb3_12_flash_bwd_cu_797fbb8019flash_bwd_dq_kernelI6__halfLi64EEEvPKT_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__9f827cb3_12_flash_bwd_cu_797fbb8019flash_bwd_dq_kernelI6__halfLi64EEEvPKT_S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
"""  # noqa: E501


def test_ptxas_report_names_each_kernel_with_its_spills():
    """The build phase's rows: which kernel, its registers, its spills."""
    rows = chip_smoke.ptxas_report({"flash_bwd": _PTXAS_LOG})
    assert rows == [
        {"source": "flash_bwd",
         "kernel": "flash_bwd_dkv_kernel<__nv_bfloat16, 128>",
         "spill_stores": 4, "spill_loads": 4, "registers": 255},
        {"source": "flash_bwd", "kernel": "flash_bwd_dq_kernel<__half, 64>",
         "spill_stores": 0, "spill_loads": 0, "registers": 80}]
    assert "flash_bwd_dkv_kernel<__nv_bfloat16, 128>" in chip_smoke.NO_SPILL


@pytest.mark.parametrize("fault", [None, "o", "lse"])
def test_check_fwd_holds_o_and_lse(fault):
    """The forward check `kernel` and `kernel_bwd` run at every shape: it
    passes the plain version's own output and fails one bf16 step off."""
    c = chip_smoke.AttnCase("small", 2, 4, 2, 96, 64, True, layout="bshd")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(c.B, c.S, h, c.D, generator=gen)
               .to(torch.bfloat16).transpose(1, 2) for h in (c.H, c.Hkv,
                                                             c.Hkv))
    o, lse = FA.flash_attention_reference(q, k, v, causal=True,
                                          sm_scale=c.D ** -0.5)
    if fault is None:
        errors = chip_smoke.check_fwd(c, q, k, v, o, lse, c.D ** -0.5)
        assert errors == {"o_max_abs_err": 0.0, "lse_max_abs_err": 0.0}
        return
    if fault == "o":
        o = o.clone()
        o[1, 3, 95, 7] += 0.25
    else:
        lse = lse.clone()
        lse[1, 3, 95, 0] += 2 * chip_smoke.LSE_ATOL
    with pytest.raises(SystemExit, match=f"{fault} differs"):
        chip_smoke.check_fwd(c, q, k, v, o, lse, c.D ** -0.5)


def _small(cases, **sizes):
    """The smoke's case list at CPU size: every case, its kind of input
    kept, its batch and widths cut."""
    return [dataclasses.replace(c, **{k: min(getattr(c, k), v)
                                      for k, v in sizes.items()})
            for c in cases]


def test_kernel_det_rehearsal_runs_every_case_on_the_plain_path():
    before = (D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_kernel_det(
        "cpu", _small(chip_smoke.NMS_CASES, B=2, N=300),
        _small(chip_smoke.ROI_CASES, B=2, R=16, C=64),
        _small(chip_smoke.ROI_GRAD_CASES, B=2, R=16, C=64))
    assert (D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    assert list(out["nms"]) == [c.name for c in chip_smoke.NMS_CASES]
    assert list(out["roi_align"]) == [c.name for c in chip_smoke.ROI_CASES]
    assert list(out["roi_align_grad"]) == [
        c.name for c in chip_smoke.ROI_GRAD_CASES]
    assert all(r["max_abs_err"] <= chip_smoke.ROI_ATOL
               and r["forward_max_abs_err"] <= chip_smoke.ROI_ATOL
               and r["route"] is None and r["bound_by"] == "bytes"
               for r in out["roi_align_grad"].values())
    assert all(r["equal"] and r["max_abs_err"] == 0
               for r in out["nms"].values())
    assert out["nms"]["fewer_than_k"]["kept"] < 2 * 100
    # cut to CPU size, no case has the inputs of its JAX golden
    assert not any(r["jax_golden_equal"] for r in out["nms"].values())
    assert all(r["bound_by"] == "bytes" for r in out["roi_align"].values())
    # no kernel ran on the CPU, so no route was taken
    assert all(r["route"] is None for r in out["roi_align"].values())


def test_kernel_det_cases_cover_the_detect_shapes():
    from cloudtik_tpu_torch.models import ssd

    cases = {c.name: c for c in chip_smoke.NMS_CASES}
    mr, ssd300 = chip_smoke.NMS_CASES[:2]
    assert (mr.B, mr.N, mr.K) == (8, 128, 50)
    assert (ssd300.B, ssd300.N, ssd300.K) == (8, 3000, 100)
    big = cases["ssd1200_b8"]
    assert (big.B, big.N, big.K) == (8, 45_384, 100)
    assert big.N == chip_smoke.SSD1200_ANCHORS == ssd.config(
        "ssd_resnet34", image_size=1200).num_anchors()
    assert cases["all_zero_ssd1200"].N == big.N
    assert cases["all_zero_ssd1200"].scores == "zero"
    assert chip_smoke.NMS_DETECT_SHAPES == ("ssd_b8", "maskrcnn_b8",
                                            "ssd1200_b8")
    assert {c.special for c in chip_smoke.NMS_CASES} == {
        "", "nan_score", "nan_box", "signed_zero", "inf_and_absent"}
    assert len({c.seed for c in chip_smoke.NMS_CASES}) == len(cases)
    r7, r14 = chip_smoke.ROI_CASES[:2]
    assert [(c.B * c.R, c.C, c.H, c.P, c.sampling, c.dtype, c.layout)
            for c in (r7, r14)] == [(1024, 1024, 32, 7, 1, "bfloat16",
                                     "nhwc"),
                                    (1024, 1024, 32, 14, 1, "bfloat16",
                                     "nhwc")]


def test_roi_cases_take_their_routes():
    """Each ROIAlign case's map, made as the smoke makes it, picks the
    route the case requires on the card: the Mask R-CNN shapes the vector
    route, the f32 NCHW and the 100-channel maps the strided one."""
    gen = torch.Generator().manual_seed(2)
    routes = {}
    for c in chip_smoke.ROI_CASES:
        feats, _ = chip_smoke.make_roi_inputs(c, gen, "cpu")
        routes[c.name] = D.roi_align_route(feats, c.P, c.sampling)
        del feats
    assert routes == {c.name: c.route for c in chip_smoke.ROI_CASES}
    assert routes["maskrcnn_7"] == routes["maskrcnn_14"] == "vector"
    assert routes["sampling2_scale025"] == "strided"
    assert routes["ragged_channels"] == "strided"
    # a vector-route map whose last 64-channel block holds only 8
    assert routes["channel_tail"] == "vector"
    assert [c.C % 64 for c in chip_smoke.ROI_CASES
            if c.name == "channel_tail"] == [8]


def test_ragged_channels_case_is_a_bf16_nhwc_map_of_100_channels():
    c = next(c for c in chip_smoke.ROI_CASES if c.name == "ragged_channels")
    assert c == chip_smoke.RoiCase("ragged_channels", 2, 64, 100, 32, 14, 1,
                                   route="strided")
    feats, rois = chip_smoke.make_roi_inputs(
        c, torch.Generator().manual_seed(0), "cpu")
    assert feats.shape == (2, 100, 32, 32) and feats.dtype == torch.bfloat16
    # channel stride 1, a 200-byte pixel stride: not 16-byte aligned
    assert feats.stride() == (32 * 32 * 100, 1, 32 * 100, 100)
    assert rois.shape == (2, 64, 4)


def test_roi_bound_at_the_maskrcnn_shapes():
    """Bytes written bound B5: 205.5 MB (7x7) and 822.1 MB (14x14) of f32
    against a 16.8 MB bf16 map."""
    for c, out_bytes, ms in ((chip_smoke.ROI_CASES[0], 205_520_896, 0.0664),
                             (chip_smoke.ROI_CASES[1], 822_083_584, 0.2504)):
        bound_ms, bound_by, _, nbytes = chip_smoke.roi_bound(c)
        assert nbytes == out_bytes + 2 * 8 * 1024 * 32 * 32 + 16 * 8 * 128
        assert bound_by == "bytes"
        assert bound_ms == pytest.approx(ms, abs=1e-4)


def test_paged_cases_are_the_chat_cells_shape_and_bound_by_bytes():
    """B6 at Mistral-7B in the chat cell: 32 lanes of 64 blocks of 16, 8
    KV heads of 128 under 32 query heads; lanes of 103-986 positions, and
    all 1,024; bound by the lanes' K/V at 3.35 TB/s."""
    spread, full = chip_smoke.PAGED_CASES
    for c in (spread, full):
        assert (c.B, c.H, c.Hkv, c.D, c.bs, c.M) == (32, 32, 8, 128, 16, 64)
        assert len(c.lengths) == c.B
    assert (min(spread.lengths) + 1, max(spread.lengths) + 1) == (103, 986)
    assert set(full.lengths) == {c.M * c.bs - 1}
    bound_ms, bound_by, flops, nbytes = chip_smoke.paged_bound(full)
    kv = 2 * 2 * 32 * 1023 * 8 * 128            # 134.1 MB of K and V
    assert nbytes == kv + 2 * (2 * 32 * 32 * 128 + 4 * 32 * 8 * 128) \
        + 8 * 32 * 64 + 9 * 32
    assert flops == 4 * 32 * 1024 * 32 * 128
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert chip_smoke.paged_bound(spread)[0] < bound_ms


def test_nms_scan_work_counts_what_the_sorted_scan_reaches():
    """Order [0, 2, 3, 1]: with K=2 the scan stops at its second kept box
    (1 IoU); with one more to keep it reaches every candidate, each later
    one held against each box kept before it; a NaN image takes nothing."""
    s = np.array([[0.9, 0.1, 0.5, 0.3]], np.float32)
    assert chip_smoke.nms_scan_work(s, np.array([[0, 2]])) == (2, 1)
    assert chip_smoke.nms_scan_work(s, np.array([[0, 2, -1]])) == (4, 5)
    absent = np.array([[0.9, -1e30, -np.inf, 0.3]], np.float32)
    assert chip_smoke.nms_scan_work(absent, np.array([[0, 3, -1]])) == (2, 1)
    nan = np.array([[0.9, np.nan, 0.5, 0.3]], np.float32)
    assert chip_smoke.nms_scan_work(nan, np.array([[-1, -1]])) == (0, 0)
    # -0.0 and +0.0 tie, so the lower index comes first
    zeros = np.array([[0.0, -0.0, 0.0]], np.float32)
    assert chip_smoke.nms_scan_work(zeros, np.array([[0, 1]])) == (2, 1)


def _golden_bound(name):
    c = next(c for c in chip_smoke.NMS_CASES if c.name == name)
    _, scores = chip_smoke.make_nms_arrays(c)
    keep = chip_smoke.golden_keep(c)
    return c, scores, keep, chip_smoke.nms_bound(c, scores, keep)


def test_nms_bound_counts_the_kept_steps():
    """SSD's shape: the scan reaches a few hundred of the 24,000 boxes, so
    the bytes bound B4; the earlier designs' K x N steps stay beside it."""
    c, scores, keep, (bound_ms, bound_by, flops, nbytes) = _golden_bound(
        "ssd_b8")
    assert c == chip_smoke.NMS_CASES[1]
    reached, pairs = chip_smoke.nms_scan_work(scores, keep)
    assert int((keep >= 0).sum()) == 800 and reached < 1000
    assert flops == 16 * pairs
    assert nbytes == 20 * 8 * 3000 + 4 * 8 * 100
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert chip_smoke.nms_steps_bound_ms(c, kept=800) == pytest.approx(
        16 * 800 * 3000 / 67e12 * 1e3)


def test_nms_bound_at_ssd1200():
    """45,384 boxes an image: 0.0022 ms of bytes; 800 kept over all boxes
    would be 0.0087 ms of f32 operations."""
    c, scores, keep, (bound_ms, bound_by, flops, nbytes) = _golden_bound(
        "ssd1200_b8")
    assert nbytes == 20 * 8 * 45_384 + 4 * 8 * 100
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(0.0022, abs=1e-4)
    assert flops < 16 * 800 * 45_384 / 100
    assert chip_smoke.nms_steps_bound_ms(c, kept=800) == pytest.approx(
        0.0087, abs=1e-4)


def test_nms_bound_of_many_kept_is_operations():
    """K=1,500 of 3,000: every candidate is held against most kept boxes."""
    _, _, _, (bound_ms, bound_by, flops, _) = _golden_bound("many_kept")
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(flops / 67e12 * 1e3)


def test_nms_path_has_no_box_cap_and_no_library_sort():
    """The wrapper refuses no box count, and neither it nor the detectors'
    NMS tail orders anything with a library call: the kernel sorts and
    selects by itself."""
    import inspect

    from cloudtik_tpu_torch.models import maskrcnn, ssd

    assert not hasattr(D, "NMS_MAX_BOXES")
    sources = [inspect.getsource(f) for f in (
        D.nms, D.nms_batched, D._kernel_nms, D.nms_reference_batched,
        ssd.select)] + [(ROOT / "cloudtik_tpu_torch" / "csrc" / "nms.cu")
                        .read_text()]
    for src in sources:
        for call in ("sort(", "topk(", "argsort(", "cub::", "thrust::"):
            assert call not in src
    assert "S.select(" in inspect.getsource(maskrcnn)   # the same tail


@pytest.mark.parametrize("kind", ["maskrcnn", "ssd"])
def test_detect_phase_rehearsal_takes_no_kernel_on_cpu(kind):
    out = chip_smoke.phase_detect(kind, "tiny", B=2, device="cpu",
                                  iters=2)
    assert out["launches"] == {"nms": 0, "roi_align": 0}
    assert out["nms_equal"] and out["measured_calls"] == 2
    assert out["peak_mem_gb"] is None and out["images_per_s"] > 0
    if kind == "maskrcnn":
        assert out["roi_align_max_abs_err"] == {"pooled_7": 0.0}


def test_detect_phase_rehearsal_takes_an_image_size():
    """The SSD-1200 call's form at CPU size: the override reaches the
    config, and the NMS sees every anchor of that size."""
    from cloudtik_tpu_torch.models import ssd

    out = chip_smoke.phase_detect("ssd", "tiny", B=2, device="cpu",
                                  iters=1, image_size=96)
    assert out["image_size"] == 96 and out["nms_equal"]
    assert out["nms_boxes_per_image"] == ssd.config(
        "tiny", image_size=96).num_anchors()
    assert out["nms_boxes_per_image"] > ssd.config("tiny").num_anchors()
    assert out["launches"] == {"nms": 0, "roi_align": 0}


def test_nms_phase_slots_are_the_kernels():
    """tools/profile_torch_nms_phases.py reads the slots that csrc/nms.cu
    fills under -DNMS_PHASE_CLOCKS: the same names, in the same order."""
    import re

    sys.path.insert(0, str(ROOT / "tools"))
    import profile_torch_nms_phases as P

    src = (ROOT / "cloudtik_tpu_torch" / "csrc" / "nms.cu").read_text()
    enum = re.search(r"enum PhaseSlot \{(.*?)\};", src, re.S).group(1)
    slots = re.findall(r"kPh(\w+)", enum)
    assert slots[-1] == "Slots"
    snake = [re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower() for n in slots[:-1]]
    assert snake == list(P.PHASES + P.COUNTS)
    assert f"kPhaseImages = {P.IMAGES};" in src
    # every slot is marked or counted somewhere in the kernel
    for n in slots[:-1]:
        assert re.search(rf"PHASE_(MARK|COUNT)\(kPh{n}\)", src), n


def test_engine_phase_rehearsal_takes_no_kernel_on_cpu():
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_engine("tiny", "cpu", chip_smoke.REHEARSAL_LOAD)
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    load = chip_smoke.REHEARSAL_LOAD
    wave = out["wave"]
    assert wave["clients"] == 16 and wave["oversize"] == 413
    assert wave["prefix_hits"] >= 7
    assert wave["prefix_tokens_saved"] >= 7 * load.prefix_len
    assert wave["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert wave["logits_diff_max"] <= chip_smoke.ENGINE_LOGITS_MAX_ABS
    assert [p["fault"] for p in out["planted"]] == ["tables", "lengths"]
    assert all(p["lanes_flagged_by_logits"] == 8 for p in out["planted"])
    assert wave["decode_step_ms_full"]["lanes"] == 8
    assert out["oversubscribed"]["preemptions"] >= 1
    assert out["pool_blocks"] == 8 * (load.max_len // load.block_size) + 1
    assert out["peak_mem_gb"] is None


def test_engine_load_is_the_engine_phase_traffic_at_tpu_1b():
    load = chip_smoke.ENGINE_LOAD
    assert (load.slots, load.max_len, load.block_size) == (8, 1024, 16)
    assert load.prompt_lens == (32, 128, 384, 700) and load.clients == 16
    # each 700-token prompt takes 3 chunks of at most 256
    assert -(-700 // 256) == 3
    # the oversubscribed prompts alone take every block of its pool
    assert load.slots * load.over_prompt // load.block_size \
        == 3 * load.max_len // load.block_size
    assert load.oversize_prompt > load.max_len


def test_tie_aware_check_fails_on_a_lane_swapped_result():
    """Two requests through one engine: each answer passes against its own
    prompt and fails against the other's, as a lane that read another
    slot's KV would."""
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)

    cfg = T.config("tiny", dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = DecodeEngine(params, cfg, EngineConfig(slots=2, max_len=64),
                       device="cpu")
    prompts = [[5, 17, 101, 9, 33], [200, 3, 3, 7]]
    reqs = [eng.submit(Request(p, max_new_tokens=12)) for p in prompts]
    eng.start()
    try:
        outs = [r.wait(timeout=60) for r in reqs]
    finally:
        eng.stop()
    for prompt, toks in zip(prompts, outs):
        assert chip_smoke.check_tie_aware(
            "own", chip_smoke.tie_gaps(params, cfg, prompt, toks,
                                       "cpu")) == 0.0
    for prompt, toks in zip(prompts, reversed(outs)):
        with pytest.raises(SystemExit, match="below the largest"):
            chip_smoke.check_tie_aware(
                "swapped", chip_smoke.tie_gaps(params, cfg, prompt, toks,
                                               "cpu"))


@pytest.mark.parametrize("fault", [None, "tables", "lengths"])
def test_logits_check_flags_a_planted_fault(fault):
    """Every decode step's logits against the teacher-forced ones: an
    engine's own answers sit at f32 rounding, and a decode step handed its
    block tables or lengths rolled one lane on is flagged in every lane."""
    from cloudtik_tpu_torch.models import transformer as T

    cfg = T.config("tiny", dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    load = chip_smoke.EngineLoad(slots=4, max_len=64, block_size=8,
                                 short_new=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 13, 21, 30)]
    out = chip_smoke.planted_fault(params, cfg, load, prompts, fault, "cpu")
    assert out["lanes"] == 4
    if fault is None:
        assert out["lanes_flagged_by_logits"] == 0
        assert out["lanes_flagged_by_tie_gap"] == 0
    else:
        assert out["lanes_flagged_by_logits"] == 4
        assert out["logits_diff_min_lane"] > chip_smoke.ENGINE_LOGITS_MAX_ABS


def test_spec_phase_rehearsal_takes_no_kernel_on_cpu():
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_spec("tiny", "cpu", chip_smoke.SPEC_REHEARSAL)
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    runs = out["runs"]
    assert set(runs) == {"plain", "other_draft", "self_draft"}
    for run in runs.values():
        assert run["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
        assert run["logits_diff_max"] <= chip_smoke.ENGINE_LOGITS_MAX_ABS
        assert run["generated_tokens"] == 7 * 12 + 3   # one EOS request
    self_run = runs["self_draft"]
    assert self_run["acceptance"] == 1.0          # `tiny` drafts itself
    assert self_run["eos_stop_in_first_round"]
    assert 1.0 < self_run["tokens_per_verify"] <= 5.0
    assert set(self_run["round_split"]) == {
        "context", "k", "catch_up_forward_ms", "draft_propose_ms",
        "verify_ms"}
    assert "acceptance" not in runs["plain"]
    planted = out["planted"]
    assert planted["lanes_flagged_by_logits"] == planted["lanes"] == 8
    assert out["peak_mem_gb"] is None


def test_lora_phase_rehearsal_takes_no_kernel_on_cpu():
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_lora("tiny", "cpu", chip_smoke.LORA_REHEARSAL)
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    assert min(out["adapter_effect"].values()) \
        >= chip_smoke.LORA_MIN_ADAPTER_EFFECT
    mixed = out["mixed"]
    assert mixed["requests"] == 12 and mixed["gathered_steps"] >= 1
    assert mixed["evictions"] >= 1 and mixed["slot_waits"] >= 1
    assert out["homogeneous"]["merged_steps"] >= 1
    assert out["isolation"]["prefix_tokens"][:2] == [0, 0]
    assert out["isolation"]["prefix_tokens"][2] > 0
    assert out["adapter_draft"]["spec_steps"][0] > 0
    assert out["adapter_draft"]["spec_steps"][1] == 0
    planted = out["planted"]
    assert planted["lanes_changed"] == 8
    assert planted["lanes_flagged_by_logits"] == 8
    for run in ("mixed", "homogeneous", "adapter_draft"):
        assert out[run]["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
        assert out[run]["logits_diff_max"] \
            <= chip_smoke.ENGINE_LOGITS_MAX_ABS


def test_disagg_phase_rehearsal_takes_no_kernel_on_cpu():
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_disagg("tiny", "cpu", chip_smoke.REHEARSAL_LOAD)
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    load = chip_smoke.REHEARSAL_LOAD
    wave = out["wave"]
    assert wave["clients"] == 16
    assert wave["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert wave["logits_diff_max"] <= chip_smoke.ENGINE_LOGITS_MAX_ABS
    assert min(wave["prefix_hits"].values()) >= 1
    # the longest prompt migrated bit for bit: 175 tokens in blocks of 8
    assert wave["bit_equal_blocks"] == -(-175 // load.block_size)
    mig = out["migration"]
    assert mig["migrations"] == mig["imports"] == 16
    assert mig["largest"]["tokens"] == 175
    assert out["torn"]["fired"] == out["torn"]["failures_counted"] == 2
    planted = out["planted"]
    assert planted["lanes_changed"] == planted["lanes"] == 8
    assert planted["lanes_flagged_by_logits"] == 8
    assert out["monolith"]["generated_tokens"] == wave["generated_tokens"]
    assert out["pool_blocks"] == {"prefill": 2 * 32 + 1,
                                  "decode": 8 * 32 + 1}
    assert out["peak_mem_gb"] is None


def test_fabric_phase_rehearsal_takes_no_kernel_on_cpu():
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_fabric("tiny", "cpu", chip_smoke.FABRIC_REHEARSAL)
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    wave = out["wave"]
    assert (wave["requests"], wave["heavy"], wave["handoffs"]) == (8, 4, 4)
    assert wave["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert len(out["torn"]["fell_back_on"]) == 1
    killed = out["prefill_killed"]
    assert killed["requests"] == 4
    assert killed["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert out["peak_mem_gb"] is None


def test_fabric_load_is_the_phase_traffic_at_tpu_1b():
    load = chip_smoke.FABRIC_LOAD
    assert (load.max_len, load.block_size, load.prefill_slots,
            load.decode_slots) == (1024, 16, 2, 4)
    assert min(load.heavy_lens) >= load.threshold > max(load.short_lens)
    assert max(load.heavy_lens) == max(chip_smoke.ENGINE_LOAD.prompt_lens)
    rehearsal = chip_smoke.FABRIC_REHEARSAL
    assert min(rehearsal.heavy_lens) >= rehearsal.threshold \
        > max(rehearsal.short_lens)


def test_spec_and_lora_loads_are_the_phases_traffic_at_tpu_1b():
    spec = chip_smoke.SPEC_LOAD
    assert (spec.slots, spec.max_len, spec.block_size, spec.k) \
        == (8, 1024, 16, 4)
    assert (spec.clients, spec.new_tokens) == (8, 32)
    assert min(spec.prompt_lens) == 32 and max(spec.prompt_lens) == 384
    assert spec.drafts == ("tpu_120m", "tpu_1b")
    lora = chip_smoke.LORA_LOAD
    assert (lora.slots, lora.max_len, lora.block_size) == (8, 1024, 16)
    assert (lora.rank, lora.alpha, lora.adapters, lora.capacity) \
        == (16, 32.0, 4, 3)
    assert lora.b_scale == 0.05 and lora.draft == "tpu_120m"
    mixed = chip_smoke.MIXED
    assert len(mixed) == 12 and mixed.count(None) == 3
    assert len(set(mixed) - {None}) == lora.adapters
    # the first 8 fill the slots on `capacity` adapters, so a3 must wait
    assert len(set(mixed[:lora.slots]) - {None}) == lora.capacity


@pytest.mark.parametrize("fault", [None, "shift"])
def test_verify_logits_rows_and_the_planted_shift(fault):
    """The verify recorder's rows are the target's logits at each accepted
    or emitted position: an f32 self-draft engine's rows sit at rounding
    against the teacher-forced forward, and a verify run one position on
    moves the rows of a short prompt far past the limit."""
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, SpecConfig)

    cfg = T.config("tiny", dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = DecodeEngine(params, cfg, EngineConfig(
        slots=2, max_len=64, block_size=8, prefill_buckets=(8, 16),
        spec=SpecConfig(k=3)), draft=(params, cfg), device="cpu")
    reqs = [eng.submit(Request(p, max_new_tokens=10))
            for p in ([5, 17, 101, 9], [42, 7, 19])]
    with chip_smoke.StepLogits(eng) as step, \
            chip_smoke.VerifyLogits(eng, fault) as verify:
        eng.start()
        try:
            for r in reqs:
                r.wait(timeout=60)
        finally:
            eng.stop()
    assert "_spec_step" not in vars(eng)           # the wrapper is gone
    rows = chip_smoke._Rows(step, verify)
    for r in reqs:
        assert verify.rounds(r) >= 2
        got = rows.of(r)
        # the first token comes from the prefill, every other from a row
        assert sorted(got) == list(range(1, len(r.tokens)))
        diff = chip_smoke.logits_diff(chip_smoke.teacher_logits(
            params, cfg, r.prompt, r.tokens, "cpu"), got)
        if fault is None:
            assert diff < 1e-4
        else:
            assert diff > chip_smoke.ENGINE_LOGITS_MAX_ABS


def test_step_logits_flags_rolled_adapter_indices():
    """A gathered LoRA step whose adapter indices are rolled one lane on
    is flagged in every lane whose adapter changed, and only there."""
    from cloudtik_tpu_torch.models import lora as LO
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.adapters import AdapterPool
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request)

    cfg = T.config("tiny", dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    lc = LO.LoRAConfig(rank=4)
    bank = {a: LO.random_lora_params(torch.Generator().manual_seed(i), cfg,
                                     lc, scale=0.2, device="cpu")
            for i, a in enumerate(("x", "y"))}
    eng = DecodeEngine(params, cfg, EngineConfig(
        slots=3, max_len=64, block_size=8, prefill_buckets=(8,)),
        adapters=AdapterPool(params, cfg, lc, bank.__getitem__, 2),
        device="cpu")
    # lanes [x, x, y]: rolled, lane 1 keeps x while lane 0 lives (it
    # asks for the most tokens); lanes 0 and 2 change
    reqs = [eng.submit(Request(p, max_new_tokens=n, adapter_id=a))
            for p, n, a in (([5, 17, 101], 10, "x"), ([42, 7], 6, "x"),
                            ([9, 9, 8], 6, "y"))]
    with chip_smoke.StepLogits(eng, "adapters") as rec:
        eng.start()
        try:
            for r in reqs:
                r.wait(timeout=60)
        finally:
            eng.stop()
    assert [rec.changed(r.request_id) for r in reqs] == [True, False, True]
    for r in reqs:
        merged = dict(params, layers=LO.merge_lora(
            params["layers"], bank[r.adapter_id], lc))
        diff = chip_smoke.logits_diff(chip_smoke.teacher_logits(
            merged, cfg, r.prompt, r.tokens, "cpu"),
            rec.rows(r.request_id))
        assert (diff > chip_smoke.ENGINE_LOGITS_MAX_ABS) \
            == rec.changed(r.request_id)


def test_checkpoint_phase_rehearsal_takes_no_kernel_on_cpu():
    """The checkpoint phase end to end at `tiny`: saves in one fit, a torn
    step 4, a resume at step 2 with every leaf equal to the uninterrupted
    run's state there and its losses (bitwise on the CPU), both backends
    on the restored weights, and its directory removed."""
    before = (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN)
    out = chip_smoke.phase_checkpoint(chip_smoke.CHECKPOINT_REHEARSAL,
                                      "cpu")
    assert (FA.LAUNCHES, D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["det_launches"] == {"nms": 0, "roi_align": 0}
    assert out["determinism"]["bitwise"] is True
    assert out["determinism"]["max_abs_leaf_gap"] == 0.0
    assert out["disk"]["max_to_keep"] == 3
    for depth in ("depth_0", "depth_2"):
        assert len(out["prefetch"][depth]["data_wait_ms_by_step"]) == 2
    resume = out["resume"]
    assert resume["restored_step"] == 2
    assert resume["max_abs_leaf_gap"] == 0.0
    assert resume["resumed_losses"] == resume["uninterrupted_losses"][2:]
    assert resume["saving_run_last_loss"] \
        == resume["uninterrupted_losses"][-1]
    assert out["save"]["step_dir_bytes"] \
        > out["save"]["torn_step_dir_bytes"]
    assert out["save"]["offloaded"]["write_s"] > 0
    assert out["save"]["offloaded"]["stall_ms"] is None   # card time only
    assert out["save"]["torn_inline"]["d2h_s"] > 0
    assert out["save"]["offloaded"]["pin_before_loop_s"] is None
    assert all(t > 0 for t in out["restore"].values())
    assert out["serve"]["plain_equals_direct_generate"]
    assert out["serve"]["engine_tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert out["memory"]["peak_with_snapshot_gb"] is None
    assert [r["step"] for r in out["memory"]["at_save"]] == [2, 4]
    assert not Path(out["directory"]).exists()


def test_checkpoint_load_is_the_train_phase_configuration():
    load = chip_smoke.CHECKPOINT_LOAD
    assert (load.model, load.batch, load.seq) == ("tpu_1b", 8, 2048)
    assert (load.every, load.steps, load.torn_step) == (2, 4, 4)


def test_leaf_gap_is_zero_only_for_equal_leaves():
    a = {"w": torch.tensor([1.0, -0.0]), "count": 3}
    assert chip_smoke._leaf_gap(a, {"w": torch.tensor([1.0, -0.0]),
                                    "count": 3}) == 0.0
    assert chip_smoke._leaf_gap(a, {"w": torch.tensor([1.5, -0.0]),
                                    "count": 3}) == 0.5
    for other in ({"w": torch.tensor([1.0, -0.0]), "count": 4},
                  {"w": torch.tensor([float("nan"), -0.0]), "count": 3}):
        assert chip_smoke._leaf_gap(a, other) == math.inf


def test_checkpoint_phase_fails_loudly_without_room(monkeypatch):
    import shutil as sh

    monkeypatch.setattr(sh, "disk_usage",
                        lambda path: sh._ntuple_diskusage(1, 1, 0))
    with pytest.raises(SystemExit, match="bytes free"):
        chip_smoke.phase_checkpoint(chip_smoke.CHECKPOINT_REHEARSAL, "cpu")


def test_bert_case_is_the_bert_phase_shape_and_its_bound():
    """BERT-Large at B=32, S=512: 16 heads of 64, non-causal, transposed
    [B, S, H, D] views, in the forward and the backward cases."""
    from cloudtik_tpu_torch.models import bert as BE

    c = next(c for c in chip_smoke.ATTN_CASES if c.name == "bert_large_b32")
    cfg = BE.config("bert_large")
    assert (c.B, c.H, c.Hkv, c.S, c.D, c.causal, c.layout, c.dtype) == (
        32, cfg.n_heads, cfg.n_heads, cfg.max_seq_len, cfg.head_dim, False,
        "bshd", "bfloat16")
    assert c in chip_smoke.BWD_CASES
    bound_ms, bound_by, flops, nbytes = chip_smoke.attention_bound(c)
    assert flops == 4 * 32 * 16 * 512 * 512 * 64       # 34.4 GFLOP
    assert nbytes == 2 * 4 * 32 * 16 * 512 * 64 + 4 * 32 * 16 * 512
    # 134 MB of q, k, v, o at 3.35 TB/s outlast 34.4 GFLOP at 989 TFLOP/s
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert bound_ms == pytest.approx(0.04038, abs=1e-5)
    bwd = chip_smoke.attention_bwd_bound(c)
    assert bwd["dq"]["bound_by"] == bwd["dkv"]["bound_by"] == "operations"
    assert bwd["dq"]["flops"] == 6 * 32 * 16 * 512 * 512 * 64
    assert bwd["dkv"]["flops"] == 8 * 32 * 16 * 512 * 512 * 64
    assert bwd["dq"]["bound_ms"] == pytest.approx(0.05211, abs=1e-5)
    assert bwd["dkv"]["bound_ms"] == pytest.approx(0.06948, abs=1e-5)


def test_lora_train_load_is_the_recipe_defaults():
    from cloudtik_tpu_torch.recipes import llama_lora_finetune as R

    assert chip_smoke.LORA_TRAIN_LOAD.argv == ()
    args = R.parser().parse_args(list(chip_smoke.LORA_TRAIN_LOAD.argv))
    assert (args.model, args.rank, args.batch, args.seq_len) == (
        "tpu_1b", 16, 8, 2048)
    assert chip_smoke.LORA_TRAIN_MIN_EFFECT == \
        2 * chip_smoke.ENGINE_LOGITS_MAX_ABS


def test_lora_train_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_lora_train(chip_smoke.LORA_TRAIN_REHEARSAL,
                                      "cpu")
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["base_unchanged"] and out["adapters_changed"]
    assert out["losses"][-1] < out["losses"][0]
    assert out["adapter_effect"] >= chip_smoke.LORA_TRAIN_MIN_EFFECT
    serve = out["serve"]
    assert serve["requests"] == 8 and serve["on_adapter"] == 4
    assert serve["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert serve["logits_diff_max"] <= chip_smoke.ENGINE_LOGITS_MAX_ABS
    from cloudtik_tpu_torch.models import transformer as T
    assert out["flops_per_token"] == pytest.approx(
        T.config("tiny", max_seq_len=64).flops_per_token() * 4 / 6)
    assert out["mfu"] is None and out["peak_mem_gb"] is None


def test_bert_load_is_bert_large_at_the_train_phase_tokens():
    from cloudtik_tpu_torch.recipes import bert_large_pretrain as R

    args = R.parser().parse_args(list(chip_smoke.BERT_LOAD.argv))
    assert (args.model, args.seq_len, args.batch) == ("bert_large", 512, 32)
    assert args.batch * args.seq_len == 8 * 2048


def test_bert_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_bert(chip_smoke.BERT_REHEARSAL, "cpu")
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["n_layers"] == 2 and out["masked_per_seq"] == 10
    assert out["losses"][-1] < out["losses"][0]
    assert 0.0 <= out["mlm_accuracy"] <= 1.0


def test_bert_grads_rehearsal():
    out = chip_smoke.phase_bert_grads("tiny", 2, 2, 64, "cpu",
                                      loss_steps=6)
    rel = out["grad_rel_l2_flash_vs_reference"]
    # every leaf but mlm_bias (never read) and bk (a zero gradient)
    assert len(rel) == 24 and "layers.wq" in rel and "mlm_dense" in rel
    assert set(out["zero_grad_leaves_over_largest_norm"]) == {"layers.bk"}
    assert max(rel.values()) <= chip_smoke.GRADS_REL_L2
    losses = out["repeated_batch_losses"]
    assert len(losses) == 6 and losses[-1] < losses[0] - 0.1


def test_optim_phase_rehearsal_runs_every_case():
    out = chip_smoke.phase_optim("tiny", 2, 5, "cpu")
    assert list(out["cases"]) == ["sgd/float32", "adafactor/float32",
                                  "lion/float32", "adamw/bfloat16"]
    for case in out["cases"].values():
        assert case["count"] == 5 and case["max_rel_l2"] == 0.0
        assert set(case["rel_l2"]) == {
            "layers.wq", "layers.wk", "layers.wv", "layers.wo",
            "layers.ln_attn", "layers.ln_mlp", "layers.w_gate",
            "layers.w_up", "layers.w_down", "final_norm"}


def test_optim_check_flags_a_wrong_update(monkeypatch):
    """The comparison's power: a card-side optimizer whose learning rate
    is 1% off moves every leaf's update by 1e-2 of itself, 10x the
    limit."""
    from cloudtik_tpu_torch.train import optim as TO

    real = TO.make_optimizer
    calls = []

    def skewed(cfg):
        calls.append(cfg.name)
        if len(calls) % 2 == 1:     # the first run of a case: the "card"
            import dataclasses as dc
            cfg = dc.replace(cfg, learning_rate=cfg.learning_rate * 1.01)
        return real(cfg)

    monkeypatch.setattr(TO, "make_optimizer", skewed)
    with pytest.raises(SystemExit, match="optim sgd"):
        chip_smoke.phase_optim("tiny", 2, 5, "cpu")


def test_roi_grad_cases_are_the_maskrcnn_train_shapes():
    """The backward is held at the shapes one Mask R-CNN train step gives
    ROIAlign: B=4 x 128 proposals, 1,024 channels of a bf16 32x32 NHWC map,
    7x7 and 14x14, on the vector route."""
    from cloudtik_tpu_torch.models import maskrcnn

    cfg = maskrcnn.config("maskrcnn_resnet50")
    args = chip_smoke.MASKRCNN_TRAIN_LOAD.argv
    B = int(args[args.index("--batch") + 1])
    assert [(c.B, c.R, c.C, c.H, c.P, c.sampling, c.dtype, c.layout,
             c.route) for c in chip_smoke.ROI_GRAD_CASES] == [
        (B, cfg.num_proposals, cfg.feature_width(), cfg.feature_size(), P,
         1, "bfloat16", "nhwc", "vector")
        for P in (cfg.roi_pool, cfg.mask_pool)]


def test_vision_loads_are_the_recipes_per_card_batches():
    """--batch 1024 --data 8, --batch 256 --data 8 and --batch 32 --data 8
    (the JAX recipes' launch lines) are 128, 32 and 4 images a card, at
    the recipes' default models and image sizes."""
    import importlib

    for load, model, size, batch in (
            (chip_smoke.RESNET_TRAIN_LOAD, "resnet50", 224, 1024 // 8),
            (chip_smoke.SSD_TRAIN_LOAD, "ssd_resnet34", 300, 256 // 8),
            (chip_smoke.MASKRCNN_TRAIN_LOAD, "maskrcnn_resnet50", 512,
             32 // 8)):
        recipe = importlib.import_module(
            f"cloudtik_tpu_torch.recipes.{load.recipe}")
        args = recipe.parser().parse_args(list(load.argv))
        assert (args.model, args.image_size, args.batch) == (model, size,
                                                             batch)
        assert (load.warmup, load.steps) == (2, 5)


NO_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
               "nms": 0, "roi_align": 0}


@pytest.mark.parametrize("phase", ["resnet", "ssd"])
def test_vision_train_phase_rehearsal_takes_no_kernel_on_cpu(phase):
    fn, load = {"resnet": (chip_smoke.phase_resnet_train,
                           chip_smoke.RESNET_TRAIN_REHEARSAL),
                "ssd": (chip_smoke.phase_ssd_train,
                        chip_smoke.SSD_TRAIN_REHEARSAL)}[phase]
    out = fn(load, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["losses"][-1] < out["losses"][0]
    assert out["images_per_s"] > 0 and out["mfu"] is None
    assert out["peak_mem_gb"] is None and out["data_wait_ms_per_step"] >= 0
    assert out["optimizer"]["warmup_steps"] == 0
    if phase == "ssd":
        assert min(out["num_pos_per_image"]) >= 1


def test_maskrcnn_train_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_maskrcnn_train(
        chip_smoke.MASKRCNN_TRAIN_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["grad_step_launches"] == {"nms": 0, "roi_align": 0}
    assert out["mask_size"] == 14 and "mask_loss" in out["metrics"]
    assert max(out["grad_rel_l2_kernel_vs_plain"].values()) <= \
        chip_smoke.MASKRCNN_F32_GRAD_REL_L2
    assert out["bf16_grad_rel_l2_kernel_vs_plain_median"] <= \
        chip_smoke.MASKRCNN_BF16_GRAD_REL_L2_MEDIAN
    assert max(out["bf16_grad_rel_l2_kernel_vs_plain_max"].values()) <= \
        chip_smoke.MASKRCNN_BF16_GRAD_REL_L2_MAX
    # the noise floor: a plain step against one whose pooled maps moved
    assert out["bf16_witness_grad_rel_l2_max"] > 0
    assert out["bf16_pooled_kernel_vs_plain_max_abs"] == 0   # one form
    assert out["backbone_grad_from_heads_share"] >= \
        chip_smoke.BACKBONE_FROM_HEADS_MIN


def test_maskrcnn_train_flags_a_roi_align_gradient_off_by_one_percent(
        monkeypatch):
    """The f32 whole-step limit's power: a ROIAlign gradient 1% too large
    moves the backbone's leaves past it."""
    real = D.roi_align_grad
    monkeypatch.setattr(D, "roi_align_grad",
                        lambda *args: real(*args) * 1.01)
    with pytest.raises(SystemExit, match="maskrcnn_train: .*f32 gradient"):
        chip_smoke.phase_maskrcnn_train(chip_smoke.MASKRCNN_TRAIN_REHEARSAL,
                                        "cpu")


def test_kernel_det_flags_a_roi_align_forward_off_at_the_train_shapes(
        monkeypatch):
    """The forward is held at the training cases too, not only timed."""
    real = D.roi_align_batched
    monkeypatch.setattr(D, "roi_align_batched",
                        lambda *args, **kw: real(*args, **kw) * (1 + 1e-3))
    with pytest.raises(SystemExit, match="roi_align_grad .*forward differs"):
        chip_smoke.phase_kernel_det(
            "cpu", (), (), _small(chip_smoke.ROI_GRAD_CASES, B=2, R=16,
                                  C=64))


def test_maskrcnn_train_flags_a_roi_align_without_a_gradient(monkeypatch):
    """The check's power: a ROIAlign whose backward gives the map nothing
    (as the kernel path gave before it had a gradient) fails the phase."""
    monkeypatch.setattr(D, "roi_align_grad",
                        lambda grad, rois, size, *a: torch.zeros(
                            size, device=grad.device))
    with pytest.raises(SystemExit, match="maskrcnn_train"):
        chip_smoke.phase_maskrcnn_train(chip_smoke.MASKRCNN_TRAIN_REHEARSAL,
                                        "cpu")


def test_loaders_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_loaders(chip_smoke.LOADERS_REHEARSAL, "cpu")
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["all_equal"] and out["batches_taken"] == out["steps"] == 3
    assert out["batches_after_marker"] == 0 and out["file_batches"] == 3
    assert out["trace_bytes"] > 0


def test_loaders_load_is_tpu_1b_cut_to_two_layers():
    from cloudtik_tpu_torch.models import transformer as T

    load = chip_smoke.LOADERS_LOAD
    cfg = T.config(load.model, n_layers=load.n_layers)
    full = T.config(load.model)
    assert (load.model, load.n_layers, load.batch, load.seq) == (
        "tpu_1b", 2, 8, 2048)
    assert cfg.d_model == full.d_model and cfg.n_layers < full.n_layers


# ------------------------------------------------------------ model zoo --

def test_zoo_loads_are_the_recipes_per_card_batches():
    """sdxl_mini at the recipe's batch default of 8; criteo_terabyte at
    8,192; RNN-T at the JAX launch line's --batch 64 --data 8 (8 a card)
    with 256 frames and 64 labels; GraphSAGE on 4,096-node blocks; each
    2 warm-up and 5 measured steps (link prediction 1 and 1)."""
    import importlib

    for load, model, batch in (
            (chip_smoke.DIFFUSION_TRAIN_LOAD, "sdxl_mini", 8),
            (chip_smoke.DLRM_TRAIN_LOAD, "criteo_terabyte", 8192),
            (chip_smoke.RNNT_TRAIN_LOAD, "rnnt", 64 // 8),
            (chip_smoke.GRAPHSAGE_TRAIN_LOAD, "graphsage", 4096)):
        recipe = importlib.import_module(
            f"cloudtik_tpu_torch.recipes.{load.recipe}")
        args = recipe.parser().parse_args(list(load.argv))
        assert args.model == model
        assert (args.nodes if model == "graphsage" else args.batch) == batch
        assert (load.warmup, load.steps) == (2, 5)
        if model == "rnnt":
            assert (args.max_frames, args.max_labels) == (256, 64)
    link = chip_smoke.GRAPHSAGE_LINK_LOAD
    assert "link_pred" in link.argv and link.warmup + link.steps == 2


def test_zoo_checks_cut_depth_or_size_never_width():
    from cloudtik_tpu_torch.models import diffusion, dlrm, rnnt

    c = chip_smoke.DIFFUSION_CHECK
    cut = diffusion.config(c.model, **dict(c.overrides))
    full = diffusion.config(c.model)
    assert (cut.base_width, cut.width_mults, cut.n_heads) == (
        full.base_width, full.width_mults, full.n_heads)
    assert (cut.blocks_per_stage, cut.image_size, c.batch) == (1, 16, 2)
    c = chip_smoke.DLRM_CHECK
    cut = dlrm.config(c.model, **dict(c.overrides))
    assert cut.num_tables == 2 and cut.embed_dim == 128 \
        and cut.rows_per_table == 100_000
    c = chip_smoke.RNNT_CHECK
    cut = rnnt.config(c.model, **dict(c.overrides))
    assert (cut.enc_hidden, cut.pred_hidden, cut.joint_dim) == (1024, 512,
                                                                512)
    assert (cut.enc_layers_pre, cut.enc_layers_post, c.batch, c.frames) == (
        1, 1, 2, 64)
    load = chip_smoke.GBDT_LOAD
    assert (load.rows, load.features, load.n_trees, load.check_rows) == (
        1_000_000, 28, 100, 20_000)


def test_diffusion_phases_rehearsal_take_no_kernel_on_cpu():
    out = chip_smoke.phase_diffusion_train(
        chip_smoke.DIFFUSION_TRAIN_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["losses"][-1] < out["losses"][0]
    assert out["images_per_s"] > 0 and out["mfu"] is None
    assert out["attention_head_dims"] == [16]
    grads = chip_smoke.phase_diffusion_grads(
        chip_smoke.DIFFUSION_CHECK_REHEARSAL, "cpu")
    assert grads["grad_leaves"] == 49 and grads["zero_grad_leaves"] == 0
    assert grads["launches"] == NO_LAUNCHES


def test_sdxl_mini_attention_takes_no_flash_kernel():
    """Head dims 80 and 160: the auto rule keeps the plain path on the card
    in bf16, as the reference's `_use_flash` does on a TPU."""
    from cloudtik_tpu_torch.models import diffusion
    from cloudtik_tpu_torch.ops.attention import use_flash_kernel

    cfg = diffusion.config("sdxl_mini")
    for stage, size in ((1, 32), (2, 16)):
        D = cfg.stage_width(stage) // cfg.n_heads
        shape = (8, cfg.n_heads, size * size, D)
        assert D in (80, 160)
        assert not use_flash_kernel("cuda", torch.bfloat16, shape, shape,
                                    False)


def test_dlrm_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_dlrm_train(chip_smoke.DLRM_TRAIN_REHEARSAL,
                                      chip_smoke.DLRM_CHECK_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["examples_per_s"] > 0
    assert out["grads"]["grad_leaves"] == 11
    assert out["grads"]["loss_card"] == out["grads"]["loss_cpu"]


def test_rnnt_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_rnnt_train(chip_smoke.RNNT_TRAIN_REHEARSAL,
                                      chip_smoke.RNNT_CHECK_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["frames_per_s"] > 0 and out["max_frames"] == 16
    check = out["check"]
    assert check["transducer_rel_err_vs_oracle"] <= chip_smoke.TRANSDUCER_REL
    assert check["greedy_tokens_equal"] and check["launches"] == NO_LAUNCHES


def test_graphsage_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_graphsage_train(
        chip_smoke.GRAPHSAGE_TRAIN_REHEARSAL,
        chip_smoke.GRAPHSAGE_LINK_REHEARSAL,
        chip_smoke.GRAPHSAGE_CHECK_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["link_pred"]["launches"] == NO_LAUNCHES
    assert out["link_pred"]["losses"][-1] < out["link_pred"]["losses"][0]
    assert "auc_proxy" in out["link_pred"]["metrics"]
    assert out["nodes_per_s"] > 0 and out["grads"]["grad_leaves"] == 6


def test_gbdt_phase_rehearsal_serves_through_tik_serve():
    out = chip_smoke.phase_gbdt(chip_smoke.GBDT_REHEARSAL, "cpu")
    assert out["launches"] == NO_LAUNCHES
    assert out["served_rows"] == 50 and out["served_equals_predict_proba"]
    assert "without bin edges" in out["refused_without_edges"]
    losses = list(out["log_loss_at_trees"].values())
    assert losses == sorted(losses, reverse=True)
    for check in out["checks"].values():
        assert check["split_differences"] == check["n_flips"] == 0
        assert check["score_drift_max"] == check["proba_max_abs_err"] == 0
        assert check["rounds"] == 10 and check["rows_left_out"] == 0


def _first_call_only(monkeypatch, module, name, planted):
    """Patch `module.name` so its first call (the card's, in a
    cross-device check) runs `planted(real, *args)` and later calls (the
    CPU's) the real function."""
    real = getattr(module, name)
    calls = []

    def patched(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return planted(real, *args, **kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, patched)


def _planted_in_check(monkeypatch, module, name, planted):
    """`_first_call_only` armed when the cross-device check starts, so the
    training steps before it run the real function."""
    real_check = chip_smoke._cross_device_grads

    def check(*args, **kwargs):
        with monkeypatch.context() as m:
            _first_call_only(m, module, name, planted)
            return real_check(*args, **kwargs)

    monkeypatch.setattr(chip_smoke, "_cross_device_grads", check)


def test_diffusion_grads_flag_an_upsample_on_the_wrong_pixel(monkeypatch):
    """The cross-device check's power: an upsample whose output i reads
    input (i + 1) // 2 (the wrong half-pixel rule) on the card alone."""
    from cloudtik_tpu_torch.models import diffusion as U

    def shifted(x):
        up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return torch.cat([up[:, 1:], up[:, -1:]], dim=1)

    def planted(real, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(U, "upsample_nearest_2x", shifted)
            return real(*args, **kwargs)

    _planted_in_check(monkeypatch, U, "loss_fn", planted)
    with pytest.raises(SystemExit, match="diffusion_grads: .*gradient"):
        chip_smoke.phase_diffusion_grads(
            chip_smoke.DIFFUSION_CHECK_REHEARSAL, "cpu")


def test_dlrm_grads_flag_an_embedding_row_off_by_one(monkeypatch):
    from cloudtik_tpu_torch.models import dlrm as D

    def planted(real, tables, ids):
        return real(tables, (ids.long() + 1) % tables.shape[1])

    _planted_in_check(monkeypatch, D, "gather_embed", planted)
    with pytest.raises(SystemExit, match="dlrm_grads"):
        chip_smoke.phase_dlrm_train(chip_smoke.DLRM_TRAIN_REHEARSAL,
                                    chip_smoke.DLRM_CHECK_REHEARSAL, "cpu")


def test_rnnt_check_flags_a_lattice_row_shifted_by_one(monkeypatch):
    """A transducer loss that reads every label one position on (on both
    devices alike, so the gradients agree) is caught by the float64
    oracle."""
    from cloudtik_tpu_torch.models import rnnt as N
    from cloudtik_tpu_torch.ops import transducer as X

    real = X.transducer_loss

    def shifted(lp, labels, *args, **kwargs):
        return real(lp, torch.roll(labels, 1, dims=1), *args, **kwargs)

    monkeypatch.setattr(X, "transducer_loss", shifted)
    monkeypatch.setattr(N, "transducer_loss", shifted)
    with pytest.raises(SystemExit, match="float64 oracle"):
        chip_smoke.phase_rnnt_train(chip_smoke.RNNT_TRAIN_REHEARSAL,
                                    chip_smoke.RNNT_CHECK_REHEARSAL, "cpu")


def test_rnnt_check_flags_a_greedy_decode_that_differs(monkeypatch):
    from cloudtik_tpu_torch.models import rnnt as N

    def planted(real, *args, **kwargs):
        out = real(*args, **kwargs)
        out[0, 0] = out[0, 0] % 7 + 1
        return out

    _first_call_only(monkeypatch, N, "greedy_decode", planted)
    with pytest.raises(SystemExit, match="greedy_decode on the card"):
        chip_smoke.phase_rnnt_train(chip_smoke.RNNT_TRAIN_REHEARSAL,
                                    chip_smoke.RNNT_CHECK_REHEARSAL, "cpu")


def test_graphsage_grads_flag_a_mean_over_padding(monkeypatch):
    from cloudtik_tpu_torch.models import graphsage as G

    def planted(real, params, batch, cfg):
        batch = dict(batch, neighbor_mask=torch.ones_like(
            batch["neighbor_mask"]))
        return real(params, batch, cfg)

    _planted_in_check(monkeypatch, G, "loss_fn", planted)
    with pytest.raises(SystemExit, match="graphsage_grads"):
        chip_smoke.phase_graphsage_train(
            chip_smoke.GRAPHSAGE_TRAIN_REHEARSAL,
            chip_smoke.GRAPHSAGE_LINK_REHEARSAL,
            chip_smoke.GRAPHSAGE_CHECK_REHEARSAL, "cpu")


def test_gbdt_check_flags_a_threshold_off_by_one_bin(monkeypatch):
    """The card's rounds (every `grow_round` without `gaps`) with the
    first usable split's threshold one bin low: not a near tie, so the
    check fails."""
    from cloudtik_tpu_torch.models import gbdt as GB

    real = GB.grow_round

    def planted(binned, scores, targets, cfg, gaps=None):
        trees = real(binned, scores, targets, cfg, gaps)
        if gaps is None:
            bins = trees["split_bin"].reshape(-1)
            bins[int(torch.nonzero(bins < cfg.n_bins)[0, 0])] -= 1
        return trees

    monkeypatch.setattr(GB, "grow_round", planted)
    with pytest.raises(SystemExit, match="not a near tie"):
        chip_smoke.phase_gbdt(chip_smoke.GBDT_REHEARSAL, "cpu")


def _round(feat, thr, leaf):
    return {"split_feat": torch.tensor([feat], dtype=torch.int32),
            "split_bin": torch.tensor([thr], dtype=torch.int32),
            "leaf": torch.tensor([leaf])}


def test_compare_round_accepts_a_flip_only_at_a_near_tie():
    """Depth 1 over 4 rows of 2 features: a root on another feature that
    partitions the rows alike is equivalent; one that partitions them
    otherwise passes only where the CPU's gain gap was a near tie, and its
    rows leave the leaf comparison."""
    binned = torch.tensor([[0, 0], [1, 1], [2, 3], [3, 2]])
    cpu = _round([0], [1], [0.5, -0.5])
    gaps = [torch.tensor([[0.5]])]
    same = chip_smoke.compare_round(_round([1], [1], [0.5, -0.5]), cpu, gaps,
                                    binned, 1)
    assert same["split_differences"] == 1 and not same["flips"]
    assert same["at_near_tie"] and float(same["leaf_diff"].max()) == 0
    other = _round([0], [2], [0.5, -0.5])
    out = chip_smoke.compare_round(other, cpu, gaps, binned, 1)
    assert out["flips"] == [{"class": 0, "level": 0, "node": 0,
                             "cpu_gain_gap": 0.5}]
    assert not out["at_near_tie"] and bool(out["left_out"].all())
    near = [torch.tensor([[chip_smoke.GBDT_NEAR_TIE / 10]])]
    assert chip_smoke.compare_round(other, cpu, near, binned, 1)[
        "at_near_tie"]
    moved = chip_smoke.compare_round(_round([0], [1], [0.5, -0.25]), cpu,
                                     gaps, binned, 1)
    assert moved["leaf_diff"].tolist() == [[0.0, 0.0, 0.25, 0.25]]


def test_moe_loads_keep_the_full_width():
    """tpu_moe_8x1b at full width: serving at full depth, training cut
    to 8 layers, the gradient check to 2; never a narrower model."""
    assert chip_smoke.MOE_SERVE_LOAD.model == "tpu_moe_8x1b"
    assert chip_smoke.MOE_SERVE_LOAD.overrides == ()
    assert (chip_smoke.MOE_SERVE_LOAD.requests,
            chip_smoke.MOE_SERVE_LOAD.prompt, chip_smoke.MOE_SERVE_LOAD.new,
            chip_smoke.MOE_SERVE_LOAD.clients) == (4, 128, 32, 8)
    train = chip_smoke.MOE_TRAIN_LOAD
    assert (train.model, train.n_layers, train.batch, train.seq,
            train.warmup, train.steps) == ("tpu_moe_8x1b", 8, 8, 2048, 2, 5)
    grads = chip_smoke.MOE_GRADS_LOAD
    assert (grads.model, grads.n_layers, grads.batch, grads.seq) == (
        "tpu_moe_8x1b", 2, 2, 256)


def test_moe_serve_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_moe_serve(chip_smoke.MOE_SERVE_REHEARSAL, "cpu")
    assert out["plain"]["equal_direct_generate"]
    eng = out["engine"]
    assert eng["tie_gap_max"] <= chip_smoke.ENGINE_TIE_GAP
    assert eng["logits_diff_max"] <= chip_smoke.ENGINE_LOGITS_MAX_ABS
    fault = eng["planted_fault"]
    assert fault["lanes_flagged_by_logits"] == fault["lanes"] == 4
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}


def test_moe_train_phase_rehearsal_takes_no_kernel_on_cpu():
    out = chip_smoke.phase_moe_train(chip_smoke.MOE_TRAIN_REHEARSAL, "cpu")
    assert out["losses_with_aux"][-1] < out["losses_with_aux"][0]
    assert out["launches_per_step"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                        "flash_bwd_dkv": 0}
    assert 0 <= out["moe_drop_fraction"] < 1


def test_moe_grads_rehearsal():
    out = chip_smoke.phase_moe_grads(chip_smoke.MOE_GRADS_REHEARSAL, "cpu")
    assert out["routing_flips"] == []
    assert out["generate_card"] == out["generate_cpu"]
    (_, worst), = out["grad_rel_l2_max"].items()
    assert worst == 0.0


def test_moe_grads_flag_a_dispatch_one_slot_short(monkeypatch):
    """The cross-device check's power: capacity one slot short on the card
    alone drops tokens the CPU keeps."""
    from cloudtik_tpu_torch.ops import moe as TM

    def planted(real, probs, cfg, capacity):
        return real(probs, cfg, max(capacity - 1, 1))

    _planted_in_check(monkeypatch, TM, "_top_k_dispatch", planted)
    with pytest.raises(SystemExit, match="moe_grads: .*gradient"):
        chip_smoke.phase_moe_grads(chip_smoke.MOE_GRADS_REHEARSAL, "cpu")


def test_moe_grads_flag_routing_that_differs_away_from_a_tie(monkeypatch):
    """The routing check's power: the card's router probabilities with two
    experts swapped route tokens otherwise, away from any near tie."""
    real = chip_smoke.forward_routes
    calls = []

    def planted(*args):
        logits, probs = real(*args)
        calls.append(1)
        if len(calls) == 1:
            probs = [p[..., [1, 0, *range(2, p.shape[-1])]] for p in probs]
        return logits, probs

    monkeypatch.setattr(chip_smoke, "forward_routes", planted)
    with pytest.raises(SystemExit, match="routing differs"):
        chip_smoke.phase_moe_grads(chip_smoke.MOE_GRADS_REHEARSAL, "cpu")


def test_router_flips_accept_only_near_ties():
    card = [torch.tensor([[[0.5, 0.3, 0.2], [0.4, 0.4 - 1e-6, 0.2]]])]
    cpu = [torch.tensor([[[0.5, 0.3, 0.2], [0.4 - 1e-6, 0.4, 0.2]]])]
    out = chip_smoke.router_flips(card, cpu, 1)
    assert [f["pos"] for f in out["flips"]] == [1] and out["all_at_near_tie"]
    # a near tie on the CPU's side only: the card's router is far off
    far = [torch.tensor([[[0.5, 0.3, 0.2], [0.7, 0.1, 0.2]]])]
    out = chip_smoke.router_flips(far, cpu, 1)
    assert len(out["flips"]) == 1 and not out["all_at_near_tie"]


def test_moe_serve_flags_a_forward_that_routes_otherwise(monkeypatch):
    """The forward check's power: a reference forward pinned to routes
    with experts 0 and 1 swapped (as a flash forward whose router read the
    wrong expert would route) is flagged."""
    real = chip_smoke.forward_routes

    def planted(params, tokens, cfg, pinned=None):
        if pinned is not None:
            pinned = [p[..., [1, 0, *range(2, p.shape[-1])]] for p in pinned]
        return real(params, tokens, cfg, pinned=pinned)

    monkeypatch.setattr(chip_smoke, "forward_routes", planted)
    with pytest.raises(SystemExit, match="forward logits differ"):
        chip_smoke.phase_moe_serve(chip_smoke.MOE_SERVE_REHEARSAL, "cpu")


def test_moe_train_flags_a_step_that_learns_nothing():
    """The loss check's power: with no learning rate the repeated batch's
    loss_with_aux cannot fall."""
    load = dataclasses.replace(chip_smoke.MOE_TRAIN_REHEARSAL, lr=0.0)
    with pytest.raises(SystemExit, match="moe_train: the loss did not fall"):
        chip_smoke.phase_moe_train(load, "cpu")


def test_parallel_2rank_phase_rehearsal():
    """The phase's two ranks over gloo on the CPU at tiny size: every
    check it makes on the card but the launch counts, the q shapes and
    the peaks (no kernel runs here)."""
    out = chip_smoke.phase_parallel_2rank(chip_smoke.PARALLEL_REHEARSAL)
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    want = out["expected_launches_per_step"]
    assert want["1f1b"]["flash_fwd"] == 2 * want["gpipe"]["flash_fwd"]
    for r in out["ranks"]:
        assert r["collectives"]["shift_route"] == "p2p"
        assert r["tensor_f32"]["max_leaf_rel_l2"] <= 1e-5
        assert r["tensor_f32_fault"]["max_leaf_rel_l2"] > 0.1
        assert r["pipe_f32_fault"]["worst_leaf"] == "lm_head"
        assert r["overlap"]["overlap"]["losses"] == \
            r["overlap"]["sequential"]["losses"]


def test_parallel_load_is_tpu_1b_at_full_width():
    load = chip_smoke.PARALLEL_LOAD
    assert load.model == "tpu_1b" and load.seq == 2048
    assert (load.tensor_batch, load.pipe_batch, load.pipe_micro,
            load.pipe_micro_peak) == (4, 8, 4, 8)
    assert load.device == "cuda:0"



def test_elastic_2rank_phase_rehearsal():
    """The phase's processes over gloo on the CPU at tiny size: the lost
    process leaves, a fresh one returns and is handed the state, and every
    check the phase makes on the card but the launch counts and the peaks
    (no kernel runs here)."""
    out = chip_smoke.phase_elastic_2rank(
        chip_smoke.ELASTIC_REHEARSAL,
        split_load=chip_smoke.ELASTIC_SPLIT_REHEARSAL)
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["k1_losses"] == out["fresh_losses"]
    assert [s for s, k in out["steps"] if k == 1] == [3, 4, 5, 6]
    assert [r["direction"] for r in out["remeshes"]["survivor"]] == [
        "shrink", "expand"]
    assert out["shards_gb"]["written"] > out["shards_gb"]["read"] > 0
    # F5: the expand under rules that split the embedding over `data`
    split = out["split"]
    assert "embed" in split["split_over_data"]
    assert split["max_rel_after_expand"] <= chip_smoke.ELASTIC_SPLIT_REL
    assert len(split["losses"]["split"]) == 5


@pytest.mark.parametrize("fault,match", [
    (None, None), ("drift", "elastic_split: f32 losses"),
    ("unsplit", "elastic_split: leaves split over data"),
    ("replicas", "the replicas' whole state differs")])
def test_elastic_split_check_flags_a_wrong_expand(monkeypatch, fault,
                                                   match):
    """The split drill's checks over drills as the ranks report them: the
    step after the expand off by 1e-4 relative, rules that split nothing
    over `data`, or replicas that differ after the expand each fail the
    phase."""
    load = chip_smoke.ELASTIC_SPLIT_REHEARSAL
    steps = [(1, 2), (2, 2), (2, 1), (3, 1), (4, 2)]

    def drill(drill_load, root, tmp):
        split = bool(drill_load.rules)
        losses = [5.5, 5.4, 5.4, 5.3, 5.2]
        if split and fault == "drift":
            losses[-1] *= 1 + 1e-4
        hist = [{"step": s, "slices": k, "loss": x}
                for (s, k), x in zip(steps, losses)]
        zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        rank = {"history": hist, "launches": zero, "launches_by_step": [],
                "remeshes": [{"direction": "expand", "wall_s": 1.0}],
                "split_over_data": ["embed"] if split
                and fault != "unsplit" else [], "digest": {"a": "1"}}
        joiner = dict(rank, history=hist[-1:], digest={
            "a": "2" if fault == "replicas" else "1"})
        return {"survivor": rank, "joiner": joiner,
                "left": dict(rank, history=hist[:2])}

    monkeypatch.setattr(chip_smoke, "_elastic_drill", drill)
    if fault is None:
        out = chip_smoke._elastic_split(load, ROOT)
        assert out["max_rel_after_expand"] == 0.0
        return
    with pytest.raises(SystemExit, match=match):
        chip_smoke._elastic_split(load, ROOT)


def test_elastic_load_is_tpu_1b_at_full_width_and_depth():
    load = chip_smoke.ELASTIC_LOAD
    assert (load.model, load.seq, load.batch) == ("tpu_1b", 2048, 8)
    assert load.device == "cuda:0"
    # depth cut to 8 of the preset's 16 layers for the script's limit
    assert (load.n_layers, load.param_dtype) == (8, "bfloat16")
    assert (load.every, load.torn_at, load.lost_at, load.return_at,
            load.steps) == (2, 4, 4, 6, 8)
    split = chip_smoke.ELASTIC_SPLIT_LOAD
    assert (split.model, split.seq, split.batch, split.device) == (
        "tpu_1b", 2048, 8, "cuda:0")
    assert (split.n_layers, split.param_dtype) == (2, "float32")
    assert chip_smoke.ELASTIC_SPLIT_RULES == {"embed": ["data", None]}


def test_zoo_2rank_phase_rehearsal():
    """The phase's two ranks over gloo on the CPU at tiny size: every
    check it makes on the card but the launch counts (no kernel runs
    here): each f32 mesh step within 1e-5 of one process, each planted
    fault far past the phase's limit."""
    out = chip_smoke.phase_zoo_2rank(chip_smoke.ZOO_MESH_REHEARSAL)
    assert out["launches"] == {"nms": 0, "roi_align": 0}
    for r in out["ranks"]:
        for name in ("maskrcnn_f32", "dlrm_f32", "graphsage_f32",
                     "graphsage_link_f32"):
            assert r[name]["clean"]["max_leaf_rel_l2"] <= 1e-4, name
            assert r[name]["clean"]["loss_rel"] <= 1e-5, name
        assert r["maskrcnn_f32"]["bn_local"]["max_leaf_rel_l2"] > 0.1
        # the sum-order witness: one process, BN's sums in the mesh's order
        assert r["maskrcnn_f32"]["witness"]["max_leaf_rel_l2"] <= 1e-4
        assert r["maskrcnn_f32"]["clean"]["proposals_repicked"] == 0
        assert r["graphsage_f32"]["own_rows"]["max_leaf_rel_l2"] > 0.1
        # the tables' embedding columns split over fsdp
        assert r["dlrm_local_table"] == [4, 100, 8]
        assert r["maskrcnn_train"]["collectives"]["collective_ms"] > 0


def test_zoo_mesh_load_is_the_recipes_at_full_width():
    load = chip_smoke.ZOO_MESH_LOAD
    assert (load.maskrcnn, load.image_size, load.maskrcnn_batch) == (
        "maskrcnn_resnet50", 512, 8)
    assert (load.dlrm, load.dlrm_batch) == ("criteo_terabyte", 8192)
    assert (load.graphsage, load.graphsage_nodes) == ("graphsage", 4096)
    assert load.device == "cuda:0"


def test_runtime_phase_rehearsal(tmp_path, monkeypatch):
    """The runtime phase on the CPU at tiny size: the serving runtime
    answers, registers and deregisters; the AI runtime's command starts
    the rank through the port's launcher on a warm cache (the library
    names planted: no nvcc here), which builds nothing and writes every
    field the phase reads; the cold cache without nvcc fails with
    KernelBuildError."""
    # the serving runtime journals the port's events under TIK_HOME
    monkeypatch.setenv("TIK_HOME", str(tmp_path))
    load = chip_smoke.RUNTIME_REHEARSAL
    out = chip_smoke.phase_runtime(load)
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert not any(out["serve_launches"].values())
    assert len(out["serve"]["tokens"]) == load.new_tokens
    rank = out["rank"]
    assert Path(rank["build_dir"]).name == "cache"
    assert rank["built"] == [] and rank["compile_s"] == 0
    assert len(rank["losses"]) == 2 and rank["ms_per_step"] > 0
    assert (rank["model"], rank["seq"], rank["batch"]) == ("tiny", 64, 4)
    assert 0 < out["spawn_to_rank_start_s"] < out["spawn_to_first_step_s"]
    assert out["miss"]["rc"] != 0
    assert "KernelBuildError: nvcc not found" in out["miss"]["error"]
    cmd = out["runnable_command"]
    assert cmd[:-3] == AIRuntime({"python": sys.executable}).\
        get_runnable_command(str(ROOT / "chip_smoke.py"), [
            "--nproc-per-node", "1", "--deadline-s", str(load.deadline_s)])
    assert cmd[-3] == "--runtime-rank"
    assert cmd[1:3] == ["-m", "cloudtik_tpu_torch.launch.run"]


def test_runtime_load_is_the_lora_recipe_at_tpu_1b():
    from cloudtik_tpu_torch.recipes import llama_lora_finetune as R

    load = chip_smoke.RUNTIME_LOAD
    assert (load.device, load.serve_model, load.warmup, load.steps) == (
        "cuda", "tpu_1b", 1, 2)
    args = R.parser().parse_args(["--device", load.device, *load.argv])
    assert (args.model, args.seq_len, args.batch, args.rank) == (
        "tpu_1b", 2048, 8, 16)
    assert chip_smoke.RUNTIME_REHEARSAL.argv[:2] == ("--model", "tiny")


def test_without_nvcc_no_path_entry_holds_nvcc(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "nvcc").write_text("#!/bin/sh\n")
    (bin_dir / "nvcc").chmod(0o755)
    env = chip_smoke._without_nvcc(
        {"PATH": f"{bin_dir}{os.pathsep}/usr/bin", "TMPDIR": str(tmp_path)})
    assert env["PATH"] == "/usr/bin"
    assert not Path(env["CUDA_HOME"]).exists()


def _fake_host(tmp_path, cards, model="NVIDIA H100 80GB HBM3"):
    """A device root with `cards` card nodes beside the driver's other
    nodes, and a /proc whose driver describes each card."""
    dev, proc = tmp_path / "dev", tmp_path / "proc"
    (dev / "nvidia-caps").mkdir(parents=True)
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset", "nvidia-caps/nvidia-cap1"):
        (dev / name).touch()
    for i in range(cards):
        (dev / f"nvidia{i}").touch()
        info = proc / "driver" / "nvidia" / "gpus" / f"0000:{i:02x}:00.0"
        info.mkdir(parents=True)
        (info / "information").write_text(
            f"Model: \t\t {model}\nGPU UUID: \t GPU-{i:08x}\n"
            f"Device Minor: \t {i}\n")
    return str(dev), str(proc)


def test_hosts_phase_rehearsal(tmp_path, monkeypatch):
    """The hosts phase on the CPU against a fake one-card host: the
    detection in fresh processes without torch, its command-line form,
    the hidden and planted cases, and the launcher's default (1 without
    CUDA) equal to the count."""
    for name in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                 "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    dev, proc = _fake_host(tmp_path, 1)
    out = chip_smoke.phase_hosts(1, "NVIDIA H100 80GB HBM3", dev, proc,
                                 nvidia_smi="fake, 0 W")
    res = out["resources"]
    assert res["GPU"] == 1.0
    assert res["accelerator_type:NVIDIA-H100-80GB-HBM3"] == 1.0
    assert out["model_source"] == "proc" and out["nproc_per_node"] == 1
    assert 0 < out["detect_ms"] < out["process_ms"]
    assert out["cli_ms"] > 0 and out["nvidia_smi"] == "fake, 0 W"
    assert out["device_mib"] is None and out["libcuda_mapped"] is False


@pytest.mark.parametrize("fault,match", [
    ("count", "detected 2.0 cards, torch sees 1"),
    ("name", "expected accelerator_type:NVIDIA-A100"),
    ("hidden", "CUDA_VISIBLE_DEVICES"),
    ("context", "the card lost 523.5625 MiB while the detecting process"),
])
def test_hosts_phase_catches_a_wrong_host(tmp_path, monkeypatch, fault,
                                          match):
    for name in ("NVIDIA_VISIBLE_DEVICES", "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    dev, proc = _fake_host(tmp_path, 2 if fault == "count" else 1)
    name = "NVIDIA A100" if fault == "name" else "NVIDIA H100 80GB HBM3"
    if fault == "hidden":
        # a detection that ignored CUDA_VISIBLE_DEVICES would still count
        # the card: plant one that does
        monkeypatch.setattr(chip_smoke, "_DETECT", chip_smoke._DETECT.replace(
            "None, sys.argv[2]", "{}, sys.argv[2]"))
    free = None
    if fault == "context":
        # a detection that opened a CUDA context: the card's free memory
        # falls by what one took on the H100
        reads = iter([80 * 2**30, 80 * 2**30 - int(523.5625 * 2**20)])
        free = lambda: next(reads)   # noqa: E731
    with pytest.raises(SystemExit, match=match):
        chip_smoke.phase_hosts(1, name, dev, proc, free_bytes=free)


def test_observe_phase_rehearsal(tmp_path, monkeypatch):
    """The observe phase's serving parts and node exporter on the CPU at
    tiny size, with the planted decode latency: the port's collector counts
    every answered request, `serve-ttft` has finite burns after 31 scrape
    cycles, the serve-demand policy adds no demand without the fault and
    one `{"GPU": 1}` with it, and the port's journal and the collector's
    hold what happened."""
    monkeypatch.setenv("TIK_HOME", str(tmp_path))
    out = chip_smoke.phase_observe(chip_smoke.OBSERVE_REHEARSAL)
    serve = out["serve"]
    n = serve["answered"]
    assert serve["after_requests"] == {"ttft_count": 17, "ok": 17}
    assert serve["after_fault"] == {"ttft_count": n, "ok": n}
    assert serve["cycles"] >= 31
    assert serve["targets"]["runtime"]["serving-telemetry"] == \
        serve["targets"]["discovery"]["serving-telemetry"]
    assert serve["control"]["max_queue"] > 0
    fault = serve["fault"]
    assert fault["demands"] == [{"GPU": 1}, {"GPU": 1}]
    assert fault["rise_eval"] - fault["first_burning_eval"] <= 3
    assert fault["ttft_past_threshold"][0] > 0
    assert "slo:serve-ttft" in serve["collector_alerts"]
    assert serve["journal"]["faults"] == fault["decode_steps_delayed"] > 0
    assert set(out["nodex"]["gauges"]) >= {"tik_node_cpu_percent",
                                           "tik_node_memory_percent"}
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert not any(out["serve_launches"].values())
    # the port's CLI over the trace, the ledger and the journal (F3); the
    # declared cluster's targets (F4)
    trace = serve["trace"]
    assert {"serve.enqueue", "serve.prefill", "serve.decode"} <= set(
        trace["names"])
    assert trace["lanes"] == [
        f"serving-telemetry (127.0.0.1:{serve['ports']['telemetry']})"]
    assert serve["records"]["ledger_count"] == n + 1
    assert serve["records"]["trace_events"] == ["tik_serve_admission"]
    assert {"serving", "serving-telemetry", "consul", "spark-ui",
            "grafana"} <= set(serve["declared_targets"]["jobs"])


def test_observe_trace_check_fails_without_the_serving_lane(tmp_path):
    """A stitched trace that holds no serve.* span of the traced request
    (here: the targets name only a dead `telemetry` job, as a collector
    that skips `serving-telemetry` would leave it) fails the phase."""
    (tmp_path / "targets.json").write_text(
        '[{"targets": ["127.0.0.1:9"], "labels": {"job": "telemetry"}}]')
    traced = {"trace_id": "a" * 32, "request_id": "1",
              "traceparent": f"00-{'a' * 32}-{'b' * 16}-01"}
    env = dict(os.environ, TIK_HOME=str(tmp_path / "home"))
    with pytest.raises(SystemExit, match="the stitched trace of"):
        chip_smoke._observe_trace(ROOT, env, tmp_path, 9, traced)


def test_observe_records_check_counts_every_answer(tmp_path):
    """`serve requests --stats` over a ledger one record short of the
    answers fails the phase, as does a port CLI that cannot start."""
    from cloudtik_tpu_torch.serve import reqlog
    from cloudtik_tpu_torch.telemetry import events

    ledger, journal = tmp_path / "rl.jsonl", tmp_path / "ev.jsonl"
    ledger.write_text("")
    journal.write_text("")
    traced = {"trace_id": "a" * 32, "request_id": "1",
              "traceparent": f"00-{'a' * 32}-{'b' * 16}-01"}
    env = dict(os.environ, TIK_HOME=str(tmp_path / "home"))
    assert reqlog.read_requests(str(ledger)) == []
    assert events.read_events(str(journal)) == []
    with pytest.raises(SystemExit, match="counts 0"):
        chip_smoke._observe_records(ROOT, env, ledger, journal, traced, 1,
                                    0)
    with pytest.raises(SystemExit, match="exited 2"):
        chip_smoke._port_cli(ROOT, env, "serve", "requests", "--nope")


def test_observe_declared_check_needs_every_http_service(tmp_path):
    """F4: the declared cluster's targets must hold the serving process's
    telemetry job; a serving runtime that serves none fails the phase."""
    out = chip_smoke._observe_declared(tmp_path / "a", {"port": 8300},
                                       9090)
    assert "serving-telemetry" in out["jobs"]
    with pytest.raises(SystemExit, match="renders the jobs"):
        chip_smoke._observe_declared(tmp_path / "b", {
            "port": 8300, "telemetry_port": 0}, 9090)


def test_observe_capture_rehearsal(tmp_path, monkeypatch):
    """Part (d) on the CPU at tiny size: the corpus through the port's
    tokenizer, the requested capture of exactly the steps after the first
    (no kernel on the CPU), the profiler runtime's command serving the
    trace byte for byte."""
    monkeypatch.setenv("TIK_HOME", str(tmp_path))
    load = dataclasses.replace(
        chip_smoke.OBSERVE_REHEARSAL, train_model="tiny", batch=2, seq=32,
        corpus_mb=0.05, parts=("capture",))
    out = chip_smoke.phase_observe(load)
    cap = out["capture"]
    assert cap["tokens"] >= 4 * 2 * 33 and cap["corpus_mb"] >= 0.05
    assert len(cap["losses"]) == 4
    assert cap["trace_kernels"] == {k: 0 for k in chip_smoke.FLASH_KERNELS}
    assert cap["trace_mb"] > 0 and cap["capture_stop_s"] > 0
    assert cap["profiler_cmd"][1:3] == ["-m", "http.server"]
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}


def test_observe_load_is_tpu_1b_at_full_width():
    load, engine = chip_smoke.OBSERVE_LOAD, chip_smoke.ENGINE_LOAD
    assert (load.device, load.model, load.train_model) == (
        "cuda", "tpu_1b", "tpu_1b")
    assert (load.batch, load.seq, load.capture_steps) == (8, 2048, 3)
    assert (load.requests, load.prompt_lens, load.slots, load.max_len) == (
        16, engine.prompt_lens, engine.slots, engine.max_len)
    assert (load.scrape_s, load.min_cycles, load.corpus_mb) == (
        0.25, 31, 4.0)
    assert set(load.parts) == {"serve", "nodex", "capture"}
    assert chip_smoke.OBSERVE_REHEARSAL.device == "cpu"


def test_control_phase_rehearsal(tmp_path, monkeypatch):
    """The control phase on the CPU at tiny size against a fake one-card
    host: the port's controller launches nothing before the job, then one
    `h100` host whose agent heartbeats into the native state server and
    advertises the fake card through the native sampler; the updater's
    start command runs the runtime phase's rank (no kernel on the CPU);
    the host is terminated for idle after the rank's result, and every
    python process of the phase ran with `import jax` raising."""
    for name in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                 "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    dev, proc = _fake_host(tmp_path, 1)
    env = dict(os.environ)
    out = chip_smoke.phase_control(chip_smoke.CONTROL_REHEARSAL,
                                   expect_gpus=1, dev_root=dev,
                                   proc_root=proc, nvidia_smi="fake, 0 W")
    assert dict(os.environ) == env
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    res = out["resources"]
    assert res["GPU"] == 1.0
    assert res["accelerator_type:NVIDIA-H100-80GB-HBM3"] == 1.0
    assert out["quiet"]["nodes"] == [] and out["quiet"]["ticks"] >= 4
    assert [(d["action"], d["reason"]) for d in out["decisions"]] == [
        ("launch", "demand"), ("terminate", "idle_timeout")]
    assert out["native_rows"] >= 1
    assert out["agent_device_mib"] is None and out["agent_maps"] == []
    rank = out["rank"]
    assert (rank["model"], rank["seq"], rank["batch"]) == ("tiny", 64, 4)
    assert len(rank["losses"]) == 2
    t = out["timing"]
    assert 0 < t["job_to_launch_s"] and 0 < t["launch_to_heartbeat_s"]
    assert t["heartbeat_to_result_s"] < t["heartbeat_to_termination_s"]
    assert t["heartbeat_to_termination_s"] >= \
        chip_smoke.CONTROL_REHEARSAL.idle_timeout_s
    assert len(out["processes"]) >= 3


def test_local_provider_phase_rehearsal(tmp_path, monkeypatch):
    """The local_provider phase on the CPU at tiny size against a fake
    one-card host: no claim before the job, then one claim of this machine
    by the `local` provider; the worker's start command boots the port's
    node services under the claim's node id, whose agent advertises the
    fake card through the native sampler, and runs the control phase's
    rank (no kernel on the CPU); the claim is released for idle after the
    rank's result and the store is empty; `node stop` through the executor
    ends the node services the release left running, and every python
    process of the phase, each with `import jax` raising; a second
    provider claims the host again and releases it."""
    for name in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
                 "TIK_NODE_RESOURCES"):
        monkeypatch.delenv(name, raising=False)
    dev, proc = _fake_host(tmp_path, 1)
    env = dict(os.environ)
    out = chip_smoke.phase_local_provider(
        chip_smoke.CONTROL_REHEARSAL, expect_gpus=1, dev_root=dev,
        proc_root=proc, nvidia_smi="fake, 0 W")
    assert dict(os.environ) == env
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    res = out["resources"]
    assert res["GPU"] == 1.0
    assert res["accelerator_type:NVIDIA-H100-80GB-HBM3"] == 1.0
    assert out["quiet"]["claims"] == {} and out["quiet"]["ticks"] >= 4
    assert [(d["action"], d["reason"]) for d in out["decisions"]] == [
        ("launch", "demand"), ("terminate", "idle_timeout")]
    assert out["native_rows"] >= 1
    assert out["services_device_mib"] is None
    assert out["services_alive_after_release"] is True
    argv = out["services_argv"]
    assert argv[argv.index("--node-id") + 1] == out["node"] == \
        out["heartbeat"]["node_ip"]
    rank = out["rank"]
    assert (rank["model"], rank["seq"], rank["batch"]) == ("tiny", 64, 4)
    assert len(rank["losses"]) == 2
    t = out["timing"]
    assert 0 < t["job_to_claim_s"] and 0 < t["claim_to_heartbeat_s"]
    assert t["heartbeat_to_result_s"] < t["heartbeat_to_release_s"]
    assert t["heartbeat_to_release_s"] >= \
        chip_smoke.CONTROL_REHEARSAL.idle_timeout_s
    # `node start --daemonize`, the node services it spawned, `node stop`
    commands = [p["argv"][1:] for p in out["processes"]]
    assert commands.count(["-m", "cloudtik_tpu_torch.scripts.cli",
                           "node"]) == 3


def test_control_load_is_the_runtime_rank_at_tpu_1b():
    load = chip_smoke.CONTROL_LOAD
    assert load.rank == dataclasses.replace(chip_smoke.RUNTIME_LOAD,
                                            steps=1, deadline_s=120.0)
    assert (load.rank.warmup, load.rank.steps) == (1, 1)
    assert chip_smoke.CONTROL_QUIET_TICKS >= 4
    assert load.update_interval_s == 0.5
    rehearsal = chip_smoke.CONTROL_REHEARSAL
    assert rehearsal.rank.argv == chip_smoke.RUNTIME_REHEARSAL.argv


def test_group_alive_sees_a_live_group_and_not_a_dead_one():
    proc = subprocess.Popen([sys.executable, "-c", "import time; "
                             "time.sleep(60)"], start_new_session=True)
    try:
        assert chip_smoke._group_alive(proc.pid) == [proc.pid]
        assert chip_smoke._maps_hold(proc.pid, ("libtorch", "libc")) == [
            "libc"]
    finally:
        proc.kill()
    # a zombie is not alive
    deadline = time.time() + 10
    while chip_smoke._group_alive(proc.pid) and time.time() < deadline:
        time.sleep(0.01)
    assert chip_smoke._group_alive(proc.pid) == []
    proc.wait()
    assert chip_smoke._group_alive(proc.pid) == []
