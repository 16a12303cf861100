"""`chip_smoke.py` rehearsed on the CPU: its serve, forward, training and
detection phases run end to end at `tiny` size on the plain kernel
versions, its kernel_det case list at CPU size, its bound arithmetic is
pinned, and without a card it fails and prints no result."""

import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cloudtik_tpu_torch.ops import detection as D
from cloudtik_tpu_torch.ops import flash_attention as FA

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
        "s1088_causal"]
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
        _small(chip_smoke.ROI_CASES, B=2, R=16, C=64))
    assert (D.LAUNCHES_NMS, D.LAUNCHES_ROI_ALIGN) == before
    assert list(out["nms"]) == [c.name for c in chip_smoke.NMS_CASES]
    assert list(out["roi_align"]) == [c.name for c in chip_smoke.ROI_CASES]
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
