#!/usr/bin/env python3
"""Where the NMS kernel's time goes, phase by phase, on one card.

    python3 tools/profile_torch_nms_phases.py

Builds `cloudtik_tpu_torch/csrc/nms.cu` into `build/nms_phases/` with
`-DNMS_PHASE_CLOCKS`, which turns on its `clock64()` mark after each of its
block-wide barriers, and launches it through the port's own `nms_batched`
on the kernel_det NMS cases at the detect shapes (`ssd_b8`, `maskrcnn_b8`,
`ssd1200_b8`), on `all_zero_ssd1200`, and on the NMS inputs of one SSD
`detect` call at 300 and at 1200 (B=8, random weights from seed 0).  It
prints one JSON line per input: SM cycles per image in each phase (radix
select, compaction, sort, and per chunk: load, IoUs against the kept boxes
and within the chunk, resolution, write-back), the radix passes, chunks
and bands it took, and whether its keep list equals the plain version's.
The marks cost a few cycles each; the kernel's own time is
`tools/profile_torch_kernels.py`'s.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the slots of csrc/nms.cu's `PhaseSlot`, in order: cycles, then counts
PHASES = ("radix", "compact", "sort", "chunk_load", "chunk_iou",
          "chunk_resolve", "chunk_write")
COUNTS = ("passes", "chunks", "bands")
SLOTS = len(PHASES) + len(COUNTS)
IMAGES = 64   # kPhaseImages: the images whose phases are kept


def build() -> ctypes.CDLL:
    """nms.cu with its phase clocks, loaded in place of the normal build,
    so `nms_batched` launches it."""
    from cloudtik_tpu_torch.ops import _kernels

    out = ROOT / "build" / "nms_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libnms_phases.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                    "-DNMS_PHASE_CLOCKS", "-o", str(lib),
                    str(_kernels.CSRC / "nms.cu")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in _kernels._SIGNATURES["nms"].items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = restype
    dll.tik_nms_phase_clocks.argtypes = [ctypes.c_void_p]
    dll.tik_nms_phase_clocks.restype = ctypes.c_int
    _kernels._loaded["nms"] = dll
    return dll


def read_clocks(dll, B: int):
    """[B, SLOTS] int64 numpy: the slots of the launches since the last
    read (all finished), cleared."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.ops import _kernels

    torch.cuda.synchronize()
    buf = np.zeros((IMAGES, SLOTS), np.int64)
    _kernels.check(dll, dll.tik_nms_phase_clocks(buf.ctypes.data),
                   "tik_nms_phase_clocks")
    return buf[:B]


def inputs():
    """{name: (boxes, scores, K, iou_threshold)} on the card."""
    import torch

    import chip_smoke as cs
    from cloudtik_tpu_torch.models import ssd as SD

    cases = {c.name: c for c in cs.NMS_CASES}
    out = {}
    for name in cs.NMS_DETECT_SHAPES + ("all_zero_ssd1200",):
        c = cases[name]
        out[name] = (*cs.make_nms_inputs(c, "cuda"), c.K, c.iou_threshold)
    for size in (300, 1200):
        cfg = SD.config("ssd_resnet34", image_size=size)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = SD.init_params(gen, cfg, "cuda")
        images = torch.randn((8, size, size, 3), generator=gen,
                             device="cuda")
        det = SD.detect(params, images, cfg, device="cuda")
        out[f"detect_ssd{size}"] = (det["nms_boxes"].contiguous(),
                                    det["nms_scores"].contiguous(), 100, 0.5)
        del params, det
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_nms_phases: needs a CUDA card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.ops import detection as D

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dll = build()
    for name, (boxes, scores, K, thr) in inputs().items():
        B, N = scores.shape
        read_clocks(dll, B)
        keep = D.nms_batched(boxes, scores, iou_threshold=thr, max_output=K)
        per_image = read_clocks(dll, B).astype(float).mean(0).tolist()
        want = D.nms_reference_batched(boxes, scores, iou_threshold=thr,
                                       max_output=K)
        print(json.dumps({
            "input": name, "B": B, "N": N, "K": K,
            "equal": bool((keep == want).all()),
            "cycles": {n: per_image[i] for i, n in enumerate(PHASES)},
            **{n: per_image[len(PHASES) + i] for i, n in enumerate(COUNTS)},
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
