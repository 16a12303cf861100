#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's detection path, on one card.

    python3 tools/profile_torch_detect.py [--batch 8]

Profiles (torch.profiler, CPU + CUDA activity) one `detect` call of
maskrcnn_resnet50 at [batch, 512, 512, 3] and of ssd_resnet34 at
[batch, 300, 300, 3] and [batch, 1200, 1200, 3] (MLPerf's SSD-ResNet34
input, 45,384 anchors an image), bf16 compute on f32 params, and prints one
JSON line for each: wall time, device time summed over kernels, the
device's busy share of the wall, the launch count, and device time grouped
by kind (the NMS and ROIAlign kernels, convolutions, matmuls, the rest) with
the top kernels by name.  Needs a CUDA card; weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_torch_inference import profile  # noqa: E402

_CONV = re.compile(r"conv|fprop|implicit|winograd|cudnn", re.I)
_GEMM = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|sm90_", re.I)


def _kind(name: str) -> str:
    if "nms_kernel" in name:
        return "nms"
    if "roi_align_vec_kernel" in name or "roi_align_strided_kernel" in name:
        return "roi_align"
    if _CONV.search(name):
        return "conv"
    if _GEMM.search(name):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_detect: needs a CUDA card", file=sys.stderr)
        return 1
    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.models import ssd as SD

    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    for M, name, overrides in ((MR, "maskrcnn_resnet50", {}),
                               (SD, "ssd_resnet34", {}),
                               (SD, "ssd_resnet34", {"image_size": 1200})):
        cfg = M.config(name, **overrides)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = M.init_params(gen, cfg, "cuda")
        S = cfg.image_size
        images = torch.randn((args.batch, S, S, 3), generator=gen,
                             device="cuda")
        profile(lambda: M.detect(params, images, cfg, device="cuda"),
                f"detect_{name}_{cfg.image_size}", kind=_kind,
                batch=args.batch,
                image_size=S)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
