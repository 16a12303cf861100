#!/usr/bin/env python3
"""Probe: how much device memory does a second process hold on the card?

    python3 tools/probe_torch_cuda_context.py

Calibrates the hosts phase of chip_smoke.py, which holds the node
resource detection (cloudtik_tpu_torch/utils/resource_spec.py) to "no
CUDA context": this process holds the card, then starts, one at a time,
  * detect  the detection as the node agent's start command runs it,
  * nvml    a bare `nvmlInit_v2` (the detection's source of the model
            where a container hides /proc/driver/nvidia/gpus),
  * context a bare `cuInit` + `cuDevicePrimaryCtxRetain`, a CUDA context
            and nothing else,
and reads the card's free memory before each and while it is alive (and
`nvidia-smi --query-compute-apps`), after each has answered.  Prints one
JSON line: {"probe": "cuda_context", "nvidia_smi": ..., "results":
{name: {"held_mib": ..., "compute_apps": ..., "answer": ...}}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILDREN = {
    "detect": """
import json, sys
from cloudtik_tpu_torch.utils import resource_spec as R
print(json.dumps(R.detect_node_resources()), flush=True)
sys.stdin.read()
""",
    "nvml": """
import ctypes, sys
print(ctypes.CDLL("libnvidia-ml.so.1").nvmlInit_v2(), flush=True)
sys.stdin.read()
""",
    "context": """
import ctypes, sys
lib = ctypes.CDLL("libcuda.so.1")
dev, ctx = ctypes.c_int(), ctypes.c_void_p()
rc = [lib.cuInit(0), lib.cuDeviceGet(ctypes.byref(dev), 0),
      lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
      lib.cuCtxSetCurrent(ctx)]
print(rc, flush=True)
sys.stdin.read()
""",
}


def _smi(*query: str) -> str:
    return subprocess.run(["nvidia-smi", *query], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main() -> int:
    import torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    results = {}
    for name, code in CHILDREN.items():
        before = torch.cuda.mem_get_info(0)[0]
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        answer = proc.stdout.readline().strip()
        time.sleep(0.5)
        held = (before - torch.cuda.mem_get_info(0)[0]) / 2**20
        apps = _smi("--query-compute-apps=pid,used_memory",
                    "--format=csv,noheader").splitlines()
        proc.stdin.close()
        proc.wait(timeout=60)
        results[name] = {"held_mib": held, "compute_apps": len(apps),
                         "answer": answer}
    print(json.dumps({"probe": "cuda_context", "nvidia_smi": _smi(
        "--query-gpu=name,power.limit", "--format=csv,noheader"),
        "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
