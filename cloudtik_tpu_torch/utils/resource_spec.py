"""Node resource detection (CPU / memory / GPU).

Counterpart of `cloudtik_tpu/utils/resource_spec.py` for GPU hosts, with
its rule: the accelerators are detected WITHOUT starting the runtime.
Neither `torch` nor `torch.cuda` is imported here, so a node agent never
opens a CUDA context on a card that belongs to the training program.
Detection order:

1. `TIK_NODE_RESOURCES` env (JSON): an explicit override, parsed as the
   reference parses it;
2. `CUDA_VISIBLE_DEVICES`, then `NVIDIA_VISIBLE_DEVICES`, where either is
   set: "", "-1", "none" and "void" mean no card, "all" every device node,
   else one card per listed entry;
3. the device nodes `/dev/nvidia<N>` (one per card; `nvidiactl`,
   `nvidia-uvm`, `nvidia-modeset` and `nvidia-caps/` are not cards).

No device node means no card, whatever the environment says.  The model
comes from the `Model:` line of `/proc/driver/nvidia/gpus/*/information`,
or from NVML where a container hides those files, and is advertised as `accelerator_type:<model>` with the characters a
resource key cannot hold made dashes.  CPU and memory are the host's
logical CPUs and physical memory, the values the reference reads through
psutil.

`python3 -m cloudtik_tpu_torch.utils.resource_spec` prints the JSON that
`TIK_NODE_RESOURCES` takes.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
from typing import Dict, List, Optional

NO_CARD_VALUES = frozenset(("", "-1", "none", "void"))
_CARD_NODE = re.compile(r"nvidia(\d+)$")


def accelerator_key(model: str) -> str:
    """The resource key a card model is advertised under:
    "NVIDIA H100 80GB HBM3" -> "accelerator_type:NVIDIA-H100-80GB-HBM3"."""
    return "accelerator_type:" + re.sub(
        r"[^A-Za-z0-9._-]+", "-", model.strip()).strip("-")


def card_minors(dev_root: str = "/dev") -> List[int]:
    """Minor numbers of the card device nodes under `dev_root`, sorted."""
    minors = []
    for path in glob.glob(os.path.join(dev_root, "nvidia*")):
        m = _CARD_NODE.match(os.path.basename(path))
        if m:
            minors.append(int(m.group(1)))
    return sorted(minors)


def driver_cards(proc_root: str = "/proc") -> Dict[int, Dict[str, str]]:
    """The cards the driver describes under
    `<proc_root>/driver/nvidia/gpus/*/information`, by minor number: the
    fields of each file (`Model`, `GPU UUID`, `Device Minor`, ...)."""
    cards: Dict[int, Dict[str, str]] = {}
    pattern = os.path.join(proc_root, "driver", "nvidia", "gpus", "*",
                           "information")
    for i, path in enumerate(sorted(glob.glob(pattern))):
        fields = {}
        try:
            with open(path) as f:
                for line in f:
                    key, sep, value = line.partition(":")
                    if sep:
                        fields[key.strip()] = value.strip()
        except OSError:
            continue
        minor = fields.get("Device Minor", "")
        cards[int(minor) if minor.isdigit() else i] = fields
    return cards


def _visible(value: str, minors: List[int], host_indices: bool,
             uuids: List[str]) -> int:
    """Cards a `*_VISIBLE_DEVICES` value leaves of the device nodes.

    CUDA_VISIBLE_DEVICES lists ordinals among the visible cards,
    NVIDIA_VISIBLE_DEVICES the host's indices (the device nodes' minors);
    either may list UUIDs (or their prefixes) and MIG instances.  As CUDA
    does, the list ends at the first entry that names no card: an index out
    of range, or a UUID the driver does not describe (where it describes
    any)."""
    value = value.strip()
    if value.lower() in NO_CARD_VALUES:
        return 0
    if value.lower() == "all":
        return len(minors)
    seen = set()
    for entry in value.split(","):
        entry = entry.strip()
        if entry.lstrip("-").isdigit():
            index = int(entry)
            if not (index in minors if host_indices
                    else 0 <= index < len(minors)):
                break
        elif not entry or (uuids and not entry.startswith("MIG-") and not any(
                u.startswith(entry) for u in uuids)):
            break
        seen.add(entry)
    return min(len(seen), len(minors))


def detect_gpu_cards(dev_root: str = "/dev",
                     env: Optional[Dict[str, str]] = None,
                     proc_root: str = "/proc") -> int:
    """Cards this host's processes can use, without touching the
    runtime."""
    env = dict(os.environ if env is None else env)
    minors = card_minors(dev_root)
    if not minors:
        return 0
    for name, host_indices in (("CUDA_VISIBLE_DEVICES", False),
                               ("NVIDIA_VISIBLE_DEVICES", True)):
        if name in env:
            uuids = [c["GPU UUID"] for c in driver_cards(proc_root).values()
                     if c.get("GPU UUID")]
            return _visible(env[name], minors, host_indices, uuids)
    return len(minors)


def nvml_model() -> Optional[str]:
    """The name of the first card the driver's management library (NVML,
    what `nvidia-smi` reads) lists, or None where there is no library or
    no card.  NVML opens no CUDA context."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    for fn, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                     ("nvmlDeviceGetHandleByIndex_v2",
                      [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                     ("nvmlDeviceGetName",
                      [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    if lib.nvmlInit_v2() != 0:
        return None
    try:
        handle = ctypes.c_void_p()
        name = ctypes.create_string_buffer(96)
        if lib.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(handle)) != 0 \
                or lib.nvmlDeviceGetName(handle, name, len(name)) != 0:
            return None
        return name.value.decode() or None
    finally:
        lib.nvmlShutdown()


def gpu_model(proc_root: str = "/proc",
              minors: Optional[List[int]] = None) -> Optional[str]:
    """The `Model` of the lowest-minor card the driver describes (of
    `minors` where given).  Where it describes none (a container may hide
    `/proc/driver/nvidia/gpus`) and `proc_root` is the live `/proc`, the
    live driver is asked through NVML; a fake root is never."""
    cards = driver_cards(proc_root)
    wanted = [m for m in sorted(cards) if cards[m].get("Model")
              and (minors is None or m in minors)]
    if wanted:
        return cards[wanted[0]]["Model"]
    return nvml_model() if os.path.abspath(proc_root) == "/proc" else None


def _host_cpu_memory() -> Dict[str, float]:
    pages = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return {"CPU": float(os.cpu_count() or 1), "memory": float(pages)}


def detect_node_resources(
        dev_root: str = "/dev",
        env: Optional[Dict[str, str]] = None,
        proc_root: str = "/proc") -> Dict[str, float]:
    """{"CPU": n, "memory": bytes, "GPU": cards?, "accelerator_type:<model>":
    1?} for this host."""
    env = dict(os.environ if env is None else env)
    override = env.get("TIK_NODE_RESOURCES")
    if override:
        try:
            parsed = json.loads(override)
            return {str(k): float(v) for k, v in parsed.items()}
        except (ValueError, TypeError, AttributeError):
            pass
    resources = _host_cpu_memory()
    cards = detect_gpu_cards(dev_root, env, proc_root)
    if cards:
        resources["GPU"] = float(cards)
        model = gpu_model(proc_root, card_minors(dev_root))
        if model:
            resources[accelerator_key(model)] = 1.0
    return resources


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m cloudtik_tpu_torch.utils.resource_spec",
        description="Print this host's resources as the JSON that "
                    "TIK_NODE_RESOURCES takes.")
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--proc-root", default="/proc")
    args = p.parse_args(argv)
    print(json.dumps(detect_node_resources(args.dev_root, None,
                                           args.proc_root), sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
