"""flash_roofline.train: the summed least times of B1-B3 (arith/attention,
at the step's shapes, times the launches the trace holds) over the summed
device time of the kernels of those names (device trace)."""

from portbench.arith import attention
from portbench.arith.kernel_kinds import kind


def read(record):
    p = record.get("profile")
    if not p or record.get("kind") != "train":
        return None
    a = record["attention"]
    shape = (a["B"], a["H"], a["Hkv"], a["S"], a["D"])
    bound = {"flash_fwd": attention.fwd_bound(*shape)["bound_ms"]}
    bwd = attention.bwd_bounds(*shape)
    bound["flash_bwd_dq"] = bwd["dq"]["bound_ms"]
    bound["flash_bwd_dkv"] = bwd["dkv"]["bound_ms"]
    need_ms, took_s = 0.0, 0.0
    for name, k in p["kernels"].items():
        kk = kind(name)
        if kk in bound:
            need_ms += bound[kk] * k["count"]
            took_s += k["seconds"]
    if took_s <= 0:
        return None
    return 100.0 * need_ms / 1e3 / took_s
