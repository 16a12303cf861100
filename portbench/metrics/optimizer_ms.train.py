"""optimizer_ms.train: device time a step of the kernels launched inside
the Trainer's `train.optimizer` profiler range (device trace)."""


def read(record):
    p = record.get("profile")
    if not p or record.get("kind") != "train":
        return None
    r = p["ranges"].get("train.optimizer")
    if not r or r["count"] == 0 or r["device_s"] <= 0:
        return None
    return r["device_s"] * 1e3 / r["count"]
