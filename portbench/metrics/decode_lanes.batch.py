"""decode_lanes.batch: the mean `active` attribute of the engine's
`serve.decode_step` spans over the window (program spans)."""


def read(record):
    lanes = [s["active"] for s in record.get("spans") or []
             if s["name"] == "serve.decode_step" and s["active"] is not None]
    return sum(lanes) / len(lanes) if lanes else None
