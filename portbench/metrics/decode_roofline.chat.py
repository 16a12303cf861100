"""decode_roofline.chat: the bytes the window's decode steps need at the
card's published bandwidth, over the summed duration of the engine's
`serve.decode_step` spans (each ends after the step's host sync).  A step
needs the weights and the LM head once, each lane's embedding row and
f32 logits, and each decoded token's K/V over its real context
(arith/model.py); the K/V is summed over the requests' decode steps."""

from portbench.arith import model
from portbench.arith.peaks import peak_bytes


def read(record):
    spans = [s for s in record.get("spans") or []
             if s["name"] == "serve.decode_step"]
    if not spans or record.get("kind") != "serve":
        return None
    t = record["transformer"]
    slots = record.get("slots", 0)
    step = model.decode_step_bytes(t, []) + 4 * t["vocab_size"] * slots
    kv = model.kv_bytes_per_token(t)
    decoded = sum(kv * sum(r["prompt_len"] + j - 1
                           for j in range(2, r["n_out"] + 1))
                  for r in record["requests"] if r["first"] is not None)
    busy = sum(s["dur"] for s in spans)
    return 100.0 * (step * len(spans) + decoded) / peak_bytes(
        record["peak_kind"]) / busy
