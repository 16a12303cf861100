"""ttft_p95_ms: the 95th percentile, by nearest rank over every request
due in the window, of first token minus when the request was due (open
loop; host clock).  A request that failed or never finished is missing:
its latency is infinite."""

from portbench.metrics._util import nearest_rank


def read(record):
    if record.get("kind") != "serve" or record.get("loop") != "open":
        return None
    vals = [(r["first"] - r["due"]) * 1e3
            if r["ok"] and r["first"] is not None else float("inf")
            for r in record["requests"]]
    return nearest_rank(vals, 0.95)
