"""tpot_p95_ms: the 95th percentile, by nearest rank over every request
due in the window, of (done - first token) / (tokens - 1) (host clock).
The engine stamps no single token, so this is per request."""

from portbench.metrics._util import nearest_rank


def read(record):
    if record.get("kind") != "serve" or record.get("loop") != "open":
        return None
    vals = [(r["done"] - r["first"]) * 1e3 / (r["n_out"] - 1)
            if r["ok"] and r["n_out"] > 1 else float("inf")
            for r in record["requests"]]
    return nearest_rank(vals, 0.95)
