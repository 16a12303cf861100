"""prefill_us_per_token.batch: the card's time a prompt token computed
in prefill, in us: 1e3 x the summed `device_ms` of the engine's
`serve.prefill` spans over their summed `chunk_len` (CUDA events around
each chunk's forward; program spans, read from the ring).  A chunk whose
events were never read (the engine stopped first) counts in neither."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.ring(record)
    if spans is None:
        return None
    timed = [s for s in spans if s["name"] == "serve.prefill"
             and s["attrs"].get("device_ms") is not None]
    tokens = sum(s["attrs"]["chunk_len"] for s in timed)
    if not tokens:
        return None
    return 1e3 * sum(s["attrs"]["device_ms"] for s in timed) / tokens
