"""queue_wait_ms.chat: the mean over the window's requests of the engine's
admission stamp (`Request.admitted_mono`) minus when the request was due
(program stamps, host clock)."""


def read(record):
    if record.get("kind") != "serve":
        return None
    waits = [(r["admitted"] - r["due"]) * 1e3 for r in record["requests"]
             if r["admitted"] is not None]
    return sum(waits) / len(waits) if waits else None
