"""decode_launch_ms.chat: the mean duration, in ms, of the engine's
`serve.decode.launch` spans (the host's time to enqueue a decode step's
kernels) over the window (program spans, read from the ring)."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.ring(record)
    if spans is None:
        return None
    m = _spans.mean(_spans.values(spans, "serve.decode.launch", "dur"))
    return None if m is None else 1e3 * m
