"""decode_device_ms.chat: the mean `device_ms` of the engine's
`serve.decode_step` spans (CUDA events around the step's launches: the
card's time from its first kernel to its last) over the window (program
spans, read from the ring)."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.ring(record)
    if spans is None:
        return None
    return _spans.mean(_spans.values(spans, "serve.decode_step",
                                     "device_ms"))
