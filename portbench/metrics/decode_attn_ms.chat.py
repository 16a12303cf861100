"""decode_attn_ms.chat: the mean `attn_device_ms` of the engine's
`serve.decode_step` spans (CUDA events around each layer's paged
attention, K/V scatter through the weighted sum, summed over the layers)
over the window (program spans, read from the ring)."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.ring(record)
    if spans is None:
        return None
    return _spans.mean(_spans.values(spans, "serve.decode_step",
                                     "attn_device_ms"))
