"""The port's own telemetry names, beside the reference's catalog.

`telemetry/names.py` is the reference's catalog, copied verbatim; the
spans and span attributes only the port emits are listed here.
docs/observability.md describes both.
"""

from typing import Dict

# spans the reference does not emit
SPANS: Dict[str, str] = {
    "checkpoint.reserve":   "page-lock the host buffers of an offloaded save",
    "serve.decode.prepare": "a decode step's host tensors built and uploaded",
    "serve.decode.launch":  "a decode step's kernels enqueued (host time)",
    "serve.decode.wait":    "the host blocked on a decode step's tokens",
}

# (span, attribute) -> what the port adds to a span of either catalog
SPAN_ATTRIBUTES: Dict[tuple, str] = {
    ("serve.decode_step", "device_ms"):
        "the card's time from the step's first kernel to its last, ms",
    ("serve.decode_step", "attn_device_ms"):
        "the card's time in each layer's paged attention, summed, ms",
    ("serve.decode_step", "paged_attn_launches"):
        "paged-attention kernel launches the step made (0 on the CPU)",
    ("serve.prefill", "device_ms"):
        "the card's time for the chunk's forward, ms",
}
