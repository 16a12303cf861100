"""The program's span ring, read in the run's own process (not a metric).

The serving runner copies only `serve.decode_step` into the record; the
readers of the engine's other spans and attributes take them from
`cloudtik_tpu_torch.telemetry.spans()`, which the runner resets before
the window.  Nothing is read unless the record is a traced serving run's
(its `spans` non-empty), nor when the ring overwrote spans.  A program
that lacks a span or attribute gives no value, and raises nothing."""

from typing import List, Optional


def ring(record) -> Optional[List[dict]]:
    if record.get("kind") != "serve" or not record.get("spans"):
        return None
    from cloudtik_tpu_torch import telemetry
    dropped = telemetry.REGISTRY.get("tik_spans_dropped_total")
    if dropped is None or dropped.value() > 0:
        return None
    return telemetry.spans()


def values(spans: List[dict], name: str, key: str) -> List[float]:
    """Attribute `key` of every `name` span that carries it (not None);
    `key` "dur" is the span's duration in seconds."""
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        v = s["dur"] if key == "dur" else s["attrs"].get(key)
        if v is not None:
            out.append(float(v))
    return out


def mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None
