"""Device time on the port's spans: CUDA event pairs on the current stream.

A span that enqueues device work can carry the card's time for that work
as an attribute, in milliseconds (`device_ms` on `serve.decode_step` and
`serve.prefill`, `attn_device_ms` on `serve.decode_step`).  The owner
records a pair of timing events around the launches and reads the pair
only after a host sync it makes anyway, so timing adds no
synchronisation: `settle(timers, synced=True)` right after such a sync,
`settle(timers, synced=False)` elsewhere, which reads a pair only once
`Event.query()` says the stream has passed it.

What a pair measures: the time the stream took from its start event to
its end event, that is from the first kernel enqueued after the start to
the last one before the end, idle stretches inside included.  Where the
host enqueues slower than the card runs, the stream waits between
kernels and the pair counts the wait: beside the host's launch time
(`serve.decode.launch`) a device time close to it reads launch-bound, one
well above it device-bound.

With telemetry off no timer is made, so no event exists and no clock is
read.  On a device that keeps no times (the CPU) `event_maker` returns
None and the attributes stay None.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional


def event_maker(device) -> Optional[Callable[[], Any]]:
    """A maker of timing events on `device`'s current stream, or None
    where the device keeps no times."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch
    return functools.partial(torch.cuda.Event, enable_timing=True)


class DeviceTimer:
    """Event pairs on the current stream whose summed elapsed time, in
    ms, becomes `attrs[key]` once read (`settle`)."""

    __slots__ = ("_make", "_attrs", "_key", "_pairs", "_start")

    def __init__(self, make: Callable[[], Any], attrs: Dict[str, Any],
                 key: str):
        self._make = make
        self._attrs = attrs
        self._key = key
        self._pairs: List[tuple] = []
        self._start = None

    def begin(self) -> None:
        self._start = self._make()
        self._start.record()

    def end(self) -> None:
        end = self._make()
        end.record()
        self._pairs.append((self._start, end))

    def passed(self) -> bool:
        """Whether the stream has passed every pair's end event."""
        return all(end.query() for _, end in self._pairs)

    def read(self) -> None:
        """Set the attribute (left as it was when no pair closed: the
        work failed between the events)."""
        if self._pairs:
            self._attrs[self._key] = sum(
                start.elapsed_time(end) for start, end in self._pairs)


def settle(timers: List[DeviceTimer], synced: bool) -> List[DeviceTimer]:
    """Read the timers the stream has passed; return the others.
    `synced`: the caller has just waited for the stream, so all have."""
    left = []
    for timer in timers:
        if synced or timer.passed():
            timer.read()
        else:
            left.append(timer)
    return left
