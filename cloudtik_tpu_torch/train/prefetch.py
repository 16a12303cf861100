"""Async input pipeline: bounded background prefetch with the host->device
copy off the step loop.

Counterpart of `cloudtik_tpu/train/prefetch.py`, with its contracts (the
CPU tests hold them): producer threads pull host batches from any iterator
and hand the step loop device-resident batches through a bounded depth-k
queue;

  * batches reach the consumer in exactly iterator order, even with
    several producer threads (sequence-numbered turn-taking);
  * a producer exception re-raises at the consumer's ``next()``;
  * iterator exhaustion drains the queue, then raises StopIteration;
  * ``max_items`` caps what is pulled from the source, so read-ahead
    never eats batches meant for the next fit on the same iterator;
  * :meth:`Prefetcher.close` stops producers and joins them with a
    timeout.

On the card a producer puts each numpy leaf into page-locked host memory
and copies it to the device with ``non_blocking=True`` on a side stream of
its own, then records an event.  The consumer's stream waits on that event
before the batch is handed over, and each tensor is marked used on the
consumer's stream (``record_stream``), so the caching allocator does not
hand its memory to the next batch's copy while the step still reads it.
There is no synchronous fallback: a `device` on a card that is absent
raises.

Fault seam: every consumer ``next()`` fires ``train.prefetch.next``, so a
chaos plan can stretch the hand-off and the goodput ledger books it as
``data_wait``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from cloudtik_tpu_torch.device import DeviceLike
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.telemetry import core as tcore
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.tree import tree_leaves, tree_map

logger = logging.getLogger(__name__)

DEFAULT_DEPTH = 2          # double-buffered
_POLL_S = 0.1              # stop-flag poll cadence for blocking waits

_END = object()            # source exhausted; emitted after the last batch


class _Raised:
    """A producer-side exception, queued for re-raise at next()."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _InFlight:
    """A batch whose copy was queued on a producer's stream, and the event
    recorded after it."""

    __slots__ = ("batch", "event")

    def __init__(self, batch: Any, event: "torch.cuda.Event"):
        self.batch = batch
        self.event = event


# ---------------------------------------------------------------- helpers --

def is_device_resident(batch: Any, device: torch.device) -> bool:
    """True when every leaf is a tensor already on `device`: a second copy
    would be a wasted host->device round."""
    leaves = tree_leaves(batch)
    return bool(leaves) and all(
        isinstance(leaf, torch.Tensor) and leaf.device == device
        for leaf in leaves)


def put_device_batch(batch: Any, device: Optional[torch.device],
                     stream: Optional["torch.cuda.Stream"] = None) -> Any:
    """`batch` (numpy arrays or tensors) moved to `device`, unless it is
    already there.  On a card the leaves go through page-locked memory and
    are copied with ``non_blocking=True`` on `stream` (default: the current
    stream)."""
    if device is None or is_device_resident(batch, device):
        return batch

    def to_host(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(leaf))
        return t.pin_memory() if device.type == "cuda" and not t.is_cuda \
            else t

    host = tree_map(to_host, batch)
    if device.type != "cuda":
        return tree_map(lambda t: t.to(device), host)
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        return tree_map(lambda t: t.to(device, non_blocking=True), host)


def _note_put(stall_s: float, qsize: int, is_batch: bool = True) -> None:
    """Producer-side instrumentation (single attribute check when
    telemetry is off).  `is_batch` is False for the exhaustion/error
    sentinels, which stall like batches but must not count as one."""
    if not tcore.STATE.enabled:
        return
    ti.TRAIN_PREFETCH_PRODUCER_STALL.observe(stall_s)
    ti.TRAIN_PREFETCH_QUEUE_DEPTH.set(qsize)
    if is_batch:
        ti.TRAIN_PREFETCH_BATCHES.inc()


def _note_get(wait_s: float, qsize: int) -> None:
    """Consumer-side instrumentation (single attribute check when
    telemetry is off)."""
    if not tcore.STATE.enabled:
        return
    ti.TRAIN_PREFETCH_CONSUMER_WAIT.observe(wait_s)
    ti.TRAIN_PREFETCH_QUEUE_DEPTH.set(qsize)


# ------------------------------------------------------------- prefetcher --

class Prefetcher(Iterator[Any]):
    """Bounded multi-threaded background prefetcher.

    source:   any iterator of host batches (trees of numpy arrays or
              tensors).
    device:   where the consumer wants its batches; the copy runs on the
              producer threads.  None = pass-through (pure read-ahead).
    depth:    queue capacity in batches (default 2, double-buffered).
    threads:  producer thread count.  The source is pulled under a lock
              (iterators are not thread-safe), so extra threads overlap
              only the copy stage.
    max_items: pull at most this many batches from the source, then
              behave as exhausted (the trainer passes `num_steps`).
    """

    def __init__(self, source: Iterator[Any], device: DeviceLike = None,
                 depth: int = DEFAULT_DEPTH, threads: int = 1,
                 max_items: Optional[int] = None,
                 join_timeout_s: float = 5.0, name: str = "tik-prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if threads < 1:
            raise ValueError(f"prefetch threads must be >= 1, "
                             f"got {threads}")
        self._source = source
        self._device = None if device is None else torch.device(device)
        # one side stream per producer: created here, so a card that is
        # absent raises now instead of falling back to synchronous copies
        self._streams = [torch.cuda.Stream(self._device)
                         for _ in range(threads)] \
            if self._device is not None and self._device.type == "cuda" \
            else [None] * threads
        self._max_items = None if max_items is None else int(max_items)
        self._join_timeout_s = float(join_timeout_s)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._source_lock = threading.Lock()
        self._order = threading.Condition()
        self._pull_turn = 0        # next sequence number to pull
        self._emit_turn = 0        # next sequence number to enqueue
        self._stop = threading.Event()
        self._done = threading.Event()   # source exhausted or errored
        self._finished = False           # consumer saw END/error
        self._closed = False
        self._threads = [
            threading.Thread(target=self._produce, args=(stream,),
                             daemon=True, name=f"{name}-{i}")
            for i, stream in enumerate(self._streams)]
        for t in self._threads:
            t.start()

    # -- producer side ---------------------------------------------------
    def _produce(self, stream) -> None:
        try:
            while not self._stop.is_set():
                sentinel = None
                with self._source_lock:
                    if self._done.is_set():
                        return
                    turn = self._pull_turn
                    if (self._max_items is not None
                            and turn >= self._max_items):
                        self._done.set()
                        sentinel = _END
                    else:
                        try:
                            item = next(self._source)
                        except StopIteration:
                            self._done.set()
                            sentinel = _END
                        except BaseException as e:
                            self._done.set()
                            sentinel = _Raised(e)
                        else:
                            self._pull_turn = turn + 1
                if sentinel is not None:
                    self._emit(turn, sentinel)
                    return
                try:
                    item = put_device_batch(item, self._device, stream)
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                        item = _InFlight(item, event)
                except BaseException as e:
                    self._done.set()
                    self._emit(turn, _Raised(e))
                    return
                if not self._emit(turn, item):
                    return
        except BaseException:      # pragma: no cover - backstop only
            logger.exception("prefetch producer died unexpectedly")
            self._done.set()
            # unwind peers parked on this producer's turn and the
            # consumer's poll: stop is the flag every blocking wait checks
            self._stop.set()
            with self._order:
                self._order.notify_all()

    def _emit(self, turn: int, item: Any) -> bool:
        """Enqueue `item` at its sequence position.  Blocks (polling the
        stop flag) until it is this turn's time AND the bounded queue has
        room; the time blocked on the FULL QUEUE is the producer-stall
        histogram (waiting for a peer's earlier turn is not a stall)."""
        enabled = tcore.STATE.enabled
        with self._order:
            while self._emit_turn != turn:
                if self._stop.is_set():
                    return False
                self._order.wait(_POLL_S)
            t0 = time.perf_counter() if enabled else 0.0
            while True:
                if self._stop.is_set():
                    return False
                try:
                    self._q.put(item, timeout=_POLL_S)
                    break
                except queue.Full:
                    continue
            self._emit_turn = turn + 1
            self._order.notify_all()
        if enabled:
            _note_put(time.perf_counter() - t0, self._q.qsize(),
                      is_batch=item is not _END
                      and not isinstance(item, _Raised))
        return True

    # -- consumer side ---------------------------------------------------
    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        if self._closed:
            raise RuntimeError("prefetcher is closed")
        seams.fire("train.prefetch.next", qsize=self._q.qsize())
        enabled = tcore.STATE.enabled
        t0 = time.perf_counter() if enabled else 0.0
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError(
                        "prefetcher closed while waiting for a batch")
                if (self._done.is_set() and self._q.empty()
                        and not any(t.is_alive()
                                    for t in self._threads)):
                    # producers gone without their sentinel reaching the
                    # queue (closed mid-emit): treat as exhaustion
                    self._finished = True
                    raise StopIteration
        if item is _END:
            self._finished = True
            self.close()
            raise StopIteration
        if isinstance(item, _Raised):
            self._finished = True
            self.close()
            raise item.exc
        if isinstance(item, _InFlight):
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(item.event)
            for leaf in tree_leaves(item.batch):
                leaf.record_stream(consumer)
            item = item.batch
        # after the sentinel checks: the wait for the exhaustion/error
        # marker is not a batch wait
        if enabled:
            _note_get(time.perf_counter() - t0, self._q.qsize())
        return item

    @property
    def qsize(self) -> int:
        return self._q.qsize()

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout_s: Optional[float] = None) -> bool:
        """Stop producers and join them.  Returns True when every
        producer thread exited within the timeout; a thread stuck in the
        source's ``next()`` is daemonic and left behind with a warning."""
        timeout_s = self._join_timeout_s if timeout_s is None \
            else float(timeout_s)
        self._closed = True
        self._stop.set()
        with self._order:
            self._order.notify_all()
        # unblock producers parked on a full queue
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        deadline = time.monotonic() + timeout_s
        joined = True
        for t in self._threads:
            t.join(max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                joined = False
        if not joined:
            logger.warning(
                "prefetch producer did not exit within %.1fs (source "
                "blocked in next()?); leaving daemon thread behind",
                timeout_s)
        return joined

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
