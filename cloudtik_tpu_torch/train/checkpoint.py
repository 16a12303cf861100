"""Checkpoint save, resume and restore of the trainer's state.

Counterpart of `cloudtik_tpu/train/checkpoint.py`: `CheckpointConfig` with
the reference's fields and defaults, and `Checkpointer` with its contracts:
a save starts on the interval (orbax's `should_save`) or when forced, fires
the `checkpoint.save` fault seam (whose torn-write directive tears the step
it just committed), keeps `max_to_keep` steps plus every `keep_period`-th,
and with `offload_d2h` costs the step loop only an on-device snapshot;
`wait` and `close` run under deadlines; `restore(partial=True)` reads only
the subtrees it is handed; `restore_latest_good` walks past unreadable
steps.  The same metrics, events, spans and goodput buckets.

The on-disk format is this package's own (orbax needs JAX), one directory
per committed step:

    <directory>/<step>/manifest.json   the step's table of contents
    <directory>/<step>/<i>.bin         leaf i's raw bytes, C order

`manifest.json` is {"format": FORMAT, "step": N, "leaves": [...]}.  Each
entry names the leaf's tree `path` (dict keys as strings, list and tuple
indices as ints) and either its `value` (a Python number, such as AdamW's
step count) or the tensor's `file`, `dtype` (torch's name: "bfloat16"
included), `shape` and `nbytes`.  A step is written into
`<step>.tmp-<hex>`, every file fsynced, the manifest last, and renamed into
place: a directory without its manifest is not a step, and a leaf file
whose length is not its manifest's makes `restore` raise, so a torn step
never restores short data.  `tools/import_jax_checkpoint.py` turns the JAX
package's orbax checkpoints into this format.

On the card the offloaded save clones each leaf on the step's stream (so
the in-place update of the next step cannot change it), and a worker
thread copies the clone into page-locked host buffers on a side stream
that waits on an event recorded after the clone; the write follows from
those buffers.  The buffers are kept across saves, and `reserve` pins
them before a fit's first step: pinning gigabytes takes seconds, and the
launches of a step that runs beside it wait for it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import DIRECTIVE_TORN_WRITE
from cloudtik_tpu_torch.telemetry import events, goodput
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.tree import tree_unflatten
from cloudtik_tpu_torch.utils.retry import run_with_deadline

logger = logging.getLogger(__name__)

FORMAT = "tik-torch-checkpoint/1"
MANIFEST = "manifest.json"

Path = Tuple[Any, ...]


@dataclasses.dataclass
class CheckpointConfig:
    directory: str = ""
    max_to_keep: int = 3
    save_interval_steps: int = 1000
    # Write in the background (the worker thread); False writes in save().
    async_save: bool = True
    # Keep one checkpoint every N steps forever (0 = disabled), on top of
    # the rolling max_to_keep window.
    keep_period: int = 0
    # Default deadline for wait()/close() (0 = block forever): past it the
    # wait gives up and journals tik_checkpoint_wait_timeout.
    wait_deadline_s: float = 0.0
    # save() pays only an on-device snapshot; the device->host copy and
    # the write run on the worker thread.  Sync saves and torn-write
    # drills take the in-line path.
    offload_d2h: bool = True


@dataclasses.dataclass
class _HostLeaf:
    """A tensor's bytes on the host (flat uint8), with its dtype and shape."""

    dtype: torch.dtype
    shape: Tuple[int, ...]
    data: torch.Tensor


def _flatten(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in `tree_leaves` order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint tree keys must be strings, "
                                f"got {k!r} at {prefix}")
            out += _flatten(v, prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor's bytes as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _ready_event(leaves) -> Optional["torch.cuda.Event"]:
    """An event after the work queued so far on the current stream of the
    leaves' card (None when no leaf is on a card)."""
    for _, leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaf.device))
            return event
    return None


class Checkpointer:
    """Async checkpoint manager for the trainer's state on one card."""

    def __init__(self, config: CheckpointConfig):
        if not config.directory:
            raise ValueError("CheckpointConfig.directory is required")
        self.config = config
        # created by the first save: a reader (the server) leaves no trace
        self.directory = os.path.abspath(
            os.path.expanduser(config.directory))
        # the newest step a save started: should_save counts it before
        # its directory lands, as orbax counts a save in flight
        self._staged: Optional[int] = None
        # the worker thread: offloaded d2h copies and background writes
        self._d2h_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._d2h_thread: Optional[threading.Thread] = None
        self._d2h_lock = threading.Lock()
        self._d2h_pending = 0
        self._d2h_done = threading.Condition(self._d2h_lock)
        self._d2h_error: Optional[BaseException] = None
        # page-locked host buffers by leaf index, reused across saves:
        # allocating gigabytes of them per save would cost seconds
        self._pinned: Dict[int, torch.Tensor] = {}
        self._copy_stream = None

    # -- save --------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        """orbax's default decision: never at or before the newest step,
        else on the interval, or when there is no checkpoint yet."""
        steps = self.all_steps()
        newest = max(steps + ([self._staged] if self._staged is not None
                              else []), default=None)
        if newest is not None and newest >= step:
            return False
        return step % self.config.save_interval_steps == 0 or newest is None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save `state` (nested dicts and lists of tensors and Python
        numbers) at `step`; returns True if a save started.

        With ``offload_d2h`` (and async saves) the call stages an
        on-device snapshot and returns: the device->host copy and the
        write happen on the worker thread, and durability is what
        ``wait()`` means.  A background failure is raised again at the
        next ``save()``, ``wait()`` or ``close()``."""
        self._reraise_d2h_error()
        # fire the seam only for saves that will start: a skipped call
        # must not consume a scheduled fault's budget
        if not (force or self.should_save(step)):
            return False
        directive = seams.fire("checkpoint.save", step=step,
                               directory=self.config.directory)
        offload = (self.config.async_save and self.config.offload_d2h
                   and directive != DIRECTIVE_TORN_WRITE)
        if not offload:
            self._save_inline(step, state,
                              torn=directive == DIRECTIVE_TORN_WRITE)
            self._note_staged(step)
            if directive == DIRECTIVE_TORN_WRITE:
                # the step LOOKS committed (listed by latest_step) but its
                # data is truncated: what a host dying between the data
                # write and the flush leaves behind
                self.wait()
                self._tear_step(step)
            return True
        t0 = time.perf_counter()
        with telemetry.span("checkpoint.save", step=step,
                            async_save=True, offload=True, part="snapshot"):
            # the previous save must be durable before the next stages:
            # when save(N) returns, save(N-1) is committed and readable
            self._d2h_join()
            self._reraise_d2h_error()
            snapshot = self._device_snapshot(_flatten(state))
            self._enqueue(step, snapshot, on_device=True)
        self._note_staged(step)
        dt = time.perf_counter() - t0
        ti.CHECKPOINT_SAVE_SECONDS.observe(dt)
        goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE, dt)
        return True

    def _note_staged(self, step: int) -> None:
        self._staged = step if self._staged is None \
            else max(self._staged, step)

    def _save_inline(self, step: int, state: Any, torn: bool) -> None:
        """The device->host copy in the caller; the write too for sync
        saves and the torn-write drill, else on the worker."""
        t0 = time.perf_counter()
        compile_marker = goodput.LEDGER.total(goodput.BUCKET_COMPILE)
        background = self.config.async_save and not torn
        with telemetry.span("checkpoint.save", step=step,
                            async_save=background, offload=False,
                            part="inline"):
            # the pinned buffers are the worker's until its save is done
            self._d2h_join()
            self._reraise_d2h_error()
            leaves = _flatten(state)
            with telemetry.span("checkpoint.d2h", step=step):
                host = self._host_copy(leaves, _ready_event(leaves),
                                       owned=False)
            if background:
                self._enqueue(step, host, on_device=False)
            else:
                with telemetry.span("checkpoint.save", step=step,
                                    async_save=False, offload=False,
                                    part="write"):
                    self._write(step, host)
        dt = time.perf_counter() - t0
        ti.CHECKPOINT_SAVE_SECONDS.observe(dt)
        compiled = max(goodput.LEDGER.total(goodput.BUCKET_COMPILE)
                       - compile_marker, 0.0)
        goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE,
                          max(dt - compiled, 0.0))

    def reserve(self, state: Any) -> None:
        """Page-lock the host buffers that an offloaded save of `state`
        copies into, ahead of the step loop (the trainer calls it before
        a fit that will save).  A no-op when they are pinned already, for
        host tensors and without ``offload_d2h``."""
        if not (self.config.async_save and self.config.offload_d2h):
            return
        sizes = {i: leaf.numel() * leaf.element_size()
                 for i, (_, leaf) in enumerate(_flatten(state))
                 if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
        if all(i in self._pinned and self._pinned[i].numel() == n
               for i, n in sizes.items()):
            return
        t0 = time.perf_counter()
        with telemetry.span("checkpoint.reserve", leaves=len(sizes)):
            # the buffers are the worker's while a save runs
            self._d2h_join()
            for i, nbytes in sizes.items():
                self._pinned_buffer(i, nbytes)
        goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE,
                          time.perf_counter() - t0)

    def _pinned_buffer(self, i: int, nbytes: int) -> torch.Tensor:
        """Leaf i's page-locked buffer of `nbytes`, kept across saves."""
        buf = self._pinned.get(i)
        if buf is None or buf.numel() != nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pinned[i] = buf
        return buf

    # -- the worker thread -------------------------------------------------
    def _device_snapshot(self, leaves) -> tuple:
        """Clones of the tensor leaves on their own devices, queued on the
        current stream before the next step's in-place update, and an
        event recorded after them."""
        with torch.no_grad():
            snapshot = [(p, leaf.detach().clone()
                         if isinstance(leaf, torch.Tensor) else leaf)
                        for p, leaf in leaves]
        return snapshot, _ready_event(snapshot)

    def _enqueue(self, step: int, leaves, on_device: bool) -> None:
        with self._d2h_lock:
            self._d2h_pending += 1
        if self._d2h_thread is None:
            self._d2h_thread = threading.Thread(
                target=self._d2h_worker, name="tik-checkpoint-d2h",
                daemon=True)
            self._d2h_thread.start()
        self._d2h_queue.put((step, leaves, on_device))

    def _d2h_worker(self) -> None:
        while True:
            item = self._d2h_queue.get()
            if item is None:
                return
            step, leaves, on_device = item
            item = None
            try:
                if on_device:
                    t0 = time.perf_counter()
                    with telemetry.span("checkpoint.d2h", step=step):
                        snapshot, ready = leaves
                        leaves = self._host_copy(snapshot, ready,
                                                 owned=True)
                        # the device snapshot goes as soon as it is copied
                        del snapshot, ready
                    dt = time.perf_counter() - t0
                    ti.CHECKPOINT_D2H_SECONDS.observe(dt)
                    goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE, dt)
                t1 = time.perf_counter()
                with telemetry.span("checkpoint.save", step=step,
                                    async_save=True, offload=on_device,
                                    part="write"):
                    self._write(step, leaves)
                goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE,
                                  time.perf_counter() - t1)
            except BaseException as e:
                logger.warning("background checkpoint save of step %d "
                               "failed", step, exc_info=True)
                with self._d2h_lock:
                    self._d2h_error = e
            finally:
                leaves = None
                with self._d2h_done:
                    self._d2h_pending -= 1
                    self._d2h_done.notify_all()

    def _host_copy(self, leaves, ready, owned: bool) -> list:
        """The leaves with every tensor's bytes on the host.  A card's
        tensors go into the reused page-locked buffers on a side stream
        that first waits on `ready`; a host tensor is cloned unless it is
        `owned` (a snapshot nobody else updates)."""
        out: list = []
        copies = []
        for i, (path, leaf) in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                out.append((path, leaf))
                continue
            if not leaf.is_cuda:
                t = leaf.detach()
                t = t.contiguous() if owned else t.clone(
                    memory_format=torch.contiguous_format)
                out.append((path, _HostLeaf(t.dtype, tuple(t.shape),
                                            _as_bytes(t))))
                continue
            buf = self._pinned_buffer(i, leaf.numel() * leaf.element_size())
            copies.append((leaf, buf))
            out.append((path, _HostLeaf(leaf.dtype, tuple(leaf.shape), buf)))
        if copies:
            device = copies[0][0].device
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device)
            stream = self._copy_stream
            stream.wait_event(ready)
            with torch.cuda.stream(stream), torch.no_grad():
                for leaf, buf in copies:
                    dst = buf.view(leaf.dtype).view(leaf.shape)
                    dst.copy_(leaf, non_blocking=True)
            stream.synchronize()
        return out

    # -- the format --------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, host_leaves) -> None:
        """Write one step under a temporary name, fsync it, rename it into
        place, then apply retention."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            if os.path.exists(final):
                raise FileExistsError(
                    f"checkpoint step {step} already exists at {final}")
            os.makedirs(tmp)   # and the directory, at the first save
            entries = []
            for i, (path, leaf) in enumerate(host_leaves):
                if not isinstance(leaf, _HostLeaf):
                    if not isinstance(leaf, (int, float, bool, str,
                                             type(None))):
                        raise TypeError(f"checkpoint leaf at {path} is a "
                                        f"{type(leaf).__name__}")
                    entries.append({"path": list(path), "value": leaf})
                    continue
                name = f"{i}.bin"
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(memoryview(leaf.data.numpy()))
                    f.flush()
                    os.fsync(f.fileno())
                entries.append({"path": list(path), "file": name,
                                "dtype": _dtype_name(leaf.dtype),
                                "shape": list(leaf.shape),
                                "nbytes": leaf.data.numel()})
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump({"format": FORMAT, "step": step,
                           "leaves": entries}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            ti.CHECKPOINT_SAVES.inc(result="failed")
            events.emit("tik_checkpoint_commit", step=step,
                        result="failed", directory=self.config.directory)
            raise
        ti.CHECKPOINT_SAVES.inc(result="ok")
        events.emit("tik_checkpoint_commit", step=step, result="ok",
                    directory=self.config.directory)
        self._apply_retention()

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.config.max_to_keep:]) \
            if self.config.max_to_keep else set(steps)
        if self.config.keep_period:
            keep |= {s for s in steps if s % self.config.keep_period == 0}
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _tear_step(self, step: int) -> None:
        """Truncate the largest leaf file of a committed step in place."""
        root = self._step_dir(step)
        largest, largest_size = None, -1
        for name in os.listdir(root):
            if name == MANIFEST:
                continue
            path = os.path.join(root, name)
            size = os.path.getsize(path)
            if size > largest_size:
                largest, largest_size = path, size
        if largest is None:
            return
        with open(largest, "r+b") as f:
            f.truncate(max(largest_size // 2, 1))
        logger.warning("torn-write fault: truncated %s (%d -> %d bytes)",
                       largest, largest_size, max(largest_size // 2, 1))

    # -- waiting -----------------------------------------------------------
    def _d2h_join(self) -> None:
        with self._d2h_done:
            while self._d2h_pending > 0:
                self._d2h_done.wait(timeout=0.5)

    def _reraise_d2h_error(self) -> None:
        with self._d2h_lock:
            error, self._d2h_error = self._d2h_error, None
        if error is not None:
            raise RuntimeError(
                "background checkpoint save failed") from error

    def wait(self, deadline_s: Optional[float] = None) -> bool:
        """Block until every save started is durable.  ``deadline_s``
        (else the config's ``wait_deadline_s``; 0/None = unbounded) caps
        the wait: past it a ``tik_checkpoint_wait_timeout`` event is
        journaled and False returned."""
        finished = self._bounded(self._d2h_join, deadline_s, op="wait")
        self._reraise_d2h_error()
        return finished

    def close(self, deadline_s: Optional[float] = None) -> bool:
        """Drain the saves and stop the worker, under the same deadline
        discipline as :meth:`wait`.  Returns True when the close
        completed, False on deadline."""
        def _close_all():
            self._d2h_join()
            thread, self._d2h_thread = self._d2h_thread, None
            if thread is not None:
                self._d2h_queue.put(None)
                thread.join()

        finished = self._bounded(_close_all, deadline_s, op="close")
        # a background save that failed must not vanish at teardown
        self._reraise_d2h_error()
        return finished

    def _bounded(self, fn, deadline_s: Optional[float], op: str) -> bool:
        deadline_s = self.config.wait_deadline_s \
            if deadline_s is None else deadline_s
        finished, _result = run_with_deadline(
            fn, deadline_s or 0.0, name=f"tik-checkpoint-{op}")
        if not finished:
            logger.warning(
                "checkpoint %s still running after %.1fs deadline; "
                "proceeding without it (wedged save thread?)",
                op, deadline_s)
            events.emit("tik_checkpoint_wait_timeout", op=op,
                        deadline_s=deadline_s,
                        directory=self.config.directory)
        return finished

    # -- restore -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed steps, oldest first: directories named by an integer
        that hold a manifest."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
            os.path.join(self.directory, n, MANIFEST)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                partial: bool = False,
                device: Optional[torch.device] = None) -> Any:
        """The saved state in the structure of `state_like`.

        `state_like`'s tensor leaves give each restored leaf's shape
        (which must match) and dtype (the saved data is cast to it, as
        orbax casts to its template's); its number leaves are
        placeholders.  Leaves go to `device`, else to the like-leaf's
        own device (the CPU for a "meta" one).  With `partial=True`,
        `state_like` may name some subtrees of the saved state only
        (e.g. {"params": ...} out of a trainer's {"params",
        "opt_state"}), and only their files are read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.config.directory}")
        t0 = time.perf_counter()
        compile_marker = goodput.LEDGER.total(goodput.BUCKET_COMPILE)
        try:
            with telemetry.span("checkpoint.restore", step=step,
                                partial=partial):
                return self._read(step, state_like, partial, device)
        finally:
            # a FAILED attempt (a torn step restore_latest_good walks
            # past) is restore work too
            dt = time.perf_counter() - t0
            ti.CHECKPOINT_RESTORE_SECONDS.observe(dt)
            compiled = max(goodput.LEDGER.total(goodput.BUCKET_COMPILE)
                           - compile_marker, 0.0)
            goodput.attribute(goodput.BUCKET_CHECKPOINT_RESTORE,
                              max(dt - compiled, 0.0))

    def _read(self, step: int, state_like: Any, partial: bool,
              device: Optional[torch.device]) -> Any:
        root = self._step_dir(step)
        with open(os.path.join(root, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{root}: not a {FORMAT} checkpoint "
                             f"(format {manifest.get('format')!r})")
        entries = {tuple(e["path"]): e for e in manifest["leaves"]}
        like = _flatten(state_like)
        missing = [p for p, _ in like if p not in entries]
        if missing:
            raise KeyError(f"checkpoint step {step} under "
                           f"{self.config.directory} has no leaf at "
                           f"{missing[:3]}")
        if not partial and len(like) != len(entries):
            extra = sorted(set(entries) - {p for p, _ in like},
                           key=str)[:3]
            raise ValueError(
                f"checkpoint step {step} holds leaves state_like does not "
                f"name ({extra} ...); restore(partial=True) reads a "
                "subtree")
        # every named file's length first: a torn step fails before a
        # byte of it is read
        for p, _ in like:
            _check_length(root, entries[p])
        values = [_read_leaf(root, entries[p], leaf, device)
                  for p, leaf in like]
        return tree_unflatten(state_like, values)

    def restore_latest_good(self, state_like: Any, partial: bool = False,
                            remove_unreadable: bool = False,
                            device: Optional[torch.device] = None
                            ) -> Optional[tuple]:
        """(state, step) of the newest checkpoint that reads back.

        Walks the steps newest first and skips any that fail to restore
        (a torn write).  Returns None only when there is NO checkpoint;
        when checkpoints exist but none restores, the failure is systemic
        (storage, a mismatched tree), so it raises rather than let the
        caller restart from step 0.  ``remove_unreadable=True`` deletes
        each skipped step once an older one restores, so a re-run can
        commit that step again."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        last_error: Optional[Exception] = None
        unreadable: list = []
        for step in steps:
            try:
                restored = self.restore(state_like, step=step,
                                        partial=partial, device=device)
            except Exception as e:
                last_error = e
                unreadable.append(step)
                logger.warning(
                    "checkpoint step %d unreadable (torn write?); "
                    "falling back to the previous committed step",
                    step, exc_info=True)
                continue
            if remove_unreadable:
                for bad in unreadable:
                    shutil.rmtree(self._step_dir(bad), ignore_errors=True)
                    logger.warning(
                        "removed unreadable checkpoint step %d so the "
                        "re-run can commit it again", bad)
            return restored, step
        raise RuntimeError(
            f"none of the {len(steps)} checkpoints under "
            f"{self.config.directory} could be restored; refusing to "
            "silently restart from scratch") from last_error


def _check_length(root: str, entry: Dict[str, Any]) -> None:
    if "value" in entry:
        return
    path = os.path.join(root, entry["file"])
    size = os.path.getsize(path)
    if size != int(entry["nbytes"]):
        raise ValueError(f"{path} holds {size} bytes, its manifest says "
                         f"{entry['nbytes']} (torn write?)")


def _read_leaf(root: str, entry: Dict[str, Any], like: Any,
               device: Optional[torch.device]) -> Any:
    if "value" in entry:
        return entry["value"]
    path = os.path.join(root, entry["file"])
    nbytes = int(entry["nbytes"])
    shape = tuple(entry["shape"])
    if isinstance(like, torch.Tensor) and tuple(like.shape) != shape:
        raise ValueError(f"{path}: saved shape {shape}, state_like's "
                         f"{tuple(like.shape)}")
    buf = torch.empty(nbytes, dtype=torch.uint8)
    with open(path, "rb") as f:
        got = f.readinto(memoryview(buf.numpy()))
    if got != nbytes:
        raise ValueError(f"{path}: read {got} of {nbytes} bytes")
    t = buf.view(getattr(torch, entry["dtype"])).reshape(shape)
    if isinstance(like, torch.Tensor):
        dev = device if device is not None else (
            like.device if like.device.type != "meta"
            else torch.device("cpu"))
        return t.to(device=dev, dtype=like.dtype)
    return t if device is None else t.to(device)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def restore_params(directory: str, like: Any,
                   device: Optional[torch.device] = None) -> Any:
    """The "params" subtree of the newest checkpoint under `directory` (a
    trainer's {"params", "opt_state"} or the LoRA trainer's {"params"}),
    in the shapes and dtypes of `like`, on `device`: a partial restore,
    so no optimizer file is read."""
    ckpt = Checkpointer(CheckpointConfig(directory=directory))
    try:
        return ckpt.restore({"params": like}, partial=True,
                            device=device)["params"]
    finally:
        ckpt.close()
