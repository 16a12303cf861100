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

On a mesh every rank writes its own shard of a step (`save(...,
shard=ShardWrite)`), with no collective and no single writer:

    <directory>/<step>/shards-<token>/<r>.json    rank r's manifest
    <directory>/<step>/shards-<token>/<r>-<i>.bin its pieces' bytes

A rank writes the pieces no other rank holds before it (index 0 on every
mesh axis the leaf is replicated over; the trainer decides), and its
manifest lists each piece's leaf `path`, the leaf's whole `shape`, its
`dtype` and the `region` of the whole it holds ([start, stop) per
dimension); rank 0's lists the number leaves too.  The manifest is written
last and renamed into place.  `<token>` is one save's own, so shards of
two attempts at a step never mix.  A step counts as committed only when
all `shards` manifests of one token are in, and a missing or short shard
file makes the whole step unreadable on every rank alike (each restore
checks every shard's lengths, not just the pieces it reads).  A restore
into any placement (`restore(..., regions=)`) reads the pieces that
overlap each rank's region; without regions it assembles whole leaves, so
one rank restores a mesh's checkpoint and a mesh restores a one-card one.

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
import math
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


@dataclasses.dataclass(frozen=True)
class Region:
    """A block of a leaf: [start, stop) per dimension."""

    bounds: Tuple[Tuple[int, int], ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in self.bounds)


@dataclasses.dataclass
class ShardWrite:
    """One rank's part of a step saved from a mesh: its `rank` of `count`
    writers, the save's `token` (the same on every rank), and per index
    of the leaves it writes (in the order handed to `save`), the leaf's
    whole shape and the Region this rank holds."""

    rank: int
    count: int
    token: str
    pieces: Dict[int, Tuple[Tuple[int, ...], Region]]


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

    def save(self, step: int, state: Any, force: bool = False,
             shard: Optional[ShardWrite] = None) -> bool:
        """Save `state` (nested dicts and lists of tensors and Python
        numbers) at `step`; returns True if a save started.  With `shard`,
        `state` is this rank's list of (path, leaf) pairs: its pieces and,
        on rank 0, the number leaves.

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
        leaves = state if shard is not None else _flatten(state)
        if not offload:
            self._save_inline(step, leaves, shard,
                              torn=directive == DIRECTIVE_TORN_WRITE)
            self._note_staged(step)
            if directive == DIRECTIVE_TORN_WRITE:
                # the step LOOKS committed (listed by latest_step) but its
                # data is truncated: what a host dying between the data
                # write and the flush leaves behind
                self.wait()
                self._tear_step(step, shard)
            return True
        t0 = time.perf_counter()
        with telemetry.span("checkpoint.save", step=step,
                            async_save=True, offload=True, part="snapshot"):
            # the previous save must be durable before the next stages:
            # when save(N) returns, save(N-1) is committed and readable
            self._d2h_join()
            self._reraise_d2h_error()
            snapshot = self._device_snapshot(leaves)
            self._enqueue(step, snapshot, on_device=True, shard=shard)
        self._note_staged(step)
        dt = time.perf_counter() - t0
        ti.CHECKPOINT_SAVE_SECONDS.observe(dt)
        goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE, dt)
        return True

    def _note_staged(self, step: int) -> None:
        self._staged = step if self._staged is None \
            else max(self._staged, step)

    def _save_inline(self, step: int, leaves, shard: Optional[ShardWrite],
                     torn: bool) -> None:
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
            with telemetry.span("checkpoint.d2h", step=step):
                host = self._host_copy(leaves, _ready_event(leaves),
                                       owned=False)
            if background:
                self._enqueue(step, host, on_device=False, shard=shard)
            else:
                with telemetry.span("checkpoint.save", step=step,
                                    async_save=False, offload=False,
                                    part="write"):
                    self._write_any(step, host, shard)
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

    def _enqueue(self, step: int, leaves, on_device: bool,
                 shard: Optional[ShardWrite] = None) -> None:
        with self._d2h_lock:
            self._d2h_pending += 1
        if self._d2h_thread is None:
            self._d2h_thread = threading.Thread(
                target=self._d2h_worker, name="tik-checkpoint-d2h",
                daemon=True)
            self._d2h_thread.start()
        self._d2h_queue.put((step, leaves, on_device, shard))

    def _d2h_worker(self) -> None:
        while True:
            item = self._d2h_queue.get()
            if item is None:
                return
            step, leaves, on_device, shard = item
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
                    self._write_any(step, leaves, shard)
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

    def _write_any(self, step: int, host_leaves,
                   shard: Optional[ShardWrite]) -> None:
        if shard is None:
            self._write(step, host_leaves)
        else:
            self._write(step, host_leaves, shard)

    def _write(self, step: int, host_leaves,
               shard: Optional[ShardWrite] = None) -> None:
        """Write one step (or this rank's shard of it) and apply retention
        (the one writer, or shard rank 0)."""
        try:
            if shard is None:
                self._write_whole(step, host_leaves)
            else:
                self._write_shard(step, host_leaves, shard)
        except BaseException:
            ti.CHECKPOINT_SAVES.inc(result="failed")
            events.emit("tik_checkpoint_commit", step=step,
                        result="failed", directory=self.config.directory)
            raise
        ti.CHECKPOINT_SAVES.inc(result="ok")
        events.emit("tik_checkpoint_commit", step=step, result="ok",
                    directory=self.config.directory)
        if shard is None or shard.rank == 0:
            self._apply_retention()

    def _entries(self, folder: str, host_leaves, prefix: str,
                 shard: Optional[ShardWrite]) -> list:
        """Write each tensor leaf's bytes into `folder` (fsynced); the
        manifest entries."""
        entries = []
        for i, (path, leaf) in enumerate(host_leaves):
            if not isinstance(leaf, _HostLeaf):
                if not isinstance(leaf, (int, float, bool, str,
                                         type(None))):
                    raise TypeError(f"checkpoint leaf at {path} is a "
                                    f"{type(leaf).__name__}")
                entries.append({"path": list(path), "value": leaf})
                continue
            name = f"{prefix}{i}.bin"
            with open(os.path.join(folder, name), "wb") as f:
                f.write(memoryview(leaf.data.numpy()))
                f.flush()
                os.fsync(f.fileno())
            entry = {"path": list(path), "file": name,
                     "dtype": _dtype_name(leaf.dtype),
                     "shape": list(leaf.shape),
                     "nbytes": leaf.data.numel()}
            if shard is not None:
                shape, region = shard.pieces[i]
                entry.update(shape=list(shape),
                             region=[list(b) for b in region.bounds])
            entries.append(entry)
        return entries

    def _write_whole(self, step: int, host_leaves) -> None:
        """Write one step under a temporary name, fsync it, rename it into
        place."""
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            if os.path.exists(final):
                raise FileExistsError(
                    f"checkpoint step {step} already exists at {final}")
            os.makedirs(tmp)   # and the directory, at the first save
            entries = self._entries(tmp, host_leaves, "", None)
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
            raise

    def _write_shard(self, step: int, host_leaves,
                     shard: ShardWrite) -> None:
        """This rank's pieces into the save's shard folder, its manifest
        last under a temporary name, renamed into place."""
        folder = os.path.join(self._step_dir(step), f"shards-{shard.token}")
        os.makedirs(folder, exist_ok=True)
        entries = self._entries(folder, host_leaves, f"{shard.rank}-", shard)
        final = os.path.join(folder, f"{shard.rank}.json")
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            json.dump({"format": FORMAT, "step": step, "shard": shard.rank,
                       "shards": shard.count, "leaves": entries}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        _fsync_dir(folder)

    def _shard_set(self, step: int) -> Optional[str]:
        """The folder of a complete shard set of `step` (every manifest of
        its count in), or None."""
        root = self._step_dir(step)
        try:
            names = sorted(os.listdir(root))
        except (FileNotFoundError, NotADirectoryError):
            return None
        for name in names:
            if not name.startswith("shards-"):
                continue
            folder = os.path.join(root, name)
            try:
                with open(os.path.join(folder, "0.json")) as f:
                    count = int(json.load(f)["shards"])
            except (OSError, ValueError, KeyError):
                # rank 0's manifest not in yet, or torn: a torn one makes
                # the set incomplete on every rank alike
                if os.path.isfile(os.path.join(folder, "0.json")):
                    return folder
                continue
            if all(os.path.isfile(os.path.join(folder, f"{r}.json"))
                   for r in range(count)):
                return folder
        return None

    def _apply_retention(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.config.max_to_keep:]) \
            if self.config.max_to_keep else set(steps)
        if self.config.keep_period:
            keep |= {s for s in steps if s % self.config.keep_period == 0}
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _tear_step(self, step: int,
                   shard: Optional[ShardWrite] = None) -> None:
        """Truncate the largest leaf file of a committed step in place (of
        this rank's shard with `shard`; its manifest when it holds no
        piece)."""
        root = self._step_dir(step)
        prefix = ""
        if shard is not None:
            root = os.path.join(root, f"shards-{shard.token}")
            prefix = f"{shard.rank}-"
        largest, largest_size = None, -1
        for name in os.listdir(root):
            if name == MANIFEST or not name.startswith(prefix) \
                    or not name.endswith(".bin"):
                continue
            path = os.path.join(root, name)
            size = os.path.getsize(path)
            if size > largest_size:
                largest, largest_size = path, size
        if largest is None:
            if shard is None:
                return
            largest = os.path.join(root, f"{shard.rank}.json")
            largest_size = os.path.getsize(largest)
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
        that hold a manifest or a complete shard set."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and (
            os.path.isfile(os.path.join(self.directory, n, MANIFEST))
            or self._shard_set(int(n)) is not None))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                partial: bool = False,
                device: Optional[torch.device] = None,
                regions: Any = None) -> Any:
        """The saved state in the structure of `state_like`.

        `state_like`'s tensor leaves give each restored leaf's shape
        (which must match) and dtype (the saved data is cast to it, as
        orbax casts to its template's); its number leaves are
        placeholders.  Leaves go to `device`, else to the like-leaf's
        own device (the CPU for a "meta" one).  With `partial=True`,
        `state_like` may name some subtrees of the saved state only
        (e.g. {"params": ...} out of a trainer's {"params",
        "opt_state"}), and only their files are read.  `regions` (a tree
        like `state_like` of `Region`s, None for a whole leaf) restores
        each leaf's block only: a rank's shard in any placement, from a
        whole-leaf step or from the pieces of a sharded one."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.config.directory}")
        t0 = time.perf_counter()
        compile_marker = goodput.LEDGER.total(goodput.BUCKET_COMPILE)
        try:
            with telemetry.span("checkpoint.restore", step=step,
                                partial=partial):
                return self._read(step, state_like, partial, device,
                                  regions)
        finally:
            # a FAILED attempt (a torn step restore_latest_good walks
            # past) is restore work too
            dt = time.perf_counter() - t0
            ti.CHECKPOINT_RESTORE_SECONDS.observe(dt)
            compiled = max(goodput.LEDGER.total(goodput.BUCKET_COMPILE)
                           - compile_marker, 0.0)
            goodput.attribute(goodput.BUCKET_CHECKPOINT_RESTORE,
                              max(dt - compiled, 0.0))

    def _manifests(self, step: int) -> Tuple[str, List[Dict[str, Any]]]:
        """(folder, manifests) of a committed step: its one manifest, or
        every shard's (rank order) with each file's length checked first,
        so a torn shard fails the step on every rank."""
        root = self._step_dir(step)
        whole = os.path.join(root, MANIFEST)
        folder = root if os.path.isfile(whole) else self._shard_set(step)
        if folder is None:
            raise FileNotFoundError(f"checkpoint step {step} under "
                                    f"{self.config.directory} is not "
                                    "committed")
        if folder == root:
            names = [MANIFEST]
        else:
            with open(os.path.join(folder, "0.json")) as f:
                count = int(json.load(f)["shards"])
            names = [f"{r}.json" for r in range(count)]
        manifests = []
        for name in names:
            with open(os.path.join(folder, name)) as f:
                manifest = json.load(f)
            if manifest.get("format") != FORMAT:
                raise ValueError(f"{folder}: not a {FORMAT} checkpoint "
                                 f"(format {manifest.get('format')!r})")
            manifests.append(manifest)
        if folder != root:
            for manifest in manifests:
                for entry in manifest["leaves"]:
                    _check_length(folder, entry)
        return folder, manifests

    def _read(self, step: int, state_like: Any, partial: bool,
              device: Optional[torch.device], regions: Any = None) -> Any:
        root, manifests = self._manifests(step)
        pieces: Dict[Path, list] = {}
        for manifest in manifests:
            for e in manifest["leaves"]:
                pieces.setdefault(tuple(e["path"]), []).append(e)
        like = _flatten(state_like)
        missing = [p for p, _ in like if p not in pieces]
        if missing:
            raise KeyError(f"checkpoint step {step} under "
                           f"{self.config.directory} has no leaf at "
                           f"{missing[:3]}")
        if not partial and len(like) != len(pieces):
            extra = sorted(set(pieces) - {p for p, _ in like},
                           key=str)[:3]
            raise ValueError(
                f"checkpoint step {step} holds leaves state_like does not "
                f"name ({extra} ...); restore(partial=True) reads a "
                "subtree")
        # every named file's length first: a torn step fails before a
        # byte of it is read
        for p, _ in like:
            for e in pieces[p]:
                _check_length(root, e)
        wanted = dict(_flatten(regions)) if regions is not None else {}
        values = [_read_leaf(root, pieces[p], leaf, device, wanted.get(p))
                  for p, leaf in like]
        return tree_unflatten(state_like, values)

    def readable_steps(self) -> List[int]:
        """Committed steps, oldest first, whose manifests parse and whose
        every file has its manifest's length (no data is read)."""
        good = []
        for step in self.all_steps():
            try:
                root, manifests = self._manifests(step)
                for manifest in manifests:
                    for e in manifest["leaves"]:
                        _check_length(root, e)
            except (OSError, ValueError, KeyError):
                continue
            good.append(step)
        return good

    def rewind(self, step: int, remove: bool = False) -> None:
        """Forget the saves started after `step` (a run resumed there saves
        those steps again) and, with `remove`, delete the committed-looking
        steps after it (the unreadable ones a restore walked past)."""
        if self._staged is not None and self._staged > step:
            self._staged = None
        if not remove:
            return
        for bad in self.all_steps():
            if bad > step:
                shutil.rmtree(self._step_dir(bad), ignore_errors=True)
                logger.warning("removed unreadable checkpoint step %d so "
                               "the re-run can commit it again", bad)

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
                self.rewind(step)
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


def _read_file(root: str, entry: Dict[str, Any]) -> torch.Tensor:
    """One file's tensor, in its saved dtype and shape (a piece's: its
    region's extents)."""
    path = os.path.join(root, entry["file"])
    nbytes = int(entry["nbytes"])
    buf = torch.empty(nbytes, dtype=torch.uint8)
    with open(path, "rb") as f:
        got = f.readinto(memoryview(buf.numpy()))
    if got != nbytes:
        raise ValueError(f"{path}: read {got} of {nbytes} bytes")
    shape = tuple(e - s for s, e in entry["region"]) if "region" in entry \
        else tuple(entry["shape"])
    return buf.view(getattr(torch, entry["dtype"])).reshape(shape)


def _read_leaf(root: str, entries: List[Dict[str, Any]], like: Any,
               device: Optional[torch.device],
               region: Optional[Region] = None) -> Any:
    """A leaf (or its `region`) from its entries: a whole file, or the
    pieces that overlap the region."""
    first = entries[0]
    if "value" in first:
        return first["value"]
    shape = tuple(first["shape"])
    if isinstance(like, torch.Tensor) and tuple(like.shape) != shape:
        raise ValueError(f"{os.path.join(root, first['file'])}: saved "
                         f"shape {shape}, state_like's {tuple(like.shape)}")
    bounds = region.bounds if region is not None else tuple(
        (0, n) for n in shape)
    t = None
    for e in entries:
        have = tuple(map(tuple, e.get("region", [(0, n) for n in shape])))
        if have == bounds:
            t = _read_file(root, e)
            break
    if t is None:
        t = torch.empty([b - a for a, b in bounds],
                        dtype=getattr(torch, first["dtype"]))
        covered = 0
        for e in entries:
            have = e.get("region", [(0, n) for n in shape])
            over = [(max(a, c), min(b, d))
                    for (a, b), (c, d) in zip(bounds, have)]
            if any(lo >= hi for lo, hi in over):
                continue
            piece = _read_file(root, e)
            src = tuple(slice(lo - c, hi - c)
                        for (lo, hi), (c, _) in zip(over, have))
            dst = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(over, bounds))
            t[dst] = piece[src]
            covered += math.prod(hi - lo for lo, hi in over)
        if covered != t.numel():
            raise ValueError(f"{root}: the pieces of {first['path']} cover "
                             f"{covered} of {t.numel()} entries of "
                             f"{bounds}")
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
