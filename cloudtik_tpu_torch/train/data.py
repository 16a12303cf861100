"""Training batches: synthetic generators, a flat token file and the
streaming shard hand-off.

Counterpart of `cloudtik_tpu/train/data.py`, byte for byte: the same numpy
generators, seeds and draws (`synthetic_lm_batches`,
`synthetic_mlm_batches`, `synthetic_image_batches`,
`synthetic_detection_batches`, `synthetic_dlrm_batches`,
`synthetic_diffusion_batches`, `synthetic_speech_batches`,
`synthetic_graph_batches`), the same file reader
(`tokenized_file_batches`) and the same streaming protocol
(`export_token_shard`, `finish_export`, `streaming_shard_batches`: shards
published by atomic rename, a `_SUCCESS` marker, readahead on a watcher
thread, a timeout, strided shard ownership), so that both packages train
on identical batches.  Batches are numpy arrays; the trainer moves them to
its device.  Where the JAX package asks `jax.process_index()` and
`process_count()` which shards are this host's, the port asks
`torch.distributed` for its rank and world size when a process group is
initialised, else 0 and 1.  `global_batches` hands each rank of a mesh
its shard of every global batch (`local_batch`): the rows JAX's batch
sharding over (data, fsdp) gives that shard, and on a `seq` axis its
slice of the sequence.
"""

from __future__ import annotations

import glob as _glob
import os
import queue
import re
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


def synthetic_lm_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic next-token-prediction batches."""
    rng = np.random.default_rng(seed)
    while True:
        tokens = rng.integers(
            0, vocab_size, (batch_size, seq_len), dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        yield {"tokens": tokens, "labels": labels.astype(np.int32)}


def synthetic_mlm_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    mask_token: int = 1,
    max_predictions: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic masked-LM batches (BERT objective).

    Emits the gathered layout (mlm_positions/mlm_labels, P =
    max_predictions) so the vocab projection runs only on masked
    positions; P defaults to ceil(mask_prob * seq_len).
    """
    rng = np.random.default_rng(seed)
    P = max_predictions or max(int(np.ceil(mask_prob * seq_len)), 1)
    while True:
        tokens = rng.integers(
            2, vocab_size, (batch_size, seq_len), dtype=np.int32)
        positions = np.stack([
            rng.choice(seq_len, size=P, replace=False)
            for _ in range(batch_size)]).astype(np.int32)
        labels = np.take_along_axis(tokens, positions, axis=1)
        masked = tokens.copy()
        np.put_along_axis(masked, positions, mask_token, axis=1)
        yield {"tokens": masked,
               "mlm_positions": positions,
               "mlm_labels": labels.astype(np.int32)}


def synthetic_image_batches(
    batch_size: int,
    image_size: int,
    num_classes: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic image-classification batches (NHWC float32)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "images": rng.standard_normal(
                (batch_size, image_size, image_size, 3)).astype(np.float32),
            "labels": rng.integers(
                0, num_classes, (batch_size,), dtype=np.int32),
        }


def synthetic_detection_batches(
    batch_size: int,
    image_size: int,
    num_classes: int,
    max_boxes: int = 64,
    mask_size: int = 0,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic detection batches: images + padded normalized gt boxes
    (xyxy) with int labels; label 0 marks padding rows.  mask_size > 0
    adds box-interior instance masks (Mask R-CNN training)."""
    rng = np.random.default_rng(seed)
    while True:
        n = rng.integers(1, max_boxes // 2 + 1, (batch_size,))
        boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
        labels = np.zeros((batch_size, max_boxes), np.int32)
        for b in range(batch_size):
            xy = rng.uniform(0.0, 0.7, (n[b], 2))
            wh = rng.uniform(0.1, 0.3, (n[b], 2))
            boxes[b, :n[b], :2] = xy
            boxes[b, :n[b], 2:] = np.minimum(xy + wh, 1.0)
            labels[b, :n[b]] = rng.integers(1, num_classes, n[b])
        batch = {
            "images": rng.standard_normal(
                (batch_size, image_size, image_size, 3)).astype(np.float32),
            "gt_boxes": boxes,
            "gt_labels": labels,
        }
        if mask_size:
            # instance masks: filled box interiors at mask resolution
            masks = np.zeros(
                (batch_size, max_boxes, mask_size, mask_size), np.float32)
            grid = (np.arange(mask_size) + 0.5) / mask_size
            for b in range(batch_size):
                for m in range(n[b]):
                    x1, y1, x2, y2 = boxes[b, m]
                    masks[b, m] = ((grid[:, None] >= y1)
                                   & (grid[:, None] <= y2)
                                   & (grid[None, :] >= x1)
                                   & (grid[None, :] <= x2))
            batch["gt_masks"] = masks
        yield batch


def synthetic_dlrm_batches(
    batch_size: int,
    num_dense: int,
    num_tables: int,
    rows_per_table: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic click-prediction batches (dense features + sparse ids)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "dense": rng.standard_normal(
                (batch_size, num_dense)).astype(np.float32),
            "sparse_ids": rng.integers(
                0, rows_per_table, (batch_size, num_tables),
                dtype=np.int32),
            "labels": rng.integers(0, 2, (batch_size,), dtype=np.int32),
        }


def synthetic_diffusion_batches(
    batch_size: int,
    image_size: int,
    channels: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic latent-diffusion batches (latents + noise + timestep)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "latents": rng.standard_normal(
                (batch_size, image_size, image_size, channels)
            ).astype(np.float32),
            "noise": rng.standard_normal(
                (batch_size, image_size, image_size, channels)
            ).astype(np.float32),
            "t": rng.uniform(0, 1, (batch_size,)).astype(np.float32),
        }


def synthetic_speech_batches(
    batch_size: int,
    max_frames: int,
    feature_dim: int,
    vocab_size: int,
    max_labels: int = 32,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic RNN-T batches: padded log-mel frames + label sequences."""
    rng = np.random.default_rng(seed)
    while True:
        flen = rng.integers(max_frames // 2, max_frames + 1,
                            (batch_size,)).astype(np.int32)
        llen = rng.integers(1, max_labels + 1,
                            (batch_size,)).astype(np.int32)
        labels = rng.integers(
            1, vocab_size, (batch_size, max_labels), dtype=np.int32)
        for b in range(batch_size):
            labels[b, llen[b]:] = 0
        yield {
            "features": rng.standard_normal(
                (batch_size, max_frames, feature_dim)).astype(np.float32),
            "feature_lengths": flen,
            "labels": labels,
            "label_lengths": llen,
        }


def synthetic_graph_batches(
    num_nodes: int,
    feature_dim: int,
    num_classes: int,
    max_degree: int = 10,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic padded-adjacency graph blocks for GraphSAGE."""
    rng = np.random.default_rng(seed)
    while True:
        deg = rng.integers(1, max_degree + 1, (num_nodes,))
        neighbors = rng.integers(
            0, num_nodes, (num_nodes, max_degree), dtype=np.int32)
        mask = np.arange(max_degree)[None, :] < deg[:, None]
        neighbors = np.where(
            mask, neighbors, np.arange(num_nodes)[:, None]).astype(np.int32)
        yield {
            "features": rng.standard_normal(
                (num_nodes, feature_dim)).astype(np.float32),
            "neighbors": neighbors,
            "neighbor_mask": mask,
            "labels": rng.integers(
                0, num_classes, (num_nodes,), dtype=np.int32),
            "train_mask": rng.uniform(size=(num_nodes,)) < 0.7,
        }


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of this process: `torch.distributed`'s when a
    process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard(shard_index: Optional[int],
           shard_count: Optional[int]) -> Tuple[int, int]:
    rank, world = process_shard()
    return (rank if shard_index is None else shard_index,
            world if shard_count is None else shard_count)


def local_batch(batch: Dict[str, Any], mesh, microbatches: int = 1,
                seq_split: bool = True) -> Dict[str, Any]:
    """This rank's shard of a global batch on `mesh` (a DeviceMesh):
    the rows of batch shard `data_index * fsdp + fsdp_index` (row-major
    over the batch axes, as a PartitionSpec tuple lays them out) and, with
    `seq` > 1 and `seq_split`, the seq_index-th slice of dimension 1 of
    each [B, S, ...] array (without `seq_split`, for a loss that reads
    whole rows, as the image and zoo families' do, the seq ranks take the
    same rows whole).  Ranks along `expert` take the same rows.  numpy
    arrays or tensors, sliced without a copy.

    With `microbatches` > 1 the global batch is that many blocks of
    consecutive rows (the reference's accumulated step reshapes the global
    batch), and this rank takes its shard of each block, in order: its
    rows, split into `microbatches` blocks, are each microbatch's shard
    (a copy)."""
    from cloudtik_tpu_torch.parallel.mesh import DATA_AXES, axis_sizes_of

    sizes = axis_sizes_of(mesh)
    shards, index = 1, 0
    for a in DATA_AXES:
        n = sizes.get(a, 1)
        index = index * n + (mesh.get_local_rank(a) if n > 1 else 0)
        shards *= n
    n_seq = sizes.get("seq", 1) if seq_split else 1
    seq_index = mesh.get_local_rank("seq") if n_seq > 1 else 0
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % (shards * microbatches):
            raise ValueError(f"batch {k!r} of {rows} rows does not split "
                             f"over {shards} batch shards"
                             + (f" in each of {microbatches} microbatches"
                                if microbatches > 1 else ""))
        per = rows // (shards * microbatches)
        if microbatches == 1:
            v = v[index * per:(index + 1) * per]
        else:
            v = v.reshape(microbatches, shards, per, *v.shape[1:])[
                :, index].reshape(microbatches * per, *v.shape[1:])
        if n_seq > 1 and v.ndim >= 2:
            if v.shape[1] % n_seq:
                raise ValueError(f"batch {k!r} of length {v.shape[1]} does "
                                 f"not split over {n_seq} seq shards")
            s = v.shape[1] // n_seq
            v = v[:, seq_index * s:(seq_index + 1) * s]
        out[k] = v
    return out


def global_batches(data_iter: Iterator[Dict[str, Any]], mesh,
                   device=None) -> Iterator[Dict[str, Any]]:
    """Each global batch of `data_iter` as this rank's shard
    (`local_batch`), as tensors on `device` (this rank's card unless
    given); integer arrays as int64."""
    import torch

    from cloudtik_tpu_torch.parallel.distributed import rank_device

    def put(v):
        t = torch.as_tensor(np.ascontiguousarray(v)
                            if isinstance(v, np.ndarray) else v)
        integer = not (t.is_floating_point() or t.dtype == torch.bool)
        return (t.long() if integer else t).to(dev)

    dev = rank_device(device)
    for batch in data_iter:
        yield {k: put(v) for k, v in local_batch(batch, mesh).items()}


# ---------------------------------------------------------------------------
# Streaming ETL -> trainer hand-off
# ---------------------------------------------------------------------------
#
# The ETL cluster (spark runtime) exports tokenized shards to shared
# storage while the training cluster trains; the trainer must start before
# the last shard exists and stream shards as they land.  Protocol:
#   * writers publish `shard-NNNNN.npy` (flat int32 token ids) ATOMICALLY
#     via export_token_shard (write hidden tmp, os.replace) so a reader
#     never observes a half-written file;
#   * the writer of the LAST shard drops `_SUCCESS` (spark's own
#     completion-marker convention) via finish_export.

SHARD_DONE_MARKER = "_SUCCESS"
_SHARD_RE = re.compile(r"shard-(\d+)\.npy$")


def export_token_shard(export_dir: str, index: int,
                       tokens: np.ndarray) -> str:
    """Atomically publish one tokenized shard (the writer half of the
    streaming hand-off; a spark executor calls this per partition)."""
    os.makedirs(export_dir, exist_ok=True)
    final = os.path.join(export_dir, f"shard-{index:05d}.npy")
    # unique tmp per attempt: a speculative/zombie re-execution of the
    # same partition must never write into the inode another attempt is
    # about to publish (the reader's contract is visible == complete)
    tmp = os.path.join(
        export_dir,
        f".tmp-shard-{index:05d}.{os.getpid()}.{id(tokens):x}.npy")
    np.save(tmp, np.asarray(tokens, np.int32))
    os.replace(tmp, final)
    return final


def finish_export(export_dir: str) -> None:
    """Drop the completion marker after every shard is published."""
    with open(os.path.join(export_dir, SHARD_DONE_MARKER), "w") as f:
        f.write("ok\n")


def streaming_shard_batches(
    export_dir: str,
    batch_size: int,
    seq_len: int,
    *,
    readahead: int = 2,
    poll_s: float = 0.25,
    timeout_s: float = 600.0,
    shard_index: Optional[int] = None,
    shard_count: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream LM batches from an export directory WHILE it is being
    written.

    A watcher thread polls for newly published shards, loads up to
    `readahead` of them ahead of the consumer (IO overlaps the train
    step), and finishes when the `_SUCCESS` marker exists and every
    published shard is consumed.  Raises TimeoutError if no new shard
    and no marker appear for `timeout_s` (a dead ETL job must fail the
    trainer, not hang it).

    Multi-process: rank h consumes shards with index % shard_count == h —
    disjoint strided ownership, same as tokenized_file_batches.  Ranks
    must see the same number of batches to stay in lockstep, so
    exporters should publish equal-size shards in multiples of
    shard_count.  Trailing tokens that don't fill a complete batch are
    dropped.
    """
    shard_index, shard_count = _shard(shard_index, shard_count)
    q: "queue.Queue" = queue.Queue(maxsize=max(readahead, 1))
    stop = threading.Event()

    def put(item) -> bool:
        """Queue put that never deadlocks a departed consumer: the
        consumer's finally drains once, but the watcher may refill —
        poll `stop` instead of blocking forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def watch():
        seen = set()
        last_progress = time.monotonic()
        try:
            while not stop.is_set():
                # marker checked BEFORE the glob: shards published
                # between a glob and a later marker check would be
                # dropped; this order guarantees the final scan happens
                # after the marker (writers drop it last)
                done = os.path.exists(
                    os.path.join(export_dir, SHARD_DONE_MARKER))
                files = sorted(
                    _glob.glob(os.path.join(export_dir, "shard-*.npy")))
                new = [f for f in files if f not in seen]
                for f in new:
                    seen.add(f)
                    last_progress = time.monotonic()
                    m = _SHARD_RE.search(f)
                    if m is None:
                        continue
                    if int(m.group(1)) % shard_count != shard_index:
                        continue
                    # rename-published: the file is complete once visible
                    if not put(np.load(f).astype(np.int32)):
                        return
                if done and not new:
                    put(None)
                    return
                if time.monotonic() - last_progress > timeout_s:
                    put(TimeoutError(
                        f"no new shard in {export_dir} for "
                        f"{timeout_s:.0f}s and no {SHARD_DONE_MARKER}"))
                    return
                # back off only when nothing new landed this scan
                if not new:
                    stop.wait(poll_s)
        except Exception as e:   # surface loader errors to the consumer
            put(e)

    watcher = threading.Thread(target=watch, daemon=True,
                               name="tik-shard-watch")
    watcher.start()
    per = seq_len + 1
    buf = np.zeros((0,), np.int32)
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            buf = np.concatenate([buf, item]) if buf.size else item
            need = batch_size * per
            while buf.size >= need:
                rows = buf[:need].reshape(batch_size, per)
                buf = buf[need:]
                yield {"tokens": rows[:, :-1].astype(np.int32),
                       "labels": rows[:, 1:].astype(np.int32)}
    finally:
        stop.set()
        # unblock a watcher stuck on a full queue
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def tokenized_file_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    *,
    shard_index: Optional[int] = None,
    shard_count: Optional[int] = None,
    repeat: bool = True,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream fixed-length LM examples from a flat token file (.npy/.bin of
    int32 token ids).  Each process reads a disjoint strided shard."""
    shard_index, shard_count = _shard(shard_index, shard_count)
    tokens = np.load(path, mmap_mode="r") if path.endswith(".npy") else \
        np.memmap(path, dtype=np.int32, mode="r")
    n_examples = len(tokens) // (seq_len + 1)
    indices = np.arange(shard_index, n_examples, shard_count)
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(indices)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            batch_idx = order[start:start + batch_size]
            rows = np.stack([
                tokens[i * (seq_len + 1):(i + 1) * (seq_len + 1)]
                for i in batch_idx])
            yield {"tokens": rows[:, :-1].astype(np.int32),
                   "labels": rows[:, 1:].astype(np.int32)}
        if not repeat:
            return

