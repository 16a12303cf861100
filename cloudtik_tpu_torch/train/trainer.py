"""The training loop on one card or a mesh of ranks: a step of grads + the
optimizer, an MFU meter, checkpoints and an async input pipeline.

Counterpart of the single-device core of `cloudtik_tpu/train/trainer.py`:
`ModelSpec`, `transformer_spec`, `bert_spec`, `resnet_spec`, `ssd_spec`,
`maskrcnn_spec`, `dlrm_spec`, `diffusion_spec`, `rnnt_spec`,
`graphsage_spec` (and `models/lora.py`'s `lora_spec`; the image, DLRM and
graph models count one "token" an image, an example or a node, so their
TrainerConfig has seq_len=1, and RNN-T one a frame),
`TrainerConfig`, `Trainer.init_state` /
`fit` with the same history keys (loss, n_tokens, accuracy, grad_norm,
step, tokens_per_sec, mfu), gradient accumulation as the mean of the
micro-batch gradients, and the update `p + u.to(p.dtype)`, applied in
place leaf by leaf with the new optimizer state written over the old
(`Optimizer.update_`: no second copy of the state is ever resident).
PyTorch runs eagerly, so a step is the loss's forward and backward, then
the optimizer;
the float() of the metrics at a log window waits for the device, and the
window's wall time is taken after it.

`fit` takes its batches through the `Prefetcher` (train/prefetch.py) when
`prefetch_depth` > 0, books each step into the goodput ledger through the
`StepProfiler` (telemetry/stepprof.py), and saves a checkpoint every
`checkpoint_every` steps into `checkpoint_dir` (train/checkpoint.py);
`maybe_resume` restores the newest readable one, and the steps a resume
re-runs book as `restart_replay`.  `fit(profile_dir=...)` traces the
whole call with `torch.profiler` (the CPU, and the card when there is one)
into `<profile_dir>/trace.json`, a Chrome trace, through the same
`ProfileCapture` that serves on-demand captures.

On a mesh (`TrainerConfig.mesh`, or `mesh=`: one process per card,
`torch.distributed` up) the trainer is the sharded loop of the reference
over all six axes.  Each parameter is placed by
`tree_to_shardings_safe` of the spec's logical axes and held as this
rank's shard; the optimizer state mirrors it and AdamW runs on the shards.
A step issues what GSPMD derives there:

* fsdp: a stacked layer leaf is gathered layer by layer where the layer
  reads it (parallel/fsdp.py), every other sharded leaf at the step's
  start; its gradient comes back reduce-scattered.
* every gradient is summed over the spec's token axes it is not split
  on: (data, fsdp, seq) for a spec whose loss reads its batch split over
  `seq` (`ModelSpec.seq_split`: the transformer, LoRA), (data, fsdp) for
  the other families, whose `seq` ranks take whole rows.  Each rank's loss
  is its share of the global loss (a global sum over a global count, as
  models/transformer.py `loss_fn` and every family's loss take it), so
  the sum is the global gradient.
* expert: each rank holds E/n experts and keeps their gradients; leaves
  replicated over `expert` get identical gradients there, not summed.
* seq: with `seq_split` each rank takes its slice of the sequence
  (`data.local_batch`) and attention runs the ring; without it the seq
  ranks read the same whole rows.
* tensor: each rank holds its heads, d_ff columns and vocab rows, and the
  model issues Megatron's collectives (models/transformer.py); leaves
  replicated over `tensor` get equal gradients there, not summed.
* pipe: each rank holds its stage's L/P layers (the stack's leading
  dimension, composed with fsdp on `embed`) and the model runs the
  pipeline (parallel/pipeline.py); every other leaf gets the same
  gradient on every pipe rank, not summed.  Every rank of a tensor or pipe
  group reads the same rows.
* the clip's global norm sums the shards' squares over their groups; a
  leaf replicated over an axis counts once.
* with `grad_accum_steps` > 1 and `overlap_grad_sync` resolved on
  (parallel/overlap.py), each microbatch's gradients are reduce-scattered
  over `data` in buckets while the next microbatch runs, and one
  all-gather closes the step.  Every accumulated step fires the
  `train.grad_sync` seam; the sync tail books to the goodput ledger's
  `grad_sync` bucket.

* a dimension split over two mesh axes (a rule such as
  `embed=("fsdp", "tensor")`) is cut into their product, row-major over
  the axes in spec order; the model reads as this rank's slice only the
  dimensions its spec names (`ModelSpec.reads_split`: the transformer's
  Megatron split, its experts and stages; nothing for the other
  families), and the trainer gathers every other split before the loss,
  which is GSPMD's gather made explicit (a gather over a token axis comes
  back summed in the backward, over another axis as this rank's slice).
* Adafactor factors from each leaf's whole shape and sums its moments
  and its clip over the shards (train/optim.py `LeafLayout`).

`fit` takes global batches (every rank the same stream) and hands each
rank its shard.  On a mesh every rank writes its own checkpoint shard
(the pieces no other rank holds before it) and a restore, on any mesh or
one card, reads the pieces that overlap each rank's shard
(train/checkpoint.py).  MFU divides by the world size.  Every family's
spec has its logical axes and trains on a mesh; a spec without them is
refused there.

`fit_elastic` trains across slices that come and go
(train/elastic.py): at a step boundary where the coordinators agree on a
change, `_apply_remesh` re-forms the group and the mesh (`remesh`), and
either restores the last commit into the new placements and rewinds (a
lost slice) or hands the live state to the returning ranks (an expand).
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.parallel import collectives, fsdp
from cloudtik_tpu_torch.parallel import overlap as overlap_lib
from cloudtik_tpu_torch.parallel import sharding
from cloudtik_tpu_torch.parallel.distributed import (process_count,
                                                     rank_device)
from cloudtik_tpu_torch.parallel.mesh import (DATA_AXES, TOKEN_AXES,
                                              MeshConfig, axis_sizes_of,
                                              build_mesh,
                                              elastic_mesh_config,
                                              local_batch_slice)
from cloudtik_tpu_torch.parallel.sharding import (AxisRules, DEFAULT_RULES,
                                                  spec_axes,
                                                  tree_to_shardings_safe)
from cloudtik_tpu_torch.telemetry import events, goodput, stepprof
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.train import checkpoint as ckpt_lib
from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                 Checkpointer)
from cloudtik_tpu_torch.train import optim as optim_lib
from cloudtik_tpu_torch.train.data import local_batch
from cloudtik_tpu_torch.train.optim import (OptimizerConfig,
                                            _norm_accumulator,
                                            make_optimizer)
from cloudtik_tpu_torch.train.prefetch import Prefetcher, put_device_batch
from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from cloudtik_tpu_torch.utils.compile_cache import ensure_compile_cache

# Dense bf16 tensor-core peaks by `torch.cuda.get_device_name` (NVIDIA's
# data sheets), for MFU.  An unknown card or the CPU gives no MFU.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,    # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}


def device_peak_flops(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


@dataclasses.dataclass
class ModelSpec:
    """What the trainer needs to know about a model family."""

    init: Callable[[torch.Generator, torch.device], Any]   # -> params
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict]]
    flops_per_token: Optional[float] = None                # fwd+bwd
    # tree of logical-axes tuples (same structure as params); a spec that
    # has them has a loss that reads the ambient mesh, and trains on one
    logical_axes: Any = None
    # bind_mesh(mesh, rules), called once by a trainer on a mesh before
    # any step, with the rule table it places the params by: a spec that
    # holds tensors outside the params (LoRA's frozen base) takes this
    # rank's slices of them there
    bind_mesh: Optional[Callable[[Any, AxisRules], None]] = None
    # {mesh axis: logical names} the model reads as this rank's slice
    # (sharding.MEGATRON_READS for the transformer); every other split is
    # gathered before the loss
    reads_split: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    # top-level keys of stacked [L, ...] layer dicts the model reads layer
    # by layer (through fsdp.LazyLayer): their fsdp splits are gathered
    # one layer at a time
    layer_stacks: Tuple[str, ...] = ()
    # whether the loss reads its batch split over `seq` (dimension 1 of
    # each array); the other families' seq ranks take whole rows
    seq_split: bool = False

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The mesh axes that split the batch the loss reads: its global
        sums and the gradient sync run over them."""
        return TOKEN_AXES if self.seq_split else DATA_AXES


def transformer_spec(cfg) -> ModelSpec:
    from cloudtik_tpu_torch.models import transformer as T

    return ModelSpec(
        init=lambda gen, device: T.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: T.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_token(),
        logical_axes=T.param_logical_axes(cfg),
        reads_split=sharding.MEGATRON_READS,
        layer_stacks=("layers",),
        seq_split=True,
    )


def bert_spec(cfg, objective: str = "mlm") -> ModelSpec:
    """BERT with the MLM objective, or ("classify") sequence
    classification."""
    from cloudtik_tpu_torch.models import bert as B

    loss = B.loss_fn if objective == "mlm" else B.classify_loss_fn
    return ModelSpec(
        init=lambda gen, device: B.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: loss(params, batch, cfg),
        flops_per_token=cfg.flops_per_token(),
        logical_axes=B.param_logical_axes(cfg),
        layer_stacks=("layers",),
    )


def resnet_spec(cfg) -> ModelSpec:
    """Image classification: "token" accounting is per image
    (seq_len=1)."""
    from cloudtik_tpu_torch.models import resnet as R

    return ModelSpec(
        init=lambda gen, device: R.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: R.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
        logical_axes=R.param_logical_axes(cfg),
    )


def ssd_spec(cfg) -> ModelSpec:
    """Single-shot detection (SSD-ResNet34): per-image accounting."""
    from cloudtik_tpu_torch.models import ssd as S

    return ModelSpec(
        init=lambda gen, device: S.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: S.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
        logical_axes=S.param_logical_axes(cfg),
    )


def maskrcnn_spec(cfg) -> ModelSpec:
    """Two-stage detection (Mask R-CNN): per-image accounting."""
    from cloudtik_tpu_torch.models import maskrcnn as M

    return ModelSpec(
        init=lambda gen, device: M.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: M.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
        logical_axes=M.param_logical_axes(cfg),
    )


def dlrm_spec(cfg) -> ModelSpec:
    """Click prediction: per-example accounting (seq_len=1)."""
    from cloudtik_tpu_torch.models import dlrm as D

    return ModelSpec(
        init=lambda gen, device: D.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: D.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_example(),
        logical_axes=D.param_logical_axes(cfg),
    )


def diffusion_spec(cfg) -> ModelSpec:
    """Latent-diffusion UNet: per-image accounting (seq_len=1)."""
    from cloudtik_tpu_torch.models import diffusion as U

    return ModelSpec(
        init=lambda gen, device: U.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: U.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
        logical_axes=U.param_logical_axes(cfg),
    )


def rnnt_spec(cfg) -> ModelSpec:
    """Speech transducer: per-frame accounting (seq_len = frames)."""
    from cloudtik_tpu_torch.models import rnnt as N

    return ModelSpec(
        init=lambda gen, device: N.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: N.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_frame(),
        logical_axes=N.param_logical_axes(cfg),
    )


def graphsage_spec(cfg, objective: str = "supervised") -> ModelSpec:
    """GraphSAGE, node classification ("supervised") or link prediction
    (any other objective, as the reference reads it): per-node
    accounting."""
    from cloudtik_tpu_torch.models import graphsage as G

    loss = G.loss_fn if objective == "supervised" else G.link_pred_loss
    return ModelSpec(
        init=lambda gen, device: G.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: loss(params, batch, cfg),
        flops_per_token=cfg.flops_per_node(),
        logical_axes=G.param_logical_axes(cfg),
    )


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int = 8
    seq_len: int = 2048
    # the mesh over the process group's ranks (fsdp fills); one process
    # (no group) is the one-card trainer
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    rules: AxisRules = DEFAULT_RULES
    log_every: int = 10
    checkpoint_every: int = 0          # 0 = disabled
    checkpoint_dir: Optional[str] = None
    # Each optimizer step averages the gradients of this many sequential
    # micro-batches (the batch splits on its leading dim).
    grad_accum_steps: int = 1
    # Overlapped gradient sync (parallel/overlap.py): with accum > 1 each
    # microbatch's gradients are reduce-scattered over `data` in buckets
    # while the next microbatch runs; one all-gather closes the step.
    # None = auto (on when accum > 1 and the mesh has a data axis); False
    # = the sequential path (each microbatch's gradients all-reduced).
    overlap_grad_sync: Optional[bool] = None
    overlap_bucket_bytes: int = overlap_lib.DEFAULT_BUCKET_BYTES
    # Async input pipeline (train/prefetch.py): batches are pulled and
    # copied to the card on background threads, behind a bounded queue
    # of this depth.  0 = the synchronous input path.
    prefetch_depth: int = 2
    prefetch_threads: int = 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter's shards lie: (dim, mesh axes) pairs.  A
    dimension split over several axes is cut into the product of their
    sizes, and a rank's piece is row-major over the axes in spec order, as
    a PartitionSpec entry ("fsdp", "tensor") lays it out.  `read_split`
    names the dims the model reads as this rank's slice
    (`ModelSpec.reads_split`); the trainer gathers the others before the
    loss."""

    dims: Tuple[Tuple[int, Tuple[str, ...]], ...] = ()
    read_split: Tuple[int, ...] = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for _, axes in self.dims for a in axes)

    def dim_of(self, axis: str) -> Optional[int]:
        return next((d for d, axes in self.dims if axis in axes), None)


def _mesh_for(config: MeshConfig):
    """The DeviceMesh `config` asks for over the process group, or None
    for one process.  A mesh that needs more ranks than there are
    raises (axis_sizes), so no parallel path runs on one rank."""
    config.axis_sizes(process_count())
    return None if process_count() == 1 else build_mesh(config)


class Trainer:
    """Holds params and optimizer state on one device (or this rank's
    shards on a mesh) and runs the loop."""

    def __init__(self, spec: ModelSpec, config: TrainerConfig,
                 device: DeviceLike = None, mesh=None):
        # a restarted job loads the kernels its last incarnation built
        # (TIK_COMPILE_CACHE_DIR; fail-soft)
        ensure_compile_cache()
        self.spec = spec
        self.config = config
        self.mesh = mesh if mesh is not None else _mesh_for(config.mesh)
        self.optimizer = make_optimizer(config.optimizer)
        self._placements = None
        if self.mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = rank_device(device)
            self._placements = self._place()
            if spec.bind_mesh is not None:
                spec.bind_mesh(self.mesh, config.rules)
        self.params = None
        self.opt_state = None
        self.step = 0
        self._plan = None
        # this mesh's save token (`_save_token`)
        self._token = None
        # seconds of the last accumulated step's sync tail (the seam and
        # the closing gather), booked to the grad_sync bucket
        self._last_sync_s = 0.0
        # steps <= this were already run before a restart (resume from an
        # older checkpoint): the goodput ledger books them as
        # restart_replay, not progress
        self._replay_until = 0
        self.checkpointer: Optional[Checkpointer] = None
        if config.checkpoint_dir and config.checkpoint_every:
            self.checkpointer = Checkpointer(CheckpointConfig(
                directory=config.checkpoint_dir,
                save_interval_steps=config.checkpoint_every))

    # -- placement ----------------------------------------------------------
    def _axis(self, axis: str) -> int:
        return axis_sizes_of(self.mesh).get(axis, 1)

    def _place(self):
        """A Placement per parameter from the spec's logical axes."""
        if self.spec.logical_axes is None:
            raise ValueError(
                "this ModelSpec has no logical_axes: a spec trains on a "
                "mesh only with the logical axes of its parameters")
        shapes = self.spec.init(torch.Generator(), torch.device("meta"))
        specs = tree_to_shardings_safe(self.mesh, self.spec.logical_axes,
                                       shapes, self.config.rules)

        # the tensor splits are Megatron's (read split) only when every
        # one of them is (`sharding.megatron_split`)
        reads = self.spec.reads_split
        megatron = sharding.megatron_split(specs, self.spec.logical_axes,
                                           reads)

        def one(params, spec, logical):
            if isinstance(params, dict):
                return {k: one(v, spec[k], logical[k])
                        for k, v in params.items()}
            if isinstance(params, (list, tuple)):
                return type(params)(one(v, spec[i], logical[i])
                                    for i, v in enumerate(params))
            dims, read = [], []
            for dim, entry in enumerate(spec):
                axes = spec_axes(entry)
                if not axes:
                    continue
                dims.append((dim, axes))
                if sharding.reads_split(entry, logical[dim], reads) and (
                        megatron or axes != ("tensor",)):
                    read.append(dim)
            return Placement(tuple(dims), tuple(read))

        self._shapes = shapes
        return one(shapes, specs, self.spec.logical_axes)

    def _piece(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(pieces, this rank's index) of a dimension split over `axes`:
        row-major over the axes in order."""
        n, index = 1, 0
        for axis in axes:
            size = self._axis(axis)
            index = index * size + (self.mesh.get_local_rank(axis)
                                    if size > 1 else 0)
            n *= size
        return n, index

    def _shard(self, full: torch.Tensor, pl: Placement) -> torch.Tensor:
        for dim, axes in pl.dims:
            n, index = self._piece(axes)
            full = full.chunk(n, dim)[index]
        return full.contiguous()

    def _region(self, shape, pl: Placement) -> Tuple[Tuple[int, int], ...]:
        """This rank's [start, stop) of each dimension of a leaf of global
        `shape` placed by `pl`."""
        region = [(0, int(n)) for n in shape]
        for dim, axes in pl.dims:
            n, index = self._piece(axes)
            per = int(shape[dim]) // n
            region[dim] = (index * per, (index + 1) * per)
        return tuple(region)

    def _gather(self, local, pl: Placement):
        """The whole leaf from this rank's shard (every rank calls it): the
        inner axis of a dimension first."""
        for dim, axes in reversed(pl.dims):
            for axis in reversed(axes):
                local = collectives.gather_full(local, dim,
                                                self.mesh.get_group(axis))
        return local

    def _opt_placements(self) -> Dict[str, Any]:
        """Per optimizer-state tree, each leaf's Placement: its parameter's
        where the optimizer keeps a parameter-shaped moment; Adafactor's
        factored rows and columns drop the averaged dimension and its
        split, and its (1,)-shaped placeholders are whole
        (`Optimizer.state_dim`)."""
        def derive(key):
            def one(shape, pl):
                dims = []
                for dim, axes in pl.dims:
                    d = self.optimizer.state_dim(key, tuple(shape.shape),
                                                 dim)
                    if d is not None:
                        dims.append((d, axes))
                return Placement(tuple(dims))
            return tree_map(one, self._shapes, self._placements)

        abstract = self.optimizer.init(self._shapes)
        return {k: derive(k) for k, v in abstract.items()
                if isinstance(v, (dict, list))}

    def _map_state(self, fn, state: Dict[str, Any]) -> Dict[str, Any]:
        """fn(leaf, placement) over params and the optimizer state's
        parameter-shaped trees (every entry but the step count)."""
        placed = self._opt_placements()
        opt = {k: (tree_map(fn, v, placed[k]) if k in placed else v)
               for k, v in state["opt_state"].items()}
        return {"params": tree_map(fn, state["params"], self._placements),
                "opt_state": opt}

    def _local_opt_state(self) -> Dict[str, Any]:
        """A fresh optimizer state of this rank's shards: the state of the
        whole ("meta") parameters, each leaf as zeros of its shard's shape
        (every optimizer starts at zeros)."""
        def zeros(x, pl):
            shape = [e - s for s, e in self._region(x.shape, pl)]
            return torch.zeros(shape, dtype=x.dtype, device=self.device)
        return self._map_state(zeros, {
            "params": self._shapes,
            "opt_state": self.optimizer.init(self._shapes)})["opt_state"]

    def _bind_optimizer(self) -> None:
        """Tell the optimizer each leaf's whole shape and the groups each
        dimension is split over (Adafactor factors and clips whole
        leaves)."""
        def one(_, shape, pl):
            return optim_lib.LeafLayout(tuple(shape.shape), {
                dim: tuple(self.mesh.get_group(a) for a in axes
                           if self._axis(a) > 1)
                for dim, axes in pl.dims})
        # in the order the optimizer walks the gradients: the params'
        self.optimizer.layout = tree_leaves(
            tree_map(one, self.params, self._shapes, self._placements))

    # -- state -------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   params=None) -> None:
        """Fresh params from `spec.init` (seed 0 unless a generator is
        given), or the `params` handed in (e.g. JAX weights through
        `convert.params_from_jax`), then a fresh optimizer state."""
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = self.spec.init(generator, self.device)
        if self.mesh is not None:
            # every rank makes (or is handed) the same whole tree and keeps
            # its shard
            params = tree_map(lambda p, pl: self._shard(
                p.detach().to(self.device), pl), params, self._placements)
        self.params = tree_map(
            lambda p: p.detach().to(self.device).requires_grad_(True), params)
        self._follow_params()
        self.opt_state = self.optimizer.init(self.params) \
            if self.mesh is None else self._local_opt_state()
        self.step = 0

    @property
    def state(self) -> Dict[str, Any]:
        """{"params", "opt_state"}: what a checkpoint holds."""
        return {"params": self.params, "opt_state": self.opt_state}

    def _set_state(self, state: Dict[str, Any]) -> None:
        """Take a restored state (this rank's shards of it on a mesh)."""
        self.params = tree_map(lambda p: p.detach().requires_grad_(True),
                               state["params"])
        self.opt_state = state["opt_state"]
        self._follow_params()

    def _follow_params(self) -> None:
        """Re-key the placements in the params' own order (a tree from
        JAX comes with sorted keys), so their leaves pair up in order, and
        hand the optimizer its layout."""
        if self._placements is not None:
            self._placements = tree_map(lambda _, pl: pl, self.params,
                                        self._placements)
            self._bind_optimizer()

    def full_state(self) -> Dict[str, Any]:
        """{params, opt_state} whole: on a mesh every leaf gathered (every
        rank must call it)."""
        if self.mesh is None:
            return self.state
        return self._map_state(self._gather, self.state)

    def _save(self, step: int, force: bool = False) -> bool:
        """Save the state: on one card whole; on a mesh each rank writes
        its own shard, the pieces it holds first (`_writes`)."""
        if self.mesh is None:
            return self.checkpointer.save(step, self.state, force=force)
        placed = dict(ckpt_lib._flatten(self._map_state(
            lambda x, pl: pl, self.state)))
        whole = dict(ckpt_lib._flatten(self._abstract_state()))
        rank = dist.get_rank()
        leaves, pieces = [], {}
        for path, leaf in ckpt_lib._flatten(self.state):
            if not isinstance(leaf, torch.Tensor):
                if rank == 0:
                    leaves.append((path, leaf))
                continue
            if not self._writes(placed[path]):
                continue
            shape = tuple(whole[path].shape)
            pieces[len(leaves)] = (shape, ckpt_lib.Region(
                self._region(shape, placed[path])))
            leaves.append((path, leaf))
        return self.checkpointer.save(step, leaves, force=force,
                                      shard=ckpt_lib.ShardWrite(
                                          rank, dist.get_world_size(),
                                          self._save_token(), pieces))

    def _writes(self, pl: Placement) -> bool:
        """Whether this rank writes its piece of a leaf placed by `pl`:
        the one at index 0 of every mesh axis the leaf is replicated
        over."""
        return all(self.mesh.get_local_rank(a) == 0
                   for a, n in axis_sizes_of(self.mesh).items()
                   if n > 1 and a not in pl.axes)

    def _save_token(self) -> str:
        """This mesh's save token (rank 0's, broadcast at the first save on
        the mesh): a save's shard folder, so shards of two attempts at one
        step never mix."""
        if self._token is None:
            box = [uuid.uuid4().hex[:12]]
            dist.broadcast_object_list(box, src=0)
            self._token = box[0]
        return self._token

    def _regions(self, abstract: Dict[str, Any]) -> Any:
        """This rank's Region of each tensor leaf of `abstract` (None off a
        mesh: whole leaves)."""
        if self.mesh is None:
            return None
        return self._map_state(
            lambda x, pl: ckpt_lib.Region(self._region(x.shape, pl)),
            abstract)

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, force: bool = False) -> bool:
        """Save the current state; returns True if a save started."""
        if self.checkpointer is None:
            raise RuntimeError("checkpointing not configured "
                               "(set checkpoint_dir + checkpoint_every)")
        return self._save(self.step, force=force)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore the state onto the trainer's device (this rank's shards
        on a mesh: the pieces that overlap them, of a whole-leaf or a
        sharded step); returns the step.  The template is on the "meta"
        device: no init runs and no second copy of the state is ever
        resident."""
        if self.checkpointer is None:
            raise RuntimeError("checkpointing not configured")
        step = (step if step is not None
                else self.checkpointer.latest_step())
        abstract = self._abstract_state()
        self._set_state(self.checkpointer.restore(
            abstract, step=step, device=self.device,
            regions=self._regions(abstract)))
        self.step = int(step)
        self._note_resume()
        return self.step

    def _note_resume(self, horizon: int = 0) -> None:
        """Reconstruct the restart-replay horizon from the flight
        recorder: steps the previous incarnation already ran (the newest
        checkpoint_commit of THIS checkpoint directory, or `horizon` when
        it is later) that this one re-runs count as restart_replay, not
        progress."""
        directory = self.checkpointer.config.directory \
            if self.checkpointer is not None else None
        horizon = max(horizon, goodput.replay_horizon(self.step,
                                                      directory=directory))
        self._replay_until = horizon if horizon > self.step else 0
        events.emit("tik_train_resume", step=self.step,
                    replay_until=self._replay_until)

    def _abstract_state(self) -> Dict[str, Any]:
        """{params, opt_state} of "meta" tensors: the shapes and dtypes a
        restore checks and casts to, for any of the optimizers' states."""
        params = self.spec.init(torch.Generator(), torch.device("meta"))
        return {"params": params, "opt_state": self.optimizer.init(params)}

    def _restore_latest_good(self, remove_unreadable: bool = False
                             ) -> Optional[int]:
        """Restore the newest readable step (None when there is none);
        returns it.  On a mesh every rank restores the same step: the
        oldest of the ranks' newest readable ones (a step whose shards are
        still landing may be listed on one rank and not on another)."""
        abstract = self._abstract_state()
        if self.mesh is None:
            restored = self.checkpointer.restore_latest_good(
                abstract, device=self.device,
                remove_unreadable=remove_unreadable)
            if restored is None:
                return None
            state, step = restored
            self._set_state(state)
            return int(step)
        good = self.checkpointer.readable_steps()
        newest = torch.tensor([good[-1] if good else -1],
                              device=self._collective_device())
        dist.all_reduce(newest, op=dist.ReduceOp.MIN)
        step = int(newest.item())
        if step < 0:
            return None
        self.checkpointer.rewind(step, remove=remove_unreadable
                                 and dist.get_rank() == 0)
        # no rank lists a removed step after this point
        dist.barrier()
        self._set_state(self.checkpointer.restore(
            abstract, step=step, device=self.device,
            regions=self._regions(abstract)))
        return step

    def _collective_device(self) -> torch.device:
        """Where a small tensor for a collective of the default group
        lives: the card under NCCL, the host under gloo."""
        return self.device if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def maybe_resume(self) -> Optional[int]:
        """Resume from the newest *readable* checkpoint, if any: a step
        whose data does not read back (torn write) is skipped and the
        previous committed step is used instead."""
        if self.checkpointer is None or not self.checkpointer.all_steps():
            return None
        step = self._restore_latest_good()
        if step is None:
            return None
        self.step = step
        self._note_resume()
        return self.step

    # -- one step ------------------------------------------------------------
    def _grads(self, batch: Dict[str, torch.Tensor]):
        if self.mesh is not None:
            return self._sharded_grads(batch)
        loss, metrics = self.spec.loss_fn(self.params, batch)
        leaves = tree_leaves(self.params)
        # a leaf the loss never reads (BERT's mlm_bias) gets a zero
        # gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return tree_unflatten(self.params, list(grads)), metrics

    def _use_tree(self):
        """The tree the loss reads: every split dimension the model does not
        read as this rank's slice (Placement.read_split) gathered, the
        leaves of the spec's layer stacks as `LayerShards` (gathered layer
        by layer) and the others now; the gradient of a gather over a
        token axis comes back summed, over another axis (whose ranks read
        the same rows) as this rank's slice."""
        token_axes = self.spec.token_axes

        def use(in_layers, p, pl):
            gathers = [(d, self.mesh.get_group(a), a in token_axes)
                       for d, axes in reversed(pl.dims)
                       if d not in pl.read_split
                       for a in reversed(axes) if self._axis(a) > 1]
            if not gathers:
                return p
            if in_layers and all(d != 0 for d, _, _ in gathers):
                return fsdp.LayerShards(p, gathers)
            for d, group, summed in gathers:
                p = collectives.gather_dim(p, d, group, summed)
            return p

        params, placements = self.params, self._placements
        if isinstance(params, dict):
            return {k: tree_map(lambda p, pl,
                                lay=(k in self.spec.layer_stacks):
                                use(lay, p, pl), v, placements[k])
                    for k, v in params.items()}
        return tree_map(lambda p, pl: use(False, p, pl), params, placements)

    def _sharded_grads(self, batch: Dict[str, torch.Tensor],
                       sum_axes: Optional[Tuple[str, ...]] = None):
        """This rank's gradients, summed over the axes in `sum_axes` (the
        spec's token axes unless given) that each leaf is not split on
        (never over tensor or pipe: the model's collectives, or the
        gathers, already leave every rank its leaves' whole gradients
        there)."""
        if sum_axes is None:
            sum_axes = self.spec.token_axes
        leaves = tree_leaves(self.params)
        with sharding.use_mesh(self.mesh):
            loss, metrics = self.spec.loss_fn(self._use_tree(), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        synced = []
        for g, pl in zip(grads, tree_leaves(self._placements)):
            for axis in sum_axes:
                if axis not in pl.axes and self._axis(axis) > 1:
                    dist.all_reduce(g, group=self.mesh.get_group(axis))
            synced.append(g)
        return tree_unflatten(self.params, synced), metrics

    def _global_norm(self, grads) -> torch.Tensor:
        """The global norm from this rank's gradient shards: the squares of
        the leaves split over the same axes are summed, then over those
        axes' groups."""
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, pl in zip(tree_leaves(grads), tree_leaves(self._placements)):
            sq = torch.square(torch.linalg.vector_norm(
                g, dtype=_norm_accumulator(g)))
            by_axes[pl.axes] = by_axes[pl.axes] + sq \
                if pl.axes in by_axes else sq
        total = 0.0
        for axes, sq in by_axes.items():
            for axis in axes:
                dist.all_reduce(sq, group=self.mesh.get_group(axis))
            total = total + sq
        return torch.sqrt(total).float()

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device-resident batch; returns its
        metrics (device tensors) with the pre-clip `grad_norm`.  The two
        halves are `torch.profiler` ranges (train.grads, train.optimizer),
        which cost nothing measurable when no profiler runs."""
        accum = max(int(self.config.grad_accum_steps), 1)
        with record_function("train.grads"):
            grads, metrics = self._accumulated_grads(batch, accum)
        with record_function("train.optimizer"):
            g_norm = None if self.mesh is None else self._global_norm(grads)
            # in place, leaf by leaf: no second copy of the state
            self.opt_state, grad_norm = self.optimizer.update_(
                grads, self.opt_state, self.params, g_norm=g_norm)
        return {**metrics, "grad_norm": grad_norm}

    def overlap_enabled(self) -> bool:
        """Whether accumulated steps run the overlapped gradient sync
        (`overlap_grad_sync` resolved against the mesh)."""
        accum = max(int(self.config.grad_accum_steps), 1)
        return self.mesh is not None and overlap_lib.should_overlap(
            self.config.overlap_grad_sync, accum, self.mesh,
            self.config.rules)

    def overlap_plan(self) -> overlap_lib.OverlapPlan:
        """The bucket plan of this rank's parameter shards (built once)."""
        if self._plan is None:
            self._plan = overlap_lib.plan_overlap(
                self.params, {} if self.mesh is None else self.mesh,
                self.config.rules, self.config.overlap_bucket_bytes)
        return self._plan

    def _fence(self) -> None:
        """Wait until the card has done the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _accumulated_grads(self, batch: Dict[str, torch.Tensor], accum: int):
        self._last_sync_s = 0.0
        if accum == 1:
            return self._grads(batch)
        # the mean of the micro-batch grads, summed in f32 (the JAX
        # package's sequential reference path), or with the overlapped
        # sync the same sums reduce-scattered over `data` in buckets.  On
        # a mesh `fit` hands this rank its shard of each global
        # microbatch in turn (`local_batch(..., microbatches=accum)`)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        overlap = self.overlap_enabled()
        sync = overlap_lib.BucketSync(
            self.overlap_plan(), self.mesh.get_group("data")) \
            if overlap else None
        grads, stacked = None, []
        for i in range(accum):
            one = {k: v[i] for k, v in micro.items()}
            if sync is not None:
                g, m = self._sharded_grads(
                    one, tuple(a for a in self.spec.token_axes
                               if a != "data"))
                sync.add(g)
            else:
                g, m = self._grads(one)
                grads = tree_map(lambda x: x.float(), g) if grads is None \
                    else tree_map(torch.add, grads, g)
            stacked.append(m)
        t_sync = time.perf_counter()
        plan = self.overlap_plan()
        overlap_lib.fire_grad_sync_seam(
            self.step, overlap, overlap_lib.deferred_sync_bytes(
                plan, overlap), fence=self._fence)
        if sync is not None:
            grads = sync.finish(self.params)
        self._last_sync_s = time.perf_counter() - t_sync
        grads = tree_map(lambda g: g / accum, grads)
        metrics = {k: torch.stack([m[k].float() for m in stacked]).mean()
                   for k in stacked[0]}
        return grads, metrics

    # -- loop ----------------------------------------------------------------
    def fit(self, data_iter: Iterator[Dict[str, np.ndarray]],
            num_steps: int, callbacks: Optional[list] = None,
            profile_dir: Optional[str] = None) -> Dict[str, Any]:
        """Run `num_steps` training steps; returns {"history",
        "final_step"}, one history entry per `log_every` steps (and one for
        a final partial window).  Each `callbacks` entry is called as
        cb(trainer, entry) after each window.  With `profile_dir`, the
        whole call is traced into `<profile_dir>/trace.json`."""
        goodput.LEDGER.start_job()
        stepprof.install_compile_tracking()
        if self.params is None:
            self.init_state()
        every = self.config.checkpoint_every
        if (self.checkpointer is not None and every and self.mesh is None
                and (self.step + num_steps) // every > self.step // every):
            # before the loop: pinning its host buffers under a running
            # step would hold up that step's launches
            self.checkpointer.reserve(self.state)
        prefetcher = None
        # one capture for the call: the whole window when profile_dir is
        # given (an on-demand request then waits: poll() skips while a
        # capture runs), else whatever a request starts
        capture = stepprof.ProfileCapture()
        if profile_dir and not capture.start(profile_dir):
            raise RuntimeError(
                f"fit(profile_dir={profile_dir!r}): the profiler did not "
                "start (the log has the reason)")
        try:
            if not isinstance(data_iter, Prefetcher):
                # max_items: a fit consumes exactly num_steps batches, as
                # the synchronous loop would
                data_iter, prefetcher = self._input(data_iter, num_steps)
            return self._fit_loop(data_iter, num_steps, callbacks or [],
                                  capture)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            # after the device has retired the window's work, so the
            # trace holds all of it
            capture.stop(tree_leaves(self.params)[0])
            goodput.LEDGER.tick()
            goodput.maybe_write_snapshot()

    def _input(self, data_iter, max_items: int):
        """(batches, prefetcher or None): on a mesh each global batch cut
        to this rank's shard (of each microbatch, when the step
        accumulates), integer ids as int64, and the async pipeline when
        `prefetch_depth` > 0."""
        if self.mesh is not None:
            mesh = self.mesh
            local_batch_slice(mesh, self.config.global_batch_size)
            accum = max(int(self.config.grad_accum_steps), 1)
            seq_split = self.spec.seq_split
            data_iter = map(lambda b: local_batch(
                b, mesh, accum, seq_split=seq_split), data_iter)
        # integer ids as int64, whatever the source gives; floats (images,
        # boxes, masks) as they are
        data_iter = map(_as_long, data_iter)
        if self.config.prefetch_depth <= 0:
            return data_iter, None
        prefetcher = Prefetcher(
            data_iter, device=self.device, depth=self.config.prefetch_depth,
            threads=self.config.prefetch_threads, max_items=max_items)
        return prefetcher, prefetcher

    # -- elastic -----------------------------------------------------------
    def remesh(self, mesh) -> None:
        """Rebind to a new mesh: the placements are rebuilt, the spec is
        bound to it again, the cached overlap plan and the save token are
        dropped.  The state is NOT moved (`_apply_remesh` restores or
        hands it over)."""
        self.mesh = mesh
        self._placements = self._place()
        if self.spec.bind_mesh is not None:
            self.spec.bind_mesh(mesh, self.config.rules)
        self._plan = None
        self._token = None
        if self.params is not None:
            self._follow_params()

    def fit_elastic(self, data_factory: Callable[[int], Iterator[Dict]],
                    num_steps: int, coordinator,
                    callbacks: Optional[list] = None,
                    join: bool = False) -> Dict[str, Any]:
        """Elastic multislice fit: train to ``self.step + num_steps``,
        re-meshing across slices at step boundaries as the coordinator
        (train/elastic.py `ElasticCoordinator`) decides.

        ``data_factory(step)`` returns an iterator of the global batches
        for steps ``step+1, step+2, ...``: a re-mesh that resumes from an
        older committed step rewinds the stream with it, which makes the
        trajectory after a shrink the one of a fresh K-1 run from the same
        committed step.  Each history entry carries ``slices``.  With
        ``join`` this process returns to a running job (a recycled
        slice's fresh process): it is admitted at the boundary that takes
        its slice back and receives the live state there.  A process
        whose slice a decision drops leaves at that boundary: the result
        then carries ``left``."""
        if self.checkpointer is None:
            raise RuntimeError(
                "elastic training requires checkpointing (set "
                "checkpoint_dir + checkpoint_every): a lost slice resumes "
                "from the last committed step")
        goodput.LEDGER.start_job()
        stepprof.install_compile_tracking()
        pending = None
        if join:
            pending, _ = coordinator.admit()
        elif self.params is None:
            self.init_state()
        ti.ELASTIC_SLICES.set(len(coordinator.current))
        end_step = self.step + num_steps
        history: list = []
        data_iter = prefetcher = None
        capture = stepprof.ProfileCapture()

        def rebind_input():
            # the input binds to a mesh era: built once, kept across
            # boundary polls, rebuilt only after a re-mesh (the stream
            # rewinds with the step and the shard follows the new mesh)
            nonlocal data_iter, prefetcher
            if prefetcher is not None:
                prefetcher.close()
            data_iter, prefetcher = self._input(data_factory(self.step),
                                                end_step - self.step)

        try:
            if pending is None:
                rebind_input()
            while self.step < end_step:
                decision = pending if pending is not None \
                    else coordinator.poll(self.step)
                pending = None
                if decision is not None:
                    # drain the old era's prefetcher before pausing: its
                    # producers cut batches for the old mesh
                    if prefetcher is not None:
                        prefetcher.close()
                        prefetcher = None
                    if coordinator.leaves(decision):
                        coordinator.leave()
                        return {"history": history, "final_step": self.step,
                                "left": True}
                    self._apply_remesh(decision, coordinator)
                    rebind_input()
                segment = min(coordinator.check_every, end_step - self.step)
                out = self._fit_loop(data_iter, segment, callbacks or [],
                                     capture)
                for entry in out["history"]:
                    entry["slices"] = len(coordinator.current)
                history.extend(out["history"])
        finally:
            if prefetcher is not None:
                prefetcher.close()
            goodput.LEDGER.tick()
            goodput.maybe_write_snapshot()
        return {"history": history, "final_step": self.step}

    def _apply_remesh(self, decision, coordinator) -> None:
        """Apply one re-mesh decision at a step boundary.

        Shrink (slice lost): the lost slice's shards are gone, so the last
        committed checkpoint is restored into the new placements and the
        step rewinds (the re-run books as restart_replay).  Expand
        (capacity returned): nothing was lost, so the live state moves to
        the returning ranks and nothing rewinds.  The pause books to the
        ``elastic_remesh`` goodput bucket net of the wait, restore and
        compile seconds booked to their own buckets."""
        from cloudtik_tpu_torch.train.elastic import (REASON_SLICE_LOST,
                                                      _note_remesh,
                                                      fire_remesh_seam)

        t0 = time.perf_counter()
        compile_mark = goodput.LEDGER.total(goodput.BUCKET_COMPILE)
        restore_mark = goodput.LEDGER.total(
            goodput.BUCKET_CHECKPOINT_RESTORE)
        pre_step = self.step
        with telemetry.span("train.remesh", reason=decision.reason,
                            from_slices=len(decision.from_slices),
                            to_slices=len(decision.to_slices)):
            fire_remesh_seam(decision.from_slices, decision.to_slices,
                             decision.reason)
            # the global batch is kept, so it must split over the new
            # data-parallel size: refused before any mutation
            ranks = coordinator.ranks(decision.to_slices)
            local_batch_slice(elastic_mesh_config(
                coordinator.mesh_config, len(decision.to_slices)
            ).axis_sizes(len(ranks)), self.config.global_batch_size)
            # a wedged async save must not hang the re-mesh; the drain is
            # checkpoint work, booked to checkpoint_save
            t_wait = time.perf_counter()
            self.checkpointer.wait(
                deadline_s=coordinator.checkpoint_wait_s)
            wait_s = time.perf_counter() - t_wait
            goodput.attribute(goodput.BUCKET_CHECKPOINT_SAVE, wait_s)
            if self.mesh is None and self.params is not None:
                raise RuntimeError("an elastic re-mesh needs a trainer on "
                                   "a mesh (coordinator.build_mesh())")
            self.remesh(coordinator.build_mesh(decision.to_slices))
            if decision.reason == REASON_SLICE_LOST:
                step = self._restore_latest_good(remove_unreadable=True)
                if step is None:
                    raise RuntimeError(
                        "elastic shrink needs a committed checkpoint under "
                        f"{self.checkpointer.config.directory}; none found")
                self.step = step
                # steps up to where the wider mesh had reached are
                # re-runs: the journal sees committed steps only, the
                # coordinator saw the boundary
                self._note_resume(horizon=pre_step)
            else:
                self._hand_over(decision, coordinator)
            dt = time.perf_counter() - t0
            booked = wait_s + \
                (goodput.LEDGER.total(goodput.BUCKET_COMPILE)
                 - compile_mark) + \
                (goodput.LEDGER.total(goodput.BUCKET_CHECKPOINT_RESTORE)
                 - restore_mark)
            goodput.attribute(goodput.BUCKET_ELASTIC_REMESH,
                              max(dt - booked, 0.0))
            _note_remesh(decision.direction, dt, len(decision.to_slices))
            # inside the span, so the journal record carries its
            # traceparent
            events.emit("tik_elastic_remesh", reason=decision.reason,
                        from_slices=list(decision.from_slices),
                        to_slices=list(decision.to_slices),
                        step=self.step, replayed_to=pre_step,
                        duration_s=round(dt, 4))
        coordinator.commit(decision)

    def _hand_over(self, decision, coordinator) -> None:
        """The expand's live reshard: every state leaf is replicated over
        `data` (the axis that spans slices), so over each `data` group the
        rank in the first surviving slice broadcasts its shard, and the
        returning ranks (no state yet) take it; the step and the number
        leaves come from that slice's first rank."""
        if any("data" in pl.axes for pl in tree_leaves(self._placements)):
            raise NotImplementedError(
                "an elastic expand hands over state replicated over "
                "`data`; these rules split a parameter over it")
        survivors = [s for s in sorted(decision.to_slices)
                     if s in decision.from_slices]
        order = coordinator.ranks(decision.to_slices)
        source = order.index(coordinator.slice_devices[survivors[0]][0])
        per = coordinator.mesh_config.data
        block = sorted(decision.to_slices).index(survivors[0]) * per
        coord = list(self.mesh.get_coordinate())
        coord[0] = block + coord[0] % per
        src = int(self.mesh.mesh[tuple(coord)])
        if self.params is None:
            abstract = self._abstract_state()
            state = self._map_state(
                lambda x, pl: torch.zeros(
                    [e - s for s, e in self._region(x.shape, pl)],
                    dtype=x.dtype, device=self.device), abstract)
        else:
            state = self.state
        box = [self.step, [(p, v) for p, v in ckpt_lib._flatten(state)
                           if not isinstance(v, torch.Tensor)]]
        dist.broadcast_object_list(box, src=source)
        group = self.mesh.get_group("data")
        tensors = sorted(((p, v) for p, v in ckpt_lib._flatten(state)
                          if isinstance(v, torch.Tensor)), key=lambda x:
                         repr(x[0]))
        with torch.no_grad():
            for _, t in tensors:
                dist.broadcast(t, src=src, group=group)
        numbers = dict(box[1])
        values = [numbers.get(p, v) for p, v in ckpt_lib._flatten(state)]
        self._set_state(tree_unflatten(state, values))
        self.step = int(box[0])

    def _fit_loop(self, data_iter, num_steps: int, callbacks: list,
                  capture: stepprof.ProfileCapture) -> Dict[str, Any]:
        tokens_per_step = self.config.global_batch_size * self.config.seq_len
        peak = device_peak_flops(self.device)
        if peak and self.mesh is not None:
            peak *= process_count()
        history = []
        profiler = stepprof.StepProfiler(
            goodput.LEDGER, replay_until=self._replay_until)
        prefetching = isinstance(data_iter, Prefetcher)
        t_window = time.perf_counter()
        window_steps = 0
        last_metrics = None

        def flush_window(metrics):
            nonlocal t_window, window_steps
            # float() waits for the device: the wall time is taken after
            t_sync = time.perf_counter()
            entry = {k: float(v) for k, v in metrics.items()}
            profiler.record_sync(self.step, time.perf_counter() - t_sync)
            dt = time.perf_counter() - t_window
            tokens_s = tokens_per_step * window_steps / dt
            entry.update(step=self.step, tokens_per_sec=tokens_s)
            ti.TRAIN_TOKENS_PER_SEC.set(tokens_s)
            if self.spec.flops_per_token and peak:
                entry["mfu"] = self.spec.flops_per_token * tokens_s / peak
                ti.TRAIN_MFU.set(entry["mfu"])
            telemetry.add_span(
                "train.window", time.time() - dt, dt,
                step=self.step, steps=window_steps,
                tokens_per_sec=round(tokens_s, 1))
            history.append(entry)
            for cb in callbacks:
                cb(self, entry)
            goodput.LEDGER.tick()
            capture.poll()
            t_window = time.perf_counter()
            window_steps = 0

        for _ in range(num_steps):
            t_step = time.perf_counter()
            batch = next(data_iter)
            t_data = time.perf_counter()
            # a no-op for the prefetcher's device-resident batches
            batch = put_device_batch(batch, self.device)
            t_put = time.perf_counter()
            profiler.dispatch_begin()
            last_metrics = self.train_step(batch)
            t_dispatch = time.perf_counter()
            self.step += 1
            window_steps += 1
            # host wall per step: the card retires the work later, and
            # the window's sync is the honest throughput number
            ti.TRAIN_STEP_SECONDS.observe(t_dispatch - t_step)
            ti.TRAIN_STEPS.inc()
            wait_s = t_data - t_step
            sync_s = self._last_sync_s
            profiler.record_step(
                self.step, 0.0 if prefetching else wait_s,
                t_put - t_data, max(t_dispatch - t_put - sync_s, 0.0),
                prefetch_wait_s=wait_s if prefetching else 0.0)
            if sync_s:
                profiler.record_grad_sync(self.step, sync_s)
            if capture.active:
                capture.step_done(tree_leaves(self.params)[0])
            if (self.checkpointer is not None
                    and self.config.checkpoint_every
                    and self.step % self.config.checkpoint_every == 0):
                self._save(self.step)
            if self.step % self.config.log_every == 0:
                flush_window(last_metrics)
        if window_steps and last_metrics is not None:
            flush_window(last_metrics)
        return {"history": history, "final_step": self.step}


def _as_long(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Integer arrays as int64 (numpy on the host, or tensors where they
    lie); floats and bools as they are."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            integer = not (v.is_floating_point() or v.is_complex()
                           or v.dtype == torch.bool)
            return v.long() if integer else v
        v = np.asarray(v)
        return v.astype(np.int64) if v.dtype.kind in "iu" else v
    return {k: cast(v) for k, v in batch.items()}
