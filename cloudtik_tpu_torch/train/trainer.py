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
for the data, fsdp, expert and seq axes.  Each parameter is placed by
`tree_to_shardings_safe` of the spec's logical axes and held as this
rank's shard; the optimizer state mirrors it and AdamW runs on the shards.
A step issues what GSPMD derives there:

* fsdp: a stacked layer leaf is gathered layer by layer where the layer
  reads it (parallel/fsdp.py), every other sharded leaf at the step's
  start; its gradient comes back reduce-scattered.
* every gradient is summed over the token axes (data, fsdp, seq) it is
  not split on: each rank's loss is its share of the global loss
  (models/transformer.py `loss_fn`), so the sum is the global gradient.
* expert: each rank holds E/n experts and keeps their gradients; leaves
  replicated over `expert` get identical gradients there, not summed.
* seq: each rank takes its slice of the sequence (`data.local_batch`);
  attention runs the ring.
* the clip's global norm sums the shards' squares over their group.

`fit` takes global batches (every rank the same stream) and hands each
rank its shard.  A checkpoint gathers each leaf and rank 0 writes the
port's format; a restore reads it on every rank and re-shards.  MFU
divides by the world size.  Only specs with logical axes (the
transformer, LoRA) train on a mesh; the tensor and pipe axes, the
overlapped gradient sync, elastic re-meshing and per-rank checkpoint shards
wait for slices 12-13 of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.parallel import collectives, fsdp, sharding
from cloudtik_tpu_torch.parallel.distributed import (process_count,
                                                     rank_device)
from cloudtik_tpu_torch.parallel.mesh import (TOKEN_AXES, MeshConfig,
                                              axis_sizes_of, build_mesh,
                                              check_ported,
                                              local_batch_slice)
from cloudtik_tpu_torch.parallel.sharding import (AxisRules, DEFAULT_RULES,
                                                  spec_axes,
                                                  tree_to_shardings_safe)
from cloudtik_tpu_torch.telemetry import events, goodput, stepprof
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                 Checkpointer)
from cloudtik_tpu_torch.train.data import local_batch
from cloudtik_tpu_torch.train.optim import (Adafactor, OptimizerConfig,
                                            _norm_accumulator,
                                            make_optimizer)
from cloudtik_tpu_torch.train.prefetch import Prefetcher, put_device_batch
from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def transformer_spec(cfg) -> ModelSpec:
    from cloudtik_tpu_torch.models import transformer as T

    return ModelSpec(
        init=lambda gen, device: T.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: T.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_token(),
        logical_axes=T.param_logical_axes(cfg),
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
    )


def resnet_spec(cfg) -> ModelSpec:
    """Image classification: "token" accounting is per image
    (seq_len=1)."""
    from cloudtik_tpu_torch.models import resnet as R

    return ModelSpec(
        init=lambda gen, device: R.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: R.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
    )


def ssd_spec(cfg) -> ModelSpec:
    """Single-shot detection (SSD-ResNet34): per-image accounting."""
    from cloudtik_tpu_torch.models import ssd as S

    return ModelSpec(
        init=lambda gen, device: S.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: S.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
    )


def maskrcnn_spec(cfg) -> ModelSpec:
    """Two-stage detection (Mask R-CNN): per-image accounting."""
    from cloudtik_tpu_torch.models import maskrcnn as M

    return ModelSpec(
        init=lambda gen, device: M.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: M.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
    )


def dlrm_spec(cfg) -> ModelSpec:
    """Click prediction: per-example accounting (seq_len=1)."""
    from cloudtik_tpu_torch.models import dlrm as D

    return ModelSpec(
        init=lambda gen, device: D.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: D.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_example(),
    )


def diffusion_spec(cfg) -> ModelSpec:
    """Latent-diffusion UNet: per-image accounting (seq_len=1)."""
    from cloudtik_tpu_torch.models import diffusion as U

    return ModelSpec(
        init=lambda gen, device: U.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: U.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_image(),
    )


def rnnt_spec(cfg) -> ModelSpec:
    """Speech transducer: per-frame accounting (seq_len = frames)."""
    from cloudtik_tpu_torch.models import rnnt as N

    return ModelSpec(
        init=lambda gen, device: N.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: N.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_frame(),
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
    # Async input pipeline (train/prefetch.py): batches are pulled and
    # copied to the card on background threads, behind a bounded queue
    # of this depth.  0 = the synchronous input path.
    prefetch_depth: int = 2
    prefetch_threads: int = 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter's shards lie: (dim, mesh axis) pairs."""

    dims: Tuple[Tuple[int, str], ...] = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for _, a in self.dims)

    def dim_of(self, axis: str) -> Optional[int]:
        return next((d for d, a in self.dims if a == axis), None)


NEXT_SLICES = "slices 12-13 of the port (ROADMAP A7)"


def _mesh_for(config: MeshConfig):
    """The DeviceMesh `config` asks for over the process group, or None
    for one process.  A mesh that needs more ranks than there are
    raises (axis_sizes), so no parallel path runs on one rank."""
    check_ported({a: getattr(config, a) for a in ("tensor", "pipe")})
    check_ported(config.axis_sizes(process_count()))
    return None if process_count() == 1 else build_mesh(config)


class Trainer:
    """Holds params and optimizer state on one device (or this rank's
    shards on a mesh) and runs the loop."""

    def __init__(self, spec: ModelSpec, config: TrainerConfig,
                 device: DeviceLike = None, mesh=None):
        self.spec = spec
        self.config = config
        self.mesh = mesh if mesh is not None else _mesh_for(config.mesh)
        self.optimizer = make_optimizer(config.optimizer)
        self._placements = None
        if self.mesh is None:
            self.device = resolve_device(device)
        else:
            check_ported(axis_sizes_of(self.mesh))
            self.device = rank_device(device)
            self._placements = self._place()
        self.params = None
        self.opt_state = None
        self.step = 0
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
            raise NotImplementedError(
                "this model family has no logical axes yet: training it on "
                f"a mesh comes with {NEXT_SLICES}")
        shapes = self.spec.init(torch.Generator(), torch.device("meta"))
        specs = tree_to_shardings_safe(self.mesh, self.spec.logical_axes,
                                       shapes, self.config.rules)

        def one(params, spec):
            if isinstance(params, dict):
                return {k: one(v, spec[k]) for k, v in params.items()}
            if isinstance(params, (list, tuple)):
                return type(params)(one(v, spec[i])
                                    for i, v in enumerate(params))
            dims = []
            for dim, entry in enumerate(spec):
                axes = spec_axes(entry)
                if len(axes) > 1 or (axes and axes[0] not in
                                     ("fsdp", "expert")):
                    raise NotImplementedError(
                        f"a parameter split over {axes}: only fsdp and "
                        f"expert placements are ported ({NEXT_SLICES})")
                if axes:
                    dims.append((dim, axes[0]))
            return Placement(tuple(dims))

        placements = one(shapes, specs)
        if isinstance(self.optimizer, Adafactor) and any(
                p.dims for p in tree_leaves(placements)):
            raise NotImplementedError(
                "Adafactor factors whole leaves; on sharded parameters it "
                f"comes with {NEXT_SLICES}")
        return placements

    def _shard(self, full: torch.Tensor, pl: Placement) -> torch.Tensor:
        for dim, axis in pl.dims:
            full = full.chunk(self._axis(axis), dim)[
                self.mesh.get_local_rank(axis)]
        return full.contiguous()

    def _gather(self, local, pl: Placement):
        """The whole leaf from this rank's shard (every rank calls it)."""
        for dim, axis in reversed(pl.dims):
            local = collectives.gather_full(local, dim,
                                            self.mesh.get_group(axis))
        return local

    def _map_state(self, fn, state: Dict[str, Any]) -> Dict[str, Any]:
        """fn(leaf, placement) over params and the optimizer state's
        param-shaped trees (every entry but the step count)."""
        opt = {k: (tree_map(fn, v, self._placements)
                   if isinstance(v, (dict, list)) else v)
               for k, v in state["opt_state"].items()}
        return {"params": tree_map(fn, state["params"], self._placements),
                "opt_state": opt}

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
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0

    @property
    def state(self) -> Dict[str, Any]:
        """{"params", "opt_state"}: what a checkpoint holds."""
        return {"params": self.params, "opt_state": self.opt_state}

    def _set_state(self, state: Dict[str, Any]) -> None:
        """Take a whole restored state (this rank's shard of it on a
        mesh)."""
        if self.mesh is not None:
            state = self._map_state(lambda x, pl: self._shard(x, pl), state)
        self.params = tree_map(lambda p: p.detach().requires_grad_(True),
                               state["params"])
        self.opt_state = state["opt_state"]
        self._follow_params()

    def _follow_params(self) -> None:
        """Re-key the placements in the params' own order (a tree from
        JAX comes with sorted keys), so their leaves pair up in order."""
        if self._placements is not None:
            self._placements = tree_map(lambda _, pl: pl, self.params,
                                        self._placements)

    def full_state(self) -> Dict[str, Any]:
        """{params, opt_state} whole: on a mesh every leaf gathered (every
        rank must call it)."""
        if self.mesh is None:
            return self.state
        return self._map_state(self._gather, self.state)

    def _save(self, step: int, force: bool = False) -> bool:
        """Save the whole state: on a mesh each leaf is gathered and rank
        0 writes it."""
        state = self.full_state()
        if self.mesh is not None and dist.get_rank() != 0:
            return False
        return self.checkpointer.save(step, state, force=force)

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, force: bool = False) -> bool:
        """Save the current state; returns True if a save started."""
        if self.checkpointer is None:
            raise RuntimeError("checkpointing not configured "
                               "(set checkpoint_dir + checkpoint_every)")
        return self._save(self.step, force=force)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore the state onto the trainer's device; returns the step.
        The template is on the "meta" device: no init runs and no second
        copy of the state is ever resident."""
        if self.checkpointer is None:
            raise RuntimeError("checkpointing not configured")
        step = (step if step is not None
                else self.checkpointer.latest_step())
        self._set_state(self.checkpointer.restore(
            self._abstract_state(), step=step, device=self.device))
        self.step = int(step)
        self._note_resume()
        return self.step

    def _note_resume(self) -> None:
        """Reconstruct the restart-replay horizon from the flight
        recorder: steps the previous incarnation already ran (the newest
        checkpoint_commit of THIS checkpoint directory) that this one
        re-runs count as restart_replay, not progress."""
        directory = self.checkpointer.config.directory \
            if self.checkpointer is not None else None
        horizon = goodput.replay_horizon(self.step, directory=directory)
        self._replay_until = horizon if horizon > self.step else 0
        events.emit("tik_train_resume", step=self.step,
                    replay_until=self._replay_until)

    def _abstract_state(self) -> Dict[str, Any]:
        """{params, opt_state} of "meta" tensors: the shapes and dtypes a
        restore checks and casts to, for any of the optimizers' states."""
        params = self.spec.init(torch.Generator(), torch.device("meta"))
        return {"params": params, "opt_state": self.optimizer.init(params)}

    def maybe_resume(self) -> Optional[int]:
        """Resume from the newest *readable* checkpoint, if any: a step
        whose data does not read back (torn write) is skipped and the
        previous committed step is used instead."""
        if self.checkpointer is None or not self.checkpointer.all_steps():
            return None
        restored = self.checkpointer.restore_latest_good(
            self._abstract_state(), device=self.device)
        if restored is None:
            return None
        state, step = restored
        self._set_state(state)
        self.step = int(step)
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
        """The tree the loss reads: fsdp-split layer-stack leaves as
        `LayerShards` (gathered per layer), other fsdp-split leaves
        gathered now; expert-split leaves stay this rank's."""
        group = self.mesh.get_group("fsdp") if self._axis("fsdp") > 1 \
            else None

        def use(in_layers, p, pl):
            d = pl.dim_of("fsdp")
            if d is None or group is None:
                return p
            if in_layers:
                return fsdp.LayerShards(p, d, group)
            return collectives.gather_dim(p, d, group)

        params, placements = self.params, self._placements
        if isinstance(params, dict):
            return {k: tree_map(lambda p, pl, lay=(k == "layers"):
                                use(lay, p, pl), v, placements[k])
                    for k, v in params.items()}
        return tree_map(lambda p, pl: use(False, p, pl), params, placements)

    def _sharded_grads(self, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(self.params)
        with sharding.use_mesh(self.mesh):
            loss, metrics = self.spec.loss_fn(self._use_tree(), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        synced = []
        for g, pl in zip(grads, tree_leaves(self._placements)):
            for axis in TOKEN_AXES:
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

    def _accumulated_grads(self, batch: Dict[str, torch.Tensor], accum: int):
        if accum == 1:
            return self._grads(batch)
        # the mean of the micro-batch grads, summed in f32 (the JAX
        # package's sequential reference path)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        grads, stacked = None, []
        for i in range(accum):
            g, m = self._grads({k: v[i] for k, v in micro.items()})
            grads = tree_map(lambda x: x.float(), g) if grads is None \
                else tree_map(torch.add, grads, g)
            stacked.append(m)
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
                if self.mesh is not None:
                    # global batches in, this rank's shard on
                    local_batch_slice(self.mesh,
                                      self.config.global_batch_size)
                    data_iter = map(
                        lambda b: local_batch(b, self.mesh), data_iter)
                # integer ids as int64, whatever the source gives; floats
                # (images, boxes, masks) as they are
                data_iter = map(_as_long, data_iter)
                if self.config.prefetch_depth > 0:
                    # max_items: a fit consumes exactly num_steps batches,
                    # as the synchronous loop would
                    prefetcher = data_iter = Prefetcher(
                        data_iter, device=self.device,
                        depth=self.config.prefetch_depth,
                        threads=self.config.prefetch_threads,
                        max_items=num_steps)
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
            profiler.record_step(
                self.step, 0.0 if prefetching else wait_s,
                t_put - t_data, t_dispatch - t_put,
                prefetch_wait_s=wait_s if prefetching else 0.0)
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
