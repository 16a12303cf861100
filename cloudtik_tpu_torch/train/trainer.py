"""The training loop on one card: a step of grads + the optimizer, an MFU
meter, checkpoints and an async input pipeline.

Counterpart of the single-device core of `cloudtik_tpu/train/trainer.py`:
`ModelSpec`, `transformer_spec`, `bert_spec`, `resnet_spec`, `ssd_spec`,
`maskrcnn_spec`, `dlrm_spec`, `diffusion_spec`, `rnnt_spec`,
`graphsage_spec` (and `models/lora.py`'s `lora_spec`; the image, DLRM and
graph models count one "token" an image, an example or a node, so their
TrainerConfig has seq_len=1, and RNN-T one a frame),
`TrainerConfig`, `Trainer.init_state` /
`fit` with the same history keys (loss, n_tokens, accuracy, grad_norm,
step, tokens_per_sec, mfu), gradient accumulation as the mean of the
micro-batch gradients, and the update `p + u.to(p.dtype)`.  PyTorch runs
eagerly, so a step is the loss's forward and backward, then the optimizer;
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

Not here yet (ROADMAP A7): the mesh and shardings, the overlapped
gradient sync and elastic re-meshing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.telemetry import events, goodput, stepprof
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                 Checkpointer)
from cloudtik_tpu_torch.train.optim import OptimizerConfig, make_optimizer
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


def transformer_spec(cfg) -> ModelSpec:
    from cloudtik_tpu_torch.models import transformer as T

    return ModelSpec(
        init=lambda gen, device: T.init_params(gen, cfg, device),
        loss_fn=lambda params, batch: T.loss_fn(params, batch, cfg),
        flops_per_token=cfg.flops_per_token(),
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
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
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


class Trainer:
    """Holds params and optimizer state on one device and runs the loop."""

    def __init__(self, spec: ModelSpec, config: TrainerConfig,
                 device: DeviceLike = None):
        self.spec = spec
        self.config = config
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(config.optimizer)
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
        self.params = tree_map(
            lambda p: p.detach().to(self.device).requires_grad_(True), params)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0

    @property
    def state(self) -> Dict[str, Any]:
        """{"params", "opt_state"}: what a checkpoint holds."""
        return {"params": self.params, "opt_state": self.opt_state}

    def _set_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_map(lambda p: p.detach().requires_grad_(True),
                               state["params"])
        self.opt_state = state["opt_state"]

    # -- checkpoint --------------------------------------------------------
    def save_checkpoint(self, force: bool = False) -> bool:
        """Save the current state; returns True if a save started."""
        if self.checkpointer is None:
            raise RuntimeError("checkpointing not configured "
                               "(set checkpoint_dir + checkpoint_every)")
        return self.checkpointer.save(self.step, self.state, force=force)

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
        loss, metrics = self.spec.loss_fn(self.params, batch)
        leaves = tree_leaves(self.params)
        # a leaf the loss never reads (BERT's mlm_bias) gets a zero
        # gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return tree_unflatten(self.params, list(grads)), metrics

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
            updates, self.opt_state, grad_norm = self.optimizer.update(
                grads, self.opt_state, self.params)
            with torch.no_grad():
                tree_map(lambda p, u: p.add_(u.to(p.dtype)), self.params,
                         updates)
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
        if (self.checkpointer is not None and every
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
                self.checkpointer.save(self.step, self.state)
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
