"""The training loop on one card: a step of grads + the optimizer, an MFU
meter, checkpoints and an async input pipeline.

Counterpart of the single-device core of `cloudtik_tpu/train/trainer.py`:
`ModelSpec`, `transformer_spec`, `bert_spec` (and `models/lora.py`'s
`lora_spec`), `TrainerConfig`, `Trainer.init_state` /
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
re-runs book as `restart_replay`.

Not here yet (ROADMAP A5, A7, A8): the mesh and shardings, the
overlapped gradient sync, elastic re-meshing, `profile_dir`, and the other
model families' specs.
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
            num_steps: int, callbacks: Optional[list] = None
            ) -> Dict[str, Any]:
        """Run `num_steps` training steps; returns {"history",
        "final_step"}, one history entry per `log_every` steps (and one for
        a final partial window).  Each `callbacks` entry is called as
        cb(trainer, entry) after each window."""
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
        try:
            if not isinstance(data_iter, Prefetcher):
                # token ids as int64, whatever the source gives
                data_iter = map(_as_long, data_iter)
                if self.config.prefetch_depth > 0:
                    # max_items: a fit consumes exactly num_steps batches,
                    # as the synchronous loop would
                    prefetcher = data_iter = Prefetcher(
                        data_iter, device=self.device,
                        depth=self.config.prefetch_depth,
                        threads=self.config.prefetch_threads,
                        max_items=num_steps)
            return self._fit_loop(data_iter, num_steps, callbacks or [])
        finally:
            if prefetcher is not None:
                prefetcher.close()
            goodput.LEDGER.tick()
            goodput.maybe_write_snapshot()

    def _fit_loop(self, data_iter, num_steps: int,
                  callbacks: list) -> Dict[str, Any]:
        tokens_per_step = self.config.global_batch_size * self.config.seq_len
        peak = device_peak_flops(self.device)
        history = []
        profiler = stepprof.StepProfiler(
            goodput.LEDGER, replay_until=self._replay_until)
        capture = stepprof.ProfileCapture()
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
        capture.stop(tree_leaves(self.params)[0])
        return {"history": history, "final_step": self.step}


def _as_long(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Token ids as int64 (numpy on the host, or tensors where they lie)."""
    return {k: v.long() if isinstance(v, torch.Tensor)
            else np.asarray(v, dtype=np.int64) for k, v in batch.items()}
