"""The training loop on one card: a step of grads + AdamW, and an MFU meter.

Counterpart of the single-device core of `cloudtik_tpu/train/trainer.py`:
`ModelSpec`, `transformer_spec`, `TrainerConfig`, `Trainer.init_state` /
`fit` with the same history keys (loss, n_tokens, accuracy, grad_norm,
step, tokens_per_sec, mfu), gradient accumulation as the mean of the
micro-batch gradients, and the update `p + u.to(p.dtype)`.  PyTorch runs
eagerly, so a step is the loss's forward and backward, then the optimizer;
the float() of the metrics at a log window waits for the device, and the
window's wall time is taken after it.

Not here yet (ROADMAP A5-A7): the mesh and shardings, the overlapped
gradient sync, prefetch, checkpointing, elastic re-meshing, goodput /
stepprof / telemetry, `profile_dir`, and the other model families' specs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.train.optim import OptimizerConfig, make_optimizer
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


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int = 8
    seq_len: int = 2048
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    log_every: int = 10
    # Each optimizer step averages the gradients of this many sequential
    # micro-batches (the batch splits on its leading dim).
    grad_accum_steps: int = 1


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

    # -- one step ------------------------------------------------------------
    def _grads(self, batch: Dict[str, torch.Tensor]):
        loss, metrics = self.spec.loss_fn(self.params, batch)
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves)
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

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, torch.long)
                for k, v in batch.items()}

    # -- loop ----------------------------------------------------------------
    def fit(self, data_iter: Iterator[Dict[str, np.ndarray]],
            num_steps: int) -> Dict[str, Any]:
        """Run `num_steps` training steps; returns {"history",
        "final_step"}, one history entry per `log_every` steps (and one for
        a final partial window)."""
        if self.params is None:
            self.init_state()
        tokens_per_step = self.config.global_batch_size * self.config.seq_len
        peak = device_peak_flops(self.device)
        history = []
        t_window = time.perf_counter()
        window_steps = 0
        last_metrics = None

        def flush_window(metrics):
            nonlocal t_window, window_steps
            # float() waits for the device: the wall time is taken after
            entry = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t_window
            tokens_s = tokens_per_step * window_steps / dt
            entry.update(step=self.step, tokens_per_sec=tokens_s)
            if self.spec.flops_per_token and peak:
                entry["mfu"] = self.spec.flops_per_token * tokens_s / peak
            history.append(entry)
            t_window = time.perf_counter()
            window_steps = 0

        for _ in range(num_steps):
            batch = self._device_batch(next(data_iter))
            last_metrics = self.train_step(batch)
            self.step += 1
            window_steps += 1
            if self.step % self.config.log_every == 0:
                flush_window(last_metrics)
        if window_steps and last_metrics is not None:
            flush_window(last_metrics)
        return {"history": history, "final_step": self.step}
