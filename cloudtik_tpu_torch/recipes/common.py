"""Shared recipe harness: arguments, the trainer, the throughput report.

Counterpart of `examples/recipes/common.py`: the same flags and defaults
and the same one JSON result line.  The port trains on one card, so the
mesh flags (`--data --fsdp --tensor --seq --expert`) take only 1 until the
parallel layer is ported (ROADMAP A7); `--device` picks the card (the
default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.train.optim import OptimizerConfig
from cloudtik_tpu_torch.train.trainer import Trainer, TrainerConfig

MESH_AXES = ("data", "fsdp", "tensor", "seq", "expert")


def recipe_argparser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--data", type=int, default=1, help="data mesh axis")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--expert", type=int, default=1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def build_recipe_trainer(spec, args, seq_len: int = 1,
                         optimizer: Optional[OptimizerConfig] = None
                         ) -> Trainer:
    """The one-card Trainer for the parsed `args` (and `optimizer`, the
    default `OptimizerConfig` unless given); any mesh axis other than 1
    raises."""
    wide = {a: getattr(args, a) for a in MESH_AXES if getattr(args, a) != 1}
    if wide:
        raise ValueError(f"mesh axes {wide}: the port trains on one card; "
                         "the parallel layer is ROADMAP A7")
    return Trainer(spec, TrainerConfig(
        global_batch_size=args.batch, seq_len=seq_len,
        optimizer=optimizer or OptimizerConfig(),
        log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every), device=args.device)


def run_and_report(trainer: Trainer, data, steps: int,
                   items_per_step: float, unit: str) -> Dict[str, Any]:
    """Train; print one JSON result line with throughput (+MFU if known)."""
    t0 = time.perf_counter()
    out = trainer.fit(data, num_steps=steps)
    dt = time.perf_counter() - t0
    last = out["history"][-1] if out["history"] else {}
    result = {
        "steps": steps,
        f"{unit}_per_sec": round(items_per_step * steps / dt, 2),
        "wall_s": round(dt, 2),
        "final_loss": (round(float(last["loss"]), 4)
                       if "loss" in last else None),
    }
    if "mfu" in last:
        result["mfu"] = round(float(last["mfu"]), 4)
    print(json.dumps(result))
    return result
