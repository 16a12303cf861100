"""Shared recipe harness: arguments, the trainer, the throughput report.

Counterpart of `examples/recipes/common.py`: the same flags and defaults
and the same one JSON result line.  With every mesh flag at 1 a recipe
trains on one card.  With `--data --fsdp --tensor --seq --expert` above 1
it is one rank of a mesh, whatever the model family: run it under
`torchrun --nproc-per-node N` or the port's tik-run (`python -m
cloudtik_tpu_torch.launch.run --nproc-per-node N -m <recipe>`, one process
per card on every host: parallel/distributed.py maps its env), and the
flags' product must be the world size; `--batch` is the global batch,
which must split over data x fsdp.  Every rank prints the result line.  As in the reference
there is no `--pipe` flag (the pipe axis is `MeshConfig(pipe=...)`).
`--device` picks the card (the default; on a mesh cuda:LOCAL_RANK) or the
CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import torch

from cloudtik_tpu_torch.device import resolve_device
from cloudtik_tpu_torch.parallel import distributed
from cloudtik_tpu_torch.parallel.mesh import MeshConfig
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


def _wide(args) -> Dict[str, int]:
    return {a: getattr(args, a) for a in MESH_AXES if getattr(args, a) != 1}


def mesh_config(args) -> Optional[MeshConfig]:
    """The mesh the flags ask for, or None when every axis is 1."""
    wide = _wide(args)
    if not wide:
        return None
    return MeshConfig(data=args.data, fsdp=args.fsdp, seq=args.seq,
                      expert=args.expert, tensor=args.tensor)


def recipe_device(args) -> torch.device:
    """Where this process computes: `--device` on one card; on a mesh the
    process group comes up first (from torchrun's or tik-run's env; gloo
    for `--device cpu`) and the card is cuda:LOCAL_RANK."""
    if mesh_config(args) is None:
        return resolve_device(args.device)
    distributed.auto_initialize(
        backend="gloo" if args.device == "cpu" else None)
    return distributed.rank_device(
        None if args.device == "cuda" else args.device)


def build_recipe_trainer(spec, args, seq_len: int = 1,
                         optimizer: Optional[OptimizerConfig] = None
                         ) -> Trainer:
    """The Trainer for the parsed `args` (and `optimizer`, the default
    `OptimizerConfig` unless given): one card, or this rank of the mesh
    the flags ask for."""
    mesh = mesh_config(args)
    return Trainer(spec, TrainerConfig(
        global_batch_size=args.batch, seq_len=seq_len,
        mesh=mesh or MeshConfig(),
        optimizer=optimizer or OptimizerConfig(),
        log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every), device=recipe_device(args))


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
