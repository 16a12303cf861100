"""Entry points of the port for a one-card forward and a multi-rank dry
run.

Counterpart of the root `__graft_entry__.py`.  `entry()` returns a forward
of the flagship transformer (tpu_1b at 512 tokens, B=1) with its inputs on
the card.  `dryrun_multichip(n)` spawns n ranks on the CPU over gloo
(`parallel.launch.run_ranks`, with a deadline) and runs the reference's
three passes, one training step each on tiny shapes:

1. the mesh `_pick_mesh(n)` factors n into (data, fsdp, seq, tensor)
   covering dp/fsdp/sp/tp (at n=8 the ring runs under `tensor`);
2. pipe=2 with fsdp filling, GPipe, 4 layers (n even);
3. pipe=4 under 1F1B with 8 microbatches, 4 layers (n divisible by 4).

Each prints the reference's OK line; a bad loss raises.

    python -m cloudtik_tpu_torch.graft_entry [n]
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path

DRYRUN_DEADLINE_S = 600.0


def entry(device=None):
    """(fn, example_args): `forward` of tpu_1b at 512 tokens, B=1, on the
    card unless `device` says otherwise."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.device import resolve_device
    from cloudtik_tpu_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = T.config("tpu_1b", max_seq_len=512, remat=False)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 512)),
        dtype=torch.long, device=dev)
    fn = functools.partial(T.forward, cfg=cfg)
    return fn, (params, tokens)


def _pick_mesh(n_devices: int):
    """Factor n into (data, fsdp, seq, tensor) covering dp/fsdp/sp/tp."""
    from cloudtik_tpu_torch.parallel.mesh import MeshConfig

    axes = {"data": 1, "fsdp": 1, "seq": 1, "tensor": 1}
    # Assign factors of 2 round-robin in priority order until n is consumed.
    order = ["fsdp", "tensor", "seq", "data"]
    remaining = n_devices
    i = 0
    while remaining > 1:
        if remaining % 2 == 0:
            axes[order[i % len(order)]] *= 2
            remaining //= 2
        else:
            axes["data"] *= remaining
            remaining = 1
        i += 1
    return MeshConfig(data=axes["data"], fsdp=axes["fsdp"],
                      seq=axes["seq"], tensor=axes["tensor"])


def dryrun_multichip(n_devices: int,
                     timeout_s: float = DRYRUN_DEADLINE_S) -> None:
    """Spawn `n_devices` gloo ranks on the CPU and run the three passes;
    prints rank 0's OK lines.  Raises `RankFailure` (every rank's output
    attached) if a rank fails or the deadline passes."""
    from cloudtik_tpu_torch.parallel.launch import run_ranks

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    outs = run_ranks(["-m", "cloudtik_tpu_torch.graft_entry", "--rank",
                      str(int(n_devices))], int(n_devices), timeout_s,
                     env=env, cwd=str(root))
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith("dryrun_multichip")]
    sys.stdout.write("".join(ln + "\n" for ln in lines))


def _one_step(n_devices: int, cfg, mesh_config, label: str) -> None:
    import torch.distributed as dist

    from cloudtik_tpu_torch.parallel.mesh import mesh_summary
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)

    seq = 128
    batch = max(8, 2 * n_devices)
    trainer = Trainer(
        transformer_spec(cfg),
        TrainerConfig(global_batch_size=batch, seq_len=seq, log_every=1,
                      mesh=mesh_config), device="cpu")
    out = trainer.fit(synthetic_lm_batches(batch, seq, cfg.vocab_size),
                      num_steps=1)
    loss = out["history"][0]["loss"]
    if not loss > 0:
        raise RuntimeError(f"bad {label}loss {loss}")
    if dist.get_rank() == 0:
        name = f" {label.strip()}" if label else ""
        print(f"dryrun_multichip({n_devices}){name} OK: mesh="
              f"{mesh_summary(trainer.mesh)} loss={loss:.3f}", flush=True)


def _rank_main(n_devices: int) -> int:
    """One rank of the dry run (run by `dryrun_multichip`)."""
    import torch

    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.parallel.distributed import auto_initialize
    from cloudtik_tpu_torch.parallel.mesh import MeshConfig

    torch.set_num_threads(1)
    auto_initialize(backend="gloo")
    # tiny shapes, real splits: tensor divides heads and mlp, seq the
    # sequence, data and fsdp the batch
    cfg = T.config("tiny", n_heads=8, n_kv_heads=8, d_ff=256, remat=False)
    _one_step(n_devices, cfg, _pick_mesh(n_devices), "")
    if n_devices % 2 == 0:
        cfg_p = T.config("tiny", n_layers=4, n_heads=8, n_kv_heads=8,
                         d_ff=256, remat=False)
        _one_step(n_devices, cfg_p, MeshConfig(
            data=1, fsdp=-1, pipe=2, seq=1, tensor=1), "pipeline ")
    if n_devices % 4 == 0:
        cfg_p4 = T.config("tiny", n_layers=4, n_heads=8, n_kv_heads=8,
                          d_ff=256, remat=False, pipeline_schedule="1f1b",
                          pipeline_microbatches=8)
        _one_step(n_devices, cfg_p4, MeshConfig(
            data=1, fsdp=-1, pipe=4, seq=1, tensor=1), "pipe4/1f1b ")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        sys.exit(_rank_main(int(sys.argv[2])))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
