#!/usr/bin/env python3
"""Multi-rank cases of the port's parallel layer, one process per rank.

    python tools/torch_parallel_cases.py <cases.pt> <out_dir>

Run by `cloudtik_tpu_torch.parallel.launch.run_ranks` with as many ranks
as the widest case.  `cases.pt` holds {"cases": [...]}; each case names
its `kind` ("train", "ring" or "collectives"), its `world` (ranks above
it sit the case out) and its inputs.  Each case gets its own process
group (gloo on the CPU unless the case says "device": "cuda", a FileStore
in `out_dir`, a 60 s timeout), and each rank writes its result to
`<out_dir>/<name>.rank<r>.pt`.  A case may plant a fault ("fault"), to
show that the caller's check catches it:

  aux_per_rank      MoE's router statistics from this rank's tokens only
  expert_bwd_twice  the expert all-reduce's backward all-reduces again
  ring_drop_block   the ring's backward leaves out one block's terms

This module imports no JAX: the tests compare its results with the JAX
package in their own process.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cloudtik_tpu_torch.parallel import collectives, distributed  # noqa: E402
from cloudtik_tpu_torch.parallel import mesh as PM  # noqa: E402
from cloudtik_tpu_torch.parallel import sharding  # noqa: E402


def plant(fault):
    """Install one planted fault (see the module docstring); returns the
    function that takes it out again."""
    from cloudtik_tpu_torch.ops import moe, ring_attention as R

    saved = (moe.DATA_AXES, moe.collectives, R._mask, R._Ring.backward)

    def undo():
        moe.DATA_AXES, moe.collectives, R._mask = saved[:3]
        R._Ring.backward = staticmethod(saved[3])

    if fault is None:
        return undo
    if fault == "aux_per_rank":
        moe.DATA_AXES = ()
    elif fault == "expert_bwd_twice":
        import torch.distributed.nn.functional as DF

        real = collectives

        class Shim:
            all_reduce = staticmethod(real.all_reduce)
            copy_to = staticmethod(real.copy_to)

            @staticmethod
            def reduce_sum(x, axes):
                if tuple(axes) == ("expert",):
                    return DF.all_reduce(x, group=sharding.axis_group(
                        "expert"))
                return real.reduce_sum(x, axes)

        moe.collectives = Shim
    elif fault == "ring_drop_block":
        real_mask, real_bwd = R._mask, R._Ring.backward
        state = {"bwd": False}

        def mask(i, j, S, device):
            m = real_mask(i, j, S, device)
            return m & False if state["bwd"] and j == 0 and i > 0 else m

        def backward(ctx, d_out):
            state["bwd"] = True
            try:
                return real_bwd(ctx, d_out)
            finally:
                state["bwd"] = False

        R._mask = mask
        R._Ring.backward = staticmethod(backward)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return undo


def case_train(case, device):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.models.lora import LoRAConfig, lora_spec
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)
    from cloudtik_tpu_torch.tree import tree_map

    cfg = T.config(case["model"], dtype=torch.float32,
                   **case.get("overrides", {}))
    params = tree_map(lambda t: t.to(device), case["params"])
    if case.get("lora_rank"):
        spec = lora_spec(params, cfg, LoRAConfig(rank=case["lora_rank"]))
        params = tree_map(lambda t: t.to(device), case["lora_params"])
    else:
        spec = transformer_spec(cfg)
    tcfg = TrainerConfig(
        global_batch_size=case["batch"], seq_len=case["seq"],
        mesh=PM.MeshConfig(**case["mesh"]),
        optimizer=OptimizerConfig(**case.get("optimizer", {})),
        rules=sharding.make_rules(**case.get("rules", {})),
        log_every=1, prefetch_depth=0,
        checkpoint_dir=case.get("checkpoint_dir"),
        checkpoint_every=case.get("checkpoint_every", 0))
    trainer = Trainer(spec, tcfg, device=device)
    trainer.init_state(params=params)
    out = trainer.fit(iter(case["batches"]), case["steps"])
    full = trainer.full_state()
    result = {"history": out["history"],
              "params": tree_map(lambda t: t.detach().cpu(),
                                 full["params"]),
              "local": tree_map(lambda t: tuple(t.shape), trainer.params)}
    if case.get("checkpoint_dir"):
        trainer.checkpointer.wait()
        dist.barrier()
        again = Trainer(spec, tcfg, device=device)
        step = again.restore_checkpoint()
        restored = again.full_state()
        result["restored_step"] = step
        result["restored"] = tree_map(lambda t: t.detach().cpu(),
                                      restored["params"])
    return result


def case_ring(case, device):
    from cloudtik_tpu_torch.ops.attention import attention

    n = dist.get_world_size()
    mesh = PM.build_mesh(PM.MeshConfig(seq=n, fsdp=1))
    i = mesh.get_local_rank("seq")
    q, k, v, do = (torch.as_tensor(case[x]).to(device)
                   for x in ("q", "k", "v", "do"))
    S = q.shape[2] // n

    def mine(t):
        return t[:, :, i * S:(i + 1) * S].clone().requires_grad_(True)

    ql, kl, vl = mine(q), mine(k), mine(v)
    with sharding.use_mesh(mesh):
        out = attention(ql, kl, vl, causal=case["causal"])
        out.backward(do[:, :, i * S:(i + 1) * S])

    def whole(t):
        return collectives.gather_full(t.detach().contiguous(), 2,
                                       mesh.get_group("seq")).cpu()

    return {"out": whole(out), "dq": whole(ql.grad), "dk": whole(kl.grad),
            "dv": whole(vl.grad)}


def case_collectives(case, device):
    """The mesh layout, local_batch's rows, and the collectives' gradients,
    on the mesh the case names."""
    from cloudtik_tpu_torch.train.data import local_batch

    mesh = PM.build_mesh(PM.MeshConfig(**case["mesh"]))
    sizes = PM.axis_sizes_of(mesh)
    coords = {a: (mesh.get_local_rank(a) if sizes[a] > 1 else 0)
              for a in PM.MESH_AXES}
    rows = local_batch({"tokens": case["tokens"]}, mesh)["tokens"]
    result = {"rank": dist.get_rank(), "coords": coords,
              "rows": np.asarray(rows).copy()}
    axis = case["axis"]
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    with sharding.use_mesh(mesh):
        x = torch.full((2, 3), float(r + 1), device=device,
                       requires_grad=True)
        g = collectives.gather_dim(x, 1, group)
        (g * torch.arange(g.numel(), device=device).reshape(g.shape)
         ).sum().backward()
        result["gathered"] = g.detach().cpu()
        result["gather_grad"] = x.grad.cpu()
        y = torch.full((2,), float(r + 1), device=device, requires_grad=True)
        s = collectives.reduce_sum(y, (axis,))
        (s * (r + 1)).sum().backward()
        result["reduce_sum"] = s.detach().cpu()
        result["reduce_sum_grad"] = y.grad.cpu()
        z = torch.ones(2, device=device, requires_grad=True)
        (collectives.copy_to(z, (axis,)) * (r + 1)).sum().backward()
        result["copy_to_grad"] = z.grad.cpu()
    return result


CASES = {"train": case_train, "ring": case_ring,
         "collectives": case_collectives}


def main(cases_path: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    cases = torch.load(cases_path, weights_only=False)["cases"]
    for n, case in enumerate(cases):
        if rank >= case["world"]:
            continue
        device = case.get("device", "cpu")
        distributed.auto_initialize(
            num_processes=case["world"], process_id=rank,
            backend="gloo", timeout_s=60.0,
            init_method=f"file://{out_dir}/store{n}")
        undo = plant(case.get("fault"))
        try:
            result = CASES[case["kind"]](case, device)
        finally:
            undo()
            dist.destroy_process_group()
        torch.save(result, Path(out_dir) / f"{case['name']}.rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
