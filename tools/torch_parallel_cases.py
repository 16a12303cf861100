#!/usr/bin/env python3
"""Multi-rank cases of the port's parallel layer, one process per rank.

    python tools/torch_parallel_cases.py <cases.pt> <out_dir>

Run by `cloudtik_tpu_torch.parallel.launch.run_ranks` with as many ranks
as the widest case.  `cases.pt` holds {"cases": [...]}; each case names
its `kind` ("train", "ring", "collectives", "pipeline" or "vocab"), its
`world` (ranks above it sit the case out) and its inputs.  Each case gets
its own process group (gloo on the CPU unless the case says "device":
"cuda", a FileStore in `out_dir`, a 60 s timeout), and each rank writes
its result to `<out_dir>/<name>.rank<r>.pt`.  A case may force the route
of every shift ("shift_route": "p2p" or "all_gather"), and plant a fault
("fault") to show that the caller's check catches it:

  aux_per_rank      MoE's router statistics from this rank's tokens only
  expert_bwd_twice  the expert all-reduce's backward all-reduces again
  ring_drop_block   the ring's backward leaves out one block's terms
  head_no_copy      x reaches the split lm head without `copy_to`, so its
                    gradient holds this rank's vocab slice only
  wo_unreduced      tensor rank 1 keeps its partial attention output (the
                    all-reduce still runs, so the ranks stay in step)
  head_pipe_summed  the lm head's gradient summed over `pipe`

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
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.ops import moe, ring_attention as R
    from cloudtik_tpu_torch.train import trainer as TR

    saved = (moe.DATA_AXES, moe.collectives, R._mask, R._Ring.backward,
             T.collectives, TR.Trainer._sharded_grads)

    def undo():
        moe.DATA_AXES, moe.collectives, R._mask = saved[:3]
        R._Ring.backward = staticmethod(saved[3])
        T.collectives, TR.Trainer._sharded_grads = saved[4:]

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
    elif fault in ("head_no_copy", "wo_unreduced"):
        T.collectives = _TransformerShim(fault)
    elif fault == "head_pipe_summed":
        real_grads = saved[5]

        def summed(self, batch, *args):
            grads, metrics = real_grads(self, batch, *args)
            dist.all_reduce(grads["lm_head"],
                            group=self.mesh.get_group("pipe"))
            return grads, metrics

        TR.Trainer._sharded_grads = summed
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return undo


class _TransformerShim:
    """models/transformer.py's `collectives` with one call planted wrong,
    picked by the function that makes it."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(collectives, name)

    def copy_to(self, x, axes):
        if self.fault == "head_no_copy" and \
                sys._getframe(1).f_code.co_name == "loss_fn":
            return x
        return collectives.copy_to(x, axes)

    def reduce_sum(self, x, axes):
        out = collectives.reduce_sum(x, axes)
        if (self.fault == "wo_unreduced"
                and sys._getframe(1).f_code.co_name == "_layer_out"
                and sharding.axis_rank("tensor") == 1):
            return x
        return out


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
        grad_accum_steps=case.get("accum", 1),
        overlap_grad_sync=case.get("overlap"),
        checkpoint_dir=case.get("checkpoint_dir"),
        checkpoint_every=case.get("checkpoint_every", 0))
    if case.get("bucket_bytes"):
        tcfg.overlap_bucket_bytes = case["bucket_bytes"]
    trainer = Trainer(spec, tcfg, device=device)
    trainer.init_state(params=params)
    summed = _record_grad_sums(trainer)
    ledger = _grad_sync_ledger(case, trainer)
    out = trainer.fit(iter(case["batches"]), case["steps"])
    full = trainer.full_state()
    result = {"history": out["history"],
              "params": tree_map(lambda t: t.detach().cpu(),
                                 full["params"]),
              "local": tree_map(lambda t: tuple(t.shape), trainer.params),
              "overlap": trainer.overlap_enabled(),
              "grad_sum_axes": sorted(summed)}
    if tcfg.grad_accum_steps > 1:
        result["buckets"] = len(trainer.overlap_plan().buckets)
    if ledger is not None:
        result["ledger"] = ledger(case, trainer)
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


class _DistRecorder:
    """torch.distributed, noting the mesh axis of each all_reduce."""

    def __init__(self, real, mesh, seen):
        self._real, self._mesh, self._seen = real, mesh, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def all_reduce(self, tensor, *args, group=None, **kwargs):
        sizes = PM.axis_sizes_of(self._mesh)
        self._seen.update(a for a in PM.MESH_AXES if sizes[a] > 1
                          and self._mesh.get_group(a) == group)
        return self._real.all_reduce(tensor, *args, group=group, **kwargs)


def _record_grad_sums(trainer):
    """The set the mesh axes that the trainer's gradient sync
    (`_sharded_grads`) sums over are added to, as it runs."""
    from cloudtik_tpu_torch.train import trainer as TR

    seen = set()
    real = trainer._sharded_grads

    def recorded(*args, **kwargs):
        saved = TR.dist
        TR.dist = _DistRecorder(saved, trainer.mesh, seen)
        try:
            return real(*args, **kwargs)
        finally:
            TR.dist = saved

    trainer._sharded_grads = recorded
    return seen


def _grad_sync_ledger(case, trainer):
    """With case["grad_sync_latency"] = (steps, seconds): one warm-up
    step, then `steps` steps with that latency at the train.grad_sync
    seam; returns a function giving the grad_sync and step_compute
    seconds those steps booked and the seam's fire count."""
    if not case.get("grad_sync_latency"):
        return None
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.telemetry import goodput

    steps, seconds = case["grad_sync_latency"]
    batches = list(case["batches"])
    trainer.fit(iter(batches[:1]), 1)

    def run(case, trainer):
        before = {b: goodput.LEDGER.total(b) for b in (
            goodput.BUCKET_GRAD_SYNC, goodput.BUCKET_STEP_COMPUTE)}
        plan = FaultPlan([FaultPoint("train.grad_sync", "latency",
                                     times=steps,
                                     args={"seconds": seconds})])
        with seams.armed(plan):
            trainer.fit(iter(batches[:steps]), steps)
        return {"fired": plan.points[0].fired, **{
            b: goodput.LEDGER.total(b) - v for b, v in before.items()}}
    return run


def case_pipeline(case, device):
    """`pipeline_apply` on a pipe mesh of the whole world: a stack of
    tanh(x @ w) layers split over the stages; the loss sum(y**2) (+ half
    the aux); outputs, the gathered parameter gradient, the input's
    gradient and the bytes the call saved for its backward."""
    from cloudtik_tpu_torch.parallel.pipeline import pipeline_apply

    n = dist.get_world_size()
    mesh = PM.build_mesh(PM.MeshConfig(pipe=n, fsdp=1))
    s = mesh.get_local_rank("pipe")
    params = torch.as_tensor(case["params"]).to(device)
    per = params.shape[0] // n
    local = params[s * per:(s + 1) * per].clone().requires_grad_(True)
    x = torch.as_tensor(case["x"]).to(device).requires_grad_(True)
    extras = case.get("extras")
    if extras is not None:
        extras = torch.as_tensor(extras).to(device)
    with_aux = case.get("aux", False)

    def stage(p, xm, e):
        for i in range(p.shape[0]):
            xm = xm + e[..., None] if e is not None \
                else torch.tanh(xm @ p[i])
        if with_aux:
            return xm, {"aux": (xm.float() ** 2).mean()}
        return xm

    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with sharding.use_mesh(mesh):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = pipeline_apply(
                stage, local, x, n_microbatches=case["micro"],
                extras=extras, aux_init={"aux": 0.0} if with_aux else None,
                schedule=case["schedule"])
            y, aux = out if with_aux else (out, None)
            loss = (y.float() ** 2).sum()
            if with_aux:
                loss = loss + 0.5 * aux["aux"]
        loss.backward()
    result = {"y": y.detach().cpu(), "loss": loss.detach().cpu(),
              "saved_bytes": sum(saved),
              "dparams": collectives.gather_full(
                  local.grad.contiguous(), 0, mesh.get_group("pipe")).cpu(),
              "dx": x.grad.cpu()}
    if with_aux:
        result["aux"] = aux["aux"].detach().cpu()
    return result


def case_vocab(case, device):
    """The vocab-parallel loss of one chunk over a tensor mesh of the
    whole world, on given logits: each rank's slice of a [B, C, V] logits
    array through `_chunk_stats_split` (x the identity, the head this
    rank's columns); nll, valid and correct, and the gradient of the
    logits gathered back."""
    from cloudtik_tpu_torch.models import transformer as T

    n = dist.get_world_size()
    mesh = PM.build_mesh(PM.MeshConfig(tensor=n, fsdp=1))
    r = mesh.get_local_rank("tensor")
    logits = torch.as_tensor(case["logits"]).to(device)
    V = logits.shape[-1]
    cols = torch.eye(V, device=device)[:, r * V // n:(r + 1) * V // n]
    x = logits.clone().requires_grad_(True)
    labels = torch.as_tensor(case["labels"]).to(device)
    with sharding.use_mesh(mesh):
        xc = collectives.copy_to(x, ("tensor",))
        nll, nv, nc = T._chunk_stats_split(xc, labels, cols)
        nll.backward()
    return {"nll": nll.detach().cpu(), "valid": nv.cpu(),
            "correct": nc.cpu(), "dlogits": x.grad.cpu()}


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
        w = torch.full((2,), float(r + 1), device=device)
        result["shift"] = collectives.shift_many([w], group, 1)[0].cpu()
        # a backward's opposite shift: the cotangent of `shift` here,
        # r + 1 a rank, goes back to the rank that sent the tensor
        result["shift_grad"] = collectives.shift_many(
            [torch.full((2,), float(r + 1), device=device)], group,
            -1)[0].cpu()
        v = torch.tensor([float(r)], device=device)
        result["max"] = collectives.all_reduce(v, (axis,), op="max").cpu()
        result["min"] = collectives.all_reduce(v, (axis,), op="min").cpu()
    return result


CASES = {"train": case_train, "ring": case_ring,
         "collectives": case_collectives, "pipeline": case_pipeline,
         "vocab": case_vocab}


def _route(case):
    """With case["shift_route"], every shift takes that route (the CPU
    takes P2P by default; the card under gloo takes the gather)."""
    real = collectives.shift_route
    if case.get("shift_route"):
        collectives.shift_route = lambda group, device: case["shift_route"]
    return lambda: setattr(collectives, "shift_route", real)


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
        unroute = _route(case)
        try:
            result = CASES[case["kind"]](case, device)
        finally:
            unroute()
            undo()
            dist.destroy_process_group()
        torch.save(result, Path(out_dir) / f"{case['name']}.rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
