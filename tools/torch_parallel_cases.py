#!/usr/bin/env python3
"""Multi-rank cases of the port's parallel layer, one process per rank.

    python tools/torch_parallel_cases.py <cases.pt> <out_dir>

Run by `cloudtik_tpu_torch.parallel.launch.run_ranks` with as many ranks
as the widest case.  `cases.pt` holds {"cases": [...]}; each case names
its `kind` ("train", "ring", "collectives", "pipeline", "vocab",
"elastic" or "restore"), its `world` (ranks above it sit the case out)
and its inputs.  A "train" case trains the transformer (or LoRA on it),
or with "family" one of the other model families (`family_spec`) at its
`tiny` preset in f32.  An "elastic" case forms its own groups through its
store: the ranks of the lost slice leave (their result goes to
`<name>.rank<r>.left.pt` and the process exits `launch.LEFT`), and come
back as fresh processes (`launch.request_return`) that join the
running case and then go on with the cases after it.  Each case gets
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
  bn_reduce_only    ResNet's BN statistics summed over the batch axes in
                    the forward only (no `copy_to`): each rank's backward
                    keeps its own share of their gradient
  per_rank_mean     BERT's MLM loss over this rank's count of valid labels
                    times the ranks: a mean of per-rank means
  sage_no_gather    GraphSAGE reads only its own rows of `h` (the other
                    ranks' rows zero)

This module imports no JAX: the tests compare its results with the JAX
package in their own process.
"""

from __future__ import annotations

import json
import os
import sys
import time
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
    from cloudtik_tpu_torch.models import bert as BE
    from cloudtik_tpu_torch.models import graphsage as GS
    from cloudtik_tpu_torch.models import resnet as RN
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.ops import moe, ring_attention as R
    from cloudtik_tpu_torch.train import trainer as TR

    saved = (moe.DATA_AXES, moe.collectives, R._mask, R._Ring.backward,
             T.collectives, TR.Trainer._sharded_grads, RN.collectives,
             BE.collectives, GS.collectives)

    def undo():
        moe.DATA_AXES, moe.collectives, R._mask = saved[:3]
        R._Ring.backward = staticmethod(saved[3])
        T.collectives, TR.Trainer._sharded_grads = saved[4:6]
        RN.collectives, BE.collectives, GS.collectives = saved[6:]

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
    elif fault == "bn_reduce_only":
        RN.collectives = _FamilyShim(copy_to=lambda x, axes: x)
    elif fault == "per_rank_mean":
        def local_count(x, axes, op="sum"):
            groups = collectives.groups_for(axes)
            return x * int(np.prod([dist.get_world_size(g)
                                    for g in groups]))
        BE.collectives = _FamilyShim(all_reduce=local_count)
    elif fault == "sage_no_gather":
        GS.collectives = _FamilyShim(gather_rows=_own_rows_only)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return undo


class _FamilyShim:
    """parallel/collectives.py with the given functions replaced."""

    def __init__(self, **replaced):
        self._replaced = replaced

    def __getattr__(self, name):
        return self._replaced.get(name, getattr(collectives, name))


def _own_rows_only(x, axes=PM.DATA_AXES):
    """`gather_rows`'s shape with only this rank's rows of x, the other
    ranks' zero."""
    n, index = 1, 0
    for a in axes:
        size = sharding.mesh_axis_size(a)
        index = index * size + sharding.axis_rank(a)
        n *= size
    zeros = x.new_zeros(x.shape)
    return torch.cat([x if i == index else zeros for i in range(n)])


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


def family_spec(family: str, objective=None, overrides=None):
    """`train/trainer.py`'s `<family>_spec` of `models/<family>.py` at its
    `tiny` preset in f32 (`objective` for BERT and GraphSAGE)."""
    import importlib

    from cloudtik_tpu_torch.train import trainer as TR

    M = importlib.import_module(f"cloudtik_tpu_torch.models.{family}")
    cfg = M.config("tiny", dtype=torch.float32, **(overrides or {}))
    args = (objective,) if objective else ()
    return getattr(TR, f"{family}_spec")(cfg, *args)


def case_train(case, device):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.models.lora import LoRAConfig, lora_spec
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)
    from cloudtik_tpu_torch.tree import tree_map

    params = tree_map(lambda t: t.to(device), case["params"])
    if case.get("family"):
        spec = family_spec(case["family"], case.get("objective"),
                           case.get("overrides"))
    elif case.get("lora_rank"):
        cfg = T.config(case["model"], dtype=torch.float32,
                       **case.get("overrides", {}))
        spec = lora_spec(params, cfg, LoRAConfig(rank=case["lora_rank"]))
        params = tree_map(lambda t: t.to(device), case["lora_params"])
    else:
        spec = transformer_spec(T.config(case["model"], dtype=torch.float32,
                                         **case.get("overrides", {})))
    tcfg = TrainerConfig(
        global_batch_size=case["batch"], seq_len=case.get("seq", 1),
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
    if case.get("whole_dir"):
        # the same state as one whole-leaf checkpoint, for the restores
        # that hold the shards to it
        from cloudtik_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                         Checkpointer)

        if dist.get_rank() == 0:
            whole = Checkpointer(CheckpointConfig(
                directory=case["whole_dir"], async_save=False))
            whole.save(trainer.step, full, force=True)
            whole.close()
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


def case_moe_seq(case, device):
    """MoE on a seq mesh of the whole world, each rank holding its slice
    of the sequence: `moe_ffn` ("what": "ffn", the loss sum(y * w) plus
    both router losses, with the gradients of x and the four weights) or
    tiny_moe's forward ("forward").  Outputs gathered along the sequence;
    the weights' gradients summed over `seq` (each rank's is its tokens'
    share)."""
    from cloudtik_tpu_torch.ops.moe import MoEConfig, moe_ffn

    n = dist.get_world_size()
    mesh = PM.build_mesh(PM.MeshConfig(seq=n, fsdp=1))
    i = mesh.get_local_rank("seq")
    group = mesh.get_group("seq")

    def mine(t):
        S = t.shape[1] // n
        return t[:, i * S:(i + 1) * S]

    def whole(t):
        return collectives.gather_full(t.detach().contiguous(), 1,
                                       group).cpu()

    if case["what"] == "forward":
        from cloudtik_tpu_torch.models import transformer as T

        cfg = T.config(case["model"], dtype=torch.float32)
        tokens = torch.as_tensor(case["tokens"]).to(device)
        with sharding.use_mesh(mesh), torch.no_grad():
            logits = T.forward(case["params"], mine(tokens), cfg)
        logits = logits[0] if isinstance(logits, tuple) else logits
        return {"logits": whole(logits)}
    x = mine(torch.as_tensor(case["x"])).clone().requires_grad_(True)
    ws = [torch.as_tensor(case[k]).clone().requires_grad_(True)
          for k in ("w_router", "w_gate", "w_up", "w_down")]
    with sharding.use_mesh(mesh):
        y, metrics = moe_ffn(x, *ws, MoEConfig(**case["moe"]))
        loss = (y * mine(torch.as_tensor(case["w"]))).sum() \
            + metrics["moe_aux_loss"] + metrics["moe_z_loss"]
        loss.backward()
        dw = [collectives.all_reduce(w.grad, ("seq",)).cpu() for w in ws]
    return {"y": whole(y), "dx": whole(x.grad),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "dw": dw}


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


def case_elastic(case, device, out_dir, join=False):
    """The elastic drill: `world` ranks in `num_slices` slices of
    `per_slice` train `steps` global batches with `fit_elastic`, saving
    every `checkpoint_every` steps; the save of `torn_at` tears, slice
    `lost` is dropped at boundary `lost_at` (its ranks leave), and when the
    survivors reach `return_at` they ask for its ranks back, which return
    as fresh processes and are handed the live state.  The survivors then
    run a fresh K-1 trainer restored from `fresh_from` over the steps the
    K-1 era ran, in their own group."""
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.parallel import launch
    from cloudtik_tpu_torch import telemetry
    from cloudtik_tpu_torch.telemetry import events, goodput
    from cloudtik_tpu_torch.telemetry import instruments as ti
    from cloudtik_tpu_torch.train.elastic import (ElasticCoordinator,
                                                  StoreMembership)
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)
    from cloudtik_tpu_torch.tree import tree_map

    rank = int(os.environ["RANK"])
    name = case["name"]
    out = Path(out_dir)
    events.install(str(out / f"{name}.events.rank{rank}.inc"
                       f"{launch.incarnation()}.jsonl"))
    telemetry.reset()
    cfg = T.config(case["model"], dtype=torch.float32,
                   **case.get("overrides", {}))
    spec = transformer_spec(cfg)
    batches = case["batches"]

    def data_factory(step):
        return iter(batches[step:])

    def tcfg(every):
        return TrainerConfig(
            global_batch_size=case["batch"], seq_len=case["seq"],
            optimizer=OptimizerConfig(**case.get("optimizer", {})),
            log_every=1, prefetch_depth=0, checkpoint_every=every,
            checkpoint_dir=str(out / f"{name}.ckpt"))

    store = distributed.elastic_store(str(out / f"{name}.store"), 60.0)
    groups = PM.slice_device_groups(range(case["world"]),
                                    case["num_slices"])
    membership = StoreMembership(store, groups)
    coord = ElasticCoordinator(
        membership, mesh_config=PM.MeshConfig(**case["per_slice"]),
        slice_devices=groups, store=store, rank=rank, backend="gloo",
        remesh_dwell_s=0.0, checkpoint_wait_s=60.0, timeout_s=60.0)
    lost = groups[case["lost"]]
    fired = {"back": False}

    def chaos(trainer, entry):
        # the survivors bring the lost slice back: its ranks are started
        # again, and every survivor waits until they have registered, so
        # the boundary's decision is the same whichever rank writes it
        if (entry["step"] != case["return_at"] or fired["back"]
                or len(coord.current) != case["num_slices"] - 1):
            return
        fired["back"] = True
        if rank == min(coord.ranks()):
            for r in lost:
                (out / f"return.rank{r}.json").write_text(
                    json.dumps({"case": name}))
                launch.request_return(r)
        deadline = time.monotonic() + 60.0
        while case["lost"] not in membership.alive_slices():
            if time.monotonic() > deadline:
                raise TimeoutError("the lost slice did not come back")
            time.sleep(0.05)

    plan = FaultPlan([
        FaultPoint("checkpoint.save", "torn_write", times=1,
                   match={"step": case["torn_at"]}),
        FaultPoint("elastic.slice_lost", "drop", times=1,
                   match={"slice": case["lost"], "step": case["lost_at"]}),
    ], seed=42)
    if join:
        trainer = Trainer(spec, tcfg(case["checkpoint_every"]),
                          device=device)
        with seams.armed(plan):
            res = trainer.fit_elastic(data_factory, case["steps"], coord,
                                      join=True)
    else:
        trainer = Trainer(spec, tcfg(case["checkpoint_every"]),
                          device=device, mesh=coord.build_mesh())
        trainer.init_state(params=tree_map(lambda t: t.to(device),
                                           case["params"]))
        with seams.armed(plan):
            res = trainer.fit_elastic(data_factory, case["steps"], coord,
                                      callbacks=[chaos])
    if res.get("left"):
        return {"history": res["history"], "left": True,
                "step": res["final_step"]}
    trainer.checkpointer.wait()
    dist.barrier()      # every rank's last shard is in
    full = trainer.full_state()
    result = {
        "history": res["history"], "final_step": res["final_step"],
        "params": tree_map(lambda t: t.detach().cpu(), full["params"]),
        "slices": list(coord.current), "world": dist.get_world_size(),
        "joined": join, "rank_now": dist.get_rank(),
        "buckets": dict(goodput.LEDGER.snapshot()["buckets"]),
        "remeshes": {d: ti.ELASTIC_REMESHES.value(direction=d)
                     for d in ("shrink", "expand")},
        "elastic_slices": ti.ELASTIC_SLICES.value(),
        "torn": [e for e in plan.trace if e["kind"] == "torn_write"],
        "events": [e for e in events.read_events()
                   if e["name"] in ("tik_elastic_remesh",
                                    "tik_train_resume")],
        "committed": trainer.checkpointer.all_steps()}
    trainer.checkpointer.close()
    dist.destroy_process_group()
    events.uninstall()
    survivors = [r for s in sorted(groups) if s != case["lost"]
                 for r in groups[s]]
    if rank in survivors and not join:
        # a fresh K-1 run from the committed step, in a group of its own
        distributed.reform_group(
            distributed.elastic_store(str(out / f"{name}.fresh.store"),
                                      60.0),
            0, survivors.index(rank), len(survivors), backend="gloo",
            timeout_s=60.0)
        fresh = Trainer(spec, tcfg(1000), device=device, mesh=PM.build_mesh(
            PM.elastic_mesh_config(PM.MeshConfig(**case["per_slice"]), 1)))
        fresh.restore_checkpoint(step=case["fresh_from"])
        era = [e for e in res["history"]
               if e["slices"] == case["num_slices"] - 1]
        result["fresh"] = fresh.fit(data_factory(case["fresh_from"]),
                                    len(era))["history"]
        fresh.checkpointer.close()
        dist.destroy_process_group()
    return result


def case_restore(case, device):
    """A checkpoint restored into this mesh's placements (the case's
    `mesh`) from its per-rank shards and from a whole-leaf copy of the
    same state: this rank's shards of both, which must be equal."""
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)
    from cloudtik_tpu_torch.tree import tree_leaves

    cfg = T.config(case["model"], dtype=torch.float32)
    got = {}
    for which in ("sharded", "whole"):
        trainer = Trainer(transformer_spec(cfg), TrainerConfig(
            global_batch_size=case["batch"], seq_len=case["seq"],
            mesh=PM.MeshConfig(**case["mesh"]),
            optimizer=OptimizerConfig(**case.get("optimizer", {})),
            checkpoint_dir=case[which], checkpoint_every=1000),
            device=device)
        step = trainer.restore_checkpoint()
        got[which] = (step, [t.detach().clone() for t in
                             tree_leaves(trainer.state)
                             if isinstance(t, torch.Tensor)])
    (s1, a), (s2, b) = got["sharded"], got["whole"]
    return {"steps": (s1, s2), "leaves": len(a),
            "equal": s1 == s2 and len(a) == len(b) and all(
                x.shape == y.shape and torch.equal(x, y)
                for x, y in zip(a, b))}


CASES = {"train": case_train, "ring": case_ring,
         "collectives": case_collectives, "pipeline": case_pipeline,
         "vocab": case_vocab, "restore": case_restore,
         "moe_seq": case_moe_seq}


def _route(case):
    """With case["shift_route"], every shift takes that route (the CPU
    takes P2P by default; the card under gloo takes the gather)."""
    real = collectives.shift_route
    if case.get("shift_route"):
        collectives.shift_route = lambda group, device: case["shift_route"]
    return lambda: setattr(collectives, "shift_route", real)


def main(cases_path: str, out_dir: str) -> int:
    from cloudtik_tpu_torch.parallel import launch

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    cases = torch.load(cases_path, weights_only=False)["cases"]
    first, joining = 0, launch.incarnation() > 0
    if joining:
        # a returning process: on with the elastic case it was asked back
        # to, then the cases after it
        name = json.loads((Path(out_dir) / f"return.rank{rank}.json")
                          .read_text())["case"]
        first = next(i for i, c in enumerate(cases) if c["name"] == name)
    for n, case in enumerate(cases[first:], start=first):
        if rank >= case["world"]:
            continue
        device = case.get("device", "cpu")
        if case["kind"] == "elastic":
            result = case_elastic(case, device, out_dir,
                                  join=joining and n == first)
            if result.get("left"):
                torch.save(result, Path(out_dir)
                           / f"{case['name']}.rank{rank}.left.pt")
                return launch.LEFT
            torch.save(result, Path(out_dir)
                       / f"{case['name']}.rank{rank}.pt")
            continue
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
