#!/usr/bin/env python3
"""How well one f32 Mask R-CNN step's gradient is determined, and whether
a data=2 mesh step moves it more than a change of summation order does.

    python3 tools/probe_torch_maskrcnn_mesh.py conditioning   # the CPU
    python3 tools/probe_torch_maskrcnn_mesh.py mesh           # the card

`conditioning` runs one process on the CPU, maskrcnn_resnet50 at 128 px,
B=4, weights from seed 0: the gradient in f32 against float64, and with
BN's statistics as a mesh takes them (a sum, then the sum of squared
deviations) against `var`'s.  `mesh` runs two ranks on card 0 over gloo,
at `tiny` (64 px, B=4) and at maskrcnn_resnet50 (512 px, B=8): the data=2
step against one process with the proposals pinned to the one process's
pick (`chip_smoke._PinnedProposals`), with the autograd engine's device
threads on and off, the order of the collectives on both ranks, and two
one-process runs against each other.  Each prints one JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _batch(cfg, B: int):
    from cloudtik_tpu_torch.train import data as TD

    return next(TD.synthetic_detection_batches(
        B, cfg.image_size, cfg.num_classes, cfg.max_boxes,
        mask_size=2 * cfg.mask_pool, seed=1))


def conditioning() -> dict:
    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.models import resnet as R
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    torch.set_num_threads(4)
    cfg = MR.config("maskrcnn_resnet50", image_size=128, dtype=torch.float32)
    host = _batch(cfg, 4)
    params = MR.init_params(torch.Generator().manual_seed(0), cfg, "cpu")

    def grads(dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = tree_map(lambda t: t.detach().to(dtype).requires_grad_(True),
                     params)
        b = {k: torch.as_tensor(v) for k, v in host.items()}
        b = {k: (v.to(dtype) if v.is_floating_point() else v.long())
             for k, v in b.items()}
        loss, _ = MR.loss_fn(p, b, c)
        return [g.double() for g in torch.autograd.grad(
            loss, tree_leaves(p), allow_unused=True, materialize_grads=True)]

    def gaps(got, want):
        rel = sorted(((a - b).norm() / max(b.norm().item(), 1e-300)).item()
                     for a, b in zip(got, want))
        return {"max_leaf_rel_l2": rel[-1],
                "median_leaf_rel_l2": rel[len(rel) // 2]}

    f32 = grads(torch.float32)
    real, R._batch_norm = R._batch_norm, cs._two_pass_batch_norm
    try:
        two_pass = grads(torch.float32)
    finally:
        R._batch_norm = real
    return {"probe": "conditioning", "model": "maskrcnn_resnet50",
            "image_size": 128, "batch": 4,
            "f32_vs_f64": gaps(f32, grads(torch.float64)),
            "two_pass_vs_var": gaps(two_pass, f32)}


def mesh_rank(out_dir: str, model: str, size: int, B: int) -> int:
    import torch.distributed as dist

    from cloudtik_tpu_torch.models import maskrcnn as MR
    from cloudtik_tpu_torch.parallel import distributed
    from cloudtik_tpu_torch.train.trainer import maskrcnn_spec

    distributed.auto_initialize(backend="gloo")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MR.config(model, image_size=size, dtype=torch.float32)
    batch = _batch(cfg, B)
    spec = maskrcnn_spec(cfg)
    params = MR.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device)
    pin = cs._PinnedProposals(MR, cfg.num_proposals)
    with pin.recording():
        ref_loss, ref = cs._one_process_grads(spec, params, batch, device)
    _, again = cs._one_process_grads(spec, params, batch, device)
    res = {"one_process_twice": cs._leaf_gaps(again, ref)}
    pin.share(B, device)
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}
    calls = []

    def recorded(name):
        def call(t, *args, **kwargs):
            calls.append([name, list(t.shape),
                          threading.current_thread().name])
            return real[name](t, *args, **kwargs)
        return call

    for mode in ("device_threads", "no_device_threads"):
        calls.clear()
        for n in names:
            setattr(dist, n, recorded(n))
        threads = contextlib.nullcontext() if mode == "device_threads" \
            else torch.autograd.set_multithreading_enabled(False)
        try:
            with threads, pin.pinning():
                step = cs._mesh_step(spec, params, batch, {"data": 2},
                                     device, ref_loss, ref)
        finally:
            for n in names:
                setattr(dist, n, real[n])
        step.update(collectives=len(calls),
                    threads=sorted({c[2] for c in calls}),
                    proposals_repicked=pin.differ)
        res[mode] = step
        (Path(out_dir) / f"{mode}.rank{dist.get_rank()}.json").write_text(
            json.dumps([c[:2] for c in calls]))
    (Path(out_dir) / f"result.rank{dist.get_rank()}.json").write_text(
        json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh() -> list:
    from cloudtik_tpu_torch.parallel.launch import run_ranks

    out = []
    for model, size, B in (("tiny", 64, 4), ("maskrcnn_resnet50", 512, 8)):
        with tempfile.TemporaryDirectory() as tmp:
            run_ranks([__file__, "mesh-rank", tmp, model, str(size), str(B)],
                      2, 600, cwd=str(ROOT))
            res = json.loads((Path(tmp) / "result.rank0.json").read_text())
            orders = [(Path(tmp) / f"device_threads.rank{r}.json")
                      .read_text() for r in range(2)]
            out.append({"probe": "mesh", "model": model, "image_size": size,
                        "batch": B, "same_collective_order": orders[0]
                        == orders[1], **res})
    return out


def main(argv) -> int:
    if argv[:1] == ["mesh-rank"]:
        return mesh_rank(argv[1], argv[2], int(argv[3]), int(argv[4]))
    if argv[:1] == ["conditioning"]:
        print(json.dumps(conditioning()))
        return 0
    if argv[:1] == ["mesh"]:
        if not torch.cuda.is_available():
            print("probe_torch_maskrcnn_mesh: mesh needs a CUDA card",
                  file=sys.stderr)
            return 1
        for line in mesh():
            print(json.dumps(line))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
