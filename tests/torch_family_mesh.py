"""The harness of tests/test_torch_vision_mesh.py and
tests/test_torch_zoo_mesh.py: the eight model families other than the
transformer on a mesh of gloo CPU ranks, against the JAX Trainer on the
same CPU mesh and against the port on one rank.

Every case starts from the JAX `init_params` (through `convert.py`) and
reads the same global batches, made from a seed with the generators both
packages share; where a loss divides by a count of its own (BERT's valid
labels, GraphSAGE's train mask) the rows of each rank are masked
differently, so a mean of per-rank means fails.  The ranks run in one
spawn a file (`tools/torch_parallel_cases.py`, no JAX in the workers),
while the JAX runs compile in the test's process.

Ceilings, f32 on one intra-op thread (those of
tests/test_torch_sharded_trainer.py): the first loss within 1e-5 relative
of JAX's, the later loss and the pre-clip global norm within 1e-4, every
parameter after the steps within 1e-4 relative L2, and so each leaf's
update under SGD (`OPT`); against the port on one rank every number
within 1e-5.  A planted fault must miss them.
"""

from __future__ import annotations

import importlib
import threading
from pathlib import Path

import jax
import numpy as np
import torch

from cloudtik_tpu.parallel.mesh import MeshConfig as JMeshConfig
from cloudtik_tpu.parallel.mesh import build_mesh as jbuild_mesh
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.parallel.launch import run_ranks
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR

ROOT = Path(__file__).resolve().parents[1]

REL = 1e-5
LATER_REL = 1e-4
STEPS = 2
# SGD with momentum, which the image recipes train with, at a learning
# rate that moves every leaf well past f32's rounding of it: its update is
# linear in the gradient, so each leaf's update holds its gradients to the
# ceiling (`gaps`).  AdamW's first update is about lr * sign(g), which
# turns a gradient that is zero in exact arithmetic (a dead channel's BN
# bias, BERT's key bias: 1e-9 of rounding either way) into a full step of
# either sign.
OPT = dict(name="sgd", learning_rate=1.0, warmup_steps=1,
           schedule="constant")
DATA2_FSDP2 = dict(data=2, fsdp=2)

# family: (seq_len, global batch); its spec is `<family>_spec`
FAMILIES = {"resnet": (1, 8), "ssd": (1, 8), "maskrcnn": (1, 8),
            "diffusion": (1, 8), "dlrm": (1, 8), "rnnt": (12, 8),
            "graphsage": (1, 32), "bert": (32, 8)}


def _module(package: str, family: str):
    return importlib.import_module(f"{package}.models.{family}")


def jax_config(family: str):
    return _module("cloudtik_tpu", family).config(
        "tiny", dtype=jax.numpy.float32)


# family: its JAX `init_params` from key 0 as numpy, as the first JAX
# Trainer of the family initialised it (`jax_trainer`)
_PARAMS: dict = {}


def jax_params(family: str):
    """The JAX `init_params` of `family` from key 0, as numpy."""
    if family not in _PARAMS:
        init = jax.jit(_module("cloudtik_tpu", family).init_params,
                       static_argnums=1)
        _PARAMS[family] = jax.tree.map(
            np.array, init(jax.random.PRNGKey(0), jax_config(family)))
    return _PARAMS[family]


def port_params(family: str):
    """The JAX `init_params` as the port's tensors (a fresh copy each
    call: a trainer steps the tensors it is handed in place)."""
    return convert.params_from_jax(
        jax.tree.map(np.array, jax_params(family)), "cpu")


def batches(family: str, objective=None, seed: int = 3) -> list:
    """`STEPS` global batches of `family` (numpy), the generators' own."""
    seq, b = FAMILIES[family]
    cfg = jax_config(family)
    if family == "resnet":
        it = TD.synthetic_image_batches(b, cfg.image_size, cfg.num_classes,
                                        seed=seed)
    elif family in ("ssd", "maskrcnn"):
        mask = 2 * cfg.mask_pool if family == "maskrcnn" else 0
        it = TD.synthetic_detection_batches(
            b, cfg.image_size, cfg.num_classes, cfg.max_boxes,
            mask_size=mask, seed=seed)
    elif family == "diffusion":
        it = TD.synthetic_diffusion_batches(b, cfg.image_size,
                                            cfg.in_channels, seed=seed)
    elif family == "dlrm":
        it = TD.synthetic_dlrm_batches(b, cfg.num_dense, cfg.num_tables,
                                       cfg.rows_per_table, seed=seed)
    elif family == "rnnt":
        it = TD.synthetic_speech_batches(b, seq, cfg.feature_dim,
                                         cfg.vocab_size, 4, seed=seed)
    elif family == "graphsage":
        from cloudtik_tpu_torch.recipes.graphsage_nodes import with_edges

        it = TD.synthetic_graph_batches(b, cfg.in_dim, cfg.num_classes,
                                        cfg.max_degree, seed=seed)
        if objective == "link_pred":
            it = with_edges(it, b)
    else:
        it = TD.synthetic_mlm_batches(b, seq, cfg.vocab_size, seed=seed)
    out = [next(it) for _ in range(STEPS)]
    if family == "bert":
        # rows 0-1 go to the first batch shard of four, 4-5 to the third:
        # uneven counts of valid labels
        out[0]["mlm_labels"][0, :3] = -100
        out[1]["mlm_labels"][5, 1:4] = -100
    return out


def cross_rank_block(n: int = 32, seed: int = 4) -> dict:
    """A GraphSAGE block whose first half of nodes has neighbours only in
    the second half and the second only in the first: at data=2 every
    rank's nodes read their neighbours on the other rank."""
    cfg = jax_config("graphsage")
    rng = np.random.default_rng(seed)
    K, half = cfg.max_degree, n // 2
    other = np.where(np.arange(n)[:, None] < half, half, 0)
    deg = rng.integers(1, K + 1, (n,))
    mask = np.arange(K)[None, :] < deg[:, None]
    picked = other + rng.integers(0, half, (n, K))
    return {
        "features": rng.standard_normal((n, cfg.in_dim)).astype(np.float32),
        "neighbors": np.where(mask, picked, other).astype(np.int32),
        "neighbor_mask": mask,
        "labels": rng.integers(0, cfg.num_classes, (n,), dtype=np.int32),
        "train_mask": rng.uniform(size=(n,)) < 0.7,
    }


def _copies(blocks: list) -> list:
    return [{k: np.array(v) for k, v in b.items()} for b in blocks]


def jax_trainer(family: str, data: list, mesh: dict, world: int,
                objective=None):
    """The JAX Trainer of `family` on `mesh` over the first `world` CPU
    devices, its state initialised from key 0 (whose params become the
    family's `jax_params`: the init compiles once)."""
    seq, _ = FAMILIES[family]
    args = (objective,) if objective else ()
    spec = getattr(JTR, f"{family}_spec")(jax_config(family), *args)
    mesh_cfg = JMeshConfig(**{"fsdp": 1, **mesh})
    trainer = JTR.Trainer(spec, JTR.TrainerConfig(
        global_batch_size=len(data[0][next(iter(data[0]))]), seq_len=seq,
        mesh=mesh_cfg, optimizer=JO.OptimizerConfig(**OPT), log_every=1,
        prefetch_depth=0), mesh=jbuild_mesh(mesh_cfg,
                                            devices=jax.devices()[:world]))
    trainer.init_state(jax.random.PRNGKey(0))
    _PARAMS.setdefault(family, jax.tree.map(np.array,
                                            trainer.state["params"]))
    return trainer


def jax_fit(trainer, data: list) -> tuple:
    """`STEPS` steps of a `jax_trainer` on `data`: its history and final
    params."""
    out = trainer.fit(iter(_copies(data)), STEPS)
    return out["history"], jax.tree.map(np.asarray,
                                        trainer.state["params"])


def one_rank(family: str, data: list, objective=None) -> tuple:
    """The port's history and final params on one process."""
    seq, _ = FAMILIES[family]
    cfg = _module("cloudtik_tpu_torch", family).config(
        "tiny", dtype=torch.float32)
    args = (objective,) if objective else ()
    spec = getattr(TTR, f"{family}_spec")(cfg, *args)
    trainer = TTR.Trainer(spec, TTR.TrainerConfig(
        global_batch_size=len(data[0][next(iter(data[0]))]), seq_len=seq,
        optimizer=TO.OptimizerConfig(**OPT), log_every=1, prefetch_depth=0),
        device="cpu")
    trainer.init_state(params=port_params(family))
    out = trainer.fit(iter(_copies(data)), STEPS)
    return out["history"], trainer.params


def case(name: str, family: str, mesh: dict, world: int, data: list,
         objective=None, **extra) -> dict:
    """A worker "train" case of `family` on `mesh`."""
    seq, _ = FAMILIES[family]
    return dict(kind="train", name=name, world=world, family=family,
                objective=objective, mesh=mesh, params=port_params(family),
                batches=_copies(data), steps=STEPS,
                batch=len(data[0][next(iter(data[0]))]), seq=seq,
                optimizer=OPT, **extra)


def spawn(cases: list, out: Path, world: int, deadline_s: float,
          meanwhile) -> dict:
    """Every case in one spawn of `world` ranks, `meanwhile()` running in
    this process as they train; rank 0's result of each case by name."""
    torch.save({"cases": cases}, out / "cases.pt")
    failure = []

    def ranks():
        try:
            run_ranks(["tools/torch_parallel_cases.py",
                       str(out / "cases.pt"), str(out)], world, deadline_s,
                      cwd=str(ROOT))
        except Exception as e:      # re-raised in the test's thread
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        meanwhile()
    finally:
        thread.join()
    if failure:
        raise failure[0]
    return {c["name"]: torch.load(out / f"{c['name']}.rank0.pt",
                                  weights_only=False) for c in cases}


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def gaps(got: dict, hist: list, params, init) -> dict:
    """The largest gaps of a mesh run to a reference run: the first loss,
    the later losses, the grad norms, the parameters and their updates
    from `init` (relative L2 of each leaf; a leaf or an update below 1e-3
    of the largest leaf's update against that 1e-3: BERT's key bias starts
    at zero and its gradient is zero in exact arithmetic, so it holds
    rounding only; every tree in jax's key order)."""
    def leaves(tree):
        return [np.asarray(p.detach() if isinstance(p, torch.Tensor) else p,
                           np.float64) for p in jax.tree.leaves(tree)]

    mine, want, start = (leaves(got["params"]), leaves(params),
                         leaves(init))
    moved = [w - s for w, s in zip(want, start)]
    floor = 1e-3 * max(np.linalg.norm(m) for m in moved)
    hist_got = got["history"]
    return {
        "first_loss": rel(hist_got[0]["loss"], hist[0]["loss"]),
        "later_loss": max(rel(m["loss"], h["loss"])
                          for m, h in zip(hist_got[1:], hist[1:])),
        "grad_norm": max(rel(m["grad_norm"], h["grad_norm"])
                         for m, h in zip(hist_got, hist)),
        "params": max(np.linalg.norm(g - w) / max(np.linalg.norm(w), floor)
                      for g, w in zip(mine, want)),
        "updates": max(np.linalg.norm((g - s) - m)
                       / max(np.linalg.norm(m), floor)
                       for g, s, m in zip(mine, start, moved)),
        "keys": all(set(m) == set(h) - {"mfu"}
                    for m, h in zip(hist_got, hist)),
    }


def within(g: dict, first: float = REL, later: float = LATER_REL) -> bool:
    return (g["first_loss"] <= first and g["later_loss"] <= later
            and g["grad_norm"] <= later and g["params"] <= later
            and g["updates"] <= later and g["keys"])


def axes_equal(family: str) -> bool:
    """The port's `param_logical_axes` equals the reference's, tuple for
    tuple (with a classifier head where BERT has one)."""
    over = {"num_labels": 3} if family == "bert" else {}
    jm, tm = _module("cloudtik_tpu", family), _module("cloudtik_tpu_torch",
                                                      family)
    want = jm.param_logical_axes(jm.config("tiny", **over))
    got = tm.param_logical_axes(tm.config("tiny", **over))

    def same(a, b):
        if isinstance(a, dict):
            return (isinstance(b, dict) and list(a) == list(b)
                    and all(same(a[k], b[k]) for k in a))
        if isinstance(a, list):
            return (isinstance(b, list) and len(a) == len(b)
                    and all(same(x, y) for x, y in zip(a, b)))
        return isinstance(b, tuple) and tuple(a) == b

    return same(want, got)
