"""The port's overlapped gradient sync (`cloudtik_tpu_torch/parallel/
overlap.py` and the trainer's accumulated step) against the JAX package's
plan on the 8-device CPU mesh, and against the port's own sequential path
over gloo ranks.

The plan must be the reference's: bucket membership, padded lengths,
scatter axes, the deferred-sync byte model, the auto resolution.  The
overlapped step (each microbatch's gradients reduce-scattered over `data`
in buckets while the next runs, one all-gather at the end) must give the
sequential path's losses and parameters bit for bit at data=2, where every
sum has two addends; at data=2 x fsdp=2 and at data=4 the order of four
addends may differ, and the ceiling is 1e-6 relative (4.0e-8 read for the
parameters after 3 steps, the losses equal).  Latency injected at the
`train.grad_sync` seam books to the goodput ledger's grad_sync bucket,
never to step compute.
"""

from pathlib import Path

import jax
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel import overlap as JOV
from cloudtik_tpu.parallel.mesh import MeshConfig as JMeshConfig
from cloudtik_tpu.parallel.mesh import build_mesh as jbuild_mesh
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.parallel import overlap as TOV
from cloudtik_tpu_torch.parallel.launch import run_ranks
from cloudtik_tpu_torch.parallel.mesh import MeshConfig
from cloudtik_tpu_torch.telemetry import goodput
from cloudtik_tpu_torch.train import data as TD

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 150
B, S, STEPS = 8, 32, 3
FOUR_RANK_REL = 1e-6
OVERRIDES = dict(n_heads=8, n_kv_heads=8, d_ff=128, remat=False)
OPT = dict(learning_rate=1e-2, warmup_steps=1, schedule="constant")
LATENCY = (3, 0.3)              # steps, seconds a step

MESHES = {"data4_fsdp2": dict(data=4, fsdp=2), "data8": dict(data=8, fsdp=1),
          "data2_fsdp4": dict(data=2, fsdp=4), "fsdp8": dict(fsdp=8)}

# name: (mesh, world, accum, bucket bytes)
RUNS = {
    "data2_a2": (dict(data=2, fsdp=1), 2, 2, None),
    "data2_a4": (dict(data=2, fsdp=1), 2, 4, None),
    "data2_a2_buckets": (dict(data=2, fsdp=1), 2, 2, 16 << 10),
    "data2_fsdp2_a2": (dict(data=2, fsdp=2), 4, 2, None),
    "data4_a2": (dict(data=4, fsdp=1), 4, 2, None),
}


def _abstract(mesh_kw, bucket_bytes):
    cfg = JT.config("tiny", **OVERRIDES)
    shapes = jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    jmesh = jbuild_mesh(JMeshConfig(**mesh_kw), devices=jax.devices()[:8])
    jplan = JOV.plan_overlap(shapes, jmesh, bucket_bytes=bucket_bytes)
    # the port's tree in JAX's leaf order (sorted keys)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    sizes = MeshConfig(**mesh_kw).axis_sizes(8)
    return jplan, TOV.plan_overlap(meta, sizes, bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("bucket_bytes", [TOV.DEFAULT_BUCKET_BYTES,
                                          16 << 10])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plan_is_the_references(mesh, bucket_bytes):
    assert TOV.DEFAULT_BUCKET_BYTES == JOV.DEFAULT_BUCKET_BYTES
    jplan, plan = _abstract(MESHES[mesh], bucket_bytes)
    assert plan.buckets == jplan.buckets
    assert plan.sizes == jplan.sizes and plan.shapes == jplan.shapes
    assert plan.scatter_axes == jplan.scatter_axes
    assert plan.pad_to == jplan.pad_to and plan.shards == jplan.shards
    assert [plan.bucket_len(b) for b in plan.buckets] == [
        jplan.bucket_len(b) for b in jplan.buckets]
    assert plan.grad_bytes() == jplan.grad_bytes()
    for overlap in (False, True):
        assert TOV.deferred_sync_bytes(plan, overlap) == \
            JOV.deferred_sync_bytes(jplan, overlap)


def test_flatten_and_unflatten_round_trip():
    _, plan = _abstract(MESHES["data4_fsdp2"], 16 << 10)
    grads = jax.tree.map(lambda s: torch.randn(s.shape), jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), JT.config(
            "tiny", **OVERRIDES))))
    flats = TOV.flatten_buckets(grads, plan)
    assert [f.numel() for f in flats] == [plan.bucket_len(b)
                                          for b in plan.buckets]
    back = TOV.unflatten_buckets(flats, plan, grads)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(grads)):
        assert torch.equal(a, b)
    # every bucket scatters evenly over the batch axes
    assert all(f.numel() % plan.pad_to == 0 for f in flats)


@pytest.mark.parametrize("config_value", [None, True, False])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_should_overlap_resolves_as_the_reference(config_value, accum, mesh):
    jmesh = jbuild_mesh(JMeshConfig(**MESHES[mesh]),
                        devices=jax.devices()[:8])
    sizes = MeshConfig(**MESHES[mesh]).axis_sizes(8)
    assert TOV.should_overlap(config_value, accum, sizes) == \
        JOV.should_overlap(config_value, accum, jmesh)


def _batches():
    it = TD.synthetic_lm_batches(B, S, 256, seed=5)
    return [next(it) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("overlap")
    cfg = TT.config("tiny", dtype=torch.float32, **OVERRIDES)
    cases = []
    for name, (mesh, world, accum, bucket_bytes) in RUNS.items():
        for overlap in (False, True):
            cases.append(dict(
                kind="train", name=f"{name}_{overlap}", world=world,
                model="tiny", overrides=OVERRIDES, mesh=mesh,
                # every case its own tensors: a trainer steps them in place
                params=TT.init_params(torch.Generator().manual_seed(0),
                                      cfg, "cpu"),
                batches=_batches(), steps=STEPS, batch=B, seq=S,
                optimizer=OPT, accum=accum, overlap=overlap,
                bucket_bytes=bucket_bytes))
    cases.append(dict(
        kind="train", name="latency", world=2, model="tiny",
        overrides=OVERRIDES, mesh=dict(data=2, fsdp=1),
        params=TT.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        batches=_batches() * 2, steps=1, batch=B, seq=S, optimizer=OPT,
        accum=2, overlap=True, grad_sync_latency=LATENCY))
    torch.save({"cases": cases}, out / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(out / "cases.pt"),
               str(out)], 4, SPAWN_DEADLINE_S, cwd=str(ROOT))
    return {c["name"]: torch.load(out / f"{c['name']}.rank0.pt",
                                  weights_only=False) for c in cases}


@pytest.mark.parametrize("name", ["data2_a2", "data2_a4",
                                  "data2_a2_buckets"])
def test_overlapped_steps_equal_sequential_bit_for_bit(spawned, name):
    seq, ovl = spawned[f"{name}_False"], spawned[f"{name}_True"]
    assert ovl["overlap"] and not seq["overlap"]
    assert [h["loss"] for h in ovl["history"]] == [
        h["loss"] for h in seq["history"]]
    for a, b in zip(jax.tree.leaves(ovl["params"]),
                    jax.tree.leaves(seq["params"])):
        assert torch.equal(a, b)
    if name.endswith("buckets"):
        assert ovl["buckets"] > 1


@pytest.mark.parametrize("name", ["data2_fsdp2_a2", "data4_a2"])
def test_overlapped_steps_on_four_ranks_within_the_ceiling(spawned, name):
    seq, ovl = spawned[f"{name}_False"], spawned[f"{name}_True"]
    assert ovl["overlap"]
    for a, b in zip(ovl["history"], seq["history"]):
        assert abs(a["loss"] - b["loss"]) <= FOUR_RANK_REL * abs(b["loss"])
    for a, b in zip(jax.tree.leaves(ovl["params"]),
                    jax.tree.leaves(seq["params"])):
        assert float((a - b).norm() / b.norm()) <= FOUR_RANK_REL


def test_injected_latency_books_to_grad_sync_not_step_compute(spawned):
    steps, seconds = LATENCY
    ledger = spawned["latency"]["ledger"]
    injected = steps * seconds
    assert ledger["fired"] == steps
    assert ledger[goodput.BUCKET_GRAD_SYNC] >= injected * 0.95
    assert ledger[goodput.BUCKET_STEP_COMPUTE] < injected
