"""Port parity: the parallel vocabulary (parallel/{mesh,sharding,
distributed,collectives}.py) against the JAX package's, with
tests/test_parallel.py's cases.

The pure parts (MeshConfig, logical_to_spec, tree_to_shardings_safe,
local_batch_slice, slice_device_groups, the elastic config) are held to
JAX on the same sizes; batch rows are pinned against JAX's NamedSharding
on the 8-device CPU mesh; `auto_initialize` reads torchrun's and tik-run's
env as the docstring maps them.  One spawn of 4 gloo ranks holds the real
DeviceMesh (row-major, slice-major) and the collectives' gradients.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import lora as JL
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel import mesh as JM
from cloudtik_tpu.parallel import sharding as JS
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.parallel import distributed as TD
from cloudtik_tpu_torch.parallel import mesh as TM
from cloudtik_tpu_torch.parallel import sharding as TS
from cloudtik_tpu_torch.parallel.launch import run_ranks
from cloudtik_tpu_torch.train.data import global_batches, local_batch

ROOT = Path(__file__).resolve().parents[1]


def test_axis_vocabulary_is_the_references():
    assert TM.MESH_AXES == JM.MESH_AXES
    assert TM.DATA_AXES == JM.DATA_AXES
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    assert TS.make_rules(embed=("fsdp", "tensor")) == \
        JS.make_rules(embed=("fsdp", "tensor"))


@pytest.mark.parametrize("kw", [
    {}, dict(data=2, fsdp=2, tensor=2, seq=1), dict(data=-1, fsdp=1),
    dict(data=2, fsdp=1, expert=4), dict(seq=8, fsdp=1)])
def test_mesh_config_axis_sizes_match_jax(kw):
    assert TM.MeshConfig(**kw).axis_sizes(8) == \
        JM.MeshConfig(**kw).axis_sizes(8)
    assert TM.MeshConfig.fsdp_only().axis_sizes(8) == \
        JM.MeshConfig.fsdp_only().axis_sizes(8)
    assert TM.MeshConfig.dp().axis_sizes(8) == JM.MeshConfig.dp().axis_sizes(8)


@pytest.mark.parametrize("kw", [dict(data=3, fsdp=1),
                                dict(data=-1, fsdp=-1),
                                dict(data=2, fsdp=2)])
def test_mesh_config_errors_read_as_jax(kw):
    with pytest.raises(ValueError) as want:
        JM.MeshConfig(**kw).axis_sizes(8)
    with pytest.raises(ValueError) as got:
        TM.MeshConfig(**kw).axis_sizes(8)
    assert str(got.value) == str(want.value)


def test_mesh_fill_axis_and_sizes():
    sizes = TM.MeshConfig().axis_sizes(8)
    assert sizes["fsdp"] == 8
    assert TM.data_axis_size(sizes) == 8
    assert TM.mesh_summary(sizes) == {"fsdp": 8}
    assert TM.local_batch_slice(sizes, 16) == 2
    with pytest.raises(ValueError, match="not divisible"):
        TM.local_batch_slice(sizes, 12)


def _jax_mesh(**kw):
    return JM.build_mesh(JM.MeshConfig(**kw))


@pytest.mark.parametrize("axes, rules, mesh", [
    (("embed", "mlp"), {}, dict(data=2, fsdp=4)),
    (("batch", "seq"), {"seq": ("data",)}, dict(data=2, fsdp=4)),
    (("batch", "seq", None), {}, dict(data=2, fsdp=2, seq=2)),
    (("layers", "expert", "embed", "mlp"), {}, dict(fsdp=2, expert=4)),
    (("vocab", "embed"), {"embed": ("fsdp", "tensor")},
     dict(fsdp=2, tensor=4)),
    (("heads", "kv"), {}, dict(fsdp=1, tensor=8)),
])
def test_logical_to_spec_matches_jax(axes, rules, mesh):
    jmesh = _jax_mesh(**mesh)
    want = tuple(JS.logical_to_spec(axes, JS.make_rules(**rules), jmesh))
    sizes = TM.MeshConfig(**mesh).axis_sizes(8)
    got = TS.logical_to_spec(axes, TS.make_rules(**rules), sizes)
    assert got == want
    flat = [a for e in got for a in TS.spec_axes(e)]
    assert len(flat) == len(set(flat))


def test_unknown_logical_axis():
    with pytest.raises(ValueError, match="Unknown logical axis"):
        TS.logical_to_spec(("nonsense",), TS.DEFAULT_RULES,
                           TM.MeshConfig().axis_sizes(8))


@pytest.mark.parametrize("model, mesh, rules", [
    ("tiny", dict(data=1, fsdp=8), {}),
    ("tiny_moe", dict(data=2, fsdp=2, expert=2), {}),
    ("tiny", dict(data=4, fsdp=2), {"mlp": "fsdp"}),
    ("tiny", dict(fsdp=8), {"vocab": "fsdp", "embed": None}),
])
def test_tree_to_shardings_safe_matches_jax(model, mesh, rules):
    jcfg = JT.config(model, d_ff=99) if rules.get("mlp") else \
        JT.config(model)
    tcfg = TT.config(model, d_ff=jcfg.d_ff)
    jmesh = _jax_mesh(**mesh)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = JS.tree_to_shardings_safe(jmesh, JT.param_logical_axes(jcfg),
                                     shapes, JS.make_rules(**rules))
    got = TS.tree_to_shardings_safe(
        TM.MeshConfig(**mesh).axis_sizes(8), TT.param_logical_axes(tcfg),
        TT.init_params(torch.Generator(), tcfg, "meta"),
        TS.make_rules(**rules))
    flat_w = {jax.tree_util.keystr(p): tuple(s.spec)
              for p, s in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(p): s for p, s in
              jax.tree_util.tree_leaves_with_path(
                  got, is_leaf=lambda x: isinstance(x, tuple))}
    assert set(flat_w) == set(flat_g)
    for path, spec in flat_w.items():
        # PartitionSpec keeps trailing None entries implicit
        assert tuple(flat_g[path][:len(spec)]) == spec, path
        assert all(e is None for e in flat_g[path][len(spec):]), path


def test_tree_to_shardings_and_lora_axes_match_jax():
    jmesh = _jax_mesh(data=1, fsdp=8)
    tree = {"w": ("embed", "mlp"), "b": ("norm",)}
    want = JS.tree_to_shardings(jmesh, tree)
    got = TS.tree_to_shardings(TM.MeshConfig(data=1, fsdp=8).axis_sizes(8),
                               tree)
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    assert TL.lora_logical_axes(TT.config("tiny"), TL.LoRAConfig(
        targets=("wq", "wk", "wv", "wo"))) == JL.lora_logical_axes(
        JT.config("tiny"), JL.LoRAConfig(targets=("wq", "wk", "wv", "wo")))


def test_logical_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    sizes = TM.MeshConfig(data=2, fsdp=2, expert=2).axis_sizes(8)
    spec = TS.logical_to_spec(("layers", "expert", "embed", "mlp"),
                              TS.DEFAULT_RULES, sizes)
    got = TS.logical_to_placements(spec, sizes)
    assert got == [Replicate(), Shard(2), Replicate(), Shard(1),
                   Replicate(), Replicate()]


def test_batch_axes_and_replicated_match_jax():
    for kw in (dict(data=2, fsdp=4), dict(data=8, fsdp=1), dict(fsdp=8)):
        jmesh = _jax_mesh(**kw)
        sizes = TM.MeshConfig(**kw).axis_sizes(8)
        assert TS.batch_mesh_axes(sizes) == JS.batch_mesh_axes(jmesh)
        assert TS.batch_sharding(sizes) == \
            tuple(JS.batch_sharding(jmesh).spec)
    assert TS.replicated(sizes) == tuple(JS.replicated(jmesh).spec)


class _Coords:
    """A mesh at one coordinate: what local_batch reads of a DeviceMesh."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


@pytest.mark.parametrize("kw", [dict(data=2, fsdp=4),
                                dict(data=2, fsdp=2, seq=2),
                                dict(data=2, fsdp=1, expert=4),
                                dict(fsdp=2, seq=4)])
def test_local_batch_rows_are_jax_batch_sharding_rows(kw):
    """Each mesh position's rows are the ones JAX's batch sharding puts on
    the device at that position (row order pinned), and a seq rank takes
    its slice of the sequence."""
    jmesh = _jax_mesh(**kw)
    tokens = np.arange(8 * 16).reshape(8, 16)
    arr = jax.device_put(tokens, JS.batch_sharding(jmesh))
    rows_of = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    sizes = TM.MeshConfig(**kw).axis_sizes(8)
    for pos in np.ndindex(*jmesh.devices.shape):
        coords = dict(zip(jmesh.axis_names, pos))
        got = local_batch({"tokens": tokens}, _Coords(sizes, coords))
        want = rows_of[jmesh.devices[pos]]
        n = sizes["seq"]
        s = 16 // n
        np.testing.assert_array_equal(
            got["tokens"], want[:, coords["seq"] * s:(coords["seq"] + 1) * s])


def test_slice_groups_and_elastic_config_match_jax():
    devs = jax.devices()
    want = JM.slice_device_groups(devs, num_slices=2)
    got = TM.slice_device_groups(range(8), num_slices=2)
    assert got == {k: [d.id for d in v] for k, v in want.items()}
    with pytest.raises(ValueError, match="simulated slices"):
        TM.slice_device_groups(range(8), num_slices=3)
    per = TM.MeshConfig(data=1, fsdp=4)
    jper = JM.MeshConfig(data=1, fsdp=4)
    assert TM.elastic_mesh_config(per, 2) == TM.MeshConfig(
        **vars(JM.elastic_mesh_config(jper, 2)))
    with pytest.raises(ValueError, match="explicit per-slice data"):
        TM.elastic_mesh_config(TM.MeshConfig(data=-1), 2)
    with pytest.raises(ValueError, match="divisible"):
        TM._per_slice_shape((3, 1, 1, 1, 1, 1), 2)


def test_tensor_and_pipe_are_refused_naming_the_next_slice():
    for axis in ("tensor", "pipe"):
        with pytest.raises(NotImplementedError, match="slice 12"):
            TM.check_ported({axis: 2})
    TM.check_ported({"data": 2, "fsdp": 2, "expert": 2, "seq": 2})


def test_ambient_mesh_probes():
    assert TS.current_mesh() is None and TS.mesh_axis_size("seq") == 1
    assert not TS.mesh_is_sharded()
    x = torch.ones(2)
    assert TS.with_sharding_constraint(x, "batch") is x
    sizes = TM.MeshConfig(data=2, fsdp=2, tensor=2).axis_sizes(8)
    with TS.use_mesh(sizes):
        assert TS.mesh_axis_size("data") == 2 and TS.mesh_is_sharded()
        assert TS.logical_axis_size("batch") == 4
        assert TS.logical_axis_size("vocab") == 2
        assert TS.with_sharding_constraint(x, "batch", None) is x
        with pytest.raises(ValueError, match="Unknown"):
            TS.with_sharding_constraint(x, "nonsense")
    assert TS.current_mesh() is None


# ---------------------------------------------------------------- env --

@pytest.fixture
def captured(monkeypatch):
    """auto_initialize with the process-group calls captured."""
    calls = {}
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", "TIK_COORDINATOR_ADDRESS",
                 "TIK_NUM_PROCESSES", "TIK_PROCESS_ID", "TIK_SLICE_INDEX",
                 "TIK_NUM_SLICES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(TD.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(TD.dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    return calls


def test_single_process_needs_no_group(captured):
    assert TD.auto_initialize() is False and not captured
    assert TD.process_index() == 0 and TD.process_count() == 1
    assert TD.is_coordinator()


def test_torchrun_env(captured, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29400")
    assert TD.auto_initialize(timeout_s=12) is True
    assert captured["world_size"] == 4 and captured["rank"] == 3
    assert captured["init_method"] == "tcp://10.0.0.2:29400"
    assert captured["backend"] == "gloo"        # no CUDA here
    assert captured["timeout"].total_seconds() == 12


def test_tik_run_env_counts_hosts_times_local_cards(captured, monkeypatch):
    """tik-run exports hosts (TIK_NUM_PROCESSES) and this host's index;
    each host runs one process per card (LOCAL_RANK of
    LOCAL_WORLD_SIZE): world = hosts x cards, rank host-major."""
    monkeypatch.setenv("TIK_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("TIK_NUM_PROCESSES", "2")
    monkeypatch.setenv("TIK_PROCESS_ID", "1")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setenv("TIK_SLICE_INDEX", "1")
    monkeypatch.setenv("TIK_NUM_SLICES", "2")
    assert TD.auto_initialize() is True
    assert captured["world_size"] == 8 and captured["rank"] == 6
    assert captured["init_method"] == "tcp://10.0.0.1:8476"
    assert TD.slice_index() == 1 and TD.slice_count() == 2
    assert TD.local_rank() == 2


def test_tik_run_single_host_one_card_is_single_process(captured,
                                                        monkeypatch):
    monkeypatch.setenv("TIK_NUM_PROCESSES", "1")
    monkeypatch.setenv("TIK_PROCESS_ID", "0")
    assert TD.auto_initialize() is False and not captured
    assert TD.slice_index() == 0 and TD.slice_count() == 1


def test_a_world_without_a_rank_or_address_is_refused(captured,
                                                      monkeypatch):
    with pytest.raises(ValueError, match="rank"):
        TD.auto_initialize(num_processes=2)
    with pytest.raises(ValueError, match="coordinator address"):
        TD.auto_initialize(num_processes=2, process_id=0)


def test_rank_device_is_the_ranks_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert TD.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TD.rank_device()


# -------------------------------------------------------------- spawn --

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    tokens = np.arange(8 * 8).reshape(8, 8)
    cases = [
        dict(kind="collectives", name="data2_fsdp2", world=4,
             mesh=dict(data=2, fsdp=2), axis="fsdp", tokens=tokens),
        dict(kind="collectives", name="slices2", world=4,
             mesh=dict(data=2, fsdp=2, num_slices=2), axis="data",
             tokens=tokens),
        dict(kind="collectives", name="expert2_seq2", world=4,
             mesh=dict(fsdp=1, expert=2, seq=2), axis="seq", tokens=tokens),
    ]
    torch.save({"cases": cases}, out / "cases.pt")
    run_ranks(["tools/torch_parallel_cases.py", str(out / "cases.pt"),
               str(out)], 4, 120, cwd=str(ROOT))
    return {c["name"]: [torch.load(out / f"{c['name']}.rank{r}.pt",
                                   weights_only=False) for r in range(4)]
            for c in cases}


def test_device_mesh_is_row_major_over_ranks(spawned):
    for name, kw in (("data2_fsdp2", dict(data=2, fsdp=2)),
                     ("expert2_seq2", dict(fsdp=1, expert=2, seq=2))):
        sizes = TM.MeshConfig(**kw).axis_sizes(4)
        shape = tuple(sizes[a] for a in TM.MESH_AXES)
        for res in spawned[name]:
            want = dict(zip(TM.MESH_AXES,
                            np.unravel_index(res["rank"], shape)))
            assert res["coords"] == {a: int(v) for a, v in want.items()}


def test_slices_are_contiguous_rank_runs_and_data_crosses_them(spawned):
    groups = TM.slice_device_groups(range(4), num_slices=2)
    for res in spawned["slices2"]:
        slice_of = next(s for s, ranks in groups.items()
                        if res["rank"] in ranks)
        assert res["coords"]["data"] == slice_of


def test_local_batch_on_the_real_mesh(spawned):
    tokens = np.arange(8 * 8).reshape(8, 8)
    for res in spawned["data2_fsdp2"]:
        c = res["coords"]
        shard = c["data"] * 2 + c["fsdp"]
        np.testing.assert_array_equal(res["rows"],
                                      tokens[shard * 2:(shard + 1) * 2])
    for res in spawned["expert2_seq2"]:
        c = res["coords"]     # every expert rank the same rows
        np.testing.assert_array_equal(
            res["rows"], tokens[:, c["seq"] * 4:(c["seq"] + 1) * 4])


def test_collective_gradients(spawned):
    """gather_dim: the shards side by side, the gradient reduce-scattered;
    reduce_sum: the sum forward, each rank's own gradient back; copy_to:
    the identity forward, the sum of the ranks' gradients back."""
    for res in spawned["data2_fsdp2"]:
        r = res["coords"]["fsdp"]
        want = torch.cat([torch.full((2, 3), 1.0), torch.full((2, 3), 2.0)],
                         dim=1)
        assert torch.equal(res["gathered"], want)
        # two ranks each differentiate sum(g * arange): the shard's grad is
        # twice its slice of arange
        ar = torch.arange(12.0).reshape(2, 6)
        assert torch.equal(res["gather_grad"], 2 * ar[:, r * 3:(r + 1) * 3])
        assert torch.equal(res["reduce_sum"], torch.full((2,), 3.0))
        assert torch.equal(res["reduce_sum_grad"],
                           torch.full((2,), float(r + 1)))
        assert torch.equal(res["copy_to_grad"], torch.full((2,), 3.0))


def test_global_batches_yield_each_ranks_rows_as_int64_tensors():
    sizes = TM.MeshConfig(data=2, fsdp=2, seq=2).axis_sizes(8)
    batch = {"tokens": np.arange(8 * 8, dtype=np.int32).reshape(8, 8),
             "weights": np.ones((8,), np.float32)}
    coords = {"data": 1, "fsdp": 0, "seq": 1}
    got = next(global_batches(iter([batch]), _Coords(sizes, coords),
                              device="cpu"))
    assert got["tokens"].dtype == torch.int64
    assert got["weights"].dtype == torch.float32
    # batch shard 1 * 2 + 0 = 2 of 4: rows 4-5, sequence half 1
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  batch["tokens"][4:6, 4:])
    assert got["weights"].shape == (2,)
