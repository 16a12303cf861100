"""The port's elastic path against the JAX package's.

The coordinator, the elastic mesh and the seams: the same scripted
membership and clock drive `cloudtik_tpu.train.elastic.ElasticCoordinator`
and the port's, and their decisions (and refusals) must be equal; the
mesh's layout over ranks must be the JAX mesh's over devices.  The
store-agreed decision, the store membership and a returning process's
admission run in one process.

The drill: four gloo ranks form two slices of fsdp=2 and train `tiny` for
12 steps with `fit_elastic`, saving every 4 steps; the step-8 save tears,
slice 1 is dropped at boundary 8 (its ranks leave), and comes back at 10
as two fresh processes that are handed the live state.  The JAX
`fit_elastic` runs the same story on the 8-device CPU mesh (two slices of
four) with the same batches.  Ceilings, f32 on one intra-op thread, as in
tests/test_torch_sharded_trainer.py: the first loss within 1e-5 relative,
later losses within 1e-4, every final parameter within 1e-4 relative L2;
the K-1 era equal bit for bit to a fresh two-rank run restored from step
4.  A second drill loses slice 0, so the surviving ranks renumber, the
shard writer's role moves to them, and a returning process is rank 0 of
the expanded group.  All ranks run in one spawn
(`tools/torch_parallel_cases.py`) with a deadline.
"""

import itertools
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cloudtik_tpu.faults import seams as jseams
from cloudtik_tpu.faults.plan import FaultPlan as JFaultPlan
from cloudtik_tpu.faults.plan import FaultPoint as JFaultPoint
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel import mesh as JM
from cloudtik_tpu.parallel.sharding import make_rules as jmake_rules
from cloudtik_tpu.train import elastic as JE
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
from cloudtik_tpu_torch.parallel import distributed
from cloudtik_tpu_torch.parallel import mesh as PM
from cloudtik_tpu_torch.parallel.launch import run_ranks
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import elastic as E

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_DEADLINE_S = 150


@pytest.fixture(autouse=True)
def _disarmed():
    seams.disarm()
    jseams.disarm()
    yield
    seams.disarm()
    jseams.disarm()


# ------------------------------------------------------ device groups --

def test_slice_groups_split_ranks_as_jax_splits_devices():
    devices = jax.devices()[:8]
    jgroups = JM.slice_device_groups(devices, num_slices=2)
    groups = PM.slice_device_groups(range(8), num_slices=2)
    assert sorted(groups) == sorted(jgroups) == [0, 1]
    for s in groups:
        assert groups[s] == [devices.index(d) for d in jgroups[s]]
    for mod, items in ((JM, devices), (PM, range(8))):
        with pytest.raises(ValueError, match="not divisible"):
            mod.slice_device_groups(items, num_slices=3)


# ------------------------------------------------------ elastic meshes --

@pytest.mark.parametrize("alive", [[0, 1], [1], [0]])
@pytest.mark.parametrize("per_slice", [dict(data=1, fsdp=-1),
                                       dict(data=2, fsdp=2)])
def test_elastic_layout_is_the_jax_mesh(alive, per_slice):
    """The data axis scales with the live slices, the intra-slice layout
    stays, and the ranks are slice-major: the port's group order is the
    JAX mesh's device order."""
    devices = jax.devices()[:8]
    jmesh = JM.build_elastic_mesh(
        JM.MeshConfig(**per_slice), JM.slice_device_groups(
            devices, num_slices=2), alive)
    groups = PM.slice_device_groups(range(8), num_slices=2)
    order = PM.elastic_ranks(groups, alive)
    sizes = PM.elastic_mesh_config(PM.MeshConfig(**per_slice),
                                   len(alive)).axis_sizes(len(order))
    assert sizes == {a: int(n) for a, n in jmesh.shape.items()}
    assert order == [devices.index(d) for d in jmesh.devices.flatten()]
    assert PM.data_axis_size(sizes) == JM.data_axis_size(jmesh)


def test_elastic_mesh_refusals_are_the_references():
    jgroups = JM.slice_device_groups(jax.devices()[:8], num_slices=2)
    groups = PM.slice_device_groups(range(8), num_slices=2)
    for bad, match in (([0, 7], "unknown slice"), ([], "zero live slices")):
        with pytest.raises(ValueError, match=match):
            JM.build_elastic_mesh(JM.MeshConfig(data=1, fsdp=-1), jgroups,
                                  bad)
        with pytest.raises(ValueError, match=match):
            PM.elastic_ranks(groups, bad)
        with pytest.raises(ValueError, match=match):
            PM.build_elastic_mesh(PM.MeshConfig(data=1, fsdp=-1), groups,
                                  bad)
    uneven = {0: [0, 1], 1: [2]}
    with pytest.raises(ValueError, match="differ in size"):
        PM.elastic_ranks(uneven, [0, 1])
    for mod in (JM, PM):
        with pytest.raises(ValueError, match="explicit per-slice data"):
            mod.elastic_mesh_config(mod.MeshConfig(data=-1, fsdp=1), 2)


def test_build_elastic_mesh_needs_the_live_slices_group():
    """Without a group of the live slices' size no mesh is built: the
    group is re-formed first (`distributed.reform_group`)."""
    groups = PM.slice_device_groups(range(4), num_slices=2)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        PM.build_elastic_mesh(PM.MeshConfig(data=1, fsdp=2), groups, [0])


# -------------------------------------------------------- coordinator --

class _Fake:
    def __init__(self, i):
        self.id = i


def _pair(alive, clock=None, membership=None, **kw):
    """(JAX coordinator, port coordinator) over the same membership and
    clock; two slices of four devices, or of four ranks."""
    kw.setdefault("remesh_dwell_s", 0.0)
    source = membership or (lambda: alive["s"])
    if clock is not None:
        kw["clock"] = lambda: clock["t"]
    slices = kw.pop("slices", 2)
    j = JE.ElasticCoordinator(
        source, mesh_config=JM.MeshConfig(data=1, fsdp=-1),
        slice_devices={s: [_Fake(4 * s + i) for i in range(4)]
                       for s in range(slices)}, **kw)
    t = E.ElasticCoordinator(
        source, mesh_config=PM.MeshConfig(data=1, fsdp=-1),
        slice_devices={s: list(range(4 * s, 4 * s + 4))
                       for s in range(slices)}, **kw)
    return j, t


def _view(decision):
    if decision is None:
        return None
    return (decision.from_slices, decision.to_slices, decision.reason,
            decision.direction)


def _both(pair, step, commit=True):
    """Poll both at `step`; the decisions (equal, or both raising the
    same) as a comparable view, committed when there is one."""
    out = []
    for c in pair:
        try:
            d = c.poll(step)
        except RuntimeError as e:
            out.append(("raise", str(e)))
            continue
        if d is not None and commit:
            c.commit(d)
        out.append(_view(d))
    assert out[0] == out[1], out
    return out[0]


def test_coordinator_script_shrink_expand_unknown_and_object():
    alive = {"s": {0, 1}}
    pair = _pair(alive)
    assert _both(pair, 3) is None
    alive["s"] = {0}
    assert _both(pair, 5) == ((0, 1), (0,), "slice_lost", "shrink")
    alive["s"] = {0, 1, 9}          # unknown slices are ignored
    assert _both(pair, 9) == ((0,), (0, 1), "capacity_returned", "expand")
    assert pair[0].current == pair[1].current == (0, 1)

    class View:
        def alive_slices(self):
            return [1]

    pair = _pair(None, membership=View())
    assert _both(pair, 0) == ((0, 1), (1,), "slice_lost", "shrink")


def test_coordinator_script_below_min_grace_then_raises():
    clock = {"t": 0.0}
    alive = {"s": set()}
    pair = _pair(alive, clock, min_slices=1, min_slices_grace_s=30.0)
    views = []
    for t, s, step in ((0.0, set(), 0), (10.0, set(), 1), (10.0, {0, 1}, 2),
                       (40.0, set(), 3), (75.0, set(), 4)):
        clock["t"], alive["s"] = t, s
        views.append(_both(pair, step))
    assert views[:4] == [None] * 4
    assert views[4][0] == "raise" and "below min_slices" in views[4][1]


def test_coordinator_script_dwell_and_equal_size_swap():
    clock = {"t": 0.0}
    alive = {"s": {0, 1}}
    pair = _pair(alive, clock, remesh_dwell_s=30.0)
    alive["s"] = {0}
    assert _both(pair, 1)[3] == "shrink"
    alive["s"] = {0, 1}
    for t, step in ((5.0, 2), (29.0, 3)):
        clock["t"] = t
        assert _both(pair, step) is None
    clock["t"] = 31.0
    assert _both(pair, 4)[2] == "capacity_returned"
    pair = _pair({"s": {0, 2}}, slices=3)
    for c in pair:
        c.current = (0, 1)
    assert _both(pair, 0) == ((0, 1), (0, 2), "slice_lost", "shrink")


def test_slice_lost_seam_drop_is_the_references():
    """An armed drop at elastic.slice_lost marks the slice lost for
    `times` polls, then capacity returns: the same decisions and fire
    counts on both."""
    alive = {"s": {0, 1}}
    pair = _pair(alive)
    jplan = JFaultPlan([JFaultPoint("elastic.slice_lost", "drop", times=2,
                                    match={"slice": 1})], seed=3)
    plan = FaultPlan([FaultPoint("elastic.slice_lost", "drop", times=2,
                                 match={"slice": 1})], seed=3)
    views = []
    with jseams.armed(jplan), seams.armed(plan):
        for step in (1, 2, 3):
            views.append(_both(pair, step))
    assert views == [((0, 1), (0,), "slice_lost", "shrink"), None,
                     ((0,), (0, 1), "capacity_returned", "expand")]
    assert jplan.points[0].fired == plan.points[0].fired == 2


def test_build_mesh_follows_the_current_set():
    alive = {"s": {0, 1}}
    j, t = _pair(alive)
    assert t.ranks() == list(range(8))
    alive["s"] = {1}
    _both((j, t), 0)
    assert t.ranks() == [4, 5, 6, 7]
    assert [d.id for d in j.slice_devices[1]] == t.ranks()


def test_remesh_seam_raises_before_anything_and_notes_are_free_when_off(
        monkeypatch):
    plan = FaultPlan([FaultPoint("elastic.remesh", "raise", times=1)],
                     seed=1)
    with seams.armed(plan):
        with pytest.raises(Exception):
            E.fire_remesh_seam((0, 1), (0,), E.REASON_SLICE_LOST)
    assert plan.points[0].fired == 1
    from cloudtik_tpu_torch.telemetry import core as tcore
    from cloudtik_tpu_torch.telemetry import instruments as ti

    before = ti.ELASTIC_REMESHES.value(direction="shrink")
    monkeypatch.setattr(tcore.STATE, "enabled", False)
    E._note_remesh("shrink", 1.0, 1)
    assert ti.ELASTIC_REMESHES.value(direction="shrink") == before


# ------------------------------------------------ the store's agreement --

def _store_pair(tmp_path, alive):
    store = distributed.elastic_store(str(tmp_path / "store"), 10.0)
    groups = {0: [0, 1], 1: [2, 3]}
    views = [lambda: alive["a"], lambda: alive["b"]]
    return store, [E.ElasticCoordinator(
        v, mesh_config=PM.MeshConfig(data=1, fsdp=2), slice_devices=groups,
        store=store, rank=r, remesh_dwell_s=0.0)
        for v, r in zip(views, (0, 2))]


def test_ranks_adopt_the_first_decision_at_a_boundary(tmp_path):
    """Two ranks that see different membership at one boundary adopt the
    decision of the first to write it; the next boundary is its own."""
    alive = {"a": {0, 1}, "b": {0}}
    store, (a, b) = _store_pair(tmp_path, alive)
    assert a.poll(4) is None
    assert b.poll(4) is None              # a wrote first: no change
    d = b.poll(5)                         # b first at 5: a shrink
    assert a.poll(5) == d and d.to_slices == (0,)
    for c in (a, b):
        c.commit(d)
    assert a.generation == b.generation == 1
    # the same step in the next generation is a new boundary
    alive["a"] = alive["b"] = {0}
    assert a.poll(5) is None and b.poll(5) is None


def test_store_membership_and_admission(tmp_path):
    """A slice counts when all its ranks registered; a decision that drops
    it marks them gone; a returning process registers and is admitted by
    the generation that takes its slice back."""
    store = distributed.elastic_store(str(tmp_path / "store"), 10.0)
    groups = {0: [0, 1], 1: [2, 3]}
    m = E.StoreMembership(store, groups)
    m.register([0, 1, 2])
    assert m.alive_slices() == {0}
    m.register([3])
    assert m.alive_slices() == {0, 1}

    def coordinator(rank):
        return E.ElasticCoordinator(
            m, mesh_config=PM.MeshConfig(data=1, fsdp=2),
            slice_devices=groups, store=store, rank=rank,
            remesh_dwell_s=0.0, timeout_s=10.0)

    survivor = coordinator(0)
    plan = FaultPlan([FaultPoint("elastic.slice_lost", "drop", times=1,
                                 match={"slice": 1})], seed=0)
    with seams.armed(plan):
        shrink = survivor.poll(8)
    assert shrink.to_slices == (0,)
    assert m.alive_slices() == {0}        # 2 and 3 marked gone
    survivor.commit(shrink)
    admitted = {}

    def returning(rank):
        c = coordinator(rank)
        admitted[rank] = c.admit()

    threads = [threading.Thread(target=returning, args=(r,))
               for r in (2, 3)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 10.0
    while m.alive_slices() != {0, 1} and time.monotonic() < deadline:
        time.sleep(0.01)
    expand = survivor.poll(10)
    for th in threads:
        th.join(10.0)
    assert expand.reason == E.REASON_CAPACITY_RETURNED
    for rank in (2, 3):
        decision, step = admitted[rank]
        assert decision == expand and step == 10
    assert survivor.leaves(expand) is False
    assert coordinator(2).leaves(shrink) is True


# ------------------------------------------------------------ the drill --

B, S, STEPS, EVERY = 8, 32, 12, 4
OPT = dict(learning_rate=1e-2, warmup_steps=1, schedule="constant")
DRILLS = {"lose1": 1, "lose0": 0}
# F5: lose1's story under rules that split the embedding over `data` (and
# fsdp inside a slice), which the expand hands over block by block
SPLIT, SPLIT_RULES = "lose1_embed_data", {"embed": ("data", "fsdp")}


def _batches():
    it = TD.synthetic_lm_batches(B, S, 256, seed=0)
    return [next(it) for _ in range(STEPS)]


def _jax_params():
    cfg = JT.config("tiny", dtype=jax.numpy.float32)
    return cfg, JT.init_params(jax.random.PRNGKey(0), cfg)


def _jax_drill(tmp, rules=None):
    """The JAX fit_elastic over two slices of four CPU devices: the torn
    step-8 save, slice 1 gone from boundary 8, back at 10 (under `rules`
    overrides: the expand's `device_put` reshards the split leaves)."""
    jcfg, _ = _jax_params()
    batches = _batches()
    alive = {"s": {0, 1}}
    coord = JE.ElasticCoordinator(
        lambda: alive["s"], mesh_config=JM.MeshConfig(data=1, fsdp=-1),
        slice_devices=JM.slice_device_groups(jax.devices()[:8],
                                             num_slices=2),
        remesh_dwell_s=0.0)
    trainer = JTR.Trainer(JTR.transformer_spec(jcfg), JTR.TrainerConfig(
        global_batch_size=B, seq_len=S, log_every=1, prefetch_depth=0,
        optimizer=JO.OptimizerConfig(**OPT), checkpoint_every=EVERY,
        rules=jmake_rules(**(rules or {})),
        checkpoint_dir=str(tmp / f"jax-ckpt{'-rules' if rules else ''}")),
        mesh=coord.build_mesh())
    trainer.init_state(jax.random.PRNGKey(0))
    fired = set()

    def chaos(_trainer, entry):
        if entry["step"] == 8 and "lost" not in fired:
            fired.add("lost")
            alive["s"] = {0}
        if entry["step"] == 10 and len(coord.current) == 1 \
                and "back" not in fired:
            fired.add("back")
            alive["s"] = {0, 1}

    def factory(step):
        return itertools.islice(iter(batches), step, None)

    plan = JFaultPlan([JFaultPoint("checkpoint.save", "torn_write",
                                   times=1, match={"step": 8})], seed=42)
    with jseams.armed(plan):
        out = trainer.fit_elastic(factory, STEPS, coord, callbacks=[chaos])
    trainer.checkpointer.wait()
    return out["history"], jax.tree.map(np.asarray, trainer.state["params"])


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    _, jp = _jax_params()
    cases = [dict(kind="elastic", name=name, world=4, num_slices=2,
                  per_slice=dict(data=1, fsdp=2), model="tiny",
                  params=convert.params_from_jax(
                      jax.tree.map(np.asarray, jp), "cpu"),
                  batches=_batches(), batch=B, seq=S, steps=STEPS,
                  checkpoint_every=EVERY, torn_at=8, lost=lost, lost_at=8,
                  return_at=10, fresh_from=4, optimizer=OPT)
             for name, lost in DRILLS.items()]
    cases.append(dict(cases[0], name=SPLIT, rules=SPLIT_RULES))
    torch.save({"cases": cases}, out / "cases.pt")
    failure = []

    def spawn():
        try:
            run_ranks(["tools/torch_parallel_cases.py",
                       str(out / "cases.pt"), str(out)], 4,
                      SPAWN_DEADLINE_S, cwd=str(ROOT))
        except Exception as e:      # re-raised in the test's thread
            failure.append(e)

    ranks = threading.Thread(target=spawn)
    ranks.start()
    try:
        jax_run = _jax_drill(out)
        jax_split = _jax_drill(out, SPLIT_RULES)
    finally:
        ranks.join()
    if failure:
        raise failure[0]
    got = {}
    for name in list(DRILLS) + [SPLIT]:
        got[name] = {r: torch.load(out / f"{name}.rank{r}.pt",
                                   weights_only=False) for r in range(4)}
        got[name]["left"] = {r: torch.load(out / f"{name}.rank{r}.left.pt",
                                           weights_only=False)
                             for r in range(4)
                             if (out / f"{name}.rank{r}.left.pt").exists()}
    got[SPLIT]["jax"] = jax_split
    return got, jax_run


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _survivor(got, name):
    return got[name][0 if DRILLS[name] == 1 else 2]


def test_drill_steps_and_slices_are_the_references(drill):
    got, (jhist, _) = drill
    want = [(h["step"], h["slices"]) for h in jhist]
    assert [s for s, k in want if k == 1] == [5, 6, 7, 8, 9, 10]
    for name in DRILLS:
        res = _survivor(got, name)
        assert [(h["step"], h["slices"]) for h in res["history"]] == want
        assert res["final_step"] == STEPS and res["slices"] == [0, 1]
        assert res["world"] == 4


def test_drill_losses_and_params_match_jax(drill):
    got, (jhist, jparams) = drill
    res = _survivor(got, "lose1")
    hist = res["history"]
    assert _rel(hist[0]["loss"], jhist[0]["loss"]) <= 1e-5
    assert max(_rel(h["loss"], j["loss"])
               for h, j in zip(hist[1:], jhist[1:])) <= 1e-4
    for a, b in zip(jax.tree.leaves(res["params"]),
                    jax.tree.leaves(jparams)):
        assert _rel(a.numpy(), b) <= 1e-4


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_drill_k1_era_is_a_fresh_k1_run_bit_for_bit(drill, name):
    got, _ = drill
    res = _survivor(got, name)
    era = [h["loss"] for h in res["history"] if h["slices"] == 1]
    assert era == [h["loss"] for h in res["fresh"]]


def test_drill_losing_slice_0_moves_the_store_and_the_writer(drill):
    """The survivors of slice 1 renumber to ranks 0-1 and write the
    K-1 era's shards; the returning processes of slice 0 are ranks 0-1
    of the expanded group; both drills walk the same trajectory."""
    got, _ = drill
    a, b = _survivor(got, "lose1"), _survivor(got, "lose0")
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    assert set(got["lose0"]["left"]) == {0, 1}
    assert set(got["lose1"]["left"]) == {2, 3}
    for name in DRILLS:
        ranks = got[name]
        joined = [r for r in range(4) if ranks[r]["joined"]]
        assert joined == ([0, 1] if name == "lose0" else [2, 3])
        assert sorted(ranks[r]["rank_now"] for r in range(4)) == [0, 1, 2,
                                                                   3]
        for r in range(4):
            assert ranks[r]["committed"] == [4, 8, 12]
            for x, y in zip(jax.tree.leaves(ranks[r]["params"]),
                            jax.tree.leaves(ranks[0]["params"])):
                assert torch.equal(x, y)
        for r, left in ranks["left"].items():
            assert left["left"] and left["step"] == 8
            assert [h["step"] for h in left["history"]] == list(
                range(1, 9))


def test_drill_books_what_the_reference_drill_asserts(drill):
    got, _ = drill
    for name in DRILLS:
        res = _survivor(got, name)
        assert res["buckets"]["elastic_remesh"] > 0
        assert res["buckets"]["restart_replay"] > 0
        assert res["remeshes"] == {"shrink": 1, "expand": 1}
        assert res["elastic_slices"] == 2
        assert res["torn"]
        remeshes = [e for e in res["events"]
                    if e["name"] == "tik_elastic_remesh"]
        assert [e["reason"] for e in remeshes] == ["slice_lost",
                                                   "capacity_returned"]
        assert remeshes[0]["from_slices"] == [0, 1]
        assert remeshes[0]["to_slices"] == [1 - DRILLS[name]]
        assert remeshes[0]["step"] == 4 and remeshes[0]["replayed_to"] == 8
        assert all(e.get("traceparent") for e in remeshes)
        resumes = [e for e in res["events"]
                   if e["name"] == "tik_train_resume"]
        assert resumes and resumes[-1]["replay_until"] == 8


# ------------------------------------------- the expand under data rules --

def test_drill_split_over_data_matches_jax(drill):
    """F5: the expand hands over leaves split over `data` (embed rows over
    data x fsdp at K=2, over fsdp at K=1): the story, losses and final
    parameters are the JAX Trainer's under the same rules, within the
    first drill's ceilings, and every rank holds the same whole state."""
    got, _ = drill
    jhist, jparams = got[SPLIT]["jax"]
    res = got[SPLIT][0]
    assert "embed" in res["split_over_data"]
    assert [(h["step"], h["slices"]) for h in res["history"]] == \
        [(h["step"], h["slices"]) for h in jhist]
    assert res["remeshes"] == {"shrink": 1, "expand": 1}
    hist = res["history"]
    assert _rel(hist[0]["loss"], jhist[0]["loss"]) <= 1e-5
    assert max(_rel(h["loss"], j["loss"])
               for h, j in zip(hist[1:], jhist[1:])) <= 1e-4
    for a, b in zip(jax.tree.leaves(res["params"]),
                    jax.tree.leaves(jparams)):
        assert _rel(a.numpy(), b) <= 1e-4
    assert [r for r in range(4) if got[SPLIT][r]["joined"]] == [2, 3]
    for r in range(1, 4):
        for x, y in zip(jax.tree.leaves(got[SPLIT][r]["params"]),
                        jax.tree.leaves(res["params"])):
            assert torch.equal(x, y)


def test_drill_split_over_data_walks_the_default_trajectory(drill):
    """The same story under the default rules: every step's f32 loss
    within 1e-5 relative (the layouts differ only in reduction order)."""
    got, _ = drill
    split = got[SPLIT][0]["history"]
    default = _survivor(got, "lose1")["history"]
    assert [h["step"] for h in split] == [h["step"] for h in default]
    assert max(_rel(a["loss"], b["loss"])
               for a, b in zip(split, default)) <= 1e-5
