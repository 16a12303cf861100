"""The port's checkpoints (cloudtik_tpu_torch/train/checkpoint.py) on the
CPU, and the one-way import of the JAX package's orbax checkpoints
(tools/import_jax_checkpoint.py).

The contracts of tests/test_checkpoint.py, on the port's `Checkpointer`
and `Trainer`: the round trip, the resume, the retention window, a missing
step, the params-only partial restore (which reads no optimizer file),
`restore_latest_good` past a torn step; the format's own guarantees (a
step without its manifest is not listed, a short leaf file never
restores); a port run resumed at step 2 equals an uninterrupted one
bitwise.  Then parity: a JAX `tiny` run's checkpoints, imported, resume in
the port to the JAX resumed run's losses within the trainer test's 1e-4
relative, and serve the JAX backends' greedy tokens (plain, engine, and an
imported LoRA adapter).  `tiny` in f32, one intra-op thread.
"""

import itertools
import json
import os
import shutil
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import lora as JL
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel.mesh import MeshConfig, build_mesh
from cloudtik_tpu.serve import server as JS
from cloudtik_tpu.train import checkpoint as JC
from cloudtik_tpu.train import data as JD
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import server as TS
from cloudtik_tpu_torch.telemetry import events, goodput
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR
from cloudtik_tpu_torch.train.checkpoint import (
    FORMAT, MANIFEST, CheckpointConfig, Checkpointer)
from cloudtik_tpu_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import import_jax_checkpoint  # noqa: E402

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
TCFG = TT.config("tiny", dtype=torch.float32, attention_impl="reference")


def _trainer(directory, every=2, prefetch_depth=2, **opt):
    return TTR.Trainer(TTR.transformer_spec(TCFG), TTR.TrainerConfig(
        global_batch_size=4, seq_len=32, log_every=1,
        optimizer=TO.OptimizerConfig(**dict(OPT, **opt)),
        checkpoint_every=every, checkpoint_dir=str(directory),
        prefetch_depth=prefetch_depth), device="cpu")


def _data(skip=0):
    return itertools.islice(TD.synthetic_lm_batches(4, 32, 256, seed=3),
                            skip, None)


def _losses(out):
    return [h["loss"] for h in out["history"]]


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# --------------------------------------------------------- the contracts --

def test_save_restore_roundtrip(tmp_path):
    trainer = _trainer(tmp_path / "ckpt", moment_dtype="bfloat16")
    trainer.fit(_data(), 4)
    trainer.checkpointer.wait()
    assert trainer.checkpointer.latest_step() == 4
    again = _trainer(tmp_path / "ckpt", moment_dtype="bfloat16")
    assert again.maybe_resume() == 4
    _assert_trees_equal(trainer.state, again.state)
    assert again.opt_state["count"] == 4
    assert again.opt_state["mu"]["embed"].dtype == torch.bfloat16
    assert all(p.requires_grad for p in tree_leaves(again.params))


def test_resume_continues_training(tmp_path):
    trainer = _trainer(tmp_path / "ckpt")
    data = _data()
    trainer.fit(data, 2)
    trainer.checkpointer.wait()
    again = _trainer(tmp_path / "ckpt")
    assert again.maybe_resume() == 2
    assert again.fit(data, 3)["final_step"] == 5


def test_resume_is_bitwise_on_the_cpu(tmp_path):
    """A run resumed at step 2 equals an uninterrupted run bitwise (the
    preempted-slice drill's contract), with and without prefetch."""
    straight = _trainer(tmp_path / "a", every=1000, prefetch_depth=0)
    straight.init_state(torch.Generator().manual_seed(0))
    want = _losses(straight.fit(_data(), 5))
    first = _trainer(tmp_path / "b")
    first.init_state(torch.Generator().manual_seed(0))
    assert _losses(first.fit(_data(), 2)) == want[:2]
    first.checkpointer.wait()
    resumed = _trainer(tmp_path / "b", every=1000)
    assert resumed.maybe_resume() == 2
    assert _losses(resumed.fit(_data(skip=2), 3)) == want[2:]
    _assert_trees_equal(resumed.state, straight.state)


def test_retention_window(tmp_path):
    trainer = _trainer(tmp_path / "ckpt", every=1)
    assert trainer.checkpointer.config.max_to_keep == 3
    trainer.fit(_data(), 5)
    trainer.checkpointer.wait()
    assert trainer.checkpointer.all_steps() == [3, 4, 5]


def test_keep_period_keeps_every_nth_beside_the_window(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(
        directory=str(tmp_path), max_to_keep=1, keep_period=2))
    for step in range(1, 6):
        assert ckpt.save(step, {"x": torch.full((2,), float(step))},
                         force=True)
    ckpt.close()
    assert ckpt.all_steps() == [2, 4, 5]


def test_should_save_follows_orbax(tmp_path):
    """The first save starts whatever its step; then only on the interval
    and never at or before the newest step, unless forced."""
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                         save_interval_steps=3))
    state = {"x": torch.zeros(2)}
    assert ckpt.save(1, state)                 # nothing saved yet
    assert not ckpt.save(2, state)             # off the interval
    assert ckpt.save(3, state)
    assert not ckpt.save(3, state)             # not again at 3
    assert ckpt.save(5, state, force=True)
    assert not ckpt.save(3, state)             # before the newest
    ckpt.wait()
    assert ckpt.all_steps() == [1, 3, 5]


def test_restore_missing_raises(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"x": torch.zeros(2)})
    assert not (tmp_path / "none").exists()


def test_partial_restore_params_only_reads_no_optimizer_file(tmp_path):
    """Serving loads params out of a full {params, opt_state} checkpoint:
    with partial=True only the params' files are read, so deleting every
    optimizer file changes nothing; without it the tree must match."""
    trainer = _trainer(tmp_path / "ckpt")
    trainer.fit(_data(), 2)
    trainer.checkpointer.wait()
    root = tmp_path / "ckpt" / "2"
    manifest = json.loads((root / MANIFEST).read_text())
    assert manifest["format"] == FORMAT
    for entry in manifest["leaves"]:
        if entry["path"][0] == "opt_state" and "file" in entry:
            os.unlink(root / entry["file"])
    template = {"params": TT.init_params(torch.Generator(), TCFG, "meta")}
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path / "ckpt")))
    restored = ckpt.restore(template, partial=True)
    assert set(restored) == {"params"}
    _assert_trees_equal(restored["params"], trainer.params)
    with pytest.raises(ValueError, match="partial=True"):
        ckpt.restore(template)


def test_a_short_leaf_file_never_restores(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    state = {"w": torch.arange(8, dtype=torch.bfloat16), "n": 3}
    ckpt.save(1, state, force=True)
    ckpt.wait()
    ckpt._tear_step(1)
    assert ckpt.all_steps() == [1]             # it LOOKS committed
    with pytest.raises(ValueError, match="torn write"):
        ckpt.restore(state)


def test_a_torn_step_fails_before_any_leaf_is_read(tmp_path,
                                                  monkeypatch):
    """Every named file's length is checked first: restore_latest_good
    walks past a torn step without reading a byte of it."""
    from cloudtik_tpu_torch.train import checkpoint as C

    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                         max_to_keep=0))
    state = {"a": torch.ones(64), "b": torch.ones(8), "c": torch.ones(4)}
    ckpt.save(1, state, force=True)
    ckpt.save(2, state, force=True)
    ckpt.wait()
    # the last leaf of step 2 short: a read in order would read a and b
    with open(tmp_path / "2" / "2.bin", "r+b") as f:
        f.truncate(4)
    reads = []
    read_leaf = C._read_leaf
    monkeypatch.setattr(C, "_read_leaf", lambda root, *a: (
        reads.append(os.path.basename(root)), read_leaf(root, *a))[1])
    _, step = ckpt.restore_latest_good(state)
    assert step == 1 and reads == ["1", "1", "1"]


def test_reserve_is_called_before_a_fit_that_will_save(tmp_path,
                                                      monkeypatch):
    """The host buffers are pinned before the loop of a fit that reaches
    a save, and never for one that does not; host tensors need none."""
    trainer = _trainer(tmp_path / "ckpt", every=3)
    trainer.init_state(torch.Generator().manual_seed(0))
    calls = []
    reserve = trainer.checkpointer.reserve
    monkeypatch.setattr(trainer.checkpointer, "reserve", lambda state: (
        calls.append(trainer.step), reserve(state)))
    trainer.fit(_data(), 2)                    # steps 1-2: no save
    trainer.fit(_data(skip=2), 2)              # steps 3-4: saves at 3
    assert calls == [2]
    trainer.checkpointer.wait()
    assert trainer.checkpointer.all_steps() == [3]
    assert trainer.checkpointer._pinned == {}  # CPU state: nothing pinned


def test_a_step_without_its_manifest_is_not_a_step(tmp_path):
    """A crash between the data and the rename leaves only the temporary
    directory; a step directory without a manifest is not listed."""
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ckpt.save(1, {"x": torch.ones(3)}, force=True)
    ckpt.wait()
    shutil.copytree(tmp_path / "1", tmp_path / "2.tmp-dead")
    shutil.copytree(tmp_path / "1", tmp_path / "3")
    os.unlink(tmp_path / "3" / MANIFEST)
    assert ckpt.all_steps() == [1]
    assert ckpt.latest_step() == 1


def test_restore_latest_good_skips_and_optionally_removes_torn(tmp_path):
    trainer = _trainer(tmp_path / "ckpt")
    trainer.fit(_data(), 4)
    trainer.checkpointer.close()
    root = tmp_path / "ckpt"
    shutil.copytree(root / "4", root / "6")
    ckpt = Checkpointer(CheckpointConfig(directory=str(root)))
    ckpt._tear_step(6)
    assert 6 in ckpt.all_steps()
    like = trainer._abstract_state()
    _state, step = ckpt.restore_latest_good(like)
    assert step == 4 and 6 in ckpt.all_steps()
    _state, step = ckpt.restore_latest_good(like, remove_unreadable=True)
    assert step == 4 and 6 not in ckpt.all_steps()


def test_restore_latest_good_raises_when_nothing_reads(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    assert ckpt.restore_latest_good({"w": torch.zeros(4)}) is None
    for step in (1, 2):
        ckpt.save(step, {"w": torch.ones(4)}, force=True)
        ckpt.wait()
        ckpt._tear_step(step)
    with pytest.raises(RuntimeError, match="none of the 2 checkpoints"):
        ckpt.restore_latest_good({"w": torch.zeros(4)})


@pytest.mark.chaos
def test_torn_checkpoint_falls_back_to_previous_committed_step(tmp_path):
    """The torn-write drill through the port's FaultPlan: step 4 is torn
    right after it commits; the resume skips it and lands on step 2."""
    trainer = _trainer(tmp_path / "ckpt")
    plan = FaultPlan([FaultPoint("checkpoint.save", "torn_write",
                                 match={"step": 4})], seed=7)
    with seams.armed(plan):
        trainer.fit(_data(), 4)
        trainer.checkpointer.wait()
    assert [e for e in plan.trace if e["kind"] == "torn_write"]
    resumed = _trainer(tmp_path / "ckpt", every=1000)
    assert resumed.checkpointer.latest_step() == 4
    assert resumed.maybe_resume() == 2
    assert resumed.fit(_data(skip=2), 1)["final_step"] == 3


@pytest.mark.parametrize("offload_d2h", [True, False])
def test_offloaded_snapshot_is_not_moved_by_the_next_update(tmp_path,
                                                            offload_d2h):
    """The step loop updates params in place right after save() returns;
    a background save (the snapshot offloaded, or copied in line and
    written by the worker) still holds the values save() was handed."""
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                         offload_d2h=offload_d2h))
    gate = threading.Event()
    write = ckpt._write

    def slow_write(step, leaves):
        gate.wait(10)
        write(step, leaves)

    ckpt._write = slow_write
    state = {"w": torch.zeros(16)}
    assert ckpt.save(1, state, force=True)
    state["w"].add_(1.0)                       # the next step's update
    gate.set()
    assert ckpt.wait(deadline_s=10)
    assert torch.equal(ckpt.restore({"w": torch.ones(16)})["w"],
                       torch.zeros(16))


def test_background_failure_is_raised_at_the_next_call(tmp_path):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))

    def broken(step, leaves):
        raise OSError("disk full")

    ckpt._write = broken
    ckpt.save(1, {"w": torch.zeros(2)}, force=True)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        ckpt.wait()
    ckpt.wait()                                 # raised once


def test_wait_deadline_journals_a_timeout(tmp_path, monkeypatch):
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    gate = threading.Event()
    write = ckpt._write

    def wedged(step, leaves):
        gate.wait(10)
        write(step, leaves)

    ckpt._write = wedged
    emitted = []
    monkeypatch.setattr(events, "emit",
                        lambda name, **kw: emitted.append((name, kw)))
    ckpt.save(1, {"w": torch.zeros(2)}, force=True)
    assert ckpt.wait(deadline_s=0.2) is False
    assert [n for n, _ in emitted] == ["tik_checkpoint_wait_timeout"]
    gate.set()
    assert ckpt.close(deadline_s=10)
    assert ckpt.all_steps() == [1]


def test_save_and_restore_book_their_goodput_buckets(tmp_path):
    ledger = goodput.LEDGER
    before = (ledger.total(goodput.BUCKET_CHECKPOINT_SAVE),
              ledger.total(goodput.BUCKET_CHECKPOINT_RESTORE))
    ckpt = Checkpointer(CheckpointConfig(directory=str(tmp_path),
                                         async_save=False))
    state = {"w": torch.randn(256, 256), "layers": [torch.ones(3), 7]}
    ckpt.save(1, state, force=True)
    restored = ckpt.restore({"w": torch.zeros(256, 256),
                             "layers": [torch.zeros(3), 0]})
    _assert_trees_equal(restored, state)
    assert ledger.total(goodput.BUCKET_CHECKPOINT_SAVE) > before[0]
    assert ledger.total(goodput.BUCKET_CHECKPOINT_RESTORE) > before[1]


# ------------------------------------------------------ import and parity --

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference")


def _jax_trainer(directory, every=1):
    jtc = JTR.TrainerConfig(
        global_batch_size=4, seq_len=32, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**OPT), log_every=1,
        checkpoint_every=every, checkpoint_dir=str(directory),
        prefetch_depth=0)
    return JTR.Trainer(JTR.transformer_spec(JCFG), jtc, mesh=build_mesh(
        jtc.mesh, devices=jax.devices()[:1]))


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A JAX tiny run of 3 steps, checkpointed every step, and its
    checkpoints imported: (jax_dir, port_dir, the JAX run)."""
    root = tmp_path_factory.mktemp("imported")
    jtrainer = _jax_trainer(root / "jax")
    jtrainer.init_state(jax.random.PRNGKey(0))
    jtrainer.fit(JD.synthetic_lm_batches(4, 32, 256, seed=3), 3)
    jtrainer.checkpointer.wait()
    jtrainer.checkpointer.close()
    steps = import_jax_checkpoint.import_checkpoints(
        str(root / "jax"), str(root / "port"))
    return str(root / "jax"), str(root / "port"), jtrainer, steps


def test_import_writes_every_step_with_its_state(imported):
    jax_dir, port_dir, jtrainer, steps = imported
    assert steps == [1, 2, 3]
    ckpt = Checkpointer(CheckpointConfig(directory=port_dir))
    assert ckpt.all_steps() == [1, 2, 3]
    port = _trainer(port_dir, every=1000)
    assert port.maybe_resume() == 3
    want = jax.tree.map(np.asarray, jtrainer.state["params"])
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(port.params)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert port.opt_state["count"] == 3


def test_imported_run_resumes_to_the_jax_resumed_losses(imported):
    jax_dir, port_dir, _jtrainer, _steps = imported
    jresumed = _jax_trainer(jax_dir, every=1000)
    assert jresumed.maybe_resume() == 3
    jout = jresumed.fit(itertools.islice(
        JD.synthetic_lm_batches(4, 32, 256, seed=3), 3, None), 2)
    tresumed = _trainer(port_dir, every=1000)
    assert tresumed.maybe_resume() == 3
    tout = tresumed.fit(_data(skip=3), 2)
    assert [h["step"] for h in tout["history"]] == [4, 5]
    for j, t in zip(jout["history"], tout["history"]):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)


def test_opt_state_from_jax_keeps_dtypes_and_the_count():
    params = {"w": jnp.ones((2, 3)), "b": jnp.zeros(3)}
    for cfg in (JO.OptimizerConfig(moment_dtype="bfloat16"),
                JO.OptimizerConfig(grad_clip_norm=None)):
        opt = JO.make_optimizer(cfg)
        state = opt.init(params)
        _, state = opt.update(params, state, params)
        got = convert.opt_state_from_jax(jax.tree.map(np.asarray, state),
                                         "cpu")
        assert got["count"] == 1 and isinstance(got["count"], int)
        want_mu = torch.bfloat16 if cfg.moment_dtype else torch.float32
        assert got["mu"]["w"].dtype == want_mu
        assert got["nu"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        convert.opt_state_from_jax({"x": np.zeros(2)}, "cpu")


PROMPTS = ([5, 17, 101, 9], [42, 7, 19, 23, 88, 3])


def test_imported_checkpoint_serves_the_jax_tokens(imported):
    jax_dir, port_dir, _jtrainer, _steps = imported
    jb = JS.transformer_backend("tiny", checkpoint_dir=jax_dir,
                                dtype=jnp.float32)
    tb = TS.transformer_backend("tiny", checkpoint_dir=port_dir,
                                device="cpu", dtype=torch.float32)
    for prompt in PROMPTS:
        payload = {"tokens": [prompt], "max_new_tokens": 6}
        assert tb.endpoints["generate"](payload) \
            == jb.endpoints["generate"](payload)


def test_imported_checkpoint_serves_the_jax_engine_tokens(imported):
    """The engine on the imported weights answers the JAX engine's tokens,
    and so does a spec engine whose draft is restored from the same run
    (`spec_checkpoint_dir`: a self-draft on trained weights)."""
    jax_dir, port_dir, _jtrainer, _steps = imported
    kw = dict(slots=2, max_len=64, block_size=8)
    jb = JS.engine_backend("tiny", checkpoint_dir=jax_dir,
                           dtype=jnp.float32, **kw)
    tb = TS.engine_backend("tiny", checkpoint_dir=port_dir, device="cpu",
                           dtype=torch.float32, **kw)
    sb = TS.engine_backend("tiny", checkpoint_dir=port_dir, device="cpu",
                           dtype=torch.float32, spec_model="tiny",
                           spec_checkpoint_dir=port_dir, spec_k=3, **kw)
    try:
        _assert_trees_equal(sb.engine._draft_params, tb.params)
        for prompt in PROMPTS:
            payload = {"tokens": [prompt], "max_new_tokens": 6}
            want = jb.endpoints["generate"](payload)[0]["tokens"]
            assert tb.endpoints["generate"](payload)[0]["tokens"] == want
            assert sb.endpoints["generate"](payload)[0]["tokens"] == want
    finally:
        for b in (jb, tb, sb):
            b.engine.stop()


def test_imported_adapter_serves_the_jax_adapter_tokens(tmp_path):
    """An adapter the JAX Checkpointer saved ({"params": adapter}, as the
    LoRA trainer does), imported, and loaded by the port's
    checkpoint_loader gives the JAX adapter engine's tokens."""
    cfg = JT.config("tiny", dtype=jnp.float32)
    adapter = JL.random_lora_params(jax.random.PRNGKey(3), cfg,
                                    JL.LoRAConfig(rank=4))
    saver = JC.Checkpointer(JC.CheckpointConfig(
        directory=str(tmp_path / "jax" / "t0")))
    saver.save(0, {"params": adapter}, force=True)
    saver.wait()
    saver.close()
    import_jax_checkpoint.import_checkpoints(
        str(tmp_path / "jax" / "t0"), str(tmp_path / "port" / "t0"))
    kw = dict(slots=2, max_len=64, block_size=8, lora_rank=4)
    jb = JS.engine_backend("tiny", adapters_dir=str(tmp_path / "jax"),
                           dtype=jnp.float32, **kw)
    # the JAX backend's base weights: init_params from PRNGKey(0)
    base = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(0), cfg))
    tb = TS.engine_backend("tiny", adapters_dir=str(tmp_path / "port"),
                           device="cpu", dtype=torch.float32, params=base,
                           **kw)
    try:
        outs = {}
        for name, b in (("jax", jb), ("port", tb)):
            outs[name] = [b.endpoints["generate"](
                {"tokens": [p], "max_new_tokens": 6, "adapter": a}
            )[0]["tokens"] for p in PROMPTS for a in ("t0", None)]
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] != outs["port"][1]   # the adapter acts
    finally:
        jb.engine.stop()
        tb.engine.stop()


def test_back_to_back_offloaded_saves_commit_every_step(tmp_path):
    """A save right after another (the worker still writing) waits for it
    and commits in order, under a short switch interval; every step reads
    back the values it was handed."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ckpt = Checkpointer(CheckpointConfig(
            directory=str(tmp_path), max_to_keep=0, save_interval_steps=1))
        w = torch.zeros(64)
        for step in range(1, 21):
            w.add_(1.0)
            assert ckpt.save(step, {"w": w, "n": step})
        assert ckpt.close(deadline_s=30)
    finally:
        sys.setswitchinterval(old)
    assert ckpt.all_steps() == list(range(1, 21))
    for step in (1, 7, 20):
        got = ckpt.restore({"w": torch.zeros(64), "n": 0}, step=step)
        assert got["n"] == step
        assert torch.equal(got["w"], torch.full((64,), float(step)))
