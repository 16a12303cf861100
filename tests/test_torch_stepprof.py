"""The port's step profiler (cloudtik_tpu_torch/telemetry/stepprof.py)
on the CPU: the contracts of tests/test_goodput.py's StepProfiler,
replay, straggler and capture-request cases, the compile seam (a kernel
build is booked to the `compile` bucket, with the build stubbed so that
nothing is compiled), a `torch.profiler` capture window, and the
restart-replay drill through the port's Trainer and checkpoints."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest
import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.ops import _kernels
from cloudtik_tpu_torch.telemetry import events, goodput, stepprof
from cloudtik_tpu_torch.telemetry import instruments as ti

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.enable()
    telemetry.reset()


def test_segments_attribute_exactly():
    ledger = goodput.GoodputLedger(job="prof")
    ledger.start_job(at=0.0)
    profiler = stepprof.StepProfiler(ledger, replay_until=2)
    for step in (1, 2, 3, 4):
        profiler.dispatch_begin()
        profiler.record_step(step, 0.25, 0.05, 1.0)
    profiler.record_sync(4, 0.5)
    assert ledger.total(goodput.BUCKET_RESTART_REPLAY) == \
        pytest.approx(2 * 1.30)
    assert ledger.total(goodput.BUCKET_DATA_WAIT) == pytest.approx(0.5)
    assert ledger.total(goodput.BUCKET_HOST_TRANSFER) == pytest.approx(0.1)
    assert ledger.total(goodput.BUCKET_STEP_COMPUTE) == pytest.approx(2.5)
    assert ti.TRAIN_DATA_WAIT_SECONDS.snapshot()["count"] == 4


def test_compile_seen_during_dispatch_is_subtracted():
    ledger = goodput.GoodputLedger(job="prof2")
    ledger.start_job(at=0.0)
    profiler = stepprof.StepProfiler(ledger)
    profiler.dispatch_begin()
    ledger.attribute(goodput.BUCKET_COMPILE, 3.0)
    profiler.record_step(1, 0.0, 0.0, 5.0)
    assert ledger.total(goodput.BUCKET_COMPILE) == pytest.approx(3.0)
    assert ledger.total(goodput.BUCKET_STEP_COMPUTE) == pytest.approx(2.0)


def test_kernel_build_is_booked_to_the_compile_bucket(monkeypatch,
                                                      tmp_path):
    """The port's compile is the nvcc build of its kernels at first use:
    `build_all` (stubbed: no nvcc here) tells the listener its wall, which
    lands in the compile bucket, one compile counted per source."""
    class Done:
        returncode = 0

    def fake_finish(name, proc, tmp, target):
        time.sleep(0.05)
        return "ptxas info"

    monkeypatch.setattr(_kernels, "_target",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "_start",
                        lambda name, nvcc, target: (Done(), target))
    monkeypatch.setattr(_kernels, "_finish", fake_finish)
    ledger = goodput.GoodputLedger(job="prof3")
    assert stepprof.install_compile_tracking(ledger) is True
    compiles = ti.TRAIN_COMPILES.value()
    assert _kernels.build_all(["nms", "roi_align"]) == {
        "nms": "ptxas info", "roi_align": "ptxas info"}
    assert ledger.total(goodput.BUCKET_COMPILE) >= 0.1
    assert ti.TRAIN_COMPILES.value() == compiles + 2
    # idempotent: a second install never double-registers
    assert stepprof.install_compile_tracking(ledger) is True
    assert _kernels.BUILD_LISTENERS.count(stepprof._on_build) == 1
    # nothing left to build books nothing
    monkeypatch.setattr(_kernels, "_target",
                        lambda name: tmp_path)   # exists
    booked = ledger.total(goodput.BUCKET_COMPILE)
    assert _kernels.build_all(["nms"]) == {}
    assert ledger.total(goodput.BUCKET_COMPILE) == booked


def test_detects_lagging_host():
    progress = {"w-1": {"step": 100, "time": 1000.0},
                "w-2": {"step": 100, "time": 1001.5},
                "w-3": {"step": 80, "time": 950.0}}
    report = stepprof.detect_stragglers(progress, now=1002.0,
                                        lag_threshold_s=10.0)
    assert report["max_step"] == 100
    assert report["lags"] == {"w-1": 0.0, "w-2": 1.5, "w-3": 52.0}
    assert report["stragglers"] == ["w-3"]
    assert ti.TRAIN_STRAGGLER_LAG.value() == pytest.approx(52.0)
    assert stepprof.detect_stragglers({})["max_step"] is None


def test_progress_callback_publishes_the_step():
    class Client:
        rows = {}

        def table_put(self, table, key, value):
            self.rows[(table, key)] = value

    class Trainer:
        step = 7

    client = Client()
    stepprof.progress_callback(client, "w-1")(Trainer(), {})
    row = client.rows[(stepprof.TABLE_TRAIN_PROGRESS, "w-1")]
    assert row["step"] == 7 and row["node_id"] == "w-1"


def test_capture_request_roundtrip(tmp_path):
    path = str(tmp_path / "req.json")
    out = str(tmp_path / "prof")
    assert stepprof.request_capture(3, out, path) == path
    request = stepprof.take_request(path)
    assert request["steps"] == 3 and request["output_dir"] == out
    assert not os.path.exists(path)
    assert stepprof.take_request(path) is None


def test_profile_capture_writes_a_trace_after_n_steps(tmp_path):
    path = str(tmp_path / "req.json")
    out = tmp_path / "prof"
    capture = stepprof.ProfileCapture(path)
    assert capture.poll() is False            # no request: idle
    stepprof.request_capture(2, str(out), path)
    assert capture.poll() is True
    for _ in range(2):
        torch.ones(8).add_(1)
        capture.step_done(torch.zeros(1))
    assert capture.active is False
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]


def _trainer(ckpt_dir):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    cfg = T.config("tiny", dtype=torch.float32)
    return cfg, Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=4, seq_len=16, log_every=2, checkpoint_every=2,
        checkpoint_dir=str(ckpt_dir),
        optimizer=OptimizerConfig(learning_rate=1e-3)), device="cpu")


@pytest.mark.chaos
def test_replay_accounting_end_to_end(tmp_path, monkeypatch):
    """Preemption + resume from an older checkpoint: the re-run steps book
    as restart_replay, the checkpoint buckets fill, everything sums to
    wall within 1%, and the resume is journaled with its horizon."""
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    monkeypatch.setenv("TIK_EVENTS_PATH", str(tmp_path / "events.jsonl"))
    events.install()
    ckpt = tmp_path / "ckpt"
    try:
        cfg, trainer = _trainer(ckpt)
        data = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=0)
        trainer.fit(data, 4)                  # commits at 2 and 4
        trainer.checkpointer.close()
        assert trainer.checkpointer.all_steps() == [2, 4]
        shutil.rmtree(str(ckpt / "4"))        # the newest is lost
        _cfg, resumed = _trainer(ckpt)
        assert resumed.maybe_resume() == 2
        assert resumed._replay_until == 4
        resumed.fit(data, 4)                  # 3, 4 replay; 5, 6 new
        resumed.checkpointer.close()
        snap = goodput.LEDGER.snapshot()
        buckets = snap["buckets"]
        for bucket in (goodput.BUCKET_RESTART_REPLAY,
                       goodput.BUCKET_CHECKPOINT_SAVE,
                       goodput.BUCKET_CHECKPOINT_RESTORE,
                       goodput.BUCKET_DATA_WAIT,
                       goodput.BUCKET_STEP_COMPUTE):
            assert buckets[bucket] > 0, bucket
        assert abs(snap["attributed_s"] - snap["wall_s"]) <= \
            0.01 * snap["wall_s"]
        resumes = [e for e in events.read_events()
                   if e["name"] == "tik_train_resume"]
        assert resumes and resumes[-1]["replay_until"] == 4
    finally:
        events.uninstall()


def test_snapshot_env_written_by_fit(tmp_path, monkeypatch):
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    snap_path = str(tmp_path / "goodput.json")
    monkeypatch.setenv(goodput.SNAPSHOT_ENV, snap_path)
    cfg, trainer = _trainer(tmp_path / "unused")
    trainer.checkpointer = None
    trainer.fit(synthetic_lm_batches(4, 16, cfg.vocab_size, seed=1), 2)
    with open(snap_path) as f:
        snap = json.load(f)
    assert snap["buckets"]["step_compute"] > 0
    assert snap["wall_s"] > 0
