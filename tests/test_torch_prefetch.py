"""The port's async input pipeline (cloudtik_tpu_torch/train/prefetch.py)
on the CPU: the Prefetcher lifecycle contracts of tests/test_prefetch.py
(order, exhaustion, errors at next(), close, max_items, instruments),
device residency, the trainer integration (prefetch gives the sync path's
history and consumes exactly num_steps batches) and the latency drill at
the `train.prefetch.next` seam.  The card's path (pinned memory, a side
stream, an event) runs in chip_smoke.py's checkpoint phase; here a card
that is absent raises instead of falling back to synchronous copies."""

from __future__ import annotations

import itertools
import time

import numpy as np
import pytest
import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
from cloudtik_tpu_torch.telemetry import goodput
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.train.prefetch import (
    Prefetcher, is_device_resident, put_device_batch)

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.enable()
    telemetry.reset()


def _batches(n):
    for i in range(n):
        yield {"i": np.full((2,), i, np.int32)}


def _first(batch):
    return int(batch["i"][0])


class TestPrefetcherLifecycle:
    @pytest.mark.parametrize("threads", [1, 3])
    @pytest.mark.parametrize("device", [None, "cpu"])
    def test_preserves_iterator_order(self, threads, device):
        with Prefetcher(_batches(40), device=device, depth=2,
                        threads=threads) as pf:
            seen = [_first(b) for b in pf]
        assert seen == list(range(40))

    def test_exhaustion_drains_queue_then_stops(self):
        pf = Prefetcher(_batches(5), depth=4)
        time.sleep(0.3)            # let producers fill the queue fully
        assert [_first(b) for b in pf] == [0, 1, 2, 3, 4]
        with pytest.raises(StopIteration):
            next(pf)
        assert not any(t.is_alive() for t in pf._threads)

    def test_producer_exception_surfaces_at_next(self):
        def broken():
            yield {"i": np.zeros((2,), np.int32)}
            yield {"i": np.ones((2,), np.int32)}
            raise ValueError("loader died")

        pf = Prefetcher(broken(), depth=2)
        assert _first(next(pf)) == 0
        assert _first(next(pf)) == 1
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="loader died"):
            next(pf)
        assert time.monotonic() - t0 < 5.0, "error must not hang"
        with pytest.raises(StopIteration):
            next(pf)               # errored stream stays finished

    def test_transfer_exception_surfaces_at_next(self):
        bad = iter([{"x": np.zeros((8, 4), np.float32)},
                    {"x": np.array([object()])}])
        pf = Prefetcher(bad, device=CPU, depth=2)
        assert isinstance(next(pf)["x"], torch.Tensor)
        with pytest.raises(TypeError):
            next(pf)

    def test_close_joins_threads(self):
        def slow():
            for i in itertools.count():
                time.sleep(0.15)
                yield {"i": np.full((2,), i, np.int32)}

        pf = Prefetcher(slow(), depth=1, threads=2)
        next(pf)
        t0 = time.monotonic()
        assert pf.close() is True
        assert time.monotonic() - t0 < 5.0
        assert not any(t.is_alive() for t in pf._threads)
        with pytest.raises(RuntimeError):
            next(pf)

    def test_close_is_idempotent_and_reentrant(self):
        pf = Prefetcher(_batches(3))
        assert pf.close() is True
        assert pf.close() is True

    def test_max_items_caps_source_consumption(self):
        pulled = []

        def counting():
            for i in itertools.count():
                pulled.append(i)
                yield {"i": np.full((2,), i, np.int32)}

        with Prefetcher(counting(), depth=4, max_items=3) as pf:
            assert [_first(b) for b in pf] == [0, 1, 2]
        assert len(pulled) == 3, "read-ahead must not eat extra batches"

    def test_bad_args_rejected(self):
        with pytest.raises(ValueError):
            Prefetcher(_batches(1), depth=0)
        with pytest.raises(ValueError):
            Prefetcher(_batches(1), threads=0)

    def test_telemetry_instruments_fed(self):
        before = ti.TRAIN_PREFETCH_BATCHES.value()
        with Prefetcher(_batches(6), depth=2) as pf:
            list(pf)
        assert ti.TRAIN_PREFETCH_BATCHES.value() == before + 6
        assert ti.TRAIN_PREFETCH_CONSUMER_WAIT.snapshot()["count"] == 6
        assert ti.TRAIN_PREFETCH_PRODUCER_STALL.snapshot()["count"] >= 6

    def test_an_absent_card_raises_instead_of_copying_synchronously(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises((RuntimeError, AssertionError)):
            Prefetcher(_batches(2), device="cuda")


class TestDeviceResidency:
    def test_prefetcher_hands_off_device_resident_batches(self):
        with Prefetcher(_batches(4), device=CPU, depth=2) as pf:
            out = list(pf)
        assert len(out) == 4
        for batch in out:
            assert is_device_resident(batch, CPU)
            assert batch["i"].dtype == torch.int32

    def test_put_device_batch_skips_resident_batches(self):
        host = {"x": np.zeros((8, 4), np.float32)}
        resident = put_device_batch(host, CPU)
        assert is_device_resident(resident, CPU)
        assert put_device_batch(resident, CPU)["x"] is resident["x"]
        assert not is_device_resident(host, CPU)
        assert put_device_batch(host, None) is host


def _trainer(prefetch_depth, log_every=1):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (
        Trainer, TrainerConfig, transformer_spec)
    cfg = T.config("tiny", dtype=torch.float32)
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=4, seq_len=16, log_every=log_every,
        prefetch_depth=prefetch_depth,
        optimizer=OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                  total_steps=50)), device="cpu")
    trainer.init_state(torch.Generator().manual_seed(7))
    return cfg, trainer


class TestTrainerIntegration:
    def test_prefetch_matches_sync_and_exact_consumption(self):
        """The same history with and without the pipeline, and two fits
        sharing ONE iterator see the stream the sync loop would."""
        from cloudtik_tpu_torch.train.data import synthetic_lm_batches
        history = {}
        for depth in (0, 2):
            cfg, trainer = _trainer(depth)
            data = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=3)
            out = trainer.fit(data, 3)["history"] \
                + trainer.fit(data, 2)["history"]
            history[depth] = [{k: v for k, v in h.items()
                               if k != "tokens_per_sec"} for h in out]
        assert history[2] == history[0]

    def test_windows_and_exhaustion(self):
        from cloudtik_tpu_torch.train.data import synthetic_lm_batches
        cfg, trainer = _trainer(2, log_every=50)
        gen = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=4)
        out = trainer.fit(gen, 3)
        assert len(out["history"]) == 1
        assert out["history"][0]["step"] == 3
        assert out["history"][0]["tokens_per_sec"] > 0
        trainer.config.log_every = 2
        out = trainer.fit(gen, 5)
        assert [h["step"] for h in out["history"]] == [4, 6, 8]
        # resident batches are taken as they are
        resident = [put_device_batch({k: np.asarray(v, np.int64)
                                      for k, v in b.items()}, CPU)
                    for b in itertools.islice(gen, 2)]
        assert trainer.fit(iter(resident), 2)["final_step"] == 10
        with pytest.raises(StopIteration):
            trainer.fit(iter(itertools.islice(gen, 2)), 5)


@pytest.mark.chaos
def test_latency_at_prefetch_seam_books_data_wait():
    from cloudtik_tpu_torch.train.data import synthetic_lm_batches
    cfg, trainer = _trainer(2)
    data = synthetic_lm_batches(4, 16, cfg.vocab_size, seed=8)
    plan = FaultPlan([FaultPoint("train.prefetch.next", "latency", times=3,
                                 args={"seconds": 0.06})], seed=1)
    wait_before = goodput.LEDGER.total(goodput.BUCKET_DATA_WAIT)
    with seams.armed(plan):
        trainer.fit(data, 4)
    fired = [e for e in plan.summary()["trace"]
             if e["seam"] == "train.prefetch.next"]
    assert len(fired) == 3
    booked = goodput.LEDGER.total(goodput.BUCKET_DATA_WAIT) - wait_before
    assert booked >= 3 * 0.06 * 0.9, booked
