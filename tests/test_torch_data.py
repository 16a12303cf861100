"""Port parity: the port's data loaders against the JAX package's.

The image, detection, DLRM, diffusion, speech and graph generators yield
the JAX package's batches byte for byte from the same seed; `tokenized_file_batches` reads the same
batches from the same `.npy` (or `.bin`) and seed; `streaming_shard_batches`
reads what `export_token_shard` published, while it is published, and is
held to the cases of `tests/test_streaming_data.py` (a concurrent writer,
the `_SUCCESS` marker, the timeout, strided ownership, a consumer that
leaves early) and to the JAX reader's batches.  Every wait is bounded.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from cloudtik_tpu.train import data as JD
from cloudtik_tpu_torch.train import data as TD


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_synthetic_image_batches_equal_jax():
    its = [m.synthetic_image_batches(3, 16, 10, seed=5) for m in (TD, JD)]
    for _ in range(3):
        _assert_batches_equal(next(its[0]), next(its[1]))


@pytest.mark.parametrize("mask_size", [0, 14])
def test_synthetic_detection_batches_equal_jax(mask_size):
    its = [m.synthetic_detection_batches(3, 32, 5, 8, mask_size=mask_size,
                                         seed=2) for m in (TD, JD)]
    for _ in range(3):
        got, want = next(its[0]), next(its[1])
        _assert_batches_equal(got, want)
        assert ("gt_masks" in got) == bool(mask_size)


ZOO_GENERATORS = {
    "dlrm": ("synthetic_dlrm_batches", (5, 13, 26, 1000)),
    "diffusion": ("synthetic_diffusion_batches", (3, 8, 4)),
    "speech": ("synthetic_speech_batches", (4, 20, 8, 29, 6)),
    "graph": ("synthetic_graph_batches", (40, 8, 4, 5)),
}


@pytest.mark.parametrize("family", sorted(ZOO_GENERATORS))
def test_model_zoo_generators_equal_jax(family):
    name, args = ZOO_GENERATORS[family]
    its = [getattr(m, name)(*args, seed=7) for m in (TD, JD)]
    for _ in range(3):
        _assert_batches_equal(next(its[0]), next(its[1]))


def _corpus(tmp_path, n=2000, suffix=".npy", seed=0):
    tokens = np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)
    path = str(tmp_path / f"corpus{suffix}")
    if suffix == ".npy":
        np.save(path, tokens)
    else:
        tokens.tofile(path)
    return path, tokens


@pytest.mark.parametrize("suffix", [".npy", ".bin"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_tokenized_file_batches_equal_jax(tmp_path, suffix, shard):
    path, _ = _corpus(tmp_path, suffix=suffix)
    kw = dict(shard_index=shard[0], shard_count=shard[1], seed=3)
    its = [m.tokenized_file_batches(path, 4, 15, **kw) for m in (TD, JD)]
    # past one epoch, so the second permutation is held too
    for _ in range(12):
        _assert_batches_equal(next(its[0]), next(its[1]))


def test_tokenized_file_batches_one_epoch_without_repeat(tmp_path):
    path, tokens = _corpus(tmp_path)
    got = list(TD.tokenized_file_batches(path, 4, 15, repeat=False,
                                         shard_index=0, shard_count=1))
    want = list(JD.tokenized_file_batches(path, 4, 15, repeat=False,
                                          shard_index=0, shard_count=1))
    assert len(got) == len(want) == (len(tokens) // 16) // 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        np.testing.assert_array_equal(g["labels"][:, :-1],
                                      g["tokens"][:, 1:])


def test_the_shard_defaults_to_the_process_group(tmp_path):
    """No group: rank 0 of 1.  In a gloo group the rank and world size
    pick the strided shard (a group of one here: rank 0 of 1)."""
    import torch.distributed as dist

    assert TD.process_shard() == (0, 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        assert TD.process_shard() == (0, 1)
        path, _ = _corpus(tmp_path)
        got = next(TD.tokenized_file_batches(path, 2, 15, seed=1))
        want = next(JD.tokenized_file_batches(path, 2, 15, seed=1,
                                              shard_index=0, shard_count=1))
        _assert_batches_equal(got, want)
    finally:
        dist.destroy_process_group()
    assert TD.process_shard() == (0, 1)


# ------------------------------------------------------------ streaming --

def _write_shards(export_dir, shards, delay_s=0.0, publish_times=None):
    for i, tokens in enumerate(shards):
        if delay_s:
            time.sleep(delay_s)
        TD.export_token_shard(str(export_dir), i, tokens)
        if publish_times is not None:
            publish_times.append(time.monotonic())
    TD.finish_export(str(export_dir))


def test_export_publishes_what_the_jax_reader_reads(tmp_path):
    """Shards the port publishes read back through both readers as the
    same batches; the shard files are the JAX exporter's, byte for byte."""
    rng = np.random.default_rng(0)
    shards = [rng.integers(0, 100, (50,), dtype=np.int32) for _ in range(4)]
    _write_shards(tmp_path / "port", shards)
    for i, tokens in enumerate(shards):
        JD.export_token_shard(str(tmp_path / "jax"), i, tokens)
    JD.finish_export(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert TD.SHARD_DONE_MARKER in names and not any(
        n.startswith(".tmp") for n in names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    kw = dict(batch_size=2, seq_len=9, shard_index=0, shard_count=1,
              timeout_s=10)
    got = list(TD.streaming_shard_batches(str(tmp_path / "port"), **kw))
    want = list(JD.streaming_shard_batches(str(tmp_path / "port"), **kw))
    assert len(got) == len(want) == (4 * 50) // (10 * 2)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    stream = np.concatenate(shards)
    rows = stream[:len(got) * 2 * 10].reshape(-1, 10)
    np.testing.assert_array_equal(
        np.concatenate([b["tokens"] for b in got]), rows[:, :-1])
    np.testing.assert_array_equal(
        np.concatenate([b["labels"] for b in got]), rows[:, 1:])


def test_consumes_while_producing(tmp_path):
    """The first batch arrives before the last shard is published."""
    rng = np.random.default_rng(1)
    shards = [rng.integers(0, 100, (40,), dtype=np.int32) for _ in range(5)]
    publish_times = []
    writer = threading.Thread(target=_write_shards, daemon=True,
                              args=(tmp_path, shards, 0.3, publish_times))
    writer.start()
    it = TD.streaming_shard_batches(str(tmp_path), batch_size=2, seq_len=9,
                                    shard_index=0, shard_count=1,
                                    poll_s=0.05, timeout_s=30)
    first = next(it)
    t_first = time.monotonic()
    rest = list(it)
    writer.join(timeout=10)
    assert not writer.is_alive()
    assert t_first < publish_times[-1]
    assert 1 + len(rest) == (5 * 40) // (10 * 2)
    assert first["tokens"].shape == (2, 9)


def test_strided_ownership(tmp_path):
    shards = [np.full((20,), i, dtype=np.int32) for i in range(4)]
    _write_shards(tmp_path, shards)
    seen = set()
    for b in TD.streaming_shard_batches(str(tmp_path), batch_size=1,
                                        seq_len=9, shard_index=1,
                                        shard_count=2, timeout_s=10):
        seen.update(np.unique(b["tokens"]).tolist())
    assert seen == {1, 3}


def test_timeout_without_marker(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        list(TD.streaming_shard_batches(
            str(tmp_path), batch_size=1, seq_len=3, shard_index=0,
            shard_count=1, poll_s=0.05, timeout_s=0.3))
    assert time.monotonic() - t0 < 10


def test_atomic_publication_never_reads_partial(tmp_path):
    np.save(os.path.join(str(tmp_path), ".tmp-shard-00000.npy"),
            np.zeros((10,), np.int32))
    TD.finish_export(str(tmp_path))
    assert list(TD.streaming_shard_batches(
        str(tmp_path), batch_size=1, seq_len=3, shard_index=0,
        shard_count=1, timeout_s=5)) == []


def test_early_consumer_exit_stops_the_watcher(tmp_path):
    """A consumer that leaves after one batch, with readahead full and no
    marker yet, releases the watcher thread."""
    shards = [np.arange(40, dtype=np.int32) + 100 * i for i in range(6)]
    for i, tokens in enumerate(shards):
        TD.export_token_shard(str(tmp_path), i, tokens)
    before = {t.ident for t in threading.enumerate()
              if t.name == "tik-shard-watch"}
    it = TD.streaming_shard_batches(str(tmp_path), batch_size=2, seq_len=9,
                                    readahead=1, shard_index=0,
                                    shard_count=1, poll_s=0.05,
                                    timeout_s=30)
    first = next(it)
    np.testing.assert_array_equal(first["tokens"][0], np.arange(9))
    it.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == "tik-shard-watch" and t.ident not in before
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "tik-shard-watch" and t.ident not in before
                   for t in threading.enumerate())


def test_trainer_streams_from_an_export(tmp_path):
    """A port Trainer consumes the export directory while the writer is
    still producing, and finishes having seen all the data."""
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)

    torch.set_num_threads(1)
    cfg = T.config("tiny", dtype=torch.float32, attention_impl="reference")
    seq, bs = 16, 4
    rng = np.random.default_rng(2)
    shards = [rng.integers(0, cfg.vocab_size, (bs * (seq + 1) * 2,),
                           dtype=np.int32) for _ in range(3)]
    publish_times = []
    writer = threading.Thread(target=_write_shards, daemon=True,
                              args=(tmp_path, shards, 0.3, publish_times))
    trainer = Trainer(transformer_spec(cfg), TrainerConfig(
        global_batch_size=bs, seq_len=seq, log_every=100), device="cpu")
    data = TD.streaming_shard_batches(str(tmp_path), batch_size=bs,
                                      seq_len=seq, shard_index=0,
                                      shard_count=1, poll_s=0.05,
                                      timeout_s=60)
    writer.start()
    t0 = time.monotonic()
    out = trainer.fit(data, num_steps=6)     # exactly all the batches
    writer.join(timeout=10)
    assert out["final_step"] == 6
    assert t0 < publish_times[-1]
    assert list(data) == []                  # the marker ends the stream
