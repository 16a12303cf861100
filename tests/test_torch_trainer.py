"""Port parity: the port's Trainer and data generator against the JAX
package's, on `tiny` in f32 with the reference attention.

Both trainers start from the same weights (the JAX `init_params`, through
`convert.params_from_jax`) and read the same `synthetic_lm_batches`; a
5-step history (loss, n_tokens, accuracy, grad_norm) agrees to 1e-4
relative: f32 on both sides, sums in another order, and Adam's 1/sqrt(nu)
amplifies tiny gradient differences in its first steps.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel.mesh import MeshConfig, build_mesh
from cloudtik_tpu.train import data as JD
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)


def test_synthetic_lm_batches_equal_jax():
    jit, tit = (m.synthetic_lm_batches(3, 17, 256, seed=5) for m in (JD, TD))
    for _ in range(4):
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for key in jb:
            assert tb[key].dtype == jb[key].dtype == np.int32
            np.testing.assert_array_equal(tb[key], jb[key])
        assert (tb["labels"][:, -1] == -100).all()


def _configs(accum):
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
    jtc = JTR.TrainerConfig(
        global_batch_size=4, seq_len=32, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**opt), log_every=1,
        grad_accum_steps=accum, prefetch_depth=0)
    ttc = TTR.TrainerConfig(
        global_batch_size=4, seq_len=32, optimizer=TO.OptimizerConfig(**opt),
        log_every=1, grad_accum_steps=accum)
    return jtc, ttc


@pytest.mark.parametrize("accum", [1, 2])
def test_five_step_history_matches_jax_trainer(accum):
    jcfg = JT.config("tiny", dtype=jax.numpy.float32,
                     attention_impl="reference")
    tcfg = TT.config("tiny", dtype=torch.float32, attention_impl="reference")
    jtc, ttc = _configs(accum)
    jtrainer = JTR.Trainer(JTR.transformer_spec(jcfg), jtc,
                           mesh=build_mesh(jtc.mesh,
                                           devices=jax.devices()[:1]))
    jtrainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtrainer.state["params"])
    ttrainer = TTR.Trainer(TTR.transformer_spec(tcfg), ttc, device="cpu")
    ttrainer.init_state(params=convert.params_from_jax(params, "cpu"))

    jout = jtrainer.fit(JD.synthetic_lm_batches(4, 32, 256, seed=3), 5)
    tout = ttrainer.fit(TD.synthetic_lm_batches(4, 32, 256, seed=3), 5)
    assert tout["final_step"] == jout["final_step"] == 5
    assert len(tout["history"]) == len(jout["history"]) == 5
    for j, t in zip(jout["history"], tout["history"]):
        assert set(t) == set(j) - {"mfu"}   # no MFU off a known card
        assert t["step"] == j["step"]
        assert t["n_tokens"] == j["n_tokens"]
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    final = convert.params_to_numpy(ttrainer.params)
    for a, b in zip(jax.tree.leaves(final),
                    jax.tree.leaves(jtrainer.state["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_loss_falls_on_a_repeated_batch():
    cfg = TT.config("tiny", dtype=torch.float32)
    tc = TTR.TrainerConfig(
        global_batch_size=2, seq_len=16, log_every=1,
        optimizer=TO.OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                                     total_steps=20))
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), tc, device="cpu")
    batch = next(TD.synthetic_lm_batches(2, 16, cfg.vocab_size, seed=0))
    out = trainer.fit(iter([batch] * 10), 10)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] - 0.5, losses
    assert all(np.isfinite(losses))


def test_accumulated_step_is_the_mean_of_micro_grads():
    """grad_accum_steps=2 over a batch of 4 equals one step over it (the
    loss is a per-token mean and both halves hold the same token count)."""
    cfg = TT.config("tiny", dtype=torch.float32)
    batch = next(TD.synthetic_lm_batches(4, 16, cfg.vocab_size, seed=1))
    norms = []
    for accum in (1, 2):
        tc = TTR.TrainerConfig(global_batch_size=4, seq_len=16, log_every=1,
                               grad_accum_steps=accum)
        trainer = TTR.Trainer(TTR.transformer_spec(cfg), tc, device="cpu")
        trainer.init_state(torch.Generator().manual_seed(0))
        norms.append(trainer.fit(iter([batch]), 1)["history"][0])
    np.testing.assert_allclose(norms[1]["grad_norm"], norms[0]["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(norms[1]["loss"], norms[0]["loss"], rtol=1e-5)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    want = float(JTR.optax_global_norm(jax.tree.map(jax.numpy.asarray,
                                                    tree)))
    got = float(TO.global_norm(convert.params_from_jax(tree, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_peak_flops_by_card_name(monkeypatch):
    assert TTR.device_peak_flops(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert TTR.device_peak_flops(torch.device("cuda")) == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 PCIe")
    assert TTR.device_peak_flops(torch.device("cuda")) == 756e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    assert TTR.device_peak_flops(torch.device("cuda")) is None


def test_config_defaults_match_jax():
    jtc, ttc = JTR.TrainerConfig(), TTR.TrainerConfig()
    for field in dataclasses.fields(TTR.TrainerConfig):
        if field.name != "optimizer":
            assert getattr(ttc, field.name) == getattr(jtc, field.name)
    assert vars(ttc.optimizer) == vars(jtc.optimizer)


def test_resnet_history_matches_jax_trainer():
    """A few `resnet_spec("tiny")` steps (one image a "token") on the same
    weights and batches: the same history as the JAX Trainer's."""
    from cloudtik_tpu.models import resnet as JR
    from cloudtik_tpu_torch.models import resnet as TR

    jcfg = JR.config("tiny", dtype=jax.numpy.float32)
    tcfg = TR.config("tiny", dtype=torch.float32)
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
    jtc = JTR.TrainerConfig(
        global_batch_size=4, seq_len=1, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**opt), log_every=1, prefetch_depth=0)
    ttc = TTR.TrainerConfig(global_batch_size=4, seq_len=1,
                            optimizer=TO.OptimizerConfig(**opt), log_every=1)
    jtrainer = JTR.Trainer(JTR.resnet_spec(jcfg), jtc,
                           mesh=build_mesh(jtc.mesh,
                                           devices=jax.devices()[:1]))
    jtrainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtrainer.state["params"])
    ttrainer = TTR.Trainer(TTR.resnet_spec(tcfg), ttc, device="cpu")
    ttrainer.init_state(params=convert.params_from_jax(params, "cpu"))

    jout = jtrainer.fit(JD.synthetic_image_batches(4, 32, 10, seed=3), 4)
    tout = ttrainer.fit(TD.synthetic_image_batches(4, 32, 10, seed=3), 4)
    assert len(tout["history"]) == len(jout["history"]) == 4
    for j, t in zip(jout["history"], tout["history"]):
        assert set(t) == set(j) - {"mfu"}
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    assert tout["history"][0]["tokens_per_sec"] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_float_batch_keys_reach_the_loss_unconverted(depth):
    """Only integer arrays become int64: f32 images (and a bool mask) reach
    `loss_fn` as they are, through the synchronous path and the
    prefetcher."""
    seen = []

    def loss_fn(params, batch):
        seen.append({k: v.dtype for k, v in batch.items()})
        loss = (params["w"] * batch["images"].mean()) ** 2
        return loss, {"loss": loss.detach()}

    spec = TTR.ModelSpec(
        init=lambda gen, device: {"w": torch.ones((), device=device)},
        loss_fn=loss_fn)
    trainer = TTR.Trainer(spec, TTR.TrainerConfig(
        global_batch_size=2, seq_len=1, log_every=1, prefetch_depth=depth),
        device="cpu")
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((2, 4, 4, 3)).astype(np.float32),
             "labels": np.array([1, 2], np.int32),
             "valid": np.array([True, False])}
    trainer.fit(iter([batch] * 2), 2)
    assert seen == [{"images": torch.float32, "labels": torch.int64,
                     "valid": torch.bool}] * 2


def test_as_long_casts_integer_tensors_only():
    out = TTR._as_long({"a": torch.tensor([1, 2], dtype=torch.int32),
                        "b": torch.tensor([0.5]),
                        "c": torch.tensor([True]),
                        "d": np.array([0.25], np.float32),
                        "e": np.array([7], np.uint8)})
    assert out["a"].dtype == torch.int64 and out["b"].dtype == torch.float32
    assert out["c"].dtype == torch.bool and out["d"].dtype == np.float32
    assert out["e"].dtype == np.int64


def test_fit_profile_dir_writes_a_chrome_trace(tmp_path):
    import json

    cfg = TT.config("tiny", dtype=torch.float32)
    tc = TTR.TrainerConfig(global_batch_size=2, seq_len=16, log_every=1)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), tc, device="cpu")
    out = trainer.fit(TD.synthetic_lm_batches(2, 16, cfg.vocab_size), 2,
                      profile_dir=str(tmp_path / "prof"))
    assert out["final_step"] == 2
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train.grads", "train.optimizer"} <= names
    # a second fit without it leaves no profiler running
    trainer.fit(TD.synthetic_lm_batches(2, 16, cfg.vocab_size), 1)
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_fit_profile_dir_leaves_an_on_demand_request_pending(tmp_path,
                                                            monkeypatch):
    from cloudtik_tpu_torch.telemetry import stepprof

    req = str(tmp_path / "req.json")
    monkeypatch.setenv(stepprof.REQUEST_ENV, req)
    cfg = TT.config("tiny", dtype=torch.float32)
    tc = TTR.TrainerConfig(global_batch_size=2, seq_len=16, log_every=1)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), tc, device="cpu")
    stepprof.request_capture(1, str(tmp_path / "asked"), req)
    trainer.fit(TD.synthetic_lm_batches(2, 16, cfg.vocab_size), 2,
                profile_dir=str(tmp_path / "prof"))
    # the whole-call capture ran; the request waits for the next fit
    assert (tmp_path / "prof" / "trace.json").exists()
    assert os.path.exists(req)
    assert not (tmp_path / "asked" / "trace.json").exists()
    trainer.fit(TD.synthetic_lm_batches(2, 16, cfg.vocab_size), 2)
    assert (tmp_path / "asked" / "trace.json").exists()
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_fit_profile_dir_raises_when_the_profiler_cannot_start(tmp_path,
                                                              monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    cfg = TT.config("tiny", dtype=torch.float32)
    tc = TTR.TrainerConfig(global_batch_size=2, seq_len=16, log_every=1)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), tc, device="cpu")
    with pytest.raises(RuntimeError, match="did not start"):
        trainer.fit(TD.synthetic_lm_batches(2, 16, cfg.vocab_size), 1,
                    profile_dir=str(tmp_path / "prof"))


def _zoo_case(family):
    """(JAX spec, port spec, seq_len, batches) of one model-zoo family at
    `tiny` in f32; the batches are the generators' (equal in both
    packages) with link prediction's edges added."""
    from cloudtik_tpu.models import diffusion as JU
    from cloudtik_tpu.models import dlrm as JDL
    from cloudtik_tpu.models import graphsage as JG
    from cloudtik_tpu.models import rnnt as JN
    from cloudtik_tpu_torch.models import diffusion as TU
    from cloudtik_tpu_torch.models import dlrm as TDL
    from cloudtik_tpu_torch.models import graphsage as TGS
    from cloudtik_tpu_torch.models import rnnt as TN
    from cloudtik_tpu_torch.recipes.graphsage_nodes import with_edges

    f32 = {"dtype": jax.numpy.float32}
    t32 = {"dtype": torch.float32}
    if family == "diffusion":
        j, t = JU.config("tiny", **f32), TU.config("tiny", **t32)
        return (JTR.diffusion_spec(j), TTR.diffusion_spec(t), 1,
                TD.synthetic_diffusion_batches(4, j.image_size,
                                               j.in_channels, seed=3))
    if family == "dlrm":
        j, t = JDL.config("tiny", **f32), TDL.config("tiny", **t32)
        return (JTR.dlrm_spec(j), TTR.dlrm_spec(t), 1,
                TD.synthetic_dlrm_batches(16, j.num_dense, j.num_tables,
                                          j.rows_per_table, seed=3))
    if family == "rnnt":
        j, t = JN.config("tiny", **f32), TN.config("tiny", **t32)
        return (JTR.rnnt_spec(j), TTR.rnnt_spec(t), 12,
                TD.synthetic_speech_batches(3, 12, j.feature_dim,
                                            j.vocab_size, 4, seed=3))
    objective = family.split("/")[1]
    j, t = JG.config("tiny", **f32), TGS.config("tiny", **t32)
    data = TD.synthetic_graph_batches(32, j.in_dim, j.num_classes,
                                      j.max_degree, seed=3)
    if objective == "link_pred":
        data = with_edges(data, 32)
    return (JTR.graphsage_spec(j, objective),
            TTR.graphsage_spec(t, objective), 1, data)


@pytest.mark.parametrize("family", ["diffusion", "dlrm", "rnnt",
                                    "graphsage/supervised",
                                    "graphsage/link_pred"])
def test_model_zoo_history_matches_jax_trainer(family):
    """Three steps of each model-zoo spec on the same weights and batches:
    the JAX Trainer's losses within 1e-5, its grad norms within 1e-4."""
    jspec, tspec, seq, data = _zoo_case(family)
    batches = [next(data) for _ in range(3)]
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50)
    jtc = JTR.TrainerConfig(
        global_batch_size=4, seq_len=seq, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**opt), log_every=1, prefetch_depth=0)
    ttc = TTR.TrainerConfig(global_batch_size=4, seq_len=seq,
                            optimizer=TO.OptimizerConfig(**opt), log_every=1)
    jtrainer = JTR.Trainer(jspec, jtc, mesh=build_mesh(
        jtc.mesh, devices=jax.devices()[:1]))
    jtrainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtrainer.state["params"])
    ttrainer = TTR.Trainer(tspec, ttc, device="cpu")
    ttrainer.init_state(params=convert.params_from_jax(params, "cpu"))
    jout = jtrainer.fit(iter([dict(b) for b in batches]), 3)
    tout = ttrainer.fit(iter([dict(b) for b in batches]), 3)
    assert len(tout["history"]) == len(jout["history"]) == 3
    for j, t in zip(jout["history"], tout["history"]):
        assert set(t) == set(j) - {"mfu"}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-4)
    losses = [h["loss"] for h in tout["history"]]
    assert all(np.isfinite(losses))
