"""Port parity: the port's Trainer and data generator against the JAX
package's, on `tiny` in f32 with the reference attention.

Both trainers start from the same weights (the JAX `init_params`, through
`convert.params_from_jax`) and read the same `synthetic_lm_batches`; a
5-step history (loss, n_tokens, accuracy, grad_norm) agrees to 1e-4
relative: f32 on both sides, sums in another order, and Adam's 1/sqrt(nu)
amplifies tiny gradient differences in its first steps.
"""

import dataclasses

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
