"""Port parity: LoRA training (`lora_loss_fn`, `lora_spec` in
cloudtik_tpu_torch/models/lora.py) against the JAX package's, on `tiny` in
f32 with the reference attention and one intra-op thread.

The same base and adapters (the JAX `init_params` / `init_lora_params` /
`random_lora_params`, through `convert.params_from_jax`) and the same
numpy batches on both sides.  Tolerances: the loss within 1e-5 relative
and each adapter gradient within 1e-4 relative L2 (f32, sums in another
order); a 5-step Trainer history within 1e-4 relative, as the transformer
trainer's.  The base is held bit for bit.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import lora as JL
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel.mesh import MeshConfig, build_mesh
from cloudtik_tpu.train import data as JD
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import adapters as TA
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR
from cloudtik_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jax.numpy.float32, attention_impl="reference")
TCFG = TT.config("tiny", dtype=torch.float32, attention_impl="reference")
LCFG = dict(rank=4)
# the reference's own LoRA trainer test: warmup off, lr 3e-3
OPT = dict(learning_rate=3e-3, warmup_steps=0, total_steps=1000)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _base():
    jbase = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jbase, convert.params_from_jax(_np(jbase), "cpu")


def _batch():
    return next(JD.synthetic_lm_batches(2, 32, JCFG.vocab_size, seed=1))


@pytest.mark.parametrize("adapters", ["init", "random"])
def test_loss_and_adapter_grads_match_jax(adapters):
    jbase, tbase = _base()
    jl, tl = JL.LoRAConfig(**LCFG), TL.LoRAConfig(**LCFG)
    make = JL.init_lora_params if adapters == "init" \
        else JL.random_lora_params
    ja = make(jax.random.PRNGKey(1), JCFG, jl)
    ta = tree_map(lambda x: x.requires_grad_(True),
                  convert.params_from_jax(_np(ja), "cpu"))
    batch = _batch()
    (jloss, _), jg = jax.value_and_grad(
        lambda a: JL.lora_loss_fn(a, jbase, {k: jax.numpy.asarray(v)
                                             for k, v in batch.items()},
                                  JCFG, jl), has_aux=True)(ja)
    tloss, tm = TL.lora_loss_fn(ta, tbase, {k: torch.as_tensor(v).long()
                                            for k, v in batch.items()},
                                TCFG, tl)
    tg = tree_unflatten(ta, list(torch.autograd.grad(tloss,
                                                    tree_leaves(ta))))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(tm) == {"loss", "n_tokens", "accuracy"}
    for t in sorted(ja):
        for k in ("a", "b"):
            got = tg[t][k].numpy()
            want = np.asarray(jg[t][k])
            if adapters == "init" and k == "a":
                # b starts at zero: a's first gradient is exactly zero
                assert not np.any(want) and not np.any(got)
                continue
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (t, k, rel)


def _jax_lora_trainer(jbase):
    jtc = JTR.TrainerConfig(
        global_batch_size=8, seq_len=32, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**OPT), log_every=1, prefetch_depth=0)
    return JTR.Trainer(JL.lora_spec(jbase, JCFG, JL.LoRAConfig(**LCFG)),
                       jtc, mesh=build_mesh(jtc.mesh,
                                            devices=jax.devices()[:1]))


def _port_lora_trainer(tbase, **kw):
    return TTR.Trainer(TL.lora_spec(tbase, TCFG, TL.LoRAConfig(**LCFG)),
                       TTR.TrainerConfig(
                           global_batch_size=8, seq_len=32, log_every=1,
                           optimizer=TO.OptimizerConfig(**OPT), **kw),
                       device="cpu")


def test_five_step_history_matches_jax_and_the_base_is_untouched():
    jbase, tbase = _base()
    before = tree_map(torch.clone, tbase)
    jtrainer = _jax_lora_trainer(jbase)
    jtrainer.init_state(jax.random.PRNGKey(1))
    ttrainer = _port_lora_trainer(tbase)
    ttrainer.init_state(params=convert.params_from_jax(
        _np(jtrainer.state["params"]), "cpu"))
    # one fixed batch, as the reference's test: adapter learning shows as
    # a descent
    batch = next(JD.synthetic_lm_batches(8, 32, JCFG.vocab_size))
    jout = jtrainer.fit(itertools.repeat(batch), 5)
    tout = ttrainer.fit(itertools.repeat(batch), 5)
    for j, t in zip(jout["history"], tout["history"]):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    losses = [h["loss"] for h in tout["history"]]
    assert losses[-1] < losses[0]
    for a, b in zip(tree_leaves(tbase), tree_leaves(before)):
        assert torch.equal(a, b) and not a.requires_grad
    # the adapters trained: every leaf moved (b away from zero too)
    start = convert.params_from_jax(_np(JL.init_lora_params(
        jax.random.PRNGKey(1), JCFG, JL.LoRAConfig(**LCFG))), "cpu")
    for a, b in zip(tree_leaves(ttrainer.params), tree_leaves(start)):
        assert not torch.equal(a.detach(), b)


def test_trainer_state_holds_the_adapters_only():
    _, tbase = _base()
    trainer = _port_lora_trainer(tbase)
    trainer.init_state(torch.Generator().manual_seed(1))
    shapes = {(t, k): tuple(v.shape) for t, pair in trainer.params.items()
              for k, v in pair.items()}
    L, d, r = TCFG.n_layers, TCFG.d_model, LCFG["rank"]
    assert shapes == {
        ("wq", "a"): (L, d, r), ("wq", "b"): (L, r, TCFG.n_heads, 16),
        ("wv", "a"): (L, d, r), ("wv", "b"): (L, r, TCFG.n_kv_heads, 16)}
    n_adapter = sum(x.numel() for x in tree_leaves(trainer.state["params"]))
    n_base = sum(x.numel() for x in tree_leaves(tbase))
    assert n_adapter < n_base * 0.05
    assert set(trainer.opt_state) == {"count", "mu", "nu"}
    assert tree_leaves(trainer.opt_state["mu"])[0].shape == (L, d, r)


def test_flops_per_token_is_four_sixths():
    _, tbase = _base()
    spec = TL.lora_spec(tbase, TCFG, TL.LoRAConfig(**LCFG))
    jspec = JL.lora_spec(_base()[0], JCFG, JL.LoRAConfig(**LCFG))
    assert spec.flops_per_token == TCFG.flops_per_token() * 4.0 / 6.0
    assert spec.flops_per_token == jspec.flops_per_token


def test_a_saved_adapter_is_what_the_server_loads(tmp_path):
    """A LoRA trainer's checkpoint holds the adapters and their optimizer
    state; `checkpoint_loader` (tik-serve --adapters-dir) reads back the
    adapters bit for bit, and the resumed trainer continues."""
    _, tbase = _base()
    trainer = _port_lora_trainer(
        tbase, checkpoint_every=2,
        checkpoint_dir=str(tmp_path / "adapters" / "t0"))
    trainer.init_state(torch.Generator().manual_seed(1))
    trainer.fit(TD.synthetic_lm_batches(8, 32, 256, seed=2), 2)
    trainer.checkpointer.wait()
    load = TA.checkpoint_loader(str(tmp_path / "adapters"), TCFG,
                                TL.LoRAConfig(**LCFG))
    got = load("t0")
    for a, b in zip(tree_leaves(got), tree_leaves(trainer.params)):
        assert torch.equal(a, b.detach())
    resumed = _port_lora_trainer(
        tbase, checkpoint_every=1000,
        checkpoint_dir=str(tmp_path / "adapters" / "t0"))
    assert resumed.maybe_resume() == 2
    assert resumed.opt_state["count"] == 2
    assert resumed.fit(TD.synthetic_lm_batches(8, 32, 256, seed=2),
                       1)["final_step"] == 3
