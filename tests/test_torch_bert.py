"""Port parity: the port's BERT (cloudtik_tpu_torch/models/bert.py) against
the JAX package's, on `tiny` in f32 with one intra-op thread.

Both sides run the same weights (the JAX `init_params`, through
`convert.params_from_jax`) on the same numpy batches.  Tolerances: f32 on
both sides with sums in another order, so the hidden states (LayerNorm
outputs, |h| <= ~4) agree within 2e-5 absolute, the losses within 1e-5
relative, the argmax-based accuracies exactly, and every gradient leaf
within 1e-4 relative L2 (a leaf's gradient sums B*S terms through 2
layers).  A 5-step Trainer history agrees within 1e-4 relative, as the
transformer trainer's does (Adam's 1/sqrt(nu) amplifies tiny gradient
differences in its first steps).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import bert as JB
from cloudtik_tpu.parallel.mesh import MeshConfig, build_mesh
from cloudtik_tpu.train import data as JD
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import bert as TB
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR
from cloudtik_tpu_torch.tree import tree_leaves

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

B, S = 2, 64
HIDDEN_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _cfgs(**kw):
    return (JB.config("tiny", dtype=jnp.float32, **kw),
            TB.config("tiny", dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = JB.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(layout="gathered", type_ids=False):
    """numpy batch: the gathered MLM layout, or labels [B, S] with -100
    off the masked positions; optional type_ids."""
    b = next(JD.synthetic_mlm_batches(B, S, 256, seed=1))
    if layout == "labels":
        labels = np.full((B, S), -100, np.int32)
        np.put_along_axis(labels, b["mlm_positions"], b["mlm_labels"],
                          axis=1)
        b = {"tokens": b["tokens"], "labels": labels}
    if type_ids:
        b["type_ids"] = (np.arange(S)[None] >= S // 2).repeat(B, 0) \
            .astype(np.int32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_presets_match_jax():
    assert set(TB.PRESETS) == set(JB.PRESETS)
    for name in JB.PRESETS:
        j, t = JB.PRESETS[name], TB.PRESETS[name]
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.num_params() == j.num_params()
        assert t.flops_per_token() == j.flops_per_token()
    # 1.97 GFLOP a token at S=512 (the bert phase's MFU)
    assert round(TB.config("bert_large").flops_per_token() / 1e9, 2) == 1.97


@pytest.mark.parametrize("num_labels", [0, 3])
def test_init_params_match_jax_shapes_and_spread(num_labels):
    jcfg, tcfg = _cfgs(num_labels=num_labels)
    jp = JB.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TB.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    tshapes = {k: ({n: (tuple(x.shape), "float32") for n, x in v.items()}
                   if isinstance(v, dict)
                   else (tuple(v.shape), "float32")) for k, v in tp.items()}
    assert tshapes == jshapes
    w = tp["layers"]["w_ff1"]
    # N(0, 0.02) truncated at 2 sigma: |w| <= 0.04, std 0.02 * 0.880
    assert float(w.abs().max()) <= 0.04
    assert abs(float(w.std()) / (0.02 * 0.8796) - 1) < 0.05
    assert float(tp["mlm_bias"].abs().max()) == 0.0


@pytest.mark.parametrize("type_ids", [False, True], ids=["no_types",
                                                          "types"])
def test_encode_matches_jax(type_ids):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch(type_ids=type_ids)
    jh = JB.encode(jp, jnp.asarray(batch["tokens"]), jcfg,
                   jnp.asarray(batch["type_ids"]) if type_ids else None)
    with torch.no_grad():
        th = TB.encode(tp, torch.as_tensor(batch["tokens"]).long(), tcfg,
                       torch.as_tensor(batch["type_ids"]).long()
                       if type_ids else None)
    assert th.shape == (B, S, tcfg.d_model) and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=HIDDEN_ATOL)


def test_mlm_logits_do_not_add_mlm_bias():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    h = torch.randn(2, 3, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    want = TB.mlm_logits(tp, h, tcfg)
    tp["mlm_bias"] = torch.full_like(tp["mlm_bias"], 5.0)
    assert torch.equal(TB.mlm_logits(tp, h, tcfg), want)


@pytest.mark.parametrize("layout", ["gathered", "labels"])
def test_loss_and_accuracy_match_jax(layout):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch(layout)
    jloss, jm = JB.loss_fn(jp, _jb(batch), jcfg)
    with torch.no_grad():
        tloss, tm = TB.loss_fn(tp, _tb(batch), tcfg)
    assert set(tm) == set(jm) == {"loss", "mlm_accuracy"}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tm["mlm_accuracy"]) == float(jm["mlm_accuracy"])


def test_mlm_accuracy_counts_valid_positions_only():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    batch = _batch("gathered")
    # labels equal to the argmax where valid, a pad of -100 elsewhere
    with torch.no_grad():
        h = TB.encode(tp, torch.as_tensor(batch["tokens"]).long(), tcfg)
        pos = torch.as_tensor(batch["mlm_positions"]).long()
        logits = TB.mlm_logits(tp, torch.gather(
            h, 1, pos[..., None].expand(-1, -1, h.shape[-1])), tcfg)
    labels = logits.argmax(-1).numpy().astype(np.int32)
    labels[:, ::2] = -100
    batch["mlm_labels"] = labels
    _, jm = JB.loss_fn(jp, _jb(batch), jcfg)
    with torch.no_grad():
        _, tm = TB.loss_fn(tp, _tb(batch), tcfg)
    assert float(tm["mlm_accuracy"]) == float(jm["mlm_accuracy"]) == 1.0


def test_classify_loss_matches_jax():
    jcfg, tcfg = _cfgs(num_labels=3)
    jp, tp = _params(jcfg)
    batch = {"tokens": _batch()["tokens"],
             "labels": np.asarray([0, 2], np.int32)}
    jloss, jm = JB.classify_loss_fn(jp, _jb(batch), jcfg)
    with torch.no_grad():
        tloss, tm = TB.classify_loss_fn(tp, _tb(batch), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])


def _grads(jcfg, tcfg, objective, layout, attention_impl=None):
    jp, tp = _params(jcfg)
    if objective == "mlm":
        batch, jloss, tloss = _batch(layout, type_ids=True), JB.loss_fn, \
            TB.loss_fn
    else:
        batch = {"tokens": _batch()["tokens"],
                 "labels": np.asarray([1, 2], np.int32)}
        jloss, tloss = JB.classify_loss_fn, TB.classify_loss_fn
    jg = jax.grad(lambda p: jloss(p, _jb(batch), jcfg)[0])(jp)
    if attention_impl:
        tcfg = dataclasses.replace(tcfg, attention_impl=attention_impl)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = tloss(tp, _tb(batch), tcfg)
    tg = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    return jg, tg


@pytest.mark.parametrize("objective,layout,impl", [
    ("mlm", "gathered", None), ("mlm", "labels", None),
    ("classify", None, None), ("mlm", "gathered", "flash")],
    ids=["mlm_gathered", "mlm_labels", "classify", "mlm_flash_plain"])
def test_every_gradient_matches_jax(objective, layout, impl):
    """"flash" on the CPU runs the kernels' plain versions
    (ops/flash_attention.py), the path the card takes through B1-B3."""
    jcfg, tcfg = _cfgs(num_labels=3 if objective == "classify" else 0)
    jg, tg = _grads(jcfg, tcfg, objective, layout, impl)
    jleaves = jax.tree.leaves(jg)
    # jax.tree sorts dict keys; the port keeps insertion order
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    tnamed = dict(zip(_paths(_params(jcfg)[1]), tg))
    assert len(tnamed) == len(jleaves)
    # bk's gradient is zero in exact arithmetic (a key bias adds the same
    # score to every key of a query), so both sides hold rounding noise
    # there: each leaf within GRAD_REL_L2 of its own norm plus 1e-7 of the
    # largest leaf's
    scale = max(np.linalg.norm(np.asarray(w)) for w in jleaves)
    for name, want in zip(names, jleaves):
        got = tnamed[name].numpy()
        want = np.asarray(want)
        if not np.any(want):
            # mlm_bias: never read, a zero gradient on both sides
            assert not np.any(got), name
            continue
        err = np.linalg.norm(got.astype(np.float64) - want)
        assert err <= GRAD_REL_L2 * np.linalg.norm(want) + 1e-7 * scale, \
            (name, _rel_l2(got, want))


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out += _paths(v, key) if isinstance(v, dict) else [key]
    return out


def test_remat_matches_no_remat_exactly():
    _, tcfg = _cfgs()
    jcfg = _cfgs()[0]
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        _, tp = _params(jcfg)
        leaves = tree_leaves(tp)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = TB.loss_fn(tp, _tb(_batch()), cfg)
        grads[remat] = (loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))
    assert torch.equal(grads[True][0], grads[False][0])
    for a, b in zip(grads[True][1], grads[False][1]):
        assert torch.equal(a, b)


def test_synthetic_mlm_batches_equal_jax():
    for kw in ({}, {"max_predictions": 5, "mask_prob": 0.3, "seed": 4}):
        jit = JD.synthetic_mlm_batches(3, 40, 256, **kw)
        tit = TD.synthetic_mlm_batches(3, 40, 256, **kw)
        for _ in range(3):
            jb, tb = next(jit), next(tit)
            assert list(tb) == list(jb) == ["tokens", "mlm_positions",
                                            "mlm_labels"]
            for key in jb:
                assert tb[key].dtype == jb[key].dtype == np.int32
                assert tb[key].tobytes() == jb[key].tobytes()


def test_five_step_trainer_history_matches_jax():
    jcfg, tcfg = _cfgs()
    opt = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)
    jtc = JTR.TrainerConfig(
        global_batch_size=8, seq_len=S, mesh=MeshConfig(data=1, fsdp=1),
        optimizer=JO.OptimizerConfig(**opt), log_every=1, prefetch_depth=0)
    jtrainer = JTR.Trainer(JTR.bert_spec(jcfg), jtc, mesh=build_mesh(
        jtc.mesh, devices=jax.devices()[:1]))
    jtrainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jtrainer.state["params"])
    ttrainer = TTR.Trainer(TTR.bert_spec(tcfg), TTR.TrainerConfig(
        global_batch_size=8, seq_len=S, optimizer=TO.OptimizerConfig(**opt),
        log_every=1), device="cpu")
    ttrainer.init_state(params=convert.params_from_jax(params, "cpu"))
    jout = jtrainer.fit(JD.synthetic_mlm_batches(8, S, 256, seed=3), 5)
    tout = ttrainer.fit(TD.synthetic_mlm_batches(8, S, 256, seed=3), 5)
    assert len(tout["history"]) == len(jout["history"]) == 5
    for j, t in zip(jout["history"], tout["history"]):
        assert t["step"] == j["step"]
        for key in ("loss", "mlm_accuracy", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                       err_msg=key)
    losses = [h["loss"] for h in tout["history"]]
    assert all(np.isfinite(losses))


def test_classify_trainer_runs_and_learns_on_a_repeated_batch():
    _, tcfg = _cfgs(num_labels=3)
    trainer = TTR.Trainer(TTR.bert_spec(tcfg, "classify"), TTR.TrainerConfig(
        global_batch_size=4, seq_len=32, log_every=1,
        optimizer=TO.OptimizerConfig(learning_rate=1e-3, warmup_steps=0)),
        device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        2, 256, (4, 32)).astype(np.int32),
        "labels": np.asarray([0, 1, 2, 1], np.int32)}
    out = trainer.fit(itertools.repeat(batch), 6)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert set(out["history"][0]) >= {"loss", "accuracy", "grad_norm"}
