"""The port's sharded Trainer over gloo against the JAX Trainer on the
8-device CPU mesh and against the port on one rank.

Every case starts from the JAX `init_params` (through `convert.py`) and
reads the same global batches, with labels masked differently in each
rank's rows (the loss must be Σnll / Σvalid over the global batch, never a
mean of per-rank means).  All ranks run in one spawn
(`tools/torch_parallel_cases.py`, no JAX in the workers; each case its own
gloo group with a 60 s timeout; the spawn's deadline kills every rank).

Ceilings, f32 on one intra-op thread: the first step's loss within 1e-5
relative of JAX's (forward only; later losses follow Adam's updates, so
1e-4, as tests/test_torch_trainer.py holds the one-card history), the
pre-clip global norm within 1e-4, every parameter after the steps within
1e-4 relative L2; against the port on one rank every number within 1e-5.
The planted faults must miss those ceilings.
"""

import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import lora as JL
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.parallel.mesh import MeshConfig as JMeshConfig
from cloudtik_tpu.parallel.mesh import build_mesh as jbuild_mesh
from cloudtik_tpu.parallel.sharding import make_rules as jmake_rules
from cloudtik_tpu.train import optim as JO
from cloudtik_tpu.train import trainer as JTR
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.parallel.launch import run_ranks
from cloudtik_tpu_torch.parallel.mesh import MeshConfig
from cloudtik_tpu_torch.train import data as TD
from cloudtik_tpu_torch.train import optim as TO
from cloudtik_tpu_torch.train import trainer as TTR

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

REL = 1e-5
LATER_REL = 1e-4
B, S, STEPS = 4, 32, 2
OPT = dict(learning_rate=1e-2, warmup_steps=1, schedule="constant")
SPAWN_DEADLINE_S = 150

# name: (model, overrides, mesh, world, rules, fault)
CASES = {
    "data2": ("tiny", {}, dict(data=2, fsdp=1), 2, {}, None),
    # mlp -> fsdp on d_ff=99: w_down's first fsdp claim (99) does not
    # divide, so it stays replicated while the rest shard on embed
    "fsdp2_undivided": ("tiny", {"d_ff": 99}, dict(fsdp=2), 2,
                        {"mlp": "fsdp"}, None),
    "data2_fsdp2": ("tiny_moe", {}, dict(data=2, fsdp=2), 4, {}, None),
    "expert2": ("tiny_moe", {}, dict(expert=2, fsdp=1), 2, {}, None),
    "seq2": ("tiny", {}, dict(seq=2, fsdp=1), 2, {}, None),
    "seq4": ("tiny", {}, dict(seq=4, fsdp=1), 4, {}, None),
    "moe_data2": ("tiny_moe", {}, dict(data=2, fsdp=1), 2, {}, None),
    "fault_aux_per_rank": ("tiny_moe", {}, dict(data=2, fsdp=1), 2, {},
                           "aux_per_rank"),
    "fault_expert_bwd_twice": ("tiny_moe", {}, dict(expert=2, fsdp=1), 2,
                               {}, "expert_bwd_twice"),
}


def _batches():
    it = TD.synthetic_lm_batches(B, S, 256, seed=3)
    out = [next(it) for _ in range(STEPS)]
    # rows 0-1 go to the first data shard, 2-3 to the second: mask them
    # unevenly so the per-shard counts of valid labels differ
    out[0]["labels"][0, :11] = -100
    out[1]["labels"][3, 5:20] = -100
    return out


def _jax_params(model, overrides):
    cfg = JT.config(model, dtype=jax.numpy.float32, **overrides)
    return cfg, JT.init_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case in one spawn of 4 ranks; rank 0's result per case."""
    out = tmp_path_factory.mktemp("sharded")
    batches = _batches()
    cases = []
    for name, (model, over, mesh, world, rules, fault) in CASES.items():
        _, jp = _jax_params(model, over)
        cases.append(dict(
            kind="train", name=name, world=world, model=model,
            overrides=over, mesh=mesh, rules=rules, fault=fault,
            params=convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu"),
            batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT))
    # LoRA adapters trained under fsdp, and a checkpoint written by rank 0
    # from gathered leaves, restored and re-sharded
    jcfg, jp = _jax_params("tiny", {})
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    lp = JL.random_lora_params(jax.random.PRNGKey(1), jcfg,
                               JL.LoRAConfig(rank=4))
    cases.append(dict(
        kind="train", name="lora_fsdp2", world=2, model="tiny", mesh=dict(
            fsdp=2), params=tp, lora_rank=4,
        lora_params=convert.params_from_jax(jax.tree.map(np.asarray, lp),
                                            "cpu"),
        batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT))
    cases.append(dict(
        kind="train", name="checkpoint_fsdp2", world=2, model="tiny_moe",
        mesh=dict(fsdp=2), params=convert.params_from_jax(
            jax.tree.map(np.asarray, _jax_params("tiny_moe", {})[1]),
            "cpu"),
        batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT,
        checkpoint_dir=str(out / "ckpt"), checkpoint_every=STEPS))
    torch.save({"cases": cases}, out / "cases.pt")
    # the JAX runs compile while the ranks train
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
        for model, over, mesh, world, rules, _ in CASES.values():
            _jax_run(model, over, mesh, world, rules)
    finally:
        ranks.join()
    if failure:
        raise failure[0]
    return {c["name"]: torch.load(out / f"{c['name']}.rank0.pt",
                                  weights_only=False) for c in cases}


_JAX_RUNS = {}


def _jax_run(model, over, mesh, world, rules, lora=None):
    """The JAX Trainer's history and final params (one run per
    configuration: a planted fault reuses its clean case's)."""
    key = repr((model, over, mesh, world, rules, lora is not None))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_fit(model, over, mesh, world, rules, lora)
    return _JAX_RUNS[key]


def _jax_fit(model, over, mesh, world, rules, lora):
    jcfg, jp = _jax_params(model, over)
    spec = JTR.transformer_spec(jcfg)
    if lora is not None:
        spec = JL.lora_spec(jp, jcfg, JL.LoRAConfig(rank=4))
    mesh_cfg = JMeshConfig(**{"fsdp": 1, **mesh})
    jtc = JTR.TrainerConfig(
        global_batch_size=B, seq_len=S, mesh=mesh_cfg,
        optimizer=JO.OptimizerConfig(**OPT), log_every=1, prefetch_depth=0,
        rules=jmake_rules(**rules))
    trainer = JTR.Trainer(spec, jtc, mesh=jbuild_mesh(
        mesh_cfg, devices=jax.devices()[:world]))
    trainer.init_state(jax.random.PRNGKey(0))
    if lora is not None:
        trainer.state["params"] = jax.device_put(
            jax.tree.map(np.array, lora), trainer.param_shardings)
    out = trainer.fit(iter(_batches()), STEPS)
    return out["history"], jax.tree.map(np.asarray,
                                        trainer.state["params"])


def _one_rank(model, over, lora=None):
    cfg = TT.config(model, dtype=torch.float32, **over)
    _, jp = _jax_params(model, over)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    spec = TTR.transformer_spec(cfg)
    if lora is not None:
        spec = TL.lora_spec(tp, cfg, TL.LoRAConfig(rank=4))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, lora), "cpu")
    trainer = TTR.Trainer(spec, TTR.TrainerConfig(
        global_batch_size=B, seq_len=S, optimizer=TO.OptimizerConfig(**OPT),
        log_every=1, prefetch_depth=0), device="cpu")
    trainer.init_state(params=tp)
    out = trainer.fit(iter(_batches()), STEPS)
    return out["history"], trainer.params


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _gaps(got, jhist, jparams):
    """The largest gaps to a reference run: first loss, later losses, the
    grad norms, the parameters."""
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    params = {p: _rel(g.numpy(), w) for p, g, w in zip(
        paths, jax.tree.leaves(got["params"]), jax.tree.leaves(jparams))}
    hist = got["history"]
    return {
        "first_loss": _rel(hist[0]["loss"], jhist[0]["loss"]),
        "later_loss": max(_rel(h["loss"], j["loss"])
                          for h, j in zip(hist[1:], jhist[1:])),
        "grad_norm": max(_rel(h["grad_norm"], j["grad_norm"])
                         for h, j in zip(hist, jhist)),
        "params": max(params.values()),
        "n_tokens": [h["n_tokens"] for h in hist] == [
            float(j["n_tokens"]) for j in jhist],
    }


def _within(g, first=REL, later=LATER_REL):
    return (g["first_loss"] <= first and g["later_loss"] <= later
            and g["grad_norm"] <= later and g["params"] <= later
            and g["n_tokens"])


@pytest.mark.parametrize("name", [n for n in CASES if not
                                  n.startswith("fault")])
def test_sharded_steps_match_jax_and_one_rank(spawned, name):
    model, over, mesh, world, rules, _ = CASES[name]
    got = spawned[name]
    jhist, jparams = _jax_run(model, over, mesh, world, rules)
    gaps = _gaps(got, jhist, jparams)
    assert _within(gaps), gaps
    if "moe" in model:
        for k in ("moe_aux_loss", "moe_z_loss", "loss_with_aux"):
            assert _rel(got["history"][0][k], jhist[0][k]) <= REL, k
    # the port on one rank: everything within 1e-5
    hist, params = _one_rank(model, over)
    for h, o in zip(got["history"], hist):
        for k in ("loss", "grad_norm", "accuracy"):
            assert _rel(h[k], o[k]) <= REL, k
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert _rel(a.numpy(), b.detach().numpy()) <= REL


def test_placements_shard_what_the_rules_say(spawned):
    """The shards each rank holds: fsdp halves the embed dimension where
    it divides, expert halves the expert dimension, data and seq hold
    everything whole."""
    local = spawned["data2_fsdp2"]["local"]
    assert local["embed"] == (256, 32)
    assert local["layers"]["w_gate"] == (2, 4, 32, 128)
    assert local["layers"]["w_router"] == (2, 32, 4)
    local = spawned["fsdp2_undivided"]["local"]
    assert local["layers"]["w_gate"] == (2, 32, 99)
    assert local["layers"]["w_down"] == (2, 99, 64)     # replicated
    assert spawned["expert2"]["local"]["layers"]["w_up"] == (2, 2, 64, 128)
    assert spawned["seq4"]["local"]["layers"]["wq"] == (2, 64, 4, 16)


def test_lora_adapters_train_under_fsdp(spawned):
    jcfg, _ = _jax_params("tiny", {})
    lora = JL.random_lora_params(jax.random.PRNGKey(1), jcfg,
                                 JL.LoRAConfig(rank=4))
    got = spawned["lora_fsdp2"]
    jhist, jparams = _jax_run("tiny", {}, dict(fsdp=2), 2, {}, lora=lora)
    assert _within(_gaps(got, jhist, jparams))
    hist, params = _one_rank("tiny", {}, lora=lora)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert _rel(a.numpy(), b.detach().numpy()) <= REL


def test_checkpoint_is_gathered_and_restores_resharded(spawned):
    got = spawned["checkpoint_fsdp2"]
    assert got["restored_step"] == STEPS
    # jax.tree orders both by key (the trees were built in other orders)
    for a, b in zip(jax.tree.leaves(got["restored"]),
                    jax.tree.leaves(got["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["fault_aux_per_rank",
                                  "fault_expert_bwd_twice"])
def test_planted_faults_are_caught(spawned, name):
    model, over, mesh, world, rules, _ = CASES[name]
    jhist, jparams = _jax_run(model, over, mesh, world, rules)
    assert not _within(_gaps(spawned[name], jhist, jparams))


def test_mesh_wider_than_the_group_is_refused():
    """No parallel path quietly runs on one rank."""
    cfg = TT.config("tiny", dtype=torch.float32)
    with pytest.raises(ValueError, match="devices"):
        TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
            mesh=MeshConfig(data=2, fsdp=1)), device="cpu")


@pytest.mark.parametrize("axis", ["tensor", "pipe"])
def test_tensor_and_pipe_name_the_next_slice(axis):
    cfg = TT.config("tiny", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="slice 12"):
        TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
            mesh=MeshConfig(**{axis: 2})), device="cpu")
