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
1e-4 relative L2; against the port on one rank every number within 1e-5
(MoE under pipe excepted: its router statistics are per microbatch, as in
the reference).  The planted faults must miss those ceilings.
"""

import importlib
import shutil
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
    # the tensor and pipe axes: tiny at t=4 splits its 4 heads but not
    # its 2 kv heads, so each rank reads kv head h // 2 of the whole wk/wv
    "tensor2": ("tiny", {}, dict(tensor=2, fsdp=1), 2, {}, None),
    "tensor4_undivided": ("tiny", {}, dict(tensor=4, fsdp=1), 4, {}, None),
    "tensor2_fsdp2": ("tiny", {}, dict(tensor=2, fsdp=2), 4, {}, None),
    "seq2_tensor2": ("tiny", {}, dict(seq=2, tensor=2, fsdp=1), 4, {},
                     None),
    "pipe2": ("tiny", {}, dict(pipe=2, fsdp=1), 2, {}, None),
    "pipe2_fsdp2": ("tiny", {}, dict(pipe=2, fsdp=2), 4, {}, None),
    "pipe4_1f1b": ("tiny", {"n_layers": 4, "pipeline_schedule": "1f1b",
                            "pipeline_microbatches": 8},
                   dict(pipe=4, fsdp=1), 4, {}, None),
    "moe_tensor2": ("tiny_moe", {}, dict(tensor=2, fsdp=1), 2, {}, None),
    "moe_pipe2": ("tiny_moe", {}, dict(pipe=2, fsdp=1), 2, {}, None),
    "moe_data2_tensor2": ("tiny_moe", {}, dict(data=2, tensor=2, fsdp=1),
                          4, {}, None),
    "data2_pipe2": ("tiny", {}, dict(data=2, pipe=2, fsdp=1), 4, {}, None),
    # the refusals slice 13 lifted: MoE routing whole rows over seq, a
    # dimension split over two mesh axes, Adafactor on split leaves (at
    # d_model 128 optax factors embed and the MLP; at 64 nothing does)
    "moe_seq2": ("tiny_moe", {}, dict(seq=2, fsdp=1), 2, {}, None),
    "embed_fsdp_tensor": ("tiny", {}, dict(fsdp=2, tensor=2), 4,
                          {"embed": ("fsdp", "tensor")}, None),
    "adafactor_fsdp2": ("tiny", {"d_model": 128, "d_ff": 256}, dict(fsdp=2),
                        2, {}, None),
    # accumulated steps, sequential and overlapped (ACCUM)
    "data2_accum2": ("tiny", {}, dict(data=2, fsdp=1), 2, {}, None),
    "data2_accum2_overlap": ("tiny", {}, dict(data=2, fsdp=1), 2, {}, None),
    "data2_fsdp2_accum2": ("tiny", {}, dict(data=2, fsdp=2), 4, {}, None),
    "data2_fsdp2_accum2_overlap": ("tiny", {}, dict(data=2, fsdp=2), 4, {},
                                   None),
    "fault_aux_per_rank": ("tiny_moe", {}, dict(data=2, fsdp=1), 2, {},
                           "aux_per_rank"),
    "fault_expert_bwd_twice": ("tiny_moe", {}, dict(expert=2, fsdp=1), 2,
                               {}, "expert_bwd_twice"),
    "fault_head_no_copy": ("tiny", {}, dict(tensor=2, fsdp=1), 2, {},
                           "head_no_copy"),
    "fault_wo_unreduced": ("tiny", {}, dict(tensor=2, fsdp=1), 2, {},
                           "wo_unreduced"),
    "fault_head_pipe_summed": ("tiny", {}, dict(pipe=2, fsdp=1), 2, {},
                               "head_pipe_summed"),
}
# a case's global batch where it is not B: 8 microbatches need 8 rows,
# and so do 2 microbatches over 4 batch ranks
BATCH = {"pipe4_1f1b": 8, "data2_fsdp2_accum2": 8,
         "data2_fsdp2_accum2_overlap": 8}
# a case's (grad_accum_steps, overlap_grad_sync) where it accumulates
ACCUM = {"data2_accum2": (2, False), "data2_accum2_overlap": (2, True),
         "data2_fsdp2_accum2": (2, False),
         "data2_fsdp2_accum2_overlap": (2, True)}
# a case's optimizer where it is not AdamW
OPTIMIZER = {"adafactor_fsdp2": "adafactor"}
# LoRA adapters on a mesh: name -> (mesh, world, rules); heads left whole
# over tensor by the rule table keeps the attention block, base and
# adapters alike, whole on each tensor rank while the vocab splits
LORA = {"lora_tensor2": (dict(tensor=2, fsdp=1), 2, {}),
        "lora_tensor2_heads_whole": (dict(tensor=2, fsdp=1), 2,
                                     {"heads": None}),
        "lora_pipe2": (dict(pipe=2, fsdp=1), 2, {})}
# the port on one rank is not the reference for these (per-microbatch
# router statistics)
NOT_ONE_RANK = {"moe_pipe2"}


def _batches(b=B):
    it = TD.synthetic_lm_batches(b, S, 256, seed=3)
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
        b = BATCH.get(name, B)
        accum, overlap = ACCUM.get(name, (1, None))
        cases.append(dict(
            kind="train", name=name, world=world, model=model,
            overrides=over, mesh=mesh, rules=rules, fault=fault,
            params=convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu"),
            batches=_batches(b), steps=STEPS, batch=b, seq=S,
            optimizer=_opt(name), accum=accum, overlap=overlap))
    # LoRA adapters trained under fsdp, tensor and pipe, and a checkpoint
    # written by rank 0 from gathered leaves, restored and re-sharded
    jcfg, jp = _jax_params("tiny", {})
    for name, (mesh, world, rules) in dict(
            lora_fsdp2=(dict(fsdp=2), 2, {}), **LORA).items():
        # every case its own tensors: a trainer steps the adapters in
        # place, and the spec holds views of the base
        cases.append(dict(
            kind="train", name=name, world=world, model="tiny", mesh=mesh,
            rules=rules, lora_rank=4, lora_params=convert.params_from_jax(
                jax.tree.map(np.asarray, _lora(jcfg)), "cpu"),
            params=convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu"),
            batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT))
    cases.append(dict(
        kind="train", name="checkpoint_fsdp2", world=2, model="tiny_moe",
        mesh=dict(fsdp=2), params=convert.params_from_jax(
            jax.tree.map(np.asarray, _jax_params("tiny_moe", {})[1]),
            "cpu"),
        batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT,
        checkpoint_dir=str(out / "ckpt"), checkpoint_every=STEPS))
    # per-rank shards at fsdp=2 x tensor=2, saved every step, beside a
    # whole-leaf copy of the final state; restored at data=2 and fsdp=4
    # here, on one rank by the tests
    cases.append(dict(
        kind="train", name="shards_fsdp2_tensor2", world=4, model="tiny",
        mesh=dict(fsdp=2, tensor=2), params=convert.params_from_jax(
            jax.tree.map(np.asarray, _jax_params("tiny", {})[1]), "cpu"),
        batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT,
        checkpoint_dir=str(out / "shards"), checkpoint_every=1,
        whole_dir=str(out / "whole")))
    for name, mesh, world in (("restore_data2", dict(data=2, fsdp=1), 2),
                              ("restore_fsdp4", dict(fsdp=4), 4)):
        cases.append(dict(kind="restore", name=name, world=world,
                          model="tiny", mesh=mesh, batch=B, seq=S,
                          optimizer=OPT, sharded=str(out / "shards"),
                          whole=str(out / "whole")))
    # a tensor x pipe checkpoint, restored on the same mesh here and on
    # one rank by the test
    cases.append(dict(
        kind="train", name="checkpoint_tensor2_pipe2", world=4,
        model="tiny", mesh=dict(tensor=2, pipe=2, fsdp=1),
        params=convert.params_from_jax(
            jax.tree.map(np.asarray, _jax_params("tiny", {})[1]), "cpu"),
        batches=batches, steps=STEPS, batch=B, seq=S, optimizer=OPT,
        checkpoint_dir=str(out / "ckpt_tp"), checkpoint_every=STEPS))
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
        for name, (model, over, mesh, world, rules, _) in CASES.items():
            _jax_run(model, over, mesh, world, rules,
                     b=BATCH.get(name, B), accum=ACCUM.get(name),
                     opt=OPTIMIZER.get(name, "adamw"))
        for mesh, world, rules in LORA.values():
            _jax_run("tiny", {}, mesh, world, rules, lora=_lora(jcfg))
    finally:
        ranks.join()
    if failure:
        raise failure[0]
    got = {c["name"]: torch.load(out / f"{c['name']}.rank0.pt",
                                 weights_only=False) for c in cases}
    got["checkpoint_tensor2_pipe2"]["dir"] = str(out / "ckpt_tp")
    got["shards_fsdp2_tensor2"].update(dir=str(out / "shards"),
                                       whole=str(out / "whole"))
    for name in ("restore_data2", "restore_fsdp4"):
        got[name] = [torch.load(out / f"{name}.rank{r}.pt",
                                weights_only=False)
                     for r in range(dict(restore_data2=2,
                                         restore_fsdp4=4)[name])]
    return got


def _opt(name):
    return dict(OPT, name=OPTIMIZER.get(name, "adamw"))


def _lora(jcfg):
    return JL.random_lora_params(jax.random.PRNGKey(1), jcfg,
                                 JL.LoRAConfig(rank=4))


_JAX_RUNS = {}


def _jax_run(model, over, mesh, world, rules, lora=None, b=B, accum=None,
             opt="adamw"):
    """The JAX Trainer's history and final params (one run per
    configuration: a planted fault reuses its clean case's).  `accum` is
    (grad_accum_steps, overlap_grad_sync) or None for one step a batch."""
    key = repr((model, over, mesh, world, rules, lora is not None, b,
                accum, opt))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_fit(model, over, mesh, world, rules, lora, b,
                                  accum or (1, None), opt)
    return _JAX_RUNS[key]


def _jax_fit(model, over, mesh, world, rules, lora, b, accum, opt):
    jcfg, jp = _jax_params(model, over)
    spec = JTR.transformer_spec(jcfg)
    if lora is not None:
        spec = JL.lora_spec(jp, jcfg, JL.LoRAConfig(rank=4))
    mesh_cfg = JMeshConfig(**{"fsdp": 1, **mesh})
    jtc = JTR.TrainerConfig(
        global_batch_size=b, seq_len=S, mesh=mesh_cfg,
        optimizer=JO.OptimizerConfig(**OPT, name=opt), log_every=1,
        prefetch_depth=0, rules=jmake_rules(**rules),
        grad_accum_steps=accum[0],
        overlap_grad_sync=accum[1])
    trainer = JTR.Trainer(spec, jtc, mesh=jbuild_mesh(
        mesh_cfg, devices=jax.devices()[:world]))
    trainer.init_state(jax.random.PRNGKey(0))
    if lora is not None:
        trainer.state["params"] = jax.device_put(
            jax.tree.map(np.array, lora), trainer.param_shardings)
    out = trainer.fit(iter(_batches(b)), STEPS)
    return out["history"], jax.tree.map(np.asarray,
                                        trainer.state["params"])


def _one_rank(model, over, lora=None, b=B, accum=1, opt="adamw"):
    cfg = TT.config(model, dtype=torch.float32, **over)
    _, jp = _jax_params(model, over)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    spec = TTR.transformer_spec(cfg)
    if lora is not None:
        spec = TL.lora_spec(tp, cfg, TL.LoRAConfig(rank=4))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, lora), "cpu")
    trainer = TTR.Trainer(spec, TTR.TrainerConfig(
        global_batch_size=b, seq_len=S,
        optimizer=TO.OptimizerConfig(**OPT, name=opt), log_every=1,
        prefetch_depth=0, grad_accum_steps=accum),
        device="cpu")
    trainer.init_state(params=tp)
    out = trainer.fit(iter(_batches(b)), STEPS)
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
    b = BATCH.get(name, B)
    accum = ACCUM.get(name)
    opt = OPTIMIZER.get(name, "adamw")
    jhist, jparams = _jax_run(model, over, mesh, world, rules, b=b,
                              accum=accum, opt=opt)
    gaps = _gaps(got, jhist, jparams)
    assert _within(gaps), gaps
    if accum is not None:
        assert got["overlap"] == accum[1]
    if "moe" in model:
        for k in ("moe_aux_loss", "moe_z_loss", "loss_with_aux"):
            assert _rel(got["history"][0][k], jhist[0][k]) <= REL, k
    # the gradients are summed over the token axes only
    assert not {"tensor", "pipe"} & set(got["grad_sum_axes"])
    if name in NOT_ONE_RANK:
        return
    # the port on one rank: everything within 1e-5
    hist, params = _one_rank(model, over, b=b,
                             accum=accum[0] if accum else 1, opt=opt)
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
    # tensor: heads, d_ff columns and vocab rows; kv heads only where
    # they divide; norms whole
    local = spawned["tensor2_fsdp2"]["local"]
    assert local["embed"] == (128, 32)
    assert local["lm_head"] == (32, 128)
    assert local["layers"]["wq"] == (2, 32, 2, 16)
    assert local["layers"]["wk"] == (2, 32, 1, 16)
    assert local["layers"]["wo"] == (2, 2, 16, 32)
    assert local["layers"]["w_down"] == (2, 64, 32)
    assert local["layers"]["ln_attn"] == (2, 64)
    local = spawned["tensor4_undivided"]["local"]
    assert local["layers"]["wq"] == (2, 64, 1, 16)
    assert local["layers"]["wk"] == (2, 64, 2, 16)      # replicated
    # pipe: the layer stack's leading dimension, with fsdp on embed
    local = spawned["pipe2_fsdp2"]["local"]
    assert local["layers"]["wq"] == (1, 32, 4, 16)
    assert local["embed"] == (256, 32)
    assert spawned["pipe4_1f1b"]["local"]["layers"]["w_up"] == (1, 64, 128)
    assert spawned["moe_tensor2"]["local"]["layers"]["w_gate"] == (
        2, 4, 64, 64)
    assert spawned["moe_tensor2"]["local"]["layers"]["w_router"] == (
        2, 64, 4)


def test_lora_adapters_train_under_fsdp(spawned):
    jcfg, _ = _jax_params("tiny", {})
    lora = _lora(jcfg)
    got = spawned["lora_fsdp2"]
    jhist, jparams = _jax_run("tiny", {}, dict(fsdp=2), 2, {}, lora=lora)
    assert _within(_gaps(got, jhist, jparams))
    hist, params = _one_rank("tiny", {}, lora=lora)
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert _rel(a.numpy(), b.detach().numpy()) <= REL


@pytest.mark.parametrize("name", sorted(LORA))
def test_lora_adapters_train_on_tensor_and_pipe(spawned, name):
    """The trainer hands the LoRA spec its mesh and rule table, and the
    spec slices the frozen base by them: the adapters train as the JAX
    Trainer's on the same mesh and rules, and as on one rank."""
    mesh, world, rules = LORA[name]
    jcfg, _ = _jax_params("tiny", {})
    lora = _lora(jcfg)
    got = spawned[name]
    jhist, jparams = _jax_run("tiny", {}, mesh, world, rules, lora=lora)
    gaps = _gaps(got, jhist, jparams)
    assert _within(gaps), gaps
    hist, params = _one_rank("tiny", {}, lora=lora)
    for h, o in zip(got["history"], hist):
        assert _rel(h["loss"], o["loss"]) <= REL
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(params)):
        assert _rel(a.numpy(), b.detach().numpy()) <= REL


@pytest.mark.parametrize("name", ["checkpoint_fsdp2",
                                  "checkpoint_tensor2_pipe2"])
def test_checkpoint_is_gathered_and_restores_resharded(spawned, name):
    got = spawned[name]
    assert got["restored_step"] == STEPS
    # jax.tree orders both by key (the trees were built in other orders)
    for a, b in zip(jax.tree.leaves(got["restored"]),
                    jax.tree.leaves(got["params"])):
        assert torch.equal(a, b)


def test_tensor_pipe_checkpoint_restores_on_one_rank(spawned):
    got = spawned["checkpoint_tensor2_pipe2"]
    cfg = TT.config("tiny", dtype=torch.float32)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
        global_batch_size=B, seq_len=S, checkpoint_dir=got["dir"],
        checkpoint_every=STEPS), device="cpu")
    assert trainer.restore_checkpoint() == STEPS
    for a, b in zip(jax.tree.leaves(trainer.params),
                    jax.tree.leaves(got["params"])):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("name", ["fault_aux_per_rank",
                                  "fault_expert_bwd_twice",
                                  "fault_head_no_copy",
                                  "fault_wo_unreduced",
                                  "fault_head_pipe_summed"])
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
    """Both axes are admitted (one process is refused only for want of
    ranks), and so is Adafactor on their split leaves: its state is
    placed from the whole leaves (at tiny's width nothing factors, so its
    v follows the parameters and the row and column slots are whole).
    Every model family's spec places on a mesh with the axis, reading
    none of its splits as a slice; a spec without logical axes is still
    refused there, with a message that names no slice of the port."""
    cfg = TT.config("tiny", dtype=torch.float32)
    with pytest.raises(ValueError, match="devices"):
        TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
            mesh=MeshConfig(**{axis: 2})), device="cpu")
    mesh = MeshConfig(fsdp=1, **{axis: 2}).axis_sizes(2)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(),
                          device="cpu", mesh=mesh)
    assert any(pl.dims for pl in jax.tree.leaves(
        trainer._placements, is_leaf=lambda x: isinstance(
            x, TTR.Placement)))
    ada = TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
        optimizer=TO.OptimizerConfig(name="adafactor")),
        device="cpu", mesh=mesh)
    placed = ada._opt_placements()

    def dims(tree):
        return jax.tree.map(lambda pl: pl.dims, tree, is_leaf=lambda x:
                            isinstance(x, TTR.Placement))

    assert dims(placed["v"]) == dims(ada._placements)
    assert not any(pl.dims for key in ("v_row", "v_col") for pl in
                   jax.tree.leaves(placed[key], is_leaf=lambda x: isinstance(
                       x, TTR.Placement)))
    for family in ("bert", "resnet", "ssd", "maskrcnn", "diffusion",
                   "dlrm", "rnnt", "graphsage"):
        fam = importlib.import_module(f"cloudtik_tpu_torch.models.{family}")
        spec = getattr(TTR, f"{family}_spec")(fam.config("tiny"))
        placed = jax.tree.leaves(TTR.Trainer(
            spec, TTR.TrainerConfig(), device="cpu", mesh=mesh)._placements,
            is_leaf=lambda x: isinstance(x, TTR.Placement))
        assert not any(pl.read_split for pl in placed), family
        assert spec.reads_split == {} and not spec.seq_split
    spec = TTR.ModelSpec(init=TTR.transformer_spec(cfg).init,
                         loss_fn=TTR.transformer_spec(cfg).loss_fn)
    with pytest.raises(ValueError, match="no logical_axes") as refused:
        TTR.Trainer(spec, TTR.TrainerConfig(), device="cpu", mesh=mesh)
    assert "slice" not in str(refused.value)


def test_two_axis_dimension_and_factored_adafactor_are_placed(spawned):
    """embed over ("fsdp", "tensor") cuts that dimension four ways, and
    the heads (whose `tensor` the embed took) stay whole; Adafactor's
    factored slots drop the averaged dimension and its split."""
    local = spawned["embed_fsdp_tensor"]["local"]
    assert local["layers"]["wq"] == (2, 16, 4, 16)
    assert local["layers"]["w_down"] == (2, 64, 32)
    assert local["embed"] == (128, 32)
    cfg = TT.config("tiny", dtype=torch.float32, d_model=128, d_ff=256)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
        optimizer=TO.OptimizerConfig(name="adafactor")), device="cpu",
        mesh=MeshConfig(fsdp=2).axis_sizes(2))
    placed = trainer._opt_placements()
    # w_gate [L, 128, 256]: rows are dim 1 (split over fsdp), columns 2
    assert trainer._placements["layers"]["w_gate"].dims == ((1, ("fsdp",)),)
    assert placed["v_row"]["layers"]["w_gate"].dims == ((1, ("fsdp",)),)
    assert placed["v_col"]["layers"]["w_gate"].dims == ()


def test_checkpoint_is_written_as_per_rank_shards(spawned):
    """Every rank writes a manifest of its own; only the ranks at index 0
    of the axes a leaf is replicated over hold its pieces."""
    root = Path(spawned["shards_fsdp2_tensor2"]["dir"])
    assert sorted(p.name for p in root.iterdir()) == ["1", "2"]
    (folder,) = [p for p in (root / "2").iterdir()]
    assert folder.name.startswith("shards-")
    names = sorted(p.name for p in folder.iterdir() if p.suffix == ".json")
    assert names == [f"{r}.json" for r in range(4)]


@pytest.mark.parametrize("name", ["restore_data2", "restore_fsdp4"])
def test_shards_restore_on_another_mesh_bit_for_bit(spawned, name):
    for res in spawned[name]:
        assert res["steps"] == (STEPS, STEPS) and res["leaves"] > 0
        assert res["equal"]


def _restore_one_rank(directory):
    cfg = TT.config("tiny", dtype=torch.float32)
    trainer = TTR.Trainer(TTR.transformer_spec(cfg), TTR.TrainerConfig(
        global_batch_size=B, seq_len=S, optimizer=TO.OptimizerConfig(**OPT),
        checkpoint_dir=str(directory), checkpoint_every=1000),
        device="cpu")
    return trainer


def test_shards_restore_on_one_rank_and_a_cut_shard_is_skipped(spawned,
                                                               tmp_path):
    got = spawned["shards_fsdp2_tensor2"]
    a, b = _restore_one_rank(got["dir"]), _restore_one_rank(got["whole"])
    assert a.restore_checkpoint() == b.restore_checkpoint() == STEPS
    for x, y in zip(jax.tree.leaves(a.state), jax.tree.leaves(b.state)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.detach(), y.detach())
        else:
            assert x == y
    # one rank's shard of the newest step cut short: the step is skipped
    cut = tmp_path / "cut"
    shutil.copytree(got["dir"], cut)
    (folder,) = [p for p in (cut / str(STEPS)).iterdir()]
    piece = max(folder.glob("1-*.bin"), key=lambda p: p.stat().st_size)
    with open(piece, "r+b") as f:
        f.truncate(piece.stat().st_size // 2)
    trainer = _restore_one_rank(cut)
    assert trainer.checkpointer.all_steps() == [1, STEPS]
    assert trainer.checkpointer.readable_steps() == [1]
    assert trainer.maybe_resume() == 1
