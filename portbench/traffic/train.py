"""The training runner: `Trainer.train_step` on packed token rows.

Set-up builds one Trainer (the seed's weights in the configuration's
dtypes, the port's AdamW with the cell's settings) and drives it through
its first `check_steps` steps with the window's own call and feed; what
those steps leave is kept for the comparison: each step's loss, the first
gradient as the optimizer took it (its first moment after one step over
1 - b1), and each leaf's change after the last.  The window then runs
steps on fresh rows, at most two in flight, until `--seconds` have
passed and the card has finished them.  Traced runs profile
`profile_steps` steps in the window's middle; the rate and model FLOPs
are read over the rest.  After the window the program is freed and the
float32 reference (reference/train_check.py) runs the same first steps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import weights
from portbench.reference import train_check

MU_KEY = "mu"


def batch(seed: int, step: int, B: int, S: int, vocab: int,
          device) -> Dict[str, torch.Tensor]:
    """Rows of S + 1 token ids drawn from (seed, step); labels are the
    next ids.  Every row of every step differs."""
    gen = torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + step)
    x = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return {"tokens": x[:, :S].contiguous(), "labels": x[:, 1:].contiguous()}


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def _named_leaves(tree: Dict, prefix: str = ""):
    """(dotted path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def initial(ctx, t: Dict, path: str, dtype) -> torch.Tensor:
    """A trained leaf's starting value, drawn again from the seed."""
    lora = ctx.cell.get("lora")
    if lora:
        return weights.make_adapter_leaf(t, lora, path, ctx.seed,
                                         ctx.device, dtype)
    return weights.make_leaf(t, path.split(".")[-1], ctx.seed, ctx.device,
                             dtype)


def compare(prog: Dict, ref: Dict, limits: Dict) -> List[Dict]:
    """The numbers a training cell is held to, each beside its limit.

    loss.<n>: |loss - reference| / reference of step n (`limits["loss"]`
    one limit, or one a step with null where it is not compared).  grad1
    and change:
    by the worst leaf, |norm - reference norm| / max(reference norm of the
    leaf, the median leaf's).  change.median: the median leaf's, which a
    seed moves less (the worst leaf's change is led by the few elements
    whose gradient is at rounding, whose Adam step flips sign between the
    program and the reference).  The changes leave out leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move under Adam by rounding alone)."""
    checks = []
    loss = limits["loss"]
    loss = loss if isinstance(loss, list) else [loss] * len(ref["losses"])
    for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
        if loss[i] is not None:     # null: a step no fault separates
            checks.append({"name": f"loss.{i + 1}",
                           "value": abs(a - b) / abs(b), "limit": loss[i]})
    g_ref = ref["first_grad"]
    g_med = sorted(g_ref.values())[len(g_ref) // 2]

    def gaps(key, keep):
        r = ref[key]
        med = sorted(r[k] for k in keep)[len(keep) // 2]
        return sorted(abs(prog[key][k] - r[k]) / max(r[k], med, 1e-30)
                      for k in keep)

    checks.append({"name": "grad1",
                   "value": gaps("first_grad", list(g_ref))[-1],
                   "limit": limits["grad1"]})
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    change = gaps("change", moved)
    checks.append({"name": "change", "value": change[-1],
                   "limit": limits["change"]})
    checks.append({"name": "change.median",
                   "value": change[len(change) // 2],
                   "limit": limits["change_median"]})
    return checks


def _build(ctx, t: Dict):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.optim import OptimizerConfig
    from cloudtik_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                                  transformer_spec)
    cell = ctx.cell
    kw = dict(t)
    kw["dtype"] = weights.dtype_of(kw["dtype"])
    kw["param_dtype"] = weights.dtype_of(kw["param_dtype"])
    cfg = T.TransformerConfig(**kw)
    if ctx.device.type == "cuda":
        from cloudtik_tpu_torch.ops import _kernels
        _kernels.build_all(["flash_fwd", "flash_bwd"])
    params = weights.make_params(t, ctx.seed, ctx.device, kw["param_dtype"])
    spec = transformer_spec(cfg)
    lora = cell.get("lora")
    if lora:
        # the frozen base in its served dtype; the adapters trained in
        # the cell's dtype
        from cloudtik_tpu_torch.models.lora import LoRAConfig, lora_spec
        spec = lora_spec(params, cfg, LoRAConfig(
            rank=lora["rank"], alpha=lora["alpha"],
            targets=tuple(lora["targets"])))
        params = weights.make_adapters(t, lora, ctx.seed, ctx.device,
                                       weights.dtype_of(lora["dtype"]))
    trainer = Trainer(spec, TrainerConfig(
        global_batch_size=cell["batch"], seq_len=cell["seq_len"],
        optimizer=OptimizerConfig(**cell["optimizer"]), prefetch_depth=0),
        device=ctx.device)
    trainer.init_state(params=params)
    return trainer


def reference(ctx, t: Dict, quant=None) -> Dict:
    """The float32 reference's first steps from the seed's inputs."""
    cell, seed, dev = ctx.cell, ctx.seed, ctx.device
    B, S, V = cell["batch"], cell["seq_len"], t["vocab_size"]
    lora = cell.get("lora")
    adapters, scale = None, 0.0
    if lora:
        params = weights.make_params(t, seed, dev,
                                     weights.dtype_of(t["param_dtype"]))
        adapters = weights.make_adapters(t, lora, seed, dev, torch.float32)
        scale = lora["alpha"] / lora["rank"]
    else:
        params = weights.make_params(t, seed, dev, torch.float32)
    ref = train_check.run_steps(
        params, t, cell["optimizer"],
        [batch(seed, i, B, S, V, dev) for i in range(cell["check_steps"])],
        initial=lambda k: initial(ctx, t, k, torch.float32), quant=quant,
        adapters=adapters, lora_scale=scale)
    del params, adapters
    ctx.free()
    return ref


def run(ctx) -> Dict:
    cell = ctx.cell
    B, S = cell["batch"], cell["seq_len"]
    t = ctx.transformer(max_seq_len=S, **cell.get("transformer", {}))
    V, dev, seed = t["vocab_size"], ctx.device, ctx.seed
    n_check = cell["check_steps"]
    b1 = cell["optimizer"]["b1"]

    trainer = _build(ctx, t)
    prog = {"losses": [], "first_grad": {}, "change": {}}
    for step in range(n_check):
        m = trainer.train_step(batch(seed, step, B, S, V, dev))
        prog["losses"].append(float(m["loss"]))
        if step == 0:
            prog["first_grad"] = {
                k: _norm(mu) / (1 - b1)
                for k, mu in _named_leaves(trainer.opt_state[MU_KEY])}
    with torch.no_grad():
        prog["change"] = {k: _norm(p - initial(ctx, t, k, p.dtype))
                          for k, p in _named_leaves(trainer.params)}
    ctx.warm_profiler()
    ctx.setup_done()

    steps, window_s, step = 0, 0.0, n_check
    profile_at = ctx.seconds / 2 if ctx.trace else None
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    pending: List = []
    sync()
    t0 = time.perf_counter()
    while True:
        trainer.train_step(batch(seed, step, B, S, V, dev))
        step += 1
        steps += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 1:
                pending.pop(0).synchronize()
        elapsed = time.perf_counter() - t0
        if profile_at is not None and elapsed >= profile_at:
            sync()
            window_s += time.perf_counter() - t0
            with ctx.profiled():
                for _ in range(cell["profile_steps"]):
                    trainer.train_step(batch(seed, step, B, S, V, dev))
                    step += 1
            profile_at = None
            pending.clear()
            t0 = time.perf_counter()
            continue
        if window_s + elapsed >= ctx.seconds:
            break
    sync()
    window_s += time.perf_counter() - t0
    ctx.window_closed()

    del trainer, pending
    ctx.free()
    ref = reference(ctx, t)
    checks = compare(prog, ref, cell["limits"])
    record = {"kind": "train", "steps": steps, "window_s": window_s,
              "tokens_per_step": B * S,
              "flops_per_token": cell["model_flops_per_token"],
              "peak_kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "attention": {"B": B, "H": t["n_heads"],
                            "Hkv": t["n_kv_heads"], "S": S,
                            "D": t["d_model"] // t["n_heads"],
                            "layers": t["n_layers"]},
              "profile_steps": cell["profile_steps"] if ctx.trace else 0,
              "program": prog, "reference": ref}
    return {"record": record, "attempted": steps, "failed": 0,
            "checks": checks}
