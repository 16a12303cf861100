"""The serving runner: `DecodeEngine.submit` of `Request`s, in-process.

Set-up draws the seed's weights in the served dtype, starts the engine
with the cell's `EngineConfig` and warms it with one request of each
prefill bucket the traffic's chunks use (random ids, which share no
block with the traffic).  The window then offers the cell's mix:

- `"loop": "open"`: requests sent when due (generator.open_loop), timed
  from when each was due; after the window every request due in it is
  waited for, up to `drain_s`, and one that never finishes counts as
  missing;
- `"loop": "closed"`: `clients` requests kept outstanding, each replaced
  when it finishes (generator.ClosedLoopSource); the tokens emitted by
  the window's end count, those of unfinished requests included; the
  engine is then stopped.

Traced runs profile `profile_s` seconds in the window's middle and keep
the engine's `serve.decode_step` spans.  After the window the engine is
freed, and the float32 reference (reference/serve_check.py) is run over a
sample of finished requests drawn from the seed, the one with the most
served tokens always in it.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import weights
from portbench.reference import serve_check
from portbench.traffic import generator

POLL_S = 0.005


def _engine(ctx, t: Dict, params):
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.serve.engine import DecodeEngine, EngineConfig
    kw = dict(t)
    kw["dtype"] = weights.dtype_of(kw["dtype"])
    kw["param_dtype"] = weights.dtype_of(kw["param_dtype"])
    cfg = T.TransformerConfig(**kw)
    engine = DecodeEngine(params, cfg, EngineConfig(**ctx.cell["engine"]),
                          device=ctx.device)
    engine.start()
    return engine


def _request(prompt, n):
    from cloudtik_tpu_torch.serve.engine import Request
    return Request(prompt, max_new_tokens=n)


def warm(engine, cell: Dict, seed: int, vocab: int) -> None:
    """One request a prefill bucket the mix's chunks use, each decoding a
    few tokens at the engine's one decode shape, all at once."""
    reqs = []
    for i, n in enumerate(cell["warm_prompt_lengths"]):
        ids = generator.token_ids(seed, 1000 + i, n, vocab)
        reqs.append(engine.submit(_request(ids, cell["warm_new_tokens"])))
    for r in reqs:
        r.wait(timeout=600)


def _row(r, due: float, t0: float) -> Dict:
    def rel(x):
        return None if x is None else x - t0
    return {"due": due, "admitted": rel(r.admitted_mono),
            "first": rel(r.first_token_mono), "done": rel(r.done_mono),
            "n_out": len(r.tokens), "prompt_len": len(r.prompt),
            "prefix_tokens": r.prefix_tokens,
            "ok": r.done_mono is not None and r.error is None
            and len(r.tokens) == r.max_new_tokens}


def open_window(ctx, engine, vocab: int):
    cell = ctx.cell
    plan = generator.open_loop(cell["mix"], ctx.seconds, ctx.seed, vocab)
    sent, late = [], [0.0]
    t0 = time.monotonic()

    def send_until(i, until):
        while i < len(plan) and plan[i]["due"] < until:
            due = t0 + plan[i]["due"]
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)
            late[0] = max(late[0], time.monotonic() - due)
            sent.append((engine.submit(_request(
                plan[i]["prompt"], plan[i]["max_new_tokens"])),
                plan[i]["due"]))
            i += 1
        return i

    i = 0
    if ctx.trace:
        i = send_until(i, ctx.seconds / 2)
        with ctx.profiled():
            i = send_until(i, ctx.seconds / 2 + cell["profile_s"])
    send_until(i, ctx.seconds)
    end = t0 + ctx.seconds
    if end > time.monotonic():
        time.sleep(end - time.monotonic())
    ctx.window_closed()
    deadline = time.monotonic() + cell["drain_s"]
    for r, _ in sent:
        try:
            r.wait(max(deadline - time.monotonic(), 0.0))
        except Exception:       # late past the drain, or failed: missing
            pass
    rows = [_row(r, due, t0) for r, due in sent]
    return sent, rows, {"window_s": ctx.seconds,
                        "generator_late_s": late[0]}


def closed_window(ctx, engine, vocab: int):
    cell = ctx.cell
    source = generator.ClosedLoopSource(cell["mix"], ctx.seed, vocab)
    sent, live = [], []
    t0 = time.monotonic()
    end = t0 + ctx.seconds
    profile_at = t0 + ctx.seconds / 2 if ctx.trace else None

    def top_up():
        while len(live) < cell["mix"]["clients"]:
            item = source.next()
            r = engine.submit(_request(item["prompt"],
                                       item["max_new_tokens"]))
            live.append(r)
            sent.append((r, time.monotonic() - t0))

    def loop(until):
        while time.monotonic() < until:
            live[:] = [r for r in live if r.done_mono is None]
            top_up()
            time.sleep(POLL_S)

    top_up()
    if profile_at is not None:
        loop(profile_at)
        with ctx.profiled():
            loop(profile_at + cell["profile_s"])
    loop(end)
    at_end = {id(r): len(r.tokens) for r, _ in sent}
    emitted = sum(at_end.values())
    window_s = time.monotonic() - t0
    stopped = {id(r) for r in live if r.done_mono is None}
    ctx.window_closed()
    engine.stop()
    rows = [dict(_row(r, due, t0), stopped=id(r) in stopped,
                 n_window=at_end[id(r)]) for r, due in sent]
    return sent, rows, {"window_s": window_s, "tokens_emitted": emitted}


def sample(sent, seed: int, want_tokens: int):
    """Finished requests drawn from the seed until `want_tokens` served
    tokens are covered, the one with the most always first."""
    done = [r for r, _ in sent
            if r.done_mono is not None and r.error is None and r.tokens]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    order = [longest] + [i for i in generator.rng(seed, 7).permutation(
        len(done)).tolist() if i != longest]
    picked, n = [], 0
    for i in order:
        picked.append((list(done[i].prompt), list(done[i].tokens)))
        n += len(done[i].tokens)
        if n >= want_tokens:
            break
    return picked


def run(ctx) -> Dict:
    cell = ctx.cell
    t = ctx.transformer(max_seq_len=cell["engine"]["max_len"])
    V = t["vocab_size"]
    params = weights.make_params(t, ctx.seed, ctx.device,
                                 weights.dtype_of(t["param_dtype"]))
    engine = _engine(ctx, t, params)
    warm(engine, cell, ctx.seed, V)
    if ctx.trace:
        from cloudtik_tpu_torch import telemetry
        telemetry.reset()           # the window's spans only
    ctx.warm_profiler()
    ctx.setup_done()
    if cell["mix"]["loop"] == "open":
        sent, rows, extra = open_window(ctx, engine, V)
    else:
        sent, rows, extra = closed_window(ctx, engine, V)
    engine.stop()
    spans = []
    if ctx.trace:
        from cloudtik_tpu_torch import telemetry
        spans = [{"name": s["name"], "dur": s["dur"],
                  "active": s["attrs"].get("active")}
                 for s in telemetry.spans()
                 if s["name"] == "serve.decode_step"]
    picked = sample(sent, ctx.seed, cell["check"]["sample_tokens"])
    del engine, sent
    ctx.free()
    gaps = serve_check.served_gaps(params, t, picked) if picked else \
        {"widest_gap": float("nan"), "tokens": 0}
    del params
    ctx.free()
    # a closed loop's requests still running at the window's end were
    # stopped with the engine: neither failed nor compared
    failed = sum(1 for r in rows if not r["ok"] and not r.get("stopped"))
    checks = [{"name": "widest_gap", "value": gaps["widest_gap"],
               "limit": cell["limits"]["widest_gap"]}]
    record = {"kind": "serve", "loop": cell["mix"]["loop"],
              "slots": cell["engine"]["slots"],
              "requests": rows, "spans": spans,
              "transformer": t, "peak_kind":
              torch.cuda.get_device_name(ctx.device)
              if ctx.device.type == "cuda" else "cpu",
              "gaps": gaps, **extra}
    return {"record": record, "attempted": len(rows), "failed": failed,
            "checks": checks}
