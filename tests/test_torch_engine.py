"""Port parity: cloudtik_tpu_torch.serve.engine vs the JAX DecodeEngine.

`tiny` in fp32 on the CPU, one intra-op thread, parameters from the JAX
`init_params(PRNGKey(0))`.  The paged helpers and the decode step agree
with their JAX counterparts on the same pools and tables (logits to 1e-5
relative, pools outside the null block 0).  Each serving scenario runs the
same requests through the JAX engine and the port's, and every greedy
result equals the port's `generate` of the prompt alone, exactly.
Scenarios whose schedule must not hang on thread timing submit their
requests before `start()`, so both engines admit them in one pass and
their preemption and prefix counts can be compared too.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.faults import plan as JP
from cloudtik_tpu.faults import seams as JS
from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import plan as TP
from cloudtik_tpu_torch.faults import seams as TS
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60          # seconds: every wait is bounded
SHARED = dict(slots=3, max_len=96, prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(M, params, start=True, **ec):
    jp, tp = params
    if M is JE:
        eng = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**ec))
    else:
        eng = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec), device="cpu")
    if start:
        eng.start()
    return eng


@pytest.fixture(scope="module")
def shared(params):
    """One engine of each package with the JAX engine tests' shared
    configuration, used by the scenarios in order, as theirs are."""
    engines = {M: _engine(M, params, **SHARED) for M in (JE, TE)}
    yield engines
    for eng in engines.values():
        eng.stop()


_REF = {}


def _reference(params, prompt, max_new):
    key = (tuple(prompt), max_new)
    if key not in _REF:
        _REF[key] = TG.generate(params[1], torch.tensor([prompt]), TCFG,
                                max_new_tokens=max_new)[0].tolist()
    return _REF[key]


def _until(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def _done(req):
    return {"prompt": req.prompt, "new": req.max_new_tokens,
            "eos": req.eos_id, "tokens": req.wait(timeout=WAIT),
            "prefill_chunks": req.prefill_chunks,
            "prefix_tokens": req.prefix_tokens,
            "prefix_blocks": req.prefix_blocks,
            "preemptions": req.preemptions}


# -- scenarios: each takes the engine module and an engine, returns what
#    it observed; the tests hold JAX's and the port's observations equal --

def sc_single(M, eng, params):
    return [_done(eng.submit(M.Request([5, 17, 101, 9],
                                       max_new_tokens=8)))]


def sc_concurrent(M, eng, params):
    prompts = [[1, 2, 3], [42, 7, 19, 23, 88, 4, 11], [200, 201]]
    reqs = [eng.submit(M.Request(p, max_new_tokens=10)) for p in prompts]
    return [_done(r) for r in reqs]


def sc_late_join(M, eng, params):
    long_req = eng.submit(M.Request([9, 8, 7, 6, 5], max_new_tokens=24))
    _until(lambda: len(long_req.tokens) >= 4)
    late = eng.submit(M.Request([3, 1, 4, 1, 5, 9], max_new_tokens=6))
    return [_done(late), _done(long_req)]


def sc_more_than_slots(M, eng, params):
    reqs = [eng.submit(M.Request([i + 1, i + 2, i + 3], max_new_tokens=5))
            for i in range(5)]
    return [_done(r) for r in reqs]


def sc_eos(M, eng, params):
    # pretend the 3rd token the prompt generates alone is EOS
    eos = _reference(params, [5, 17, 101, 9], 8)[2]
    return [_done(eng.submit(M.Request([5, 17, 101, 9], max_new_tokens=8,
                                       eos_id=eos)))]


def sc_chunked(M, eng, params):
    prompt = [((i * 37) % 250) + 1 for i in range(40)]
    return [_done(eng.submit(M.Request(prompt, max_new_tokens=8)))]


def sc_prefix_reuse(M, eng, params):
    prompt = [((i * 13) % 250) + 1 for i in range(40)]
    out = [_done(eng.submit(M.Request(prompt, max_new_tokens=6)))]
    out.append(_done(eng.submit(M.Request(prompt, max_new_tokens=6))))
    out.append(_done(eng.submit(M.Request(prompt + [7, 8, 9],
                                          max_new_tokens=6))))
    return out


SHARED_SCENARIOS = {
    "single": sc_single, "concurrent": sc_concurrent,
    "late_join": sc_late_join, "more_than_slots": sc_more_than_slots,
    "eos": sc_eos, "chunked": sc_chunked, "prefix_reuse": sc_prefix_reuse,
}


def _check_against_generate(params, runs):
    for run in runs:
        want = _reference(params, run["prompt"], run["new"])
        if run["eos"] is not None and run["eos"] in want:
            want = want[:want.index(run["eos"]) + 1]
        assert run["tokens"] == want


@pytest.mark.parametrize("name", list(SHARED_SCENARIOS))
def test_shared_engine_scenario_matches_jax_and_generate(params, shared,
                                                         name):
    scenario = SHARED_SCENARIOS[name]
    want = scenario(JE, shared[JE], params)
    got = scenario(TE, shared[TE], params)
    assert got == want
    _check_against_generate(params, got)
    bs = shared[TE].ec.block_size
    if name == "eos":
        full = _reference(params, [5, 17, 101, 9], 8)
        assert full[2] not in full[:2]
        assert got[0]["tokens"] == full[:3]
    if name == "chunked":
        assert got[0]["prefill_chunks"] == 2
    if name == "prefix_reuse":
        first, again, ext = got
        assert again["prefix_tokens"] == ((40 - 1) // bs) * bs
        assert again["prefix_blocks"] == again["prefix_tokens"] // bs
        assert ext["prefix_tokens"] == 40 // bs * bs
        assert shared[TE].pool.prefix_hits >= 2
        assert shared[TE].pool.prefix_hits == shared[JE].pool.prefix_hits


def test_oversized_request_is_rejected_for_capacity(shared):
    msgs = {}
    for M in (JE, TE):
        req = shared[M].submit(M.Request(list(range(30)),
                                         max_new_tokens=90))
        with pytest.raises(M.RequestRejected,
                           match="block-table capacity") as exc:
            req.wait(timeout=WAIT)
        assert exc.value.reason == "capacity"
        msgs[M] = str(exc.value)
    assert msgs[TE] == msgs[JE]


# -- scenarios on engines of their own configuration ------------------------

def sc_bucket_overrun(M, eng, params):
    """A chunk whose bucket (64) overruns the 64-token table from 16: it
    must land in the scratch tail, and A's shared prefix block stays
    intact for A's rerun."""
    a = [((i * 11) % 250) + 1 for i in range(20)]
    b = a[:16] + [((i * 5) % 250) + 1 for i in range(44)]
    out = [_done(eng.submit(M.Request(a, max_new_tokens=4)))]
    out.append(_done(eng.submit(M.Request(b, max_new_tokens=4))))
    out.append(_done(eng.submit(M.Request(a, max_new_tokens=4))))
    return out


def sc_preempt_newest(M, eng, params):
    reqs = [eng.submit(M.Request(p, max_new_tokens=28))
            for p in ([9, 8, 7, 6], [3, 1, 4, 1])]
    eng.start()
    return [_done(r) for r in reqs]


def sc_salvage(M, eng, params):
    pa = [9, 8, 7, 6, 5, 4, 3]
    pb = [((i * 11) % 250) + 1 for i in range(32)]
    reqs = [eng.submit(M.Request(pa, max_new_tokens=25)),
            eng.submit(M.Request(pb, max_new_tokens=8))]
    eng.start()
    return [_done(r) for r in reqs]


def sc_alloc_fault(M, eng, params):
    """The third allocation (a's first decode growth) fails by injection:
    the newest request is preempted exactly as on real exhaustion."""
    plan_mod, seams_mod = (JP, JS) if M is JE else (TP, TS)
    plan = plan_mod.FaultPlan([plan_mod.FaultPoint(
        "serve.kvcache.alloc", "raise", at_call=3, times=1)])
    with seams_mod.armed(plan):
        reqs = [eng.submit(M.Request(p, max_new_tokens=10))
                for p in ([9, 8, 7, 6], [3, 1, 4, 1])]
        eng.start()
        out = [_done(r) for r in reqs]
    assert [t["call"] for t in plan.trace] == [3]
    return out


OWN_SCENARIOS = {
    # name: (scenario, engine config, started before the scenario)
    "bucket_overrun": (sc_bucket_overrun, dict(
        slots=2, max_len=64, prefill_buckets=(16, 32, 64), block_size=16),
        True),
    "preempt_newest": (sc_preempt_newest, dict(
        slots=2, max_len=32, prefill_buckets=(8,), block_size=4,
        num_blocks=9, prefix_cache=False), False),
    "mid_prefill_salvage": (sc_salvage, dict(
        slots=2, max_len=40, prefill_buckets=(4,), block_size=4,
        num_blocks=12, prefix_cache=True), False),
    "alloc_fault": (sc_alloc_fault, dict(
        slots=2, max_len=32, prefill_buckets=(8,), block_size=4,
        prefix_cache=False), False),
}


@pytest.mark.parametrize("name", list(OWN_SCENARIOS))
def test_own_engine_scenario_matches_jax_and_generate(params, name):
    scenario, ec, start = OWN_SCENARIOS[name]
    seen = {}
    for M in (JE, TE):
        eng = _engine(M, params, start=start, **ec)
        try:
            seen[M] = scenario(M, eng, params)
        finally:
            eng.stop()
        assert eng.pool.used() == 0
        assert eng.pool.available() == eng.pool.usable_blocks
    got = seen[TE]
    assert got == seen[JE]
    _check_against_generate(params, got)
    if name == "bucket_overrun":
        assert got[1]["prefix_tokens"] == 16
        assert got[2]["tokens"] == got[0]["tokens"]
    if name in ("preempt_newest", "alloc_fault"):
        assert got[0]["preemptions"] == 0      # oldest never preempted
        assert got[1]["preemptions"] >= 1
    if name == "mid_prefill_salvage":
        assert got[1]["preemptions"] >= 1
        # the salvage: re-admission was a prefix-cache hit
        assert got[1]["prefix_tokens"] > 0
        assert got[1]["prefix_tokens"] % ec["block_size"] == 0


@pytest.mark.parametrize("M", [JE, TE], ids=["jax", "port"])
def test_pool_fully_free_after_cancel_and_stop(params, M):
    """Cancel one request mid-flight and one still queued, then stop with
    the rest in flight: every request completes and every block returns
    to the pool, on both engines."""
    eng = _engine(M, params, slots=2, max_len=64, prefill_buckets=(8, 16),
                  block_size=8)
    reqs = [eng.submit(M.Request([i + 1] * 6, max_new_tokens=40))
            for i in range(4)]
    try:
        _until(lambda: reqs[0].tokens)
        assert reqs[0].cancel()
        reqs[3].cancel()
        # the loop thread frees the cancelled slot on its next pass
        _until(reqs[0]._done.is_set)
    finally:
        eng.stop()
    assert all(r._done.is_set() for r in reqs)
    with pytest.raises(M.RequestCancelled):
        reqs[0].wait(timeout=WAIT)
    assert eng.pool.used() == 0
    assert eng.pool.available() == eng.pool.usable_blocks


def test_wfq_admission_order_matches_jax(params):
    """Weighted-fair admission over two slots: tenant `a` bursts four
    requests ahead of tenant `b`'s two; both engines admit in the same
    order, and `b` is not starved behind `a`'s burst."""
    order = {}
    for M in (JE, TE):
        eng = _engine(M, params, start=False, slots=2, max_len=32,
                      prefill_buckets=(8,), block_size=8, admission="wfq",
                      tenant_weights={"a": 1.0, "b": 1.0})
        reqs = [eng.submit(M.Request([t + 1, 2, 3], max_new_tokens=n,
                                     tenant=tenant))
                for t, (tenant, n) in enumerate(
                    [("a", 6), ("a", 3), ("a", 3), ("a", 3),
                     ("b", 4), ("b", 4)])]
        eng.start()
        try:
            for r in reqs:
                r.wait(timeout=WAIT)
        finally:
            eng.stop()
        ranked = sorted(range(len(reqs)), key=lambda i: reqs[i].admitted_mono)
        order[M] = [reqs[i].tenant + str(i) for i in ranked]
    assert order[TE] == order[JE]
    assert order[TE][:2] == ["a0", "b4"]


def test_max_queue_depth_overflow_is_queue_full(params):
    for M in (JE, TE):
        eng = _engine(M, params, start=False, slots=1, max_len=32,
                      prefill_buckets=(8,), max_queue_depth=1)
        try:
            first = eng.submit(M.Request([1, 2, 3], max_new_tokens=2))
            second = eng.submit(M.Request([4, 5, 6], max_new_tokens=2))
            with pytest.raises(M.RequestRejected, match="queue is full") \
                    as exc:
                second.wait(timeout=WAIT)
            assert exc.value.reason == "queue_full"
            assert not first._done.is_set()
        finally:
            eng.stop()
        with pytest.raises(RuntimeError, match="engine stopped"):
            first.wait(timeout=WAIT)


def test_sampled_lane_leaves_greedy_lane_unchanged(params):
    eng = _engine(TE, params, start=False, slots=2, max_len=64,
                  prefill_buckets=(8,), top_k=0)
    greedy = eng.submit(TE.Request([5, 17, 101, 9], max_new_tokens=12))
    sampled = eng.submit(TE.Request([5, 17, 101, 9], max_new_tokens=12,
                                    temperature=1.5))
    eng.start()
    try:
        assert greedy.wait(timeout=WAIT) == _reference(
            params, [5, 17, 101, 9], 12)
        assert len(sampled.wait(timeout=WAIT)) == 12
    finally:
        eng.stop()
    # at temperature 1.5 over 256 ids the draws leave the greedy path
    assert sampled.tokens != greedy.tokens


def test_seeded_sampled_request_repeats(params):
    def run(seed):
        eng = TE.DecodeEngine(
            params[1], TCFG, TE.EngineConfig(slots=2, max_len=64,
                                             prefill_buckets=(8,), top_k=8),
            generator=torch.Generator().manual_seed(seed), device="cpu")
        eng.start()
        try:
            return eng.generate([3, 1, 4, 1, 5], max_new_tokens=10,
                                temperature=1.0)
        finally:
            eng.stop()

    first = run(7)
    assert run(7) == first
    assert any(run(s) != first for s in (8, 9))
    # every draw lies in the engine's static top-8 at its position
    cache = TG.init_cache(TCFG, 1, 16, "cpu")
    logits, _ = TG.forward_step(params[1], torch.tensor([[3, 1, 4, 1, 5]]),
                                cache, TCFG)
    for tok in first:
        assert tok in torch.topk(logits[0, -1], 8).indices.tolist()
        logits, _ = TG.forward_step(params[1], torch.tensor([[tok]]), cache,
                                    TCFG)


def test_cow_fork_appends_through_both_forks(params):
    """Copy-on-write through `copy_block`: a live request's table is
    forked mid-decode and both forks append; the first writer copies the
    shared tail block, the blocks that stay shared are unchanged, both
    continuations equal the reference and the pool reconciles.  The test
    thread drives the loop phases, so it owns slot state."""
    prompt, max_new = [5, 17, 101, 9, 33, 7, 2, 11], 10
    ref = _reference(params, prompt, max_new)
    eng = _engine(TE, params, start=False, slots=2, max_len=32,
                  prefill_buckets=(8,), block_size=4, prefix_cache=False)
    with torch.inference_mode():
        a = eng.submit(TE.Request(prompt, max_new_tokens=max_new))
        eng._admit()
        slot = eng._slots[0]
        while not slot.decoding:
            eng._prefill_tick()
        eng._step()
        eng._step()
        assert len(a.tokens) == 3 and slot.length == 10
        shared_blocks = list(slot.table)
        before = eng._kp[:, shared_blocks[:2]].clone()
        b = TE.Request(prompt, max_new_tokens=max_new)
        b.tokens = list(a.tokens)
        b.admitted = time.time()
        b.admitted_mono = time.monotonic()
        fork = TE._Slot(request=b, table=eng.pool.fork_table(slot.table),
                        true_len=len(prompt), prefill_pos=len(prompt),
                        length=slot.length, remaining=slot.remaining,
                        decoding=True)
        eng._slots[1] = fork
        eng._sync_table(1)
        eng._lengths[1] = slot.length
        eng._tokens[1] = a.tokens[-1]
        assert eng.pool.needs_copy(slot.table[2])
        eng._step()
        assert slot.table[2] != fork.table[2]
        assert eng.pool.ref(slot.table[2]) == eng.pool.ref(fork.table[2]) == 1
        for _ in range(30):
            if a._done.is_set() and b._done.is_set():
                break
            eng._step()
    assert a.tokens == ref and b.tokens == ref
    assert torch.equal(eng._kp[:, shared_blocks[:2]], before)
    assert eng.pool.used() == 0
    assert eng.pool.available() == eng.pool.usable_blocks


@pytest.mark.parametrize("kwargs, what", [({"migrator": "m"}, "migrator")])
def test_unported_surfaces_raise(params, kwargs, what):
    """`migrator=` is ported (tests/test_torch_migration.py); what still
    raises there is the reference's refusal of speculative decoding on a
    prefill-role engine, which never decodes."""
    with pytest.raises(ValueError, match=f"prefill-role engine \\({what}="):
        TE.DecodeEngine(params[1], TCFG,
                        TE.EngineConfig(spec=TE.SpecConfig(k=2)),
                        draft=(params[1], TCFG), device="cpu", **kwargs)


def test_import_blocks_and_bad_ids_are_refused(params):
    eng = _engine(TE, params, start=False, slots=1, max_len=32)
    try:
        # an import this engine can never hold (blocks of 4 tokens into a
        # pool of 16) fails its request, not the engine
        shape = (TCFG.n_layers, 1, 4, TCFG.n_kv_heads, TCFG.head_dim)
        bad = eng.import_blocks(
            TE.Request([1]), {"length": 1, "first_token": 2,
                              "block_size": 4, "blocks": 1},
            torch.zeros(shape), torch.zeros(shape))
        eng._import_tick()
        with pytest.raises(TE.RequestRejected, match="migrated request"):
            bad.wait(timeout=WAIT)
        assert eng.pool.used() == 0
        for bad in (TE.Request([1, 256]), TE.Request([1], eos_id=-1),
                    TE.Request([])):
            with pytest.raises(TE.RequestRejected) as exc:
                eng.submit(bad).wait(timeout=WAIT)
            assert exc.value.reason in ("token_ids", "empty_prompt")
    finally:
        eng.stop()


def test_engine_loop_runs_without_autograd(params):
    """The loop thread enters inference mode itself: the pools and the
    step's outputs carry no autograd history even when the weights ask
    for gradients."""
    tp = {k: v for k, v in params[1].items()}
    tp["final_norm"] = tp["final_norm"].clone().requires_grad_(True)
    eng = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(slots=1, max_len=32,
                                                    prefill_buckets=(8,)),
                          device="cpu")
    eng.start()
    try:
        assert eng.generate([1, 2, 3], max_new_tokens=4) == _reference(
            params, [1, 2, 3], 4)
    finally:
        eng.stop()
    assert eng._kp.grad_fn is None and eng._tokens.grad_fn is None
    assert eng._tokens.is_inference()


# -- the device programs against their JAX counterparts ---------------------

def _pools(seed, N=7, bs=4):
    rng = np.random.default_rng(seed)
    shape = (TCFG.n_layers, N, bs, TCFG.n_kv_heads, TCFG.head_dim)
    return rng.standard_normal(shape).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("start, C", [(0, 8), (4, 4), (8, 8)])
def test_paged_prefill_chunk_matches_jax(params, start, C):
    """A chunk at `start` against a table whose earlier blocks hold
    context, with unallocated entries on the null block; (8, 8) overruns
    the 12-token table into the scratch tail."""
    jp, tp = params
    kp, vp = _pools(start)
    table = np.array([3, 5, 1, 0], np.int64)[:3]
    tokens = np.random.default_rng(C).integers(0, 256, (1, C))
    jkp, jvp, jl = JG.paged_prefill_chunk(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table, jnp.int32),
        jnp.asarray(tokens, jnp.int32), start, JCFG)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    rkp, rvp, tl = TG.paged_prefill_chunk(
        tp, tkp, tvp, torch.from_numpy(table), torch.from_numpy(tokens),
        start, TCFG)
    assert rkp is tkp and rvp is tvp                 # updated in place
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-5
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-5,
                                   atol=1e-5)


def test_decode_step_matches_jax(params):
    """Three lanes at different lengths (one crossing into a new block),
    one inactive lane, over the same pools and tables."""
    jp, tp = params
    bs, N = 4, 9
    kp, vp = _pools(11, N=N, bs=bs)
    tables = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 0]],
                      np.int64)
    lengths = np.array([9, 2, 4, 6], np.int64)
    active = np.array([True, True, True, False])
    tokens = np.array([17, 4, 250, 9], np.int64)
    # JAX: the decode step's tokens, and its logits through the layers
    jt, jkp, jvp, jlen = JE.decode_step(
        jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables, jnp.int32),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(active),
        jnp.zeros(4, jnp.float32), jax.random.PRNGKey(0), JCFG, bs, 0)
    x = JT._embed_lookup(jp["embed"], jnp.asarray(tokens, jnp.int32)[:, None],
                         JCFG)
    for i in range(JCFG.n_layers):
        layer = jax.tree.map(lambda w: w[i], jp["layers"])
        x, _, _ = JE._decode_layer(
            JCFG, x, layer, jnp.asarray(kp[i]), jnp.asarray(vp[i]),
            jnp.asarray(tables, jnp.int32), jnp.asarray(lengths, jnp.int32),
            jnp.asarray(active), bs)
    x = JG._rms_norm(x, jp["final_norm"], JCFG.norm_eps)
    jl = np.asarray(x @ JT._lm_head(jp, JCFG))[:, 0]
    # the port
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    args = (torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(active))
    tl = TE.decode_logits(tp, torch.from_numpy(tokens), tkp.clone(),
                          tvp.clone(), *args, TCFG, bs)
    nxt, rkp, rvp, tlen = TE.decode_step(
        tp, torch.from_numpy(tokens), tkp, tvp, *args, None, None, TCFG,
        bs, 0)
    assert rkp is tkp
    assert _rel(tl.numpy()[active], jl[active]) <= 1e-5
    assert nxt.tolist() == np.asarray(jt).tolist()
    assert nxt[3].item() == 9                        # inactive keeps its
    assert tlen.tolist() == np.asarray(jlen).tolist()
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-5,
                                   atol=1e-5)


def test_copy_block_and_gather_match_jax():
    kp, vp = _pools(3)
    jk, jv = JG.copy_block(jnp.asarray(kp), jnp.asarray(vp), 2, 5)
    tk, tv = TG.copy_block(torch.from_numpy(kp.copy()),
                           torch.from_numpy(vp.copy()), 2, 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    table = np.array([4, 0, 2], np.int64)
    jg = JG.gather_paged_cache(jk, jv, jnp.asarray(table, jnp.int32))
    tg = TG.gather_paged_cache(tk, tv, torch.from_numpy(table))
    for got, want in zip(tg, jg):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_pool_is_zeroed():
    kp, vp = TG.init_block_pool(TCFG, 5, 4, "cpu")
    assert kp.shape == (2, 5, 4, 2, 16) and kp.dtype == torch.float32
    assert not kp.any() and not vp.any()
