"""Port parity: speculative decoding in cloudtik_tpu_torch (models/generate
`paged_verify` and `draft_propose`, serve/engine `SpecConfig`) vs the JAX
package.

`tiny` in fp32 on the CPU, one intra-op thread, parameters from the JAX
`init_params` converted with `convert.params_from_jax`.  The device helpers
agree with their JAX counterparts on the same pools, tables and caches.  A
spec engine's greedy tokens equal the JAX spec engine's, the port's plain
engine's and `generate`'s, with a self-draft (every proposal accepted) and
a draft of other weights (the rewind path), and each request's
`draft_tokens`, `accepted_tokens` and `spec_steps` equal JAX's.  Requests
are submitted before `start()`, so both engines admit them in one pass.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import plan as TP
from cloudtik_tpu_torch.faults import seams as TS
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import reqlog

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60
SPEC = dict(slots=2, max_len=96, prefill_buckets=(8, 16, 32), block_size=8)


def _both(seed):
    jp = JT.init_params(jax.random.PRNGKey(seed), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params():
    return _both(0)


@pytest.fixture(scope="module")
def other():
    """A draft of other weights: it disagrees with the target."""
    return _both(7)


_REF = {}


def _reference(params, prompt, max_new):
    key = (tuple(prompt), max_new)
    if key not in _REF:
        _REF[key] = TG.generate(params[1], torch.tensor([prompt]), TCFG,
                                max_new_tokens=max_new)[0].tolist()
    return _REF[key]


def _spec_engine(params, draft, k=3, start=True, **ec):
    kw = dict(SPEC, **ec)
    eng = TE.DecodeEngine(params[1], TCFG,
                          TE.EngineConfig(spec=TE.SpecConfig(k=k), **kw),
                          draft=(draft[1], TCFG), device="cpu")
    if start:
        eng.start()
    return eng


@pytest.fixture(scope="module")
def self_draft(params):
    eng = _spec_engine(params, params)
    yield eng
    eng.stop()


def _free(eng):
    assert eng.pool.used() == 0
    assert eng.pool.available() == eng.pool.usable_blocks


# -- the device helpers against JAX ------------------------------------------

def _pools(seed, N=7, bs=4):
    rng = np.random.default_rng(seed)
    shape = (TCFG.n_layers, N, bs, TCFG.n_kv_heads, TCFG.head_dim)
    return rng.standard_normal(shape).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("start", [2, 6, 9])
def test_paged_verify_matches_jax(params, start):
    """A k+1 = 4 window at `start` over a 3-block table: inside a block,
    across a block boundary, and past the table into the scratch tail."""
    jp, tp = params
    kp, vp = _pools(start)
    table = np.array([3, 5, 1], np.int64)
    tokens = np.random.default_rng(start).integers(0, 256, (1, 4))
    jkp, jvp, jl = JG.paged_verify(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table, jnp.int32),
        jnp.asarray(tokens, jnp.int32), start, JCFG)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    rkp, rvp, tl = TG.paged_verify(
        tp, tkp, tvp, torch.from_numpy(table), torch.from_numpy(tokens),
        start, TCFG)
    assert rkp is tkp and rvp is tvp                 # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_draft_propose_matches_jax(params, k):
    jp, tp = params
    prompt = np.random.default_rng(k).integers(0, 256, (1, 6))
    jc = JG.init_cache(JCFG, 1, 16)
    _, jc = JG.forward_step(jp, jnp.asarray(prompt, jnp.int32), jc, JCFG)
    jtoks, jc = JG.draft_propose(jp, jnp.asarray(17, jnp.int32), jc, JCFG, k)
    tc = TG.init_cache(TCFG, 1, 16, "cpu")
    TG.forward_step(tp, torch.from_numpy(prompt), tc, TCFG)
    ttoks, tc2 = TG.draft_propose(tp, torch.tensor(17), tc, TCFG, k)
    assert tc2 is tc and tc["length"] == 6 + k
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5)


# -- spec engines against the JAX spec engine and the plain engine ----------

PROMPTS = [([5, 17, 101, 9], 12),
           ([((i * 37) % 250) + 1 for i in range(40)], 10),   # 2 chunks
           ([9, 8, 7, 6], 16),
           ([3, 1, 4, 1, 5], 7)]


def _run(eng, start=True):
    reqs = [eng.submit(eng_mod(eng).Request(p, max_new_tokens=n))
            for p, n in PROMPTS]
    if start:
        eng.start()
    try:
        return [{"tokens": r.wait(timeout=WAIT),
                 "spec": (r.draft_tokens, r.accepted_tokens, r.spec_steps)}
                for r in reqs]
    finally:
        eng.stop()


def eng_mod(eng):
    return TE if isinstance(eng, TE.DecodeEngine) else JE


@pytest.mark.parametrize("draft_name", ["self", "other"])
def test_spec_engine_matches_jax_spec_and_plain_engines(params, other,
                                                        draft_name):
    draft = params if draft_name == "self" else other
    jeng = JE.DecodeEngine(params[0], JCFG, JE.EngineConfig(
        spec=JE.SpecConfig(k=3), **SPEC), draft=(draft[0], JCFG))
    want = _run(jeng)
    eng = _spec_engine(params, draft, start=False)
    got = _run(eng)
    _free(eng)
    plain = _run(TE.DecodeEngine(params[1], TCFG, TE.EngineConfig(**SPEC),
                                 device="cpu"))
    assert got == want
    assert [g["tokens"] for g in got] == [p["tokens"] for p in plain]
    for (prompt, n), g in zip(PROMPTS, got):
        assert g["tokens"] == _reference(params, prompt, n)
        drafted, accepted, steps = g["spec"]
        assert steps > 0
        if draft_name == "self":
            assert accepted == drafted          # the draft IS the target
        else:
            assert accepted < drafted           # the rewind path ran


# -- the reference's TestSpeculative behaviours on the port ------------------

def test_self_draft_multi_chunk_and_prefix_reuse(params, self_draft):
    prompt = [((i * 13) % 250) + 1 for i in range(40)]
    first = self_draft.submit(TE.Request(prompt, max_new_tokens=10))
    out = first.wait(timeout=WAIT)
    assert out == _reference(params, prompt, 10)
    assert first.prefill_chunks == 2          # 40 tokens, chunk 32
    assert first.spec_steps > 0
    again = self_draft.submit(TE.Request(prompt, max_new_tokens=10))
    assert again.wait(timeout=WAIT) == out
    assert again.prefix_tokens > 0            # reused blocks
    assert again.spec_steps > 0
    assert again.accepted_tokens == again.draft_tokens


def test_eos_inside_accepted_window_stops_early(params, self_draft):
    """The first round proposes full[1:4]; EOS is full[2], the second
    proposal, accepted: the round keeps it and drops what follows."""
    prompt = [5, 17, 101, 9]
    full = _reference(params, prompt, 8)
    eos = full[2]
    assert eos not in full[:2]
    req = self_draft.submit(TE.Request(prompt, max_new_tokens=8,
                                       eos_id=eos))
    assert req.wait(timeout=WAIT) == full[:3]
    assert req.spec_steps == 1 and req.accepted_tokens == 3


def test_temperature_request_bypasses_spec(self_draft):
    req = self_draft.submit(TE.Request([1, 2, 3], max_new_tokens=6,
                                       temperature=0.9))
    assert len(req.wait(timeout=WAIT)) == 6
    assert req.spec_steps == 0 and req.draft_tokens == 0


def test_ledger_records_spec_fields_and_stats(self_draft, tmp_path):
    from cloudtik_tpu_torch import telemetry

    path = str(tmp_path / "req.jsonl")
    reqlog.install(path)
    try:
        req = self_draft.submit(TE.Request([3, 1, 4, 1, 5],
                                           max_new_tokens=12))
        req.wait(timeout=WAIT)
    finally:
        reqlog.uninstall()
    records = reqlog.read_requests(path)
    rec = [r for r in records if r["request_id"] == req.request_id][0]
    assert rec["spec_steps"] == req.spec_steps > 0
    assert rec["draft_tokens"] == req.draft_tokens
    assert rec["accepted_tokens"] == req.accepted_tokens
    stats = reqlog.compute_stats(records)
    assert stats["spec_acceptance_rate"] == 1.0       # self-draft
    assert stats["spec_tokens_per_verify"] > 1.0
    exposition = telemetry.render_prometheus()
    assert "tik_serve_spec_acceptance_rate" in exposition
    assert "tik_serve_spec_verify_steps_total" in exposition


def test_pool_fully_free_after_cancel_and_stop(params):
    eng = _spec_engine(params, params, max_len=64, prefill_buckets=(8, 16))
    reqs = [eng.submit(TE.Request([i + 1] * 6, max_new_tokens=40))
            for i in range(4)]
    deadline = time.monotonic() + WAIT
    while not reqs[0].tokens:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    reqs[0].cancel()
    reqs[3].cancel()
    eng.stop()
    assert all(r._done.is_set() for r in reqs)
    _free(eng)


def test_spec_config_requires_draft_and_a_fitting_k(params):
    with pytest.raises(ValueError, match="draft"):
        TE.DecodeEngine(params[1], TCFG,
                        TE.EngineConfig(spec=TE.SpecConfig(k=3)),
                        device="cpu")
    # k past the prefill chunk: the draft plane's scratch tail could not
    # take the proposals of a request near capacity (JAX clamps the write)
    with pytest.raises(ValueError, match="prefill chunk"):
        _spec_engine(params, params, k=9, start=False,
                     prefill_buckets=(8,))
    with pytest.raises(ValueError, match=">= 1"):
        _spec_engine(params, params, k=0, start=False)


# -- new behaviours ----------------------------------------------------------

def test_verify_fault_degrades_request_to_plain_decode(params, self_draft):
    """A `serve.spec.verify` raise on the second round: that request
    decodes plain from there on, and its tokens do not change."""
    prompt = [42, 7, 19, 23, 88]
    plan = TP.FaultPlan([TP.FaultPoint("serve.spec.verify", "raise",
                                       at_call=2, times=1)])
    with TS.armed(plan):
        req = self_draft.submit(TE.Request(prompt, max_new_tokens=14))
        out = req.wait(timeout=WAIT)
    assert [t["call"] for t in plan.trace] == [2]
    assert out == _reference(params, prompt, 14)
    assert req.spec_steps == 1 and req.draft_tokens == 3


def test_spec_request_runs_to_capacity(params):
    """prompt + max_new equal to the capacity (24 tokens), and the draft's
    second prompt chunk padded to 16 at position 16 overruns it: the pad
    lands in the draft plane's scratch tail, and every token comes."""
    prompt = [((i * 7) % 250) + 1 for i in range(20)]
    eng = _spec_engine(params, params, k=4, max_len=24,
                       prefill_buckets=(16,), block_size=8)
    try:
        req = eng.submit(TE.Request(prompt, max_new_tokens=4))
        assert req.wait(timeout=WAIT) == _reference(params, prompt, 4)
    finally:
        eng.stop()
    assert req.prefill_chunks == 2 and req.spec_steps >= 1
    _free(eng)


def test_verify_window_across_a_shared_block(params):
    """A live spec slot's table is forked mid-decode (both forks share
    every block, the partly written tail block included), and the next
    verify window [13, 18) starts in that shared block and crosses into a
    fresh one: the first writer copies the shared block before the
    verify, the blocks that stay shared are unchanged, both continuations
    equal the reference and the pool reconciles.  The test thread drives
    the loop phases, so it owns slot state."""
    prompt, max_new = [5, 17, 101, 9, 33, 7, 2, 11], 12
    ref = _reference(params, prompt, max_new)
    eng = _spec_engine(params, params, k=4, start=False, max_len=32,
                       prefill_buckets=(8,), block_size=4,
                       prefix_cache=False)
    with torch.inference_mode():
        a = eng.submit(TE.Request(prompt, max_new_tokens=max_new))
        eng._admit()
        slot = eng._slots[0]
        while not slot.decoding:
            eng._prefill_tick()
        eng._step()                 # one round: 1 + 5 tokens, length 13
        assert slot.length == 13 and len(a.tokens) == 6
        assert len(slot.table) == 4            # blocks_for(13 + 1)
        shared = list(slot.table)
        before = eng._kp[:, shared[:3]].clone()
        b = TE.Request(prompt, max_new_tokens=max_new)
        b.tokens = list(a.tokens)
        b.admitted = time.time()
        b.admitted_mono = time.monotonic()
        cache = slot.draft_cache
        fork = TE._Slot(
            request=b, table=eng.pool.fork_table(slot.table),
            true_len=len(prompt), prefill_pos=len(prompt),
            length=slot.length, remaining=slot.remaining, decoding=True,
            draft_cache={"k": cache["k"].clone(), "v": cache["v"].clone(),
                         "length": cache["length"]},
            draft_pos=slot.draft_pos, draft_len=slot.draft_len,
            draft_params=slot.draft_params)
        eng._slots[1] = fork
        eng._sync_table(1)
        eng._lengths[1] = slot.length
        eng._tokens[1] = a.tokens[-1]
        assert eng.pool.needs_copy(slot.table[3])
        eng._step()
        assert slot.table[3] != fork.table[3]
        assert torch.equal(eng._kp[:, shared[:3]], before)
        for _ in range(10):
            if a._done.is_set() and b._done.is_set():
                break
            eng._step()
    assert a.tokens == ref and b.tokens == ref
    assert a.accepted_tokens == a.draft_tokens
    _free(eng)
