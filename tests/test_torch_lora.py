"""Port parity: multi-tenant LoRA serving in cloudtik_tpu_torch
(models/lora.py, serve/adapters.py, the `lora` branch of models/generate
and serve/engine) vs the JAX package.

`tiny` in fp32 on the CPU, one intra-op thread; the base parameters and
the adapters come from the JAX `init_params` / `random_lora_params`,
converted with `convert.params_from_jax`.  The plane plumbing and the
gathered delta agree with JAX; an adapter engine's greedy tokens equal the
JAX adapter engine's and a dedicated engine's on the merged weights, on
the gathered (heterogeneous) and the merged (homogeneous) path.  Around
that, the reference's adapter-pool residency, load-failure, tenant
isolation and spec-guard behaviours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import lora as JL
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import adapters as JA
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.faults import plan as TP
from cloudtik_tpu_torch.faults import seams as TS
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve.adapters import (
    AdapterLoadError, AdapterPool, AdapterSlotsExhausted, checkpoint_loader)

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60
ALL = ("wq", "wk", "wv", "wo")
ENGINE_KW = dict(max_len=64, prefill_buckets=(8, 16), block_size=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return convert.params_from_jax(_np(tree), "cpu")


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params, port LoRAConfig, JAX bank, port bank)."""
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    jlc = JL.LoRAConfig(rank=4)
    jbank = {f"t{i}": JL.random_lora_params(jax.random.PRNGKey(i + 1),
                                            JCFG, jlc)
             for i in range(4)}
    return (jp, _torch(jp), TL.LoRAConfig(rank=4), jbank,
            {k: _torch(v) for k, v in jbank.items()})


def _pool(model, capacity=4, loader=None):
    _jp, tp, lc, _jbank, bank = model
    return AdapterPool(tp, TCFG, lc, loader=loader or (lambda a: bank[a]),
                       capacity=capacity)


def _engine(model, pool, slots=3, start=True, **kw):
    eng = TE.DecodeEngine(model[1], TCFG,
                          TE.EngineConfig(slots=slots, **dict(ENGINE_KW,
                                                              **kw)),
                          adapters=pool, device="cpu")
    if start:
        eng.start()
    return eng


def _merged(model, adapter_id):
    _jp, tp, lc, _jbank, bank = model
    if adapter_id is None:
        return tp
    return dict(tp, layers=TL.merge_lora(tp["layers"], bank[adapter_id], lc))


_REF = {}


def _merged_reference(model, adapter_id, prompt, max_new):
    """A dedicated engine on the merged weights, one request."""
    key = (adapter_id, tuple(prompt), max_new)
    if key not in _REF:
        eng = TE.DecodeEngine(_merged(model, adapter_id), TCFG,
                              TE.EngineConfig(slots=1, **ENGINE_KW),
                              device="cpu")
        eng.start()
        try:
            _REF[key] = eng.generate(prompt, max_new_tokens=max_new)
        finally:
            eng.stop()
    return _REF[key]


def _free(eng):
    assert eng.pool.used() == 0
    assert eng.pool.available() == eng.pool.usable_blocks


# -- the plane plumbing and the delta against JAX ----------------------------

@pytest.fixture(scope="module")
def all_targets():
    """Two adapters on all four targets, JAX and port, with their planes
    [null, t0, t1]."""
    jlc = JL.LoRAConfig(rank=4, targets=ALL)
    jads = [JL.random_lora_params(jax.random.PRNGKey(s), JCFG, jlc)
            for s in (11, 12)]
    jplanes = JL.write_adapter_slot(JL.write_adapter_slot(
        JL.init_adapter_planes(JCFG, jlc, 3), 1, jads[0]), 2, jads[1])
    tlc = TL.LoRAConfig(rank=4, targets=ALL)
    tplanes = TL.init_adapter_planes(TCFG, tlc, 3, "cpu")
    for slot, ad in ((1, jads[0]), (2, jads[1])):
        TL.write_adapter_slot(tplanes, slot, _torch(ad))
    return jlc, jads, jplanes, tlc, tplanes


def _assert_tree_close(got, want, tol):
    for t, pair in want.items():
        for k, w in pair.items():
            np.testing.assert_allclose(got[t][k].numpy(), np.asarray(w),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("target", ALL)
def test_gathered_delta_matches_jax(all_targets, target):
    """Lanes on [null, t1, t0, null, t1]; the null lanes contribute 0."""
    jlc, _jads, jplanes, _tlc, tplanes = all_targets
    idx = np.array([0, 2, 1, 0, 2])
    rng = np.random.default_rng(3)
    shape = (5, 3, TCFG.d_model) if target != "wo" else \
        (5, 3, TCFG.n_heads, TCFG.head_dim)
    h = rng.standard_normal(shape).astype(np.float32)
    layer = 1
    want = JL.gathered_delta(
        target, jnp.asarray(h),
        jax.tree.map(lambda w: w[layer], jplanes), jnp.asarray(idx),
        jlc.scale)
    got = TL.gathered_delta(target, torch.from_numpy(h),
                            TL.layer_planes(tplanes, layer),
                            torch.from_numpy(idx), jlc.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[idx == 0].any()


def test_plane_plumbing_matches_jax(all_targets, model):
    jlc, jads, jplanes, tlc, tplanes = all_targets
    _assert_tree_close(tplanes, jplanes, 1e-6)
    assert TL.plane_shapes(TCFG, tlc, 3) == JL.plane_shapes(JCFG, jlc, 3)
    # clear in place
    jcleared = JL.clear_adapter_slot(jplanes, 1)
    tcleared = TL.clear_adapter_slot(
        {t: {k: v.clone() for k, v in p.items()} for t, p in
         tplanes.items()}, 1)
    _assert_tree_close(tcleared, jcleared, 1e-6)
    assert not tcleared["wq"]["a"][:, 1].any()
    # stack
    tads = [_torch(a) for a in jads]
    _assert_tree_close(TL.stack_adapters(tads, TCFG, tlc),
                       JL.stack_adapters(jads, JCFG, jlc), 1e-6)
    # merge
    jp, tp = model[0], model[1]
    _assert_tree_close(
        {t: {"w": w} for t, w in TL.merge_lora(tp["layers"], tads[0],
                                               tlc).items()},
        {t: {"w": w} for t, w in JL.merge_lora(jp["layers"], jads[0],
                                               jlc).items()}, 1e-6)


def test_write_adapter_slot_refuses_mismatches_and_writes_nothing(model):
    _jp, _tp, lc, _jbank, bank = model
    planes = TL.init_adapter_planes(TCFG, lc, 3, "cpu")
    wrong_rank = TL.random_lora_params(torch.Generator().manual_seed(1),
                                       TCFG, TL.LoRAConfig(rank=8),
                                       device="cpu")
    with pytest.raises(ValueError, match="shape"):
        TL.write_adapter_slot(planes, 1, wrong_rank)
    wrong_target = dict(bank["t0"], wk=bank["t0"]["wq"])
    with pytest.raises(ValueError, match="do not match"):
        TL.write_adapter_slot(planes, 1, wrong_target)
    assert not any(v.any() for p in planes.values() for v in p.values())
    assert TL.write_adapter_slot(planes, 2, bank["t0"]) is planes


def test_port_adapters_have_the_reference_shapes(model):
    _jp, _tp, lc, jbank, _bank = model
    gen = torch.Generator().manual_seed(0)
    init = TL.init_lora_params(gen, TCFG, lc, "cpu")
    rand = TL.random_lora_params(gen, TCFG, lc, device="cpu")
    for t, pair in jbank["t0"].items():
        for k, w in pair.items():
            assert tuple(init[t][k].shape) == w.shape
            assert tuple(rand[t][k].shape) == w.shape
    assert not init["wq"]["b"].any() and rand["wq"]["b"].any()
    assert init["wq"]["a"].std().item() == pytest.approx(
        TCFG.d_model ** -0.5, rel=0.2)


def test_forward_step_and_prefill_chunk_with_lora_match_jax(model):
    jp, tp, lc, jbank, _bank = model
    jlc = JL.LoRAConfig(rank=4)
    jplanes = JL.stack_adapters([jax.tree.map(jnp.zeros_like, jbank["t0"]),
                                 jbank["t0"], jbank["t1"]], JCFG, jlc)
    tplanes = _torch(jplanes)
    idx = np.array([2, 0, 1])
    tokens = np.random.default_rng(5).integers(0, 256, (3, 7))
    jlora = {"planes": jplanes, "idx": jnp.asarray(idx), "scale": jlc.scale}
    tlora = {"planes": tplanes, "idx": torch.from_numpy(idx),
             "scale": lc.scale}
    jl, _ = JG.forward_step(jp, jnp.asarray(tokens, jnp.int32),
                            JG.init_cache(JCFG, 3, 12), JCFG, lora=jlora)
    tl, _ = TG.forward_step(tp, torch.from_numpy(tokens),
                            TG.init_cache(TCFG, 3, 12, "cpu"), TCFG,
                            lora=tlora)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    # the paged chunk: one lane on t1 over a table with context
    rng = np.random.default_rng(9)
    shape = (TCFG.n_layers, 6, 4, TCFG.n_kv_heads, TCFG.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    table = np.array([2, 4, 5], np.int64)
    chunk = tokens[:1, :4]
    jkp, jvp, jcl = JG.paged_prefill_chunk(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table, jnp.int32),
        jnp.asarray(chunk, jnp.int32), 4, JCFG,
        lora=dict(jlora, idx=jnp.asarray([2])))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, _, tcl = TG.paged_prefill_chunk(
        tp, tkp, tvp, torch.from_numpy(table), torch.from_numpy(chunk), 4,
        TCFG, lora=dict(tlora, idx=torch.tensor([2])))
    np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), rtol=1e-4,
                               atol=1e-4)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-4,
                                   atol=1e-4)


def test_decode_step_with_lora_matches_jax(model):
    """Three lanes on [t1, null, t0] and one inactive lane."""
    jp, tp, lc, jbank, _bank = model
    jlc = JL.LoRAConfig(rank=4)
    jplanes = JL.stack_adapters([jax.tree.map(jnp.zeros_like, jbank["t0"]),
                                 jbank["t0"], jbank["t1"]], JCFG, jlc)
    bs, N = 4, 9
    rng = np.random.default_rng(13)
    shape = (TCFG.n_layers, N, bs, TCFG.n_kv_heads, TCFG.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    tables = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0], [7, 8, 0]],
                      np.int64)
    lengths = np.array([9, 2, 4, 6], np.int64)
    active = np.array([True, True, True, False])
    tokens = np.array([17, 4, 250, 9], np.int64)
    idx = np.array([2, 0, 1, 0])
    jt, jkp, jvp, _ = JE.decode_step(
        jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables, jnp.int32),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(active),
        jnp.zeros(4, jnp.float32), jax.random.PRNGKey(0), JCFG, bs, 0,
        lora={"planes": jplanes, "idx": jnp.asarray(idx),
              "scale": jlc.scale})
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    nxt, _, _, _ = TE.decode_step(
        tp, torch.from_numpy(tokens), tkp, tvp, torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(active), None, None,
        TCFG, bs, 0, lora={"planes": _torch(jplanes),
                           "idx": torch.from_numpy(idx),
                           "scale": lc.scale})
    assert nxt.tolist() == np.asarray(jt).tolist()
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-5,
                                   atol=1e-5)


# -- adapter engines against the JAX adapter engine --------------------------

HETERO = [([5, 17, 101, 9], "t0"), ([42, 7, 19, 23, 88], "t1"),
          ([200, 201, 202], None), (list(range(1, 21)), "t2")]


def test_adapter_engine_matches_jax_and_dedicated_merged_engines(model):
    """Four requests, three adapters and the base model, in one engine of
    three slots: heterogeneous steps gather, and once only one adapter is
    left the step runs on its merged weights."""
    jp, _tp, _lc, jbank, _bank = model
    outs = {}
    for M in (JE, TE):
        if M is JE:
            pool = JA.AdapterPool(jp, JCFG, JL.LoRAConfig(rank=4),
                                  loader=lambda a: jbank[a], capacity=4)
            eng = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(
                slots=3, **ENGINE_KW), adapters=pool)
        else:
            eng = _engine(model, _pool(model), start=False)
        reqs = [eng.submit(M.Request(p, max_new_tokens=8, adapter_id=a,
                                     tenant=a or "base"))
                for p, a in HETERO]
        eng.start()
        try:
            outs[M] = [r.wait(timeout=WAIT) for r in reqs]
        finally:
            eng.stop()
        assert eng._gathered_steps > 0
        assert eng.pool.used() == 0
        if M is TE:
            assert eng._merged_steps > 0
            assert (eng._gathered_steps, eng._merged_steps) == counts
        counts = (eng._gathered_steps, eng._merged_steps)
    assert outs[TE] == outs[JE]
    for (prompt, adapter), out in zip(HETERO, outs[TE]):
        assert out == _merged_reference(model, adapter, prompt, 8)


class TestGatheredEquivalence:
    def test_homogeneous_batch_takes_merged_fallback(self, model):
        engine = _engine(model, _pool(model), slots=2)
        try:
            r1 = engine.submit(TE.Request([5, 17, 101, 9], max_new_tokens=8,
                                          adapter_id="t2"))
            r2 = engine.submit(TE.Request([42, 7, 19], max_new_tokens=8,
                                          adapter_id="t2"))
            o1, o2 = r1.wait(timeout=WAIT), r2.wait(timeout=WAIT)
        finally:
            engine.stop()
        assert engine._merged_steps > 0
        assert engine._gathered_steps == 0
        assert o1 == _merged_reference(model, "t2", [5, 17, 101, 9], 8)
        assert o2 == _merged_reference(model, "t2", [42, 7, 19], 8)

    def test_batch_composition_does_not_change_output(self, model):
        prompt = [3, 1, 4, 1, 5]
        solo = _merged_reference(model, "t1", prompt, 8)
        engine = _engine(model, _pool(model))
        try:
            hetero = [engine.submit(TE.Request(prompt, max_new_tokens=8,
                                               adapter_id="t1")),
                      engine.submit(TE.Request([9, 9, 9], max_new_tokens=8,
                                               adapter_id="t3"))]
            assert hetero[0].wait(timeout=WAIT) == solo
            hetero[1].wait(timeout=WAIT)
        finally:
            engine.stop()


class TestAdapterPool:
    def test_lru_eviction_past_capacity(self, model):
        pool = _pool(model, capacity=2)
        pool.acquire("t0")
        pool.release("t0")
        pool.acquire("t1")
        pool.release("t1")
        assert pool.resident() == ["t0", "t1"]
        pool.acquire("t2")             # t0 is least recently used
        assert pool.resident() == ["t1", "t2"]
        assert pool.slot("t1") != pool.slot("t2")
        assert 0 not in (pool.slot("t1"), pool.slot("t2"))
        # the evicted slot now holds t2 in place
        bank = model[4]
        assert torch.equal(pool.planes["wq"]["a"][:, pool.slot("t2")],
                           bank["t2"]["wq"]["a"])

    def test_pinned_adapters_are_not_evictable(self, model):
        pool = _pool(model, capacity=1)
        pool.acquire("t0")
        with pytest.raises(AdapterSlotsExhausted):
            pool.acquire("t1")
        pool.release("t0")
        assert pool.acquire("t1") == pool.slot("t1")
        assert pool.resident() == ["t1"]

    def test_resident_reacquire_is_cheap_and_refcounted(self, model):
        loads = []

        def loader(aid):
            loads.append(aid)
            return model[4][aid]

        pool = _pool(model, capacity=2, loader=loader)
        pool.acquire("t0")
        pool.acquire("t0")
        assert loads == ["t0"]
        pool.release("t0")
        pool.acquire("t1")
        with pytest.raises(AdapterSlotsExhausted):
            pool.acquire("t2")
        pool.release("t0")
        pool.release("t1")
        pool.acquire("t2")
        assert loads == ["t0", "t1", "t2"]
        assert pool.resident() == ["t1", "t2"]

    def test_load_failure_returns_slot_and_raises(self, model):
        def loader(aid):
            if aid == "bad":
                raise OSError("checkpoint unreadable")
            return model[4][aid]

        pool = _pool(model, capacity=1, loader=loader)
        with pytest.raises(AdapterLoadError):
            pool.acquire("bad")
        assert pool.acquire("t0") > 0
        assert pool.resident() == ["t0"]

    def test_mismatched_adapter_fails_as_load_error_no_slot_leak(
            self, model):
        wrong = TL.random_lora_params(torch.Generator().manual_seed(9),
                                      TCFG, TL.LoRAConfig(rank=8),
                                      device="cpu")
        pool = _pool(model, capacity=1,
                     loader=lambda a: wrong if a == "wrong" else model[4][a])
        with pytest.raises(AdapterLoadError):
            pool.acquire("wrong")
        assert pool.resident() == []
        assert pool.acquire("t0") > 0

    def test_merged_cache_rides_residency(self, model):
        pool = _pool(model, capacity=2)
        pool.acquire("t0")
        first = pool.merged("t0")
        assert pool.merged("t0") is first
        assert pool.merged(None) is model[1]
        pool.release("t0")
        pool.acquire("t1")
        pool.release("t1")
        pool.acquire("t2")             # evicts t0 (LRU)
        assert "t0" not in pool._merged

    def test_checkpoint_loader_waits_on_the_checkpoint_slice(self, model,
                                                            tmp_path):
        """The loader is ported (tests/test_torch_checkpoint.py serves an
        imported adapter): an adapter without a directory fails its load
        as an AdapterLoadError.  The name dates from before the port and
        is kept, so that the test's history follows it."""
        load = checkpoint_loader(str(tmp_path), TCFG, model[2])
        with pytest.raises(AdapterLoadError, match="no checkpoint"):
            load("absent")


class TestLoadFailureFailsRequestNotEngine:
    def test_unknown_adapter_fails_request_engine_lives(self, model):
        engine = _engine(model, _pool(model))
        try:
            bad = engine.submit(TE.Request([1, 2, 3], max_new_tokens=4,
                                           adapter_id="no-such-adapter"))
            with pytest.raises(AdapterLoadError):
                bad.wait(timeout=WAIT)
            out = engine.generate([1, 2, 3], max_new_tokens=4)
            assert out == _merged_reference(model, None, [1, 2, 3], 4)
        finally:
            engine.stop()
        _free(engine)

    def test_armed_fault_at_lora_load_seam(self, model):
        engine = _engine(model, _pool(model))
        plan = TP.FaultPlan([TP.FaultPoint("serve.lora.load", "raise",
                                           times=1)])
        try:
            with TS.armed(plan):
                bad = engine.submit(TE.Request([1, 2, 3], max_new_tokens=4,
                                               adapter_id="t0"))
                with pytest.raises(AdapterLoadError):
                    bad.wait(timeout=WAIT)
                out = engine.submit(TE.Request(
                    [1, 2, 3], max_new_tokens=4,
                    adapter_id="t0")).wait(timeout=WAIT)
            assert out == _merged_reference(model, "t0", [1, 2, 3], 4)
        finally:
            engine.stop()


class TestPrefixTenantIsolation:
    def test_identical_prompts_different_adapters_share_nothing(self, model):
        prompt = list(range(1, 18))          # 17 tokens = 2 full blocks
        engine = _engine(model, _pool(model), slots=1)
        try:
            a1 = engine.submit(TE.Request(prompt, max_new_tokens=2,
                                          adapter_id="t0"))
            a1.wait(timeout=WAIT)
            b = engine.submit(TE.Request(prompt, max_new_tokens=2,
                                         adapter_id="t1"))
            b.wait(timeout=WAIT)
            assert b.prefix_tokens == 0 and b.prefix_blocks == 0
            base = engine.submit(TE.Request(prompt, max_new_tokens=2))
            base.wait(timeout=WAIT)
            assert base.prefix_tokens == 0
            a2 = engine.submit(TE.Request(prompt, max_new_tokens=2,
                                          adapter_id="t0"))
            a2.wait(timeout=WAIT)
            assert a2.prefix_tokens > 0
            assert a2.tokens == _merged_reference(model, "t0", prompt, 2)
        finally:
            engine.stop()

    def test_waits_for_a_pinned_slot_and_refuses_without_a_pool(self, model):
        """Two requests on two adapters with one plane slot: the second
        waits (AdapterSlotsExhausted) until the first releases; an engine
        without a pool refuses an adapter request at submit."""
        engine = _engine(model, _pool(model, capacity=1), slots=2,
                         start=False)
        reqs = [engine.submit(TE.Request([1, 2, 3], max_new_tokens=6,
                                         adapter_id=a))
                for a in ("t0", "t1")]
        engine.start()
        try:
            outs = [r.wait(timeout=WAIT) for r in reqs]
        finally:
            engine.stop()
        assert reqs[1].admitted_mono > reqs[0].done_mono
        for out, a in zip(outs, ("t0", "t1")):
            assert out == _merged_reference(model, a, [1, 2, 3], 6)
        plain = TE.DecodeEngine(model[1], TCFG, TE.EngineConfig(slots=1),
                                device="cpu")
        with pytest.raises(TE.RequestRejected) as exc:
            plain.submit(TE.Request([1], adapter_id="t0")).wait(WAIT)
        assert exc.value.reason == "adapter"
        plain.stop()


class TestAdapterPlanes:
    def test_write_and_clear_slot_roundtrip(self, model):
        _jp, _tp, lc, _jbank, bank = model
        planes = TL.init_adapter_planes(TCFG, lc, 3, "cpu")
        TL.write_adapter_slot(planes, 1, bank["t0"])
        a = planes["wq"]["a"]
        assert a[:, 1].abs().max() > 0
        assert a[:, 0].abs().max() == 0       # null slot untouched
        assert a[:, 2].abs().max() == 0
        TL.clear_adapter_slot(planes, 1)
        assert planes["wq"]["a"][:, 1].abs().max() == 0

    def test_stack_adapters_layer_axis_leads(self, model):
        _jp, _tp, lc, _jbank, bank = model
        planes = TL.stack_adapters([bank["t0"], bank["t1"]], TCFG, lc)
        a = planes["wq"]["a"]
        assert a.shape[0] == TCFG.n_layers and a.shape[1] == 2
        with pytest.raises(ValueError, match="at least one"):
            TL.stack_adapters([], TCFG, lc)


class TestSpecAdapterGuard:
    """A request carrying an adapter_id speculates only with a registered
    per-adapter draft, and is then verified against the merged target."""

    def _spec_engine(self, model, pool, adapter_drafts=None, slots=3):
        tp = model[1]
        engine = TE.DecodeEngine(
            tp, TCFG, TE.EngineConfig(slots=slots, spec=TE.SpecConfig(k=3),
                                      **ENGINE_KW),
            draft=(tp, TCFG), adapters=pool, adapter_drafts=adapter_drafts,
            device="cpu")
        engine.start()
        return engine

    def test_base_speculates_beside_an_unmatched_adapter(self, model):
        engine = self._spec_engine(model, _pool(model))
        try:
            base = engine.submit(TE.Request(list(range(2, 11)),
                                            max_new_tokens=8))
            worn = engine.submit(TE.Request(list(range(3, 12)),
                                            max_new_tokens=8,
                                            adapter_id="t1"))
            base_out = base.wait(timeout=WAIT)
            worn_out = worn.wait(timeout=WAIT)
        finally:
            engine.stop()
        assert base.draft_tokens > 0
        assert base.accepted_tokens == base.draft_tokens
        assert worn.draft_tokens == 0 and worn.spec_steps == 0
        assert base_out == _merged_reference(model, None,
                                             list(range(2, 11)), 8)
        assert worn_out == _merged_reference(model, "t1",
                                             list(range(3, 12)), 8)
        _free(engine)

    def test_registered_adapter_draft_speculates(self, model):
        engine = self._spec_engine(model, _pool(model),
                                   adapter_drafts={"t1": _merged(model,
                                                                 "t1")})
        try:
            prompt = list(range(4, 13))
            req = engine.submit(TE.Request(prompt, max_new_tokens=8,
                                           adapter_id="t1"))
            out = req.wait(timeout=WAIT)
            other = engine.submit(TE.Request(prompt, max_new_tokens=8,
                                             adapter_id="t0"))
            other_out = other.wait(timeout=WAIT)
        finally:
            engine.stop()
        # the t1 draft IS the t1-merged target: every proposal accepted
        assert req.draft_tokens > 0
        assert req.accepted_tokens == req.draft_tokens
        assert out == _merged_reference(model, "t1", prompt, 8)
        assert other.draft_tokens == 0
        assert other_out == _merged_reference(model, "t0", prompt, 8)

    def test_adapter_drafts_validation(self, model):
        tp = model[1]
        with pytest.raises(ValueError, match="spec"):
            TE.DecodeEngine(tp, TCFG, TE.EngineConfig(slots=1, **ENGINE_KW),
                            adapters=_pool(model),
                            adapter_drafts={"t0": tp}, device="cpu")
        with pytest.raises(ValueError, match="adapter pool"):
            TE.DecodeEngine(tp, TCFG, TE.EngineConfig(
                slots=1, spec=TE.SpecConfig(k=3), **ENGINE_KW),
                draft=(tp, TCFG), adapter_drafts={"t0": tp}, device="cpu")


def test_params_from_jax_carries_adapters_planes_and_draft_params():
    """A JAX adapter tree, its stacked [L, A, ...] planes (in bf16 too) and
    a draft model's params cross by `convert.params_from_jax` as they are:
    same keys, shapes and values, bf16 bit for bit."""
    jlc = JL.LoRAConfig(rank=4, targets=ALL)
    adapter = JL.random_lora_params(jax.random.PRNGKey(21), JCFG, jlc)
    planes = JL.stack_adapters([adapter, adapter], JCFG, jlc)
    bf16 = jax.tree.map(lambda w: w.astype(jnp.bfloat16), planes)
    draft = JT.init_params(jax.random.PRNGKey(3), JCFG)
    for tree in (adapter, planes, bf16, draft):
        got = _torch(tree)
        back = convert.params_to_numpy(got)
        for (path, want), leaf in zip(
                jax.tree_util.tree_flatten_with_path(_np(tree))[0],
                jax.tree.leaves(back)):
            assert leaf.shape == want.shape, path
            np.testing.assert_array_equal(leaf, want.astype(np.float32))
    assert _torch(bf16)["wq"]["a"].dtype == torch.bfloat16
    assert _torch(planes)["wo"]["b"].shape == (JCFG.n_layers, 2, 4,
                                               JCFG.d_model)
