"""Port parity: the serving fabric over port engines — the copied
`serve/fabric.py`, `serve/router.py` and `serve/replicas.py` driving
`cloudtik_tpu_torch` prefill-role and decode-role engines, as
tests/test_fabric.py drives the JAX package's.

`tiny` in fp32 on the CPU, one intra-op thread, parameters from the JAX
`init_params(PRNGKey(0))`.  Prompt-heavy requests take the fabric hop
(prefill replica -> socket KV migration -> decode replica) and short ones
go direct, with greedy tokens equal to the port's monolithic `generate`
and to a JAX fabric's; a torn migration falls back on the same decode
replica; a dead decode target is excluded while the healthy prefill
replica carries the retry; a prefill replica killed mid-traffic leaves
every request answered right (checked by outcome, never by timing: the
reference's own drill of this is load-timed).  Every wait is bounded.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.control import state as JS
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu.serve import fabric as JF
from cloudtik_tpu.serve import replicas as JR
from cloudtik_tpu.serve import router as JRT
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.control.state import (
    InMemoryStateBackend, StateClient)
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import fabric
from cloudtik_tpu_torch.serve import reqlog
from cloudtik_tpu_torch.serve.replicas import (
    AutoscalerConfig, ReplicaAutoscaler, ReplicaRegistry)
from cloudtik_tpu_torch.serve.router import (
    ReplicaClient, ReplicaDraining, ReplicaUnavailable, Router,
    RouterConfig, chain_hash)
from cloudtik_tpu_torch.telemetry import instruments as ti

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60          # seconds: every wait is bounded
PREFILL_EC = dict(max_len=64, prefill_buckets=(8, 16, 32, 64),
                  chunk_size=64, block_size=8)
DECODE_EC = dict(max_len=64, prefill_buckets=(8, 16), block_size=8)


@pytest.fixture(autouse=True)
def _disarmed():
    seams.disarm()
    yield
    seams.disarm()


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def make_registry() -> ReplicaRegistry:
    return ReplicaRegistry(StateClient(InMemoryStateBackend()))


def make_prefill(tp, replica_id="p0", slots=2, blocks=25,
                 frame_delay_s=0.0, adapters=None):
    engine = TE.DecodeEngine(
        tp, TCFG, TE.EngineConfig(slots=slots, num_blocks=blocks,
                                  **PREFILL_EC),
        migrator=fabric.FabricMigrator(frame_delay_s=frame_delay_s),
        adapters=adapters, device="cpu")
    engine.start()
    return fabric.PrefillReplica(replica_id, engine)


def make_decode(tp, replica_id="d0", slots=3, blocks=49, adapters=None):
    engine = TE.DecodeEngine(
        tp, TCFG, TE.EngineConfig(slots=slots, num_blocks=blocks,
                                  **DECODE_EC),
        role="decode", adapters=adapters, device="cpu")
    engine.start()
    return fabric.DecodeReplica(replica_id, engine)


def make_fabric_router(prefills, decodes, registry=None, autoscaler=None,
                       router_cls=Router, config_cls=RouterConfig,
                       **config_kw):
    config_kw.setdefault("block_size", 8)
    config_kw.setdefault("prefill_len_threshold", 16)
    config_kw.setdefault("request_deadline_s", 120)
    router = router_cls(registry or make_registry(),
                        config_cls(**config_kw), autoscaler=autoscaler)
    for replica in prefills:
        router.add_client(replica, role="prefill", slots=2)
    for replica in decodes:
        router.add_client(replica, role="decode", slots=3)
    return router


_REF: Dict[tuple, List[int]] = {}


def reference(tp, prompt, max_new):
    key = (tuple(prompt), max_new)
    if key not in _REF:
        _REF[key] = TG.generate(tp, torch.tensor([prompt]), TCFG,
                                max_new_tokens=max_new)[0].tolist()
    return _REF[key]


@pytest.fixture(scope="module")
def fleet(params):
    """Shared 1-prefill + 2-decode port fabric (counter assertions use
    before/after deltas)."""
    prefill = make_prefill(params[1])
    decodes = [make_decode(params[1], f"d{i}") for i in range(2)]
    router = make_fabric_router([prefill], decodes)
    yield router, prefill, decodes
    prefill.stop()
    for replica in decodes:
        replica.stop()


def _paths():
    return {p: ti.SERVE_FABRIC_REQUESTS.value(path=p)
            for p in ("migrated", "fallback", "direct")}


MIXED = [[i * 7 + j for j in range(20)] if i % 2 == 0
         else [i * 5 + j for j in range(5)] for i in range(8)]


class TestFabricBitIdentity:
    def test_prompt_heavy_migrates_bit_identical(self, fleet, params):
        router, _prefill, _decodes = fleet
        before = _paths()
        prompt = list(range(3, 30))            # 27 tokens: heavy
        out = router.handle({"tokens": prompt, "max_new_tokens": 8})
        assert out["tokens"][0] == reference(params[1], prompt, 8)
        assert out["fabric_path"] == "migrated"
        after = _paths()
        assert after["migrated"] == before["migrated"] + 1
        assert after["fallback"] == before["fallback"]
        assert after["direct"] == before["direct"]

    def test_short_prompt_forwards_direct(self, fleet, params):
        router, _prefill, _decodes = fleet
        before = _paths()
        prompt = [5, 6, 7, 8, 9]               # below the threshold
        out = router.handle({"tokens": prompt, "max_new_tokens": 6})
        assert out["tokens"][0] == reference(params[1], prompt, 6)
        assert _paths() == before

    def test_prefix_reused_prompts_bit_identical(self, fleet, params):
        router, _prefill, _decodes = fleet
        base = list(range(40, 56))             # two full blocks
        a = base + [100, 101, 102, 103, 104]
        b = base + [110, 111, 112, 113, 114]
        hits0 = ti.SERVE_PREFIX_HITS.value()
        out_a = router.handle({"tokens": a, "max_new_tokens": 8})
        out_b = router.handle({"tokens": b, "max_new_tokens": 8})
        assert out_a["tokens"][0] == reference(params[1], a, 8)
        assert out_b["tokens"][0] == reference(params[1], b, 8)
        assert ti.SERVE_PREFIX_HITS.value() > hits0

    def test_concurrent_mixed_traffic_equals_the_jax_fabric(self, fleet,
                                                            params):
        """The same mixed traffic through the port's fabric and a JAX
        fabric (JAX engines behind the JAX router): equal greedy tokens,
        each the monolith's."""
        router, _prefill, _decodes = fleet
        reqs = [TE.Request(list(p), max_new_tokens=6) for p in MIXED]
        for req in reqs:
            router.submit(req)
        got = [req.wait(timeout=WAIT) for req in reqs]
        jp = params[0]
        jprefill = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(
            slots=2, num_blocks=25, **PREFILL_EC),
            migrator=JF.FabricMigrator())
        jdecode = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(
            slots=3, num_blocks=49, **DECODE_EC), role="decode")
        jprefill.start()
        jdecode.start()
        prefill = JF.PrefillReplica("p0", jprefill)
        decode = JF.DecodeReplica("d0", jdecode)
        jrouter = make_fabric_router(
            [prefill], [decode], registry=JR.ReplicaRegistry(
                JS.StateClient(JS.InMemoryStateBackend())),
            router_cls=JRT.Router, config_cls=JRT.RouterConfig)
        try:
            jreqs = [JE.Request(list(p), max_new_tokens=6) for p in MIXED]
            for req in jreqs:
                jrouter.submit(req)
            want = [req.wait(timeout=WAIT) for req in jreqs]
        finally:
            prefill.stop()
            decode.stop()
        assert got == want
        for prompt, out in zip(MIXED, got):
            assert out == reference(params[1], prompt, 6)

    def test_adapter_bearing_prompt_matches_merged_reference(self, params):
        from cloudtik_tpu_torch.models import lora as TL
        from cloudtik_tpu_torch.serve.adapters import AdapterPool

        tp = params[1]
        lora_cfg = TL.LoRAConfig(rank=4)
        bank = {"tA": TL.random_lora_params(
            torch.Generator().manual_seed(11), TCFG, lora_cfg,
            device="cpu")}

        def pool():
            return AdapterPool(tp, TCFG, lora_cfg,
                               loader=lambda aid: bank[aid], capacity=2)

        prefill = make_prefill(tp, "pA", adapters=pool())
        decode = make_decode(tp, adapters=pool())
        router = make_fabric_router([prefill], [decode])
        try:
            prompt = list(range(7, 31))        # 24 tokens: heavy
            before = _paths()
            out = router.handle({"tokens": prompt, "max_new_tokens": 8,
                                 "adapter": "tA"})
            merged = dict(tp, layers=TL.merge_lora(tp["layers"],
                                                   bank["tA"], lora_cfg))
            assert out["tokens"][0] == reference(merged, prompt, 8)
            assert _paths()["migrated"] == before["migrated"] + 1
        finally:
            prefill.stop()
            decode.stop()


# -------------------------------------------------- role policy (fakes) --

class FakeReplica(ReplicaClient):
    def __init__(self, replica_id: str,
                 fail_with: Optional[BaseException] = None):
        self.replica_id = replica_id
        self.fail_with = fail_with
        self.forwards: List[Dict] = []
        self.healthy = True

    def forward(self, payload, timeout_s, traceparent=None):
        self.forwards.append(dict(payload))
        if self.fail_with is not None:
            raise self.fail_with
        return {"tokens": [[7, 8, 9]], "request_id": 1}

    def health(self, timeout_s=2.0):
        return self.healthy


class FakeDecode(FakeReplica):
    """Decode-capable fake that speaks the fabric ticket surface."""

    def expect(self, origin_id):
        raise AssertionError("the router never calls expect directly")

    def forget(self, origin_id):
        pass


class FakePrefill(FakeReplica):
    def __init__(self, replica_id: str,
                 fail_with: Optional[BaseException] = None):
        super().__init__(replica_id, fail_with)
        self.handoffs: List[Dict] = []

    def forward_to(self, payload, decode_replica, timeout_s,
                   traceparent=None):
        self.handoffs.append({"payload": dict(payload),
                              "decode": decode_replica.replica_id})
        if self.fail_with is not None:
            raise self.fail_with
        return {"tokens": [[1, 2, 3]], "request_id": 2}


HEAVY = {"tokens": list(range(1, 33)), "max_new_tokens": 4}
SHORT = {"tokens": [1, 2, 3, 4], "max_new_tokens": 4}


class TestRolePolicy:
    def _router(self, prefills, decodes):
        router = Router(make_registry(), RouterConfig(
            prefill_len_threshold=16, block_size=8))
        for replica in prefills:
            router.add_client(replica, role="prefill", slots=2)
        for replica in decodes:
            router.add_client(replica, role="decode", slots=4)
        return router

    def test_prompt_heavy_takes_the_fabric_hop(self):
        prefill, decode = FakePrefill("p0"), FakeDecode("d0")
        out = self._router([prefill], [decode]).handle(dict(HEAVY))
        assert out["tokens"] == [[1, 2, 3]]
        assert [h["decode"] for h in prefill.handoffs] == ["d0"]
        assert decode.forwards == []

    def test_short_prompt_and_no_prefill_role_route_direct(self):
        prefill, decode = FakePrefill("p0"), FakeDecode("d0")
        out = self._router([prefill], [decode]).handle(dict(SHORT))
        assert out["tokens"] == [[7, 8, 9]]
        assert prefill.handoffs == [] and len(decode.forwards) == 1
        alone = FakeDecode("d1")
        direct0 = ti.SERVE_FABRIC_REQUESTS.value(path="direct")
        self._router([], [alone]).handle(dict(HEAVY))
        assert len(alone.forwards) == 1
        assert ti.SERVE_FABRIC_REQUESTS.value(path="direct") == direct0

    @pytest.mark.parametrize("error", [
        ReplicaUnavailable("prefill died"), ReplicaDraining("draining")],
        ids=["unavailable", "draining"])
    def test_prefill_failure_degrades_direct(self, error):
        prefill = FakePrefill("p0", fail_with=error)
        decode = FakeDecode("d0")
        direct0 = ti.SERVE_FABRIC_REQUESTS.value(path="direct")
        out = self._router([prefill], [decode]).handle(dict(HEAVY))
        assert out["tokens"] == [[7, 8, 9]]
        assert len(prefill.handoffs) == 1 and len(decode.forwards) == 1
        if isinstance(error, ReplicaUnavailable):
            assert ti.SERVE_FABRIC_REQUESTS.value(path="direct") \
                == direct0 + 1

    def test_decode_without_receiver_routes_direct(self):
        prefill, plain = FakePrefill("p0"), FakeReplica("d0")
        out = self._router([prefill], [plain]).handle(dict(HEAVY))
        assert out["tokens"] == [[7, 8, 9]]
        assert prefill.handoffs == [] and len(plain.forwards) == 1


# ------------------------------------------------------ torn migration --

class TestTornMigration:
    def test_torn_stream_falls_back_on_the_same_decode(self, params,
                                                       tmp_path):
        """Fault at `serve.kvcache.migrate` mid-stream: the decode replica
        re-prefills the request as a plain submit, the router never
        double-routes, the ledger finishes `done` once, both pools end
        free."""
        tp = params[1]
        prefill = make_prefill(tp)
        decode = make_decode(tp)
        router = make_fabric_router([prefill], [decode])
        path = str(tmp_path / "req.jsonl")
        reqlog.install(path)
        prompt = list(range(5, 29))            # 24 tokens: heavy
        before = _paths()
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        failovers0 = ti.SERVE_ROUTER_FAILOVERS.value()
        plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                     at_call=2, times=1)])
        try:
            with seams.armed(plan):
                out = router.handle({"tokens": prompt,
                                     "max_new_tokens": 8})
            assert plan.points[0].fired == 1
            assert out["tokens"][0] == reference(tp, prompt, 8)
            assert out["fabric_path"] == "fallback"
            after = _paths()
            assert after["fallback"] == before["fallback"] + 1
            assert after["migrated"] == before["migrated"]
            assert ti.SERVE_KV_MIGRATION_FAILURES.value() == failures0 + 1
            assert ti.SERVE_ROUTER_FAILOVERS.value() == failovers0
            deadline = time.monotonic() + WAIT
            while time.monotonic() < deadline and (
                    prefill.engine.pool.used()
                    or decode.engine.pool.used()):
                time.sleep(0.02)
            assert prefill.engine.pool.used() == 0
            assert decode.engine.pool.used() == 0
        finally:
            reqlog.uninstall()
            prefill.stop()
            decode.stop()
        records = reqlog.read_requests(path)
        assert [r["finish"] for r in records] == ["done"]
        assert reqlog.compute_stats(records)["availability"] == 1.0


# --------------------------------------------- decode and prefill kills --

class TestReplicaKills:
    def test_dead_decode_target_excludes_decode_not_prefill(self, params):
        tp = params[1]
        prefill = make_prefill(tp)
        decodes = [make_decode(tp, f"d{i}") for i in range(2)]
        router = make_fabric_router([prefill], decodes)
        try:
            victim = decodes[0]
            prompt = None
            for s in range(64):
                cand = [(s * 31 + j) % 240 + 1 for j in range(20)]
                client, _ = router._pick(chain_hash(cand, 8), set())
                if client.replica_id == victim.replica_id:
                    prompt = cand
                    break
            assert prompt is not None
            victim.kill()
            before = _paths()
            failovers0 = ti.SERVE_ROUTER_FAILOVERS.value()
            out = router.handle({"tokens": prompt, "max_new_tokens": 6})
            assert out["tokens"][0] == reference(tp, prompt, 6)
            after = _paths()
            assert after["migrated"] == before["migrated"] + 1
            assert after["direct"] == before["direct"]
            assert ti.SERVE_ROUTER_FAILOVERS.value() == failovers0 + 1
        finally:
            prefill.stop()
            for replica in decodes:
                replica.stop()

    def test_prefill_killed_mid_traffic_leaves_every_request_answered(
            self, params, tmp_path):
        """Kill the prefill replica with migrations in flight (a fat frame
        delay holds them open): every request still answers the
        monolith's tokens, through the decode replica or its fallback; no
        ledger record is an error; the registry condemns the dead replica
        and the autoscaler asks for its role.  Outcomes only: how many
        requests were in flight at the kill is the machine's business."""
        tp = params[1]
        prefill = make_prefill(tp, frame_delay_s=0.02)
        decode = make_decode(tp, slots=3)
        registry = make_registry()
        asks = []
        autoscaler = ReplicaAutoscaler(
            registry, ask=lambda d, r: asks.append((d, r)),
            config=AutoscalerConfig(min_replicas=1))
        router = make_fabric_router([prefill], [decode], registry=registry,
                                    autoscaler=autoscaler,
                                    probe_failures=2)
        path = str(tmp_path / "req.jsonl")
        reqlog.install(path)
        prompts = [[i * 9 + j for j in range(20)] for i in range(6)]
        try:
            reqs = [TE.Request(list(p), max_new_tokens=6) for p in prompts]
            for req in reqs:
                router.submit(req)
            time.sleep(0.05)
            prefill.kill()
            outs = [req.wait(timeout=WAIT) for req in reqs]
            for req, prompt, out in zip(reqs, prompts, outs):
                assert req.error is None
                assert out == reference(tp, prompt, 6)
            router.probe_cycle()
            router.probe_cycle()
            info = next(i for i in registry.list_replicas()
                        if i.replica_id == "p0")
            assert info.condemned == "probe_failed"
            assert (1, "lost_node") in asks
        finally:
            router.stop()
            reqlog.uninstall()
            prefill.stop()
            decode.stop()
        finishes = {r["finish"] for r in reqlog.read_requests(path)}
        assert not finishes & {"error", "drained"}


# ------------------------------------------------- replica surfaces --

class TestReplicaSurfaces:
    def test_prefill_replica_requires_fabric_migrator(self, params):
        engine = TE.DecodeEngine(params[1], TCFG, TE.EngineConfig(
            slots=1, **DECODE_EC), device="cpu")
        with pytest.raises(ValueError, match="FabricMigrator"):
            fabric.PrefillReplica("pX", engine)

    def test_prefill_replica_refuses_direct_forwards(self, fleet):
        _router, prefill, _decodes = fleet
        with pytest.raises(ReplicaDraining, match="prefill-role"):
            prefill.forward(dict(SHORT), timeout_s=5)

    def test_decode_replica_kill_fails_waiting_tickets(self, params):
        decode = make_decode(params[1], "dk")
        try:
            ticket = decode.expect(12345)
            decode.kill()
            assert ticket.event.wait(timeout=5)
            assert isinstance(ticket.error, ReplicaUnavailable)
        finally:
            decode.stop()

    def test_unstamped_request_is_refused_by_fabric_migrator(self):
        from cloudtik_tpu_torch.serve import migration

        class Req:
            request_id = 7
        with pytest.raises(migration.MigrationError,
                           match="no decode handoff"):
            fabric.FabricMigrator(async_send=False).export(
                Req(), first_token=0, length=0, k=None, v=None,
                block_size=8)
