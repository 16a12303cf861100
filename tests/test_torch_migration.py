"""Port parity: cloudtik_tpu_torch.serve.migration and the engine's
migration half, against the contracts of tests/test_migration.py.

`tiny` in fp32 on the CPU, one intra-op thread, parameters from the JAX
`init_params(PRNGKey(0))`.  The wire is the JAX package's byte for byte
(headers, blocks, commits, aborts); a request's KV state exported from one
port engine and imported into another is bit-identical, the pool
bookkeeping (refcounts, prefix registration, the copy-on-write boundary)
survives the crossing, and greedy decode continues as a monolith would.
Across frameworks, a JAX prefill-role engine feeds a port decode-role
engine over `SocketKVTransport` and the other way round: the continuation
equals the JAX monolith's in f32, and bf16 planes cross bit for bit both
ways (the port names bf16 through its own dtype table, not `ml_dtypes`).
Every wait is bounded.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudtik_tpu.models import generate as JG
from cloudtik_tpu.models import transformer as JT
from cloudtik_tpu.serve import engine as JE
from cloudtik_tpu.serve import migration as JM
from cloudtik_tpu_torch import convert
from cloudtik_tpu_torch.models import generate as TG
from cloudtik_tpu_torch.models import lora as TL
from cloudtik_tpu_torch.models import transformer as TT
from cloudtik_tpu_torch.serve import engine as TE
from cloudtik_tpu_torch.serve import migration as TM
from cloudtik_tpu_torch.serve import reqlog as TR
from cloudtik_tpu_torch.serve.adapters import AdapterPool

# one intra-op thread: a first multi-threaded CPU f32 exp can be off by
# ~1e-4 in one thread's chunk (tools/repro_torch_cpu_exp.py)
torch.set_num_threads(1)

JCFG = JT.config("tiny", dtype=jnp.float32, attention_impl="reference",
                 remat=False)
TCFG = TT.config("tiny", dtype=torch.float32)
WAIT = 60          # seconds: every wait is bounded
EC = dict(slots=2, max_len=32, prefill_buckets=(8,), block_size=4)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _reference(tp, prompt, max_new, cfg=TCFG):
    return TG.generate(tp, torch.tensor([prompt]), cfg,
                       max_new_tokens=max_new)[0].tolist()


def _until(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _bits(t):
    """A plane's raw bits as numpy integers (torch or numpy input)."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view({2: torch.int16, 4: torch.int32}[
            t.element_size()]).numpy()
    return np.asarray(t).view({2: np.int16, 4: np.int32}[
        np.asarray(t).dtype.itemsize])


def _planes(shape, dtype, seed):
    """The same values as a numpy array of the JAX package's dtype and as
    a torch tensor of the port's, bit for bit."""
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    if dtype == "bfloat16":
        j = np.asarray(jnp.asarray(x, jnp.bfloat16))
        return j, torch.from_numpy(j.view(np.int16).copy()).view(
            torch.bfloat16)
    return x, torch.from_numpy(x.copy())


class TestWireFormat:
    def test_header_commit_abort_bytes_equal_the_reference(self):
        meta = {"request_id": 7, "prompt": [1, 2, 3], "dtype": "bfloat16"}
        for name in ("pack_header",):
            assert getattr(TM, name)(meta) == getattr(JM, name)(meta)
        assert TM.pack_commit(7, blocks=3) == JM.pack_commit(7, blocks=3)
        assert TM.pack_abort(7) == JM.pack_abort(7)
        kind, got, k, v = TM.unpack(TM.pack_header(meta))
        assert kind == TM.MSG_HEADER and got == meta
        assert k is None and v is None
        kind, got, _k, _v = TM.unpack(JM.pack_commit(7, blocks=3))
        assert kind == TM.MSG_COMMIT and got == {"request_id": 7,
                                                 "blocks": 3}
        kind, got, _k, _v = TM.unpack(TM.pack_abort(7))
        assert kind == TM.MSG_ABORT and got["request_id"] == 7

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_block_bytes_equal_the_reference_and_round_trip(self, dtype):
        jk, tk = _planes((2, 4, 3, 5), dtype, 0)
        jv, tv = _planes((2, 4, 3, 5), dtype, 1)
        msg = TM.pack_block(9, 2, tk, tv)
        assert msg == JM.pack_block(9, 2, jk, jv)
        kind, meta, kb, vb = TM.unpack(msg)
        assert kind == TM.MSG_BLOCK and meta == {"request_id": 9, "seq": 2}
        got_k = kb.view(TM.DTYPES[dtype]).reshape(tk.shape)
        got_v = vb.view(TM.DTYPES[dtype]).reshape(tv.shape)
        assert np.array_equal(_bits(got_k), _bits(tk))
        assert np.array_equal(_bits(got_v), _bits(tv))
        # the JAX reader takes the port's frame as its own
        _kind, _meta, jkb, _jvb = JM.unpack(msg)
        assert np.array_equal(jkb.view(np.dtype(dtype)).view(
            _bits(jk).dtype).reshape(jk.shape), _bits(jk))

    def test_malformed_messages_and_dtypes_refuse(self):
        with pytest.raises(TM.MigrationError):
            TM.unpack(b"")
        with pytest.raises(TM.MigrationError):
            TM.unpack(b"XXXX\x00\x00\x00\x00")
        msg = TM.pack_block(1, 0, torch.zeros(1, 2), torch.zeros(1, 2))
        with pytest.raises(TM.MigrationError):
            TM.unpack(msg[:-4])
        with pytest.raises(TM.MigrationError):
            TM.unpack(msg[:20])
        with pytest.raises(TM.MigrationError, match="cannot migrate"):
            TM.pack_block(1, 0, torch.zeros(2, dtype=torch.int16),
                          torch.zeros(2, dtype=torch.int16))
        for name in ("uint16", "int16", None):
            with pytest.raises(TM.MigrationError, match="names dtype"):
                TM.wire_dtype(name)
        assert {TM.dtype_name(d): d for d in TM.DTYPES.values()} \
            == TM.DTYPES


class TestInbox:
    def _stream(self, rid=1, n_blocks=2, shape=(2, 1, 4, 3, 5),
                dtype="float32", pack=TM):
        """(header_msg, block_msgs, commit_msg, k_ref, v_ref), packed by
        `pack` (the port's module or the JAX package's)."""
        L, _M, bs, H, D = shape
        jk, tk = _planes((L, n_blocks, bs, H, D), dtype, rid)
        jv, tv = _planes((L, n_blocks, bs, H, D), dtype, rid + 100)
        k, v = (tk, tv) if pack is TM else (jk, jv)
        header = {"request_id": rid, "dtype": dtype,
                  "n_layers": L, "block_size": bs, "n_kv_heads": H,
                  "head_dim": D, "blocks": n_blocks}
        blocks = [pack.pack_block(rid, j, k[:, j], v[:, j])
                  for j in range(n_blocks)]
        return (pack.pack_header(header), blocks,
                pack.pack_commit(rid, n_blocks), tk, tv)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("pack", [TM, JM], ids=["port", "jax"])
    def test_commit_delivers_planes_bit_identical(self, dtype, pack):
        got = []
        inbox = TM.MigrationInbox(lambda h, k, v: got.append((h, k, v)))
        header, blocks, commit, k_ref, v_ref = self._stream(
            dtype=dtype, pack=pack)
        inbox.feed(header)
        for msg in blocks:
            inbox.feed(msg)
        assert got == []                  # nothing until commit
        inbox.feed(commit)
        (h, k, v), = got
        assert h["request_id"] == 1
        assert k.dtype == TM.DTYPES[dtype] and k.shape == k_ref.shape
        assert np.array_equal(_bits(k), _bits(k_ref))
        assert np.array_equal(_bits(v), _bits(v_ref))

    def test_port_stream_reads_back_through_the_jax_inbox(self):
        got = []
        inbox = JM.MigrationInbox(lambda h, k, v: got.append((k, v)))
        header, blocks, commit, k_ref, v_ref = self._stream(
            dtype="bfloat16")
        for msg in [header, *blocks, commit]:
            inbox.feed(msg)
        (k, v), = got
        assert k.dtype == jnp.bfloat16
        assert np.array_equal(_bits(k), _bits(k_ref))
        assert np.array_equal(_bits(v), _bits(v_ref))

    def test_abort_drops_the_partial_stream(self):
        got = []
        inbox = TM.MigrationInbox(lambda h, k, v: got.append(h))
        header, blocks, commit, _k, _v = self._stream()
        inbox.feed(header)
        inbox.feed(blocks[0])
        inbox.feed(TM.pack_abort(1))
        with pytest.raises(TM.MigrationError):
            inbox.feed(commit)
        assert got == []

    def test_commit_with_missing_blocks_or_unknown_dtype_refuses(self):
        inbox = TM.MigrationInbox(lambda h, k, v: None)
        header, blocks, commit, _k, _v = self._stream(n_blocks=3)
        inbox.feed(header)
        inbox.feed(blocks[0])
        inbox.feed(blocks[2])             # seq 1 never arrives
        with pytest.raises(TM.MigrationError):
            inbox.feed(commit)
        # an integer view's name (what an exporter handing numpy a uint16
        # view of bf16 would write) is refused at the header, so the
        # stream can never be cast into a pool
        _h, blocks, commit, _k, _v = self._stream(rid=2)
        with pytest.raises(TM.MigrationError, match="names dtype"):
            inbox.feed(TM.pack_header({
                "request_id": 2, "dtype": "uint16", "n_layers": 2,
                "block_size": 4, "n_kv_heads": 3, "head_dim": 5,
                "blocks": 2}))
        for msg in [*blocks, commit]:
            with pytest.raises(TM.MigrationError, match="no header"):
                inbox.feed(msg)
        # a block whose bytes do not fill its geometry is refused
        header, blocks, _commit, _k, _v = self._stream(rid=3)
        inbox.feed(header)
        with pytest.raises(TM.MigrationError, match="bytes"):
            inbox.feed(TM.pack_block(3, 0, torch.zeros(2, 4, 3, 4),
                                     torch.zeros(2, 4, 3, 4)))

    def test_block_without_header_refuses(self):
        inbox = TM.MigrationInbox(lambda h, k, v: None)
        _header, blocks, _commit, _k, _v = self._stream()
        with pytest.raises(TM.MigrationError):
            inbox.feed(blocks[0])


def _engine_pair(tp, ec=EC, adapters=(None, None)):
    """(prefill_engine, decode_engine, delivered): UNSTARTED port engines
    wired by a loopback transport, driven on the test thread (which
    therefore owns slot state)."""
    delivered = []
    inbox = TM.MigrationInbox(lambda h, k, v: delivered.append((h, k, v)))
    migrator = TM.BlockMigrator(TM.LoopbackTransport(inbox.feed))
    prefill = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec),
                              migrator=migrator, adapters=adapters[0],
                              device="cpu")
    decode = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec),
                             role="decode", adapters=adapters[1],
                             device="cpu")
    return prefill, decode, delivered


def _prefill_out(prefill, req):
    prefill.submit(req)
    prefill._admit()
    for _ in range(10):
        if all(s is None for s in prefill._slots):
            break
        prefill._prefill_tick()


def _decode_all(decode):
    for _ in range(40):
        if all(s is None for s in decode._slots):
            break
        decode._step()


class TestExportImportRoundTrip:
    def test_planes_refcounts_and_pool_reconcile(self, params):
        prefill, decode, delivered = _engine_pair(params[1])
        assert (prefill._role, decode._role) == ("prefill", "decode")
        assert prefill.pool.role == "prefill"
        prompt = [((i * 13) % 250) + 1 for i in range(10)]  # 3 blocks
        ref = _reference(params[1], prompt, 6)
        req = TE.Request(prompt, max_new_tokens=6)
        prefill.submit(req)
        prefill._admit()
        table = list(prefill._slots[0].table)      # fixed at admission
        for _ in range(10):
            if prefill._slots[0] is None:
                break
            prefill._prefill_tick()
        assert prefill._slots[0] is None           # exported + freed
        assert prefill.pool.used() == 0            # lane turned over
        (header, k, v), = delivered
        assert torch.equal(k, prefill._kp[:, table])
        assert torch.equal(v, prefill._vp[:, table])
        assert header["length"] == len(prompt) and header["blocks"] == 3
        assert header["dtype"] == "float32"

        decode.import_blocks(req, header, k, v)
        decode._import_tick()
        slot = decode._slots[0]
        assert slot is not None and slot.decoding
        assert slot.length == len(prompt)
        assert torch.equal(decode._kp[:, slot.table], k)
        assert torch.equal(decode._vp[:, slot.table], v)
        # the import wrote no other block: the null block is still zero
        assert not decode._kp[:, 0].any() and not decode._vp[:, 0].any()
        assert all(decode.pool.ref(b) == 1 for b in slot.table)
        assert req.first_token_time is not None
        assert req.tokens == [ref[0]]
        assert req.migrations == 1 and req.migrated_tokens == len(prompt)
        _decode_all(decode)
        assert req.tokens == ref
        assert decode.pool.used() == 0

    def test_imported_shared_blocks_arm_the_cow_boundary(self, params):
        prefill, decode, delivered = _engine_pair(params[1])
        prompt = [((i * 7) % 250) + 1 for i in range(10)]
        ref = _reference(params[1], prompt, 5)
        reqs = [TE.Request(prompt, max_new_tokens=5) for _ in range(2)]
        for req in reqs:
            _prefill_out(prefill, req)
        assert len(delivered) == 2
        for req, (header, k, v) in zip(reqs, delivered):
            decode.import_blocks(req, header, k, v)
        decode._import_tick()
        a, b = decode._slots[0], decode._slots[1]
        assert a is not None and b is not None
        assert b.table[:2] == a.table[:2]
        assert b.table[2] != a.table[2]
        for blk in a.table[:2]:
            assert decode.pool.ref(blk) == 2
            assert decode.pool.needs_copy(blk)     # the COW boundary
        assert not decode.pool.needs_copy(a.table[2])
        shared = list(a.table[:2])
        before = decode._kp[:, shared].clone()
        _decode_all(decode)
        assert reqs[0].tokens == ref and reqs[1].tokens == ref
        assert torch.equal(decode._kp[:, shared], before)
        assert decode.pool.used() == 0
        assert decode.pool.available() == decode.pool.usable_blocks

    @pytest.mark.parametrize("header, shape", [
        ({"block_size": 16}, (2, 1, 16, 2, 4)),
        ({"block_size": 4}, (3, 1, 4, 2, 4))],
        ids=["block_size", "layers"])
    def test_incompatible_import_fails_the_request_not_the_pool(
            self, params, header, shape):
        _prefill, decode, _delivered = _engine_pair(params[1])
        req = TE.Request([1, 2, 3], max_new_tokens=4)
        header = dict(header, request_id=req.request_id, length=3,
                      first_token=5, blocks=1)
        decode.import_blocks(req, header, torch.zeros(shape),
                             torch.zeros(shape))
        decode._import_tick()
        assert req._done.is_set()
        assert isinstance(req.error, TE.RequestRejected)
        assert decode.pool.used() == 0

    def test_torn_export_hands_the_request_to_the_fallback(self, params):
        from cloudtik_tpu_torch.faults import seams
        from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint
        from cloudtik_tpu_torch.telemetry import instruments as ti

        handed = []
        inbox = TM.MigrationInbox(lambda h, k, v: handed.append("import"))
        migrator = TM.BlockMigrator(TM.LoopbackTransport(inbox.feed),
                                    fallback=handed.append)
        prefill = TE.DecodeEngine(params[1], TCFG, TE.EngineConfig(**EC),
                                  migrator=migrator, device="cpu")
        failures0 = ti.SERVE_KV_MIGRATION_FAILURES.value()
        req = TE.Request([((i * 3) % 250) + 1 for i in range(10)],
                         max_new_tokens=4)
        plan = FaultPlan([FaultPoint("serve.kvcache.migrate", "raise",
                                     at_call=2, times=1)])
        with seams.armed(plan):
            _prefill_out(prefill, req)
        assert plan.points[0].fired == 1
        assert handed == [req]                # no half import, no loss
        assert req.admitted is None and not req._done.is_set()
        assert prefill.pool.used() == 0
        assert ti.SERVE_KV_MIGRATION_FAILURES.value() == failures0 + 1


class _FakeEngine:
    """Records import_blocks calls; completes nothing."""

    def __init__(self):
        self.imports = []

    def import_blocks(self, request, header, k, v):
        self.imports.append((request, header, k, v))
        return request


def _header(rid, dtype="float32", blocks=2, **kw):
    return dict({"request_id": rid, "prompt": [1, 2, 3, 4],
                 "first_token": 5, "length": 4, "max_new_tokens": 4,
                 "temperature": 0.0, "eos_id": None, "traceparent": None,
                 "dtype": dtype, "n_layers": 2, "block_size": 4,
                 "n_kv_heads": 3, "head_dim": 5, "blocks": blocks}, **kw)


class TestSocketTransport:
    def test_request_from_header_carries_everything(self):
        created = time.time() - 2.0
        header = {"prompt": [1, 2, 3], "max_new_tokens": 7,
                  "temperature": 0.5, "eos_id": 9, "request_id": 41,
                  "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                  "first_token": 4, "created": created, "admitted": 1.0,
                  "export_started": 2.0, "tenant": "acme",
                  "adapter_id": "tA"}
        req = TM.request_from_header(header)
        assert isinstance(req, TE.Request)
        assert (req.prompt, req.max_new_tokens, req.temperature,
                req.eos_id) == ([1, 2, 3], 7, 0.5, 9)
        assert req.traceparent == header["traceparent"]
        assert req.migrated_from == 41 and req.fabric_path == "migrated"
        assert (req.prefill_admitted_ts, req.export_started_ts) == (1.0,
                                                                    2.0)
        assert req.tenant == "acme" and req.adapter_id == "tA"
        # lifecycle back-dated to the origin submit, both clocks
        assert req.created == created
        assert time.monotonic() - req.created_mono >= 2.0
        assert req.import_ts is not None and req.import_mono is not None
        legacy = TM.request_from_header({"prompt": [1, 2]})
        assert legacy.adapter_id is None and legacy.tenant == "default"

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_framed_stream_reaches_the_engine(self, dtype):
        engine = _FakeEngine()
        receiver = TM.MigrationReceiver(engine, host="127.0.0.1")
        receiver.start()
        try:
            transport = TM.SocketKVTransport("127.0.0.1", receiver.port)
            _jk, k = _planes((2, 2, 4, 3, 5), dtype, 3)
            _jv, v = _planes((2, 2, 4, 3, 5), dtype, 4)
            transport.send(TM.pack_header(_header(41, dtype)))
            for j in range(2):
                transport.send(TM.pack_block(41, j, k[:, j], v[:, j]))
            transport.send(TM.pack_commit(41, 2))
            transport.close()
            _until(lambda: engine.imports)
            request, got_header, gk, gv = engine.imports[0]
            # the Request was CONSTRUCTED from the header
            assert isinstance(request, TE.Request)
            assert request.prompt == [1, 2, 3, 4]
            assert got_header["first_token"] == 5
            assert np.array_equal(_bits(gk), _bits(k))
            assert np.array_equal(_bits(gv), _bits(v))
        finally:
            receiver.stop()

    def test_torn_connection_drops_partial_stream(self):
        engine = _FakeEngine()
        receiver = TM.MigrationReceiver(engine, host="127.0.0.1")
        receiver.start()
        try:
            transport = TM.SocketKVTransport("127.0.0.1", receiver.port)
            k = torch.zeros(2, 1, 4, 3, 5)
            transport.send(TM.pack_header(_header(42)))
            transport.send(TM.pack_block(42, 0, k[:, 0], k[:, 0]))
            transport.close()          # torn before block 1 + commit
            time.sleep(0.3)
            assert engine.imports == []
        finally:
            receiver.stop()

    def test_send_on_torn_transport_raises(self):
        receiver = TM.MigrationReceiver(_FakeEngine(), host="127.0.0.1")
        receiver.start()
        try:
            transport = TM.SocketKVTransport("127.0.0.1", receiver.port)
            transport.close()
            with pytest.raises(OSError):
                transport.send(b"KVC1\x00\x00\x00\x00")
        finally:
            receiver.stop()

    def test_engine_to_engine_over_real_socket(self, params):
        """Port prefill role -> TCP -> a Request built from the header ->
        port decode role: the monolith's tokens, both pools free, and
        on_finish sees the completion."""
        tp = params[1]
        ec = TE.EngineConfig(slots=2, max_len=64, prefill_buckets=(8, 16),
                             block_size=8)
        decode = TE.DecodeEngine(tp, TCFG, ec, role="decode", device="cpu")
        decode.start()
        finished, done = [], threading.Event()
        receiver = TM.MigrationReceiver(
            decode, host="127.0.0.1",
            on_finish=lambda req: (finished.append(req), done.set()))
        receiver.start()
        transport = TM.SocketKVTransport("127.0.0.1", receiver.port)
        prefill = TE.DecodeEngine(tp, TCFG, ec,
                                  migrator=TM.BlockMigrator(transport),
                                  device="cpu")
        prefill.start()
        try:
            prompt = [((i * 7) % 250) + 1 for i in range(20)]
            prefill.submit(TE.Request(prompt, max_new_tokens=6))
            assert done.wait(timeout=WAIT)
            req = finished[0]
            assert req.error is None
            assert req.tokens == _reference(tp, prompt, 6)
            assert req.migrations == 1
            assert req.migrated_tokens == len(prompt)
        finally:
            prefill.stop()
            decode.stop()
            receiver.stop()
            transport.close()
        assert prefill.pool.used() == 0 and decode.pool.used() == 0


class TestCrossFramework:
    """A JAX engine and a port engine exchange KV blocks over
    `SocketKVTransport`, each direction."""

    def test_jax_prefill_feeds_port_decode(self, params):
        jp, tp = params
        ec = dict(slots=2, max_len=64, prefill_buckets=(8, 16),
                  block_size=8)
        decode = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec),
                                 role="decode", device="cpu")
        decode.start()
        finished, done = [], threading.Event()
        receiver = TM.MigrationReceiver(
            decode, host="127.0.0.1",
            on_finish=lambda req: (finished.append(req), done.set()))
        receiver.start()
        transport = JM.SocketKVTransport("127.0.0.1", receiver.port)
        prefill = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**ec),
                                  migrator=JM.BlockMigrator(transport))
        prefill.start()
        try:
            prompt = [((i * 11) % 250) + 1 for i in range(20)]
            prefill.submit(JE.Request(prompt, max_new_tokens=6))
            assert done.wait(timeout=WAIT)
            req = finished[0]
            assert req.error is None and req.migrations == 1
            want = np.asarray(JG.generate(jp, jnp.asarray([prompt]), JCFG,
                                          max_new_tokens=6))[0].tolist()
            assert req.tokens == want
        finally:
            prefill.stop()
            decode.stop()
            receiver.stop()
            transport.close()
        assert decode.pool.used() == 0

    def test_port_prefill_feeds_jax_decode(self, params):
        jp, tp = params
        ec = dict(slots=2, max_len=64, prefill_buckets=(8, 16),
                  block_size=8)
        decode = JE.DecodeEngine(jp, JCFG, JE.EngineConfig(**ec),
                                 role="decode")
        decode.start()
        finished, done = [], threading.Event()
        receiver = JM.MigrationReceiver(
            decode, host="127.0.0.1",
            on_finish=lambda req: (finished.append(req), done.set()))
        receiver.start()
        transport = TM.SocketKVTransport("127.0.0.1", receiver.port)
        prefill = TE.DecodeEngine(tp, TCFG, TE.EngineConfig(**ec),
                                  migrator=TM.BlockMigrator(transport),
                                  device="cpu")
        prefill.start()
        try:
            prompt = [((i * 17) % 250) + 1 for i in range(20)]
            prefill.submit(TE.Request(prompt, max_new_tokens=6))
            assert done.wait(timeout=WAIT)
            req = finished[0]
            assert req.error is None and req.migrations == 1
            want = np.asarray(JG.generate(jp, jnp.asarray([prompt]), JCFG,
                                          max_new_tokens=6))[0].tolist()
            assert req.tokens == want
        finally:
            prefill.stop()
            decode.stop()
            receiver.stop()
            transport.close()
        assert prefill.pool.used() == 0

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_bf16_planes_cross_bit_for_bit(self, params, direction):
        """bf16 engines, driven on the test thread: the decode pool's
        imported blocks hold exactly the prefill pool's bits."""
        jcfg = JT.config("tiny", dtype=jnp.bfloat16,
                         attention_impl="reference", remat=False)
        tcfg = TT.config("tiny", dtype=torch.bfloat16)
        jp, tp = params
        ec = dict(slots=1, max_len=32, prefill_buckets=(8,), block_size=4)
        prompt = [((i * 19) % 250) + 1 for i in range(10)]
        if direction == "jax_to_port":
            decode = TE.DecodeEngine(tp, tcfg, TE.EngineConfig(**ec),
                                     role="decode", device="cpu")
            receiver = TM.MigrationReceiver(decode, host="127.0.0.1")
            Sender, EngineM = JM, JE
        else:
            decode = JE.DecodeEngine(jp, jcfg, JE.EngineConfig(**ec),
                                     role="decode")
            receiver = JM.MigrationReceiver(decode, host="127.0.0.1")
            Sender, EngineM = TM, TE
        receiver.start()
        transport = Sender.SocketKVTransport("127.0.0.1", receiver.port)
        try:
            migrator = Sender.BlockMigrator(transport)
            if EngineM is JE:
                prefill = JE.DecodeEngine(jp, jcfg, JE.EngineConfig(**ec),
                                          migrator=migrator)
            else:
                prefill = TE.DecodeEngine(tp, tcfg, TE.EngineConfig(**ec),
                                          migrator=migrator, device="cpu")
            req = EngineM.Request(prompt, max_new_tokens=4)
            prefill.submit(req)
            prefill._admit()
            table = list(prefill._slots[0].table)
            for _ in range(10):
                if prefill._slots[0] is None:
                    break
                prefill._prefill_tick()
            assert prefill._slots[0] is None
            sent = [_bits(np.asarray(p[:, table]) if EngineM is JE
                          else p[:, table]) for p in (prefill._kp,
                                                      prefill._vp)]
            _until(lambda: not decode._imports.empty())
            decode._import_tick()
            slot = decode._slots[0]
            assert slot is not None and slot.decoding
            got = [_bits(p[:, slot.table] if EngineM is JE
                         else np.asarray(p[:, np.asarray(slot.table)]))
                   for p in (decode._kp, decode._vp)]
            assert got[0].dtype == np.int16
            for g, s in zip(got, sent):
                assert np.array_equal(g, s)
            decode._release_slot(0)
        finally:
            receiver.stop()
            transport.close()


class TestLedgerAggregates:
    def test_stats_sum_migration_fields(self):
        records = [
            {"finish": "done", "migrations": 1, "migrated_tokens": 40},
            {"finish": "done", "migrations": 1, "migrated_tokens": 8},
            {"finish": "done"},            # pre-migration record shape
        ]
        stats = TR.compute_stats(records)
        assert stats["migrations"] == 2
        assert stats["migrated_tokens"] == 48


class TestAdapterIdentityCrossing:
    def test_export_header_carries_adapter_tenant_and_dtype(self):
        class _Req:
            request_id = 3
            prompt = [1, 2]
            max_new_tokens = 2
            temperature = 0.0
            eos_id = None
            traceparent = None
            tenant = "acme"
            adapter_id = "tA"

        headers = {}
        for M, zeros in ((TM, torch.zeros(1, 1, 2, 1, 1,
                                          dtype=torch.bfloat16)),
                         (JM, np.zeros((1, 1, 2, 1, 1), jnp.bfloat16))):
            sent = []
            M.BlockMigrator(M.LoopbackTransport(sent.append)).export(
                _Req(), first_token=3, length=2, k=zeros, v=zeros,
                block_size=2)
            _kind, headers[M], _k, _v = JM.unpack(sent[0])
            headers[M].pop("export_started")
        assert headers[TM] == headers[JM]
        assert headers[TM]["adapter_id"] == "tA"
        assert headers[TM]["tenant"] == "acme"
        assert headers[TM]["dtype"] == "bfloat16"

    def test_adapter_mismatch_fails_the_request_not_the_pool(self, params):
        _prefill, decode, _delivered = _engine_pair(params[1])
        req = TE.Request([1, 2, 3], max_new_tokens=4, adapter_id="tA")
        header = {"request_id": req.request_id, "length": 3,
                  "first_token": 5, "block_size": 4, "blocks": 1,
                  "adapter_id": "tA"}
        shape = (TCFG.n_layers, 1, 4, TCFG.n_kv_heads, TCFG.head_dim)
        decode.import_blocks(req, header, torch.zeros(shape),
                             torch.zeros(shape))
        decode._import_tick()
        assert req._done.is_set()
        assert "adapter" in str(req.error)
        assert decode.pool.used() == 0

    def test_lora_migration_equals_the_merged_engine(self, params):
        tp = params[1]
        lora_cfg = TL.LoRAConfig(rank=4)
        bank = {"tA": TL.random_lora_params(
            torch.Generator().manual_seed(1), TCFG, lora_cfg, device="cpu")}

        def pool():
            return AdapterPool(tp, TCFG, lora_cfg,
                               loader=lambda aid: bank[aid], capacity=2)

        prefill, decode, delivered = _engine_pair(
            tp, adapters=(pool(), pool()))
        prompt = [((i * 11) % 250) + 1 for i in range(10)]
        req = TE.Request(prompt, max_new_tokens=5, adapter_id="tA")
        _prefill_out(prefill, req)
        (header, k, v), = delivered
        assert header["adapter_id"] == "tA"
        decode.import_blocks(req, header, k, v)
        decode._import_tick()
        slot = decode._slots[0]
        assert slot is not None and slot.adapter_slot != 0
        _decode_all(decode)
        merged = dict(tp, layers=TL.merge_lora(tp["layers"], bank["tA"],
                                               lora_cfg))
        assert req.tokens == _reference(merged, prompt, 5)
        assert decode.pool.used() == 0
        blocks, _ = decode.pool.match_prefix(prompt, count=False,
                                             namespace="tA")
        assert blocks
        bare, _ = decode.pool.match_prefix(prompt, count=False)
        assert not bare
