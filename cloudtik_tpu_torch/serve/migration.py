"""KV-block migration: serialize a request's paged-cache state and
stream it between engines, on PyTorch.

Counterpart of `cloudtik_tpu/serve/migration.py`, with the same wire: the
same tags, the same little-endian `<I`/`<Q` framing, the same header keys,
and `pack_*`/`unpack` byte for byte.  A migration is a short message
stream over a byte-oriented :class:`KVTransport`:

    header  — JSON request metadata (prompt, first token, lengths,
              plane geometry, dtype name) framed as ``KVH1``
    block×M — one raw K/V plane pair per KV block (``KVB1``)
    commit  — ``KVC1``: the stream is complete; only now may the
              receiver act on it (a torn stream is dropped, never
              half-imported)
    abort   — ``KVA1``: the sender failed mid-transfer; the receiver
              discards the partial stream

The planes are host torch tensors.  The header names their dtype through
this module's own table (`DTYPES`: ``"bfloat16"``, ``"float16"``,
``"float32"``), never through numpy, which has no bfloat16 of its own; a
block's bytes are its elements' bits, written through an integer view of
the same width.  Torch's bfloat16 bits are the bytes of the JAX package's
``jnp.bfloat16``, so a JAX engine and a port engine exchange blocks over
one wire, in both directions, bit for bit.

The exporter fires the ``serve.kvcache.migrate`` fault seam before every
block message, so a chaos plan can tear a transfer at any chunk; the
engine's contract is to degrade that request to the re-prefill path,
never to lose it.
"""

from __future__ import annotations

import json
import logging
import math
import socket
import socketserver
import struct
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch.faults import seams

logger = logging.getLogger(__name__)

MSG_HEADER = b"KVH1"
MSG_BLOCK = b"KVB1"
MSG_COMMIT = b"KVC1"
MSG_ABORT = b"KVA1"

# one fixed little-endian frame layout per message kind:
#   header/commit/abort:  tag + u32 json_len + json
#   block:                tag + u32 json_len + json + u64 k_len + k
#                         + u64 v_len + v
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# the wire's dtype names, as numpy (and the JAX package) spell them
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
# an integer dtype of each element width: a block's bytes are written and
# read through it, so no float conversion ever touches the bits
_BITS = {2: torch.int16, 4: torch.int32}


class MigrationError(RuntimeError):
    """A malformed or out-of-order migration message."""


def dtype_name(dtype: torch.dtype) -> str:
    """The wire's name of a plane dtype; MigrationError for any other."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise MigrationError(
            f"planes of {dtype} cannot migrate; the wire carries "
            f"{sorted(DTYPES)}") from None


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype a header's ``dtype`` names; MigrationError for a
    name outside the table (never a guess: integers cast into a float
    pool would be silent corruption)."""
    try:
        return DTYPES[name]
    except (KeyError, TypeError):
        raise MigrationError(
            f"migration header names dtype {name!r}; expected one of "
            f"{sorted(DTYPES)}") from None


def _plane_bits(t: torch.Tensor):
    """A host tensor's elements as a flat numpy integer array of their
    width, without a copy when `t` is contiguous (numpy has no bfloat16,
    so its bits travel as integers)."""
    dtype_name(t.dtype)
    return t.contiguous().view(_BITS[t.element_size()]).numpy().reshape(-1)


def pack_header(meta: Dict[str, Any]) -> bytes:
    blob = json.dumps(meta).encode()
    return MSG_HEADER + _U32.pack(len(blob)) + blob


def pack_block(request_id: int, seq: int, k: torch.Tensor,
               v: torch.Tensor) -> bytes:
    """One KV block's planes, raw bytes after a tiny JSON envelope.
    k/v are one block's [L, bs, Hkv, Dh] host planes, each copied once,
    straight into the frame."""
    kb, vb = _plane_bits(k), _plane_bits(v)
    meta = json.dumps({"request_id": request_id, "seq": seq}).encode()
    return b"".join((MSG_BLOCK, _U32.pack(len(meta)), meta,
                     _U64.pack(kb.nbytes), kb, _U64.pack(vb.nbytes), vb))


def pack_commit(request_id: int, blocks: int) -> bytes:
    blob = json.dumps({"request_id": request_id,
                       "blocks": blocks}).encode()
    return MSG_COMMIT + _U32.pack(len(blob)) + blob


def pack_abort(request_id: int) -> bytes:
    blob = json.dumps({"request_id": request_id}).encode()
    return MSG_ABORT + _U32.pack(len(blob)) + blob


def _flat_u8(buf) -> torch.Tensor:
    """A flat uint8 tensor over `buf` (a message's bytes, or the inbox's
    buffer), without a copy; the tensor keeps `buf` alive.  A message's
    planes are only read (the inbox copies them into its own buffer), so
    torch's warning about read-only buffers does not apply."""
    if not len(buf):
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=torch.uint8)


def unpack(msg: bytes) -> Tuple[bytes, Dict[str, Any],
                                Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """(kind, meta, k_bytes_or_None, v_bytes_or_None); planes come back
    as flat uint8 tensors over the message — the inbox views them in the
    header's dtype and geometry."""
    if len(msg) < 8:
        raise MigrationError("truncated migration message")
    kind = bytes(msg[:4])
    if kind not in (MSG_HEADER, MSG_BLOCK, MSG_COMMIT, MSG_ABORT):
        raise MigrationError(f"unknown migration tag {kind!r}")
    (meta_len,) = _U32.unpack_from(msg, 4)
    off = 8
    if len(msg) < off + meta_len:
        raise MigrationError("migration message shorter than its framing")
    meta = json.loads(bytes(msg[off:off + meta_len]).decode())
    off += meta_len
    if kind != MSG_BLOCK:
        return kind, meta, None, None
    view = memoryview(msg)
    if len(msg) < off + 8:
        raise MigrationError("block message shorter than its framing")
    (k_len,) = _U64.unpack_from(msg, off)
    off += 8
    k = view[off:off + k_len]
    off += k_len
    if len(msg) < off + 8:
        raise MigrationError("block message shorter than its framing")
    (v_len,) = _U64.unpack_from(msg, off)
    off += 8
    v = view[off:off + v_len]
    if len(k) != k_len or len(v) != v_len:
        raise MigrationError("block message shorter than its framing")
    return kind, meta, _flat_u8(k), _flat_u8(v)


# ------------------------------------------------------------ transport --

class KVTransport:
    """The pluggable byte pipe a migration streams through: ``send`` one
    self-describing frame, ``close``."""

    def send(self, msg: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LoopbackTransport(KVTransport):
    """In-process delivery: hands every message straight to a receiver
    callable (typically ``MigrationInbox.feed``)."""

    def __init__(self, deliver: Callable[[bytes], None]):
        self._deliver = deliver

    def send(self, msg: bytes) -> None:
        self._deliver(msg)


class SocketKVTransport(KVTransport):
    """Length-prefixed frames over TCP.

    Each ``send`` writes one ``u32 frame_length`` prefix plus the
    self-describing message bytes; :class:`MigrationReceiver` reframes
    them and feeds its inbox.  ``connect_timeout_s`` bounds the connect
    and ``send_timeout_s`` every write; ANY send failure tears the
    connection down (the receiver sees EOF mid-stream and drops the
    partial migration whole), and a torn transport is never reused.
    ``frame_delay_s`` adds a fixed latency per frame (a cross-host wire
    emulated over loopback TCP)."""

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 5.0,
                 send_timeout_s: float = 10.0,
                 frame_delay_s: float = 0.0):
        self.address = (host, int(port))
        self.frame_delay_s = float(frame_delay_s)
        self._sock: Optional[socket.socket] = socket.create_connection(
            self.address, timeout=connect_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(send_timeout_s)

    def send(self, msg: bytes) -> None:
        if self._sock is None:
            raise OSError("socket KV transport already torn down")
        if self.frame_delay_s > 0.0:
            time.sleep(self.frame_delay_s)
        try:
            self._sock.sendall(_U32.pack(len(msg)) + msg)
        except (OSError, ValueError):
            self.close()              # abort-on-tear: EOF > half frame
            raise

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


def request_from_header(header: Dict[str, Any]):
    """Construct a live engine ``Request`` from a migration header: the
    cross-host receiver's replacement for the loopback's live-object
    handoff.  Lifecycle stamps are back-dated to the origin submit
    (``created``), so TTFT and queue wait span the whole path; the
    prefill half's wall stamps ride along for the request ledger's phase
    decomposition, and ``migrated_from`` is the origin request id (the
    constructed request gets a fresh local id)."""
    from cloudtik_tpu_torch.serve.engine import Request

    request = Request(
        [int(t) for t in header["prompt"]],
        max_new_tokens=int(header.get("max_new_tokens", 16)),
        temperature=float(header.get("temperature", 0.0)),
        eos_id=header.get("eos_id"),
        tenant=str(header.get("tenant", "default")),
        adapter_id=header.get("adapter_id"))
    request.traceparent = header.get("traceparent")
    request.migrated_from = header.get("request_id")
    request.fabric_path = "migrated"
    request.prefill_admitted_ts = header.get("admitted")
    request.export_started_ts = header.get("export_started")
    request.import_ts = time.time()
    request.import_mono = time.monotonic()
    created = header.get("created")
    if created is not None:
        # the monotonic twin (what the ledger derives latencies from)
        # shifts by the wall time elapsed since the origin submit
        elapsed = max(0.0, time.time() - float(created))
        request.created = float(created)
        request.created_mono -= elapsed
    return request


class MigrationReceiver:
    """TCP server side of :class:`SocketKVTransport`: reframe
    length-prefixed messages, reassemble per-request streams, and at
    commit construct a ``Request`` FROM THE HEADER and hand it to
    ``engine.import_blocks`` (which only queues it: this thread issues no
    device work).  ``on_finish(request)`` observes each imported
    request's completion from a watcher thread.  A connection that dies
    mid-stream drops every migration it had in flight."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 on_finish: Optional[Callable[[Any], None]] = None):
        self.engine = engine
        self.on_finish = on_finish
        receiver = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # one inbox per connection: a torn connection takes
                # exactly its own partial streams down with it
                inbox = MigrationInbox(receiver._import)
                sock = self.request
                try:
                    while True:
                        prefix = _recv_exact(sock, 4)
                        if prefix is None:
                            return
                        (length,) = _U32.unpack(prefix)
                        frame = _recv_exact(sock, length)
                        if frame is None:
                            return            # torn mid-frame: drop
                        try:
                            inbox.feed(frame)
                        except Exception:
                            # one bad migration drops THAT request, not
                            # every other stream on the connection
                            logger.warning(
                                "dropping failed migration frame",
                                exc_info=True)
                except OSError:
                    return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _import(self, header: Dict[str, Any], k: torch.Tensor,
                v: torch.Tensor) -> None:
        request = request_from_header(header)
        self.engine.import_blocks(request, header, k, v)
        if self.on_finish is not None:
            def _watch():
                try:
                    request.wait(timeout=600)
                except Exception:
                    pass
                self.on_finish(request)
            threading.Thread(target=_watch, daemon=True,
                             name="tik-migration-finish").start()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tik-migration-receiver", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Read exactly n bytes, or None on EOF (clean or mid-buffer: either
    way the stream is over and partials are dropped)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            read = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if not read:
            return None
        got += read
    return buf


# ---------------------------------------------------------------- inbox --

class MigrationInbox:
    """Reassembles migration streams and delivers complete ones.

    ``on_migration(header, k, v)`` fires at commit with host torch planes
    ``[L, M, bs, Hkv, Dh]`` in table order, in the header's dtype (each a
    view of a block-major tensor, so `k[:, start:]` is one dense copy to
    the device).  The header sizes one host buffer per plane set; each
    block's bytes are copied into it as they arrive (numpy copies, off
    torch's CPU thread pool), and `torch.frombuffer(...).view(dtype)`
    gives the planes at commit.  A header naming an unknown dtype is
    refused; torn streams (abort, missing blocks, bad framing) are dropped
    whole — a half-imported cache would be silent corruption."""

    def __init__(self, on_migration: Callable[
            [Dict[str, Any], torch.Tensor, torch.Tensor], None]):
        self._on_migration = on_migration
        self._partial: Dict[int, Dict[str, Any]] = {}

    def feed(self, msg: bytes) -> None:
        kind, meta, k, v = unpack(msg)
        if kind == MSG_HEADER:
            dtype = wire_dtype(meta.get("dtype"))
            shape = (int(meta["blocks"]), int(meta["n_layers"]),
                     int(meta["block_size"]), int(meta["n_kv_heads"]),
                     int(meta["head_dim"]))
            nbytes = math.prod(shape[1:]) * dtype.itemsize
            self._partial[meta["request_id"]] = {
                "header": meta, "seqs": set(), "dtype": dtype,
                "shape": shape, "nbytes": nbytes,
                "bufs": np.empty((2, shape[0] * nbytes), np.uint8)}
            return
        rid = meta.get("request_id")
        state = self._partial.get(rid)
        if kind == MSG_ABORT:
            self._partial.pop(rid, None)
            return
        if state is None:
            raise MigrationError(
                f"migration message for request {rid} with no header")
        shape, nbytes = state["shape"], state["nbytes"]
        if kind == MSG_BLOCK:
            seq = int(meta["seq"])
            if not 0 <= seq < shape[0]:
                raise MigrationError(
                    f"migration for request {rid}: block {seq} of "
                    f"{shape[0]}")
            if k.numel() != nbytes or v.numel() != nbytes:
                raise MigrationError(
                    f"migration for request {rid}: block {seq} holds "
                    f"{k.numel()} + {v.numel()} bytes, not {nbytes} each")
            at = slice(seq * nbytes, (seq + 1) * nbytes)
            state["bufs"][0, at] = k.numpy()
            state["bufs"][1, at] = v.numpy()
            state["seqs"].add(seq)
            return
        # commit: every announced block must have arrived
        self._partial.pop(rid, None)
        n = int(meta["blocks"])
        if n != shape[0] or state["seqs"] != set(range(n)):
            raise MigrationError(
                f"migration for request {rid} committed with "
                f"{sorted(state['seqs'])} of {n} blocks")
        # block-major [M, L, ...], handed over as [L, M, ...] views
        k_planes, v_planes = (
            _flat_u8(buf).view(state["dtype"]).reshape(shape).transpose(0, 1)
            for buf in state["bufs"])
        self._on_migration(state["header"], k_planes, v_planes)


# -------------------------------------------------------------- exporter --

class BlockMigrator:
    """Engine-side sender: serialize a finished prefill's KV state and
    stream it, one message per block, through the transport.

    ``fallback(request)`` is the degrade path a mid-transfer fault takes:
    the engine hands the request over with its KV discarded and the
    receiver re-prefills it from the prompt (in disaggregated mode: a
    plain submit to the decode-role engine)."""

    def __init__(self, transport: KVTransport,
                 fallback: Optional[Callable[[Any], None]] = None):
        self.transport = transport
        self.fallback = fallback

    def export(self, request, *, first_token: int, length: int,
               k: torch.Tensor, v: torch.Tensor, block_size: int) -> None:
        """Stream one request's KV state.  k/v are host torch planes
        ``[L, M, bs, Hkv, Dh]`` for the request's covered blocks, in
        table order.  Raises whatever the ``serve.kvcache.migrate`` seam
        (fired before every block) or the transport raises — the caller
        owns the degrade."""
        n_blocks = int(k.shape[1])
        # the prefill side's "migrated" ledger record ends its prefill
        # phase here (reqlog.derive_phases)
        request.export_started_ts = time.time()
        request.export_mono = time.monotonic()
        header = {
            "request_id": request.request_id,
            "prompt": list(request.prompt),
            "first_token": int(first_token),
            "length": int(length),
            "max_new_tokens": request.max_new_tokens,
            "temperature": request.temperature,
            "eos_id": request.eos_id,
            "traceparent": request.traceparent,
            # origin submit time: the importer back-dates its stamps
            "created": getattr(request, "created", None),
            # phase decomposition stamps (wall)
            "admitted": getattr(request, "admitted", None),
            "export_started": request.export_started_ts,
            # adapter identity crosses with the KV state
            "tenant": getattr(request, "tenant", "default"),
            "adapter_id": getattr(request, "adapter_id", None),
            "block_size": int(block_size),
            "n_layers": int(k.shape[0]),
            "n_kv_heads": int(k.shape[3]),
            "head_dim": int(k.shape[4]),
            "dtype": dtype_name(k.dtype),
            "blocks": n_blocks,
        }
        try:
            self.transport.send(pack_header(header))
            for seq in range(n_blocks):
                seams.fire("serve.kvcache.migrate",
                           request=request.request_id, seq=seq,
                           blocks=n_blocks)
                self.transport.send(pack_block(
                    request.request_id, seq, k[:, seq], v[:, seq]))
            self.transport.send(pack_commit(request.request_id,
                                            n_blocks))
            # the commit frame is on the wire: the prefill half of the
            # request's story gets its "migrated" ledger record here, at
            # the commit point, so a tear never leaves one beside the
            # fallback's
            from cloudtik_tpu_torch.serve import reqlog
            reqlog.record(request, reqlog.FINISH_MIGRATED)
        except BaseException:
            # best-effort abort so the receiver drops the torn stream;
            # the original failure is the one that must surface
            try:
                self.transport.send(pack_abort(request.request_id))
            except Exception:
                pass
            raise
