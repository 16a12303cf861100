"""Continuous-batching decode engine over a paged KV cache, on PyTorch.

Counterpart of `cloudtik_tpu/serve/engine.py`, with the same host logic,
request lifecycle, metric, span, event and request-ledger names:

* One global block pool `[L, num_blocks, block_size, Hkv, Dh]` per K and V
  with a free-list allocator (serve/kvcache.py).  A request holds an
  ordered block table; block 0 is the reserved null block that inactive
  lanes and unallocated table slots point at, so every gather/scatter
  index in the decode step is valid.
* DECODE: one step for all slots.  Each lane appends its new K/V at
  `(table[length // bs], length % bs)` and attends over its table in f32
  (ops/paged_attention.py): on the card a hand-written kernel reads each
  lane's K/V in place up to its length, on the CPU the reference's
  gathered einsums run.  The pools are updated in place (the reference
  threads them through its programs).
* PREFILL is CHUNKED: at most one bucket-sized chunk per loop iteration
  through `models/generate.paged_prefill_chunk`, interleaved with decode
  steps.
* PREFIX REUSE, copy-on-write, and preemption of the newest request on
  pool exhaustion (with the victim's computed prompt blocks salvaged into
  the prefix LRU) are the reference's, line for line.
* Sampling on the device: greedy, per-slot temperature (Gumbel-max over
  `logits / temperature`, the reference's `jax.random.categorical`, drawn
  from the engine's `torch.Generator`, so sampled tokens differ from the
  reference's), engine-level static top_k.  Greedy lanes take the argmax
  whatever the sampled lanes beside them draw.
* SPECULATIVE DECODING (`EngineConfig.spec` + `DecodeEngine(draft=...)`):
  per greedy slot and loop iteration, a draft model proposes k tokens
  against a private contiguous cache (`generate.draft_propose`) and ONE
  target verify (`generate.paged_verify`) scores all k+1 positions; the
  longest matching prefix is accepted and the target's own token at the
  first mismatch (or the bonus token) is always emitted, so greedy output
  stays what plain decode gives.  Rejected positions rewind the cursor,
  speculation-only blocks return to the pool, and a shared block in the
  verify's window is copied first.  A `serve.spec.verify` fault degrades
  the request to plain decode; sampled requests never speculate.
* MULTI-TENANT LoRA (`DecodeEngine(adapters=AdapterPool(...))`,
  serve/adapters.py): requests carry `tenant` + `adapter_id`; a step whose
  lanes wear different adapters runs the gathered base+delta forward
  (per-lane plane indices), a batch-homogeneous step runs the plain step
  on the pool's cached merged weights.  Prefix chain keys are salted with
  the adapter_id.  An adapter request speculates only with a registered
  per-adapter draft (`adapter_drafts=`), and is then verified against the
  merged target.
* MIGRATION / DISAGGREGATION (serve/migration.py + serve/disagg.py): a
  prefill-role engine (`DecodeEngine(migrator=...)`) gathers a finished
  prompt's KV blocks on the device, copies them to the host once, and
  exports them through a pluggable transport instead of decoding; a
  decode-role engine imports them (`import_blocks`, thread-safe: it only
  queues) and its loop thread copies them to the device, scatters them
  into its own pool in place, registers the full prompt blocks in its
  prefix map and decodes from the header's first token.  A fault at the
  `serve.kvcache.migrate` seam mid-transfer degrades that request to the
  migrator's fallback (a plain re-prefill submit on the decode role).

The loop thread runs under `torch.inference_mode()`: grad mode is
thread-local, and a decode step that recorded autograd history would grow
memory with every step.  One host sync per decode step (`.tolist()` of the
next tokens), and two per spec round (the proposals, the verify's tokens).

The port serves token ids it has checked against the vocabulary: an id
outside it is refused at submit (`reason="token_ids"`, HTTP 400), since
an index past the embedding would fault the CUDA context mid-step, where
the reference's `jnp.take` passes it through.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultInjected
from cloudtik_tpu_torch.models import generate as G
from cloudtik_tpu_torch.models import lora as LO
from cloudtik_tpu_torch.models.generate import _NEG
from cloudtik_tpu_torch.models.transformer import (
    TransformerConfig, _embed_lookup, _mlp, _rms_norm, _rope,
    layer_params, logits_f32)
from cloudtik_tpu_torch.ops import paged_attention as PA
from cloudtik_tpu_torch.serve import kvcache, migration, reqlog
from cloudtik_tpu_torch.serve.adapters import (
    AdapterLoadError, AdapterPool, AdapterSlotsExhausted)
from cloudtik_tpu_torch.serve.kvcache import BlockPool, BlockPoolExhausted
from cloudtik_tpu_torch.telemetry import devtime, events, goodput
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.telemetry.core import STATE as _telemetry_state

logger = logging.getLogger(__name__)

Params = Dict[str, Any]


@dataclasses.dataclass
class SpecConfig:
    """Draft-model speculative decoding (Leviathan et al., ICML'23; Chen
    et al., "Accelerating LLM Decoding with Speculative Sampling").

    Each spec round runs `k` draft forwards plus ONE target verify over
    the paged pool and emits 1..k+1 tokens; greedy output stays what
    plain decode gives.  The draft model itself is handed to
    :class:`DecodeEngine` as ``draft=(params, cfg)``."""

    k: int = 4                        # draft tokens proposed per verify


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4                    # concurrent decode lanes
    max_len: int = 512                # per-request KV capacity (tokens)
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    top_k: int = 0                    # static, engine-wide
    block_size: int = 16              # KV page size (tokens per block)
    # pool size; None = slots * ceil(max_len/block_size) + null block
    # (full provisioning — shrink it, or raise slots, to oversubscribe)
    num_blocks: Optional[int] = None
    prefix_cache: bool = True         # share hashed full prompt blocks
    # max prompt tokens prefilled per loop iteration; None = largest
    # bucket (the ladder is the chunk size).  max_len disables chunking.
    chunk_size: Optional[int] = None
    # draft-model speculative decoding; needs DecodeEngine(draft=...)
    spec: Optional[SpecConfig] = None
    # admission-queue bound: a submit arriving past this many waiting
    # requests is REFUSED (RequestRejected reason="queue_full" -> HTTP
    # 429 + Retry-After).  None = unbounded.
    max_queue_depth: Optional[int] = None
    # admission policy: "fifo" (arrival order) or "wfq" — weighted-fair
    # queueing across tenants: the next admit goes to the waiting tenant
    # with the lowest slots-held/weight share, and pool-exhaustion
    # preemption picks the newest slot of the MOST over-share tenant
    admission: str = "fifo"
    # per-tenant weights for "wfq" (unlisted tenants weigh 1.0)
    tenant_weights: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class _Slot:
    request: "Request"
    table: List[int]                  # physical block ids, logical order
    true_len: int                     # prompt tokens
    prefill_pos: int                  # prompt tokens already in cache
    length: int = 0                   # tokens in cache once decoding
    remaining: int = 0                # new tokens still wanted
    decoding: bool = False            # prefill finished
    adapter_slot: int = 0             # LoRA plane slot (0 = base model)
    # speculative decoding: the slot's private contiguous draft cache, its
    # prompt-prefill cursor, the tokens it holds (its "length"), and the
    # latch a verify fault flips (the request falls back to plain decode)
    draft_cache: Optional[Dict[str, Any]] = None
    draft_pos: int = 0                # prompt tokens in the draft cache
    draft_len: int = 0                # tokens the draft cache holds
    spec_off: bool = False            # verify fault: degraded to plain
    # which draft weights propose for this slot: the base draft, or a
    # registered per-adapter draft (adapter requests with no matching
    # draft get no cache at all — they decode plain)
    draft_params: Optional[Params] = None


class RequestCancelled(RuntimeError):
    """The request was cancelled; its slot has been freed."""


class RequestRejected(ValueError):
    """Refused at submit; `.reason` is machine-readable for the HTTP
    layer (`capacity` -> 413, `queue_full` -> 429, else 400)."""

    def __init__(self, message: str, reason: str = "capacity"):
        super().__init__(message)
        self.reason = reason


_request_ids = itertools.count(1)


class Request:
    """One generation request; wait() blocks until tokens are ready.

    Lifecycle timestamps (epoch seconds) are stamped on every request:
    `created` at construction, `admitted` when a slot is taken,
    `first_token_time` when prefill produces the first token, and
    `done_time` at completion — TTFT is first_token_time - created,
    and queue wait is admitted - created.  A preempted request's
    admitted/first-token stamps reset (it re-runs from scratch);
    `preemptions` counts how often that happened.  `draft_tokens`,
    `accepted_tokens` and `spec_steps` count speculative rounds, and
    `migrations` / `migrated_tokens` the KV imports that carried its
    prompt in (serve/migration.py; an imported request's TTFT is stamped
    at import).
    """

    def __init__(self, prompt: List[int], max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 tenant: str = "default",
                 adapter_id: Optional[str] = None):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        # multi-tenant serving: which product this request belongs to
        # (reqlog records, per-tenant metrics, weighted-fair admission)
        # and which LoRA adapter decodes it (None = the base model)
        self.tenant = str(tenant)
        self.adapter_id = adapter_id
        self.tokens: List[int] = []
        self.error: Optional[Exception] = None
        self.request_id = next(_request_ids)
        # trace handoff: stamped at submit() with the enqueue span's
        # traceparent, re-entered by the loop thread so the whole
        # request (enqueue -> prefill -> decode) is one trace
        self.traceparent: Optional[str] = None
        self.created: float = time.time()
        self.admitted: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.done_time: Optional[float] = None
        # monotonic twins of the wall stamps: the request ledger derives
        # queue_wait/TTFT/TPOT from these (immune to wall-clock steps)
        self.created_mono: float = time.monotonic()
        self.admitted_mono: Optional[float] = None
        self.first_token_mono: Optional[float] = None
        self.done_mono: Optional[float] = None
        self.bucket: Optional[int] = None     # first prefill chunk bucket
        # paged-cache accounting (request-ledger fields)
        self.kv_blocks: int = 0               # peak blocks held
        self.prefix_blocks: int = 0           # blocks reused from cache
        self.prefix_tokens: int = 0           # prompt tokens not recomputed
        self.prefill_chunks: int = 0          # chunks the prompt took
        self.preemptions: int = 0             # pool-exhaustion requeues
        # KV-block migration accounting (serve/migration.py)
        self.migrations: int = 0              # completed imports
        self.migrated_tokens: int = 0         # tokens whose KV moved
        self.draft_tokens: int = 0
        self.accepted_tokens: int = 0
        self.spec_steps: int = 0
        self._done = threading.Event()
        self._cancel = False
        # serializes completion: cancel() (caller thread) can race the
        # loop thread finishing the same request in the pop->admit
        # window; exactly one completion may run
        self._finish_lock = threading.Lock()
        self._engine: Optional["DecodeEngine"] = None

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.tokens

    def cancel(self) -> bool:
        """Cancel this request; wait() then raises RequestCancelled.
        A request occupying a decode slot has the slot freed BY THE
        LOOP THREAD (which owns slot state) on its next pass.  A
        merely-queued request finishes immediately — it holds no slot
        state, and the loop discards the dead queue entry on pop
        (completion is idempotent).  Returns False when already
        completed."""
        if self._done.is_set():
            return False
        self._cancel = True
        engine = self._engine
        if engine is not None and self.admitted is not None:
            engine._wake.set()
        elif engine is not None:
            engine._finish_request(
                self, "cancelled", RequestCancelled("request cancelled"))
            engine._wake.set()
        else:
            # never submitted: nothing owns it, finish it here (still
            # counted — requests_total must sum to completed requests)
            with self._finish_lock:
                if not self._done.is_set():
                    self.error = RequestCancelled("request cancelled")
                    self.done_time = time.time()
                    self.done_mono = time.monotonic()
                    ti.SERVE_REQUESTS.inc(result="cancelled")
                    ti.SERVE_TENANT_REQUESTS.inc(
                        tenant=self.tenant, result="cancelled")
                    events.emit("tik_serve_cancel",
                                request=self.request_id)
                    reqlog.record(self, reqlog.FINISH_CANCELLED)
                    self._done.set()
        return True


def fire_verify_seam(request_id: int, width: int) -> None:
    """The `serve.spec.verify` injection seam, fired immediately before
    every speculative draft/verify round (`raise` -> the request degrades
    to non-speculative decode for the rest of its life; `latency` -> a
    slow verify).  With no plan armed this is one attribute check."""
    seams.fire("serve.spec.verify", request=request_id, width=width)


def _decode_layer(cfg: TransformerConfig, x: torch.Tensor, layer: Params,
                  ck: torch.Tensor, cv: torch.Tensor, tables: torch.Tensor,
                  lengths: torch.Tensor, active: torch.Tensor,
                  block_size: int, lora=None,
                  attn_timer: Optional[devtime.DeviceTimer] = None
                  ) -> torch.Tensor:
    """One layer, one token per slot, against the paged pool.

    x [B,1,d]; ck/cv [N,bs,Hkv,Dh] (this layer's pool plane, written in
    place); tables [B,M] physical block ids; lengths [B] int64 (per-slot
    absolute position); active [B] bool.  Each lane appends its new K/V
    at (table[length // bs], length % bs) and attends over its table
    (ops/paged_attention.py: the CUDA kernel on a card, the reference's
    gathered einsums on the CPU); an inactive lane's output is discarded
    by the caller.

    `lora` is the gathered batched-adapter triple (layer_planes, idx,
    scale) (models/lora.py): each lane gathers ITS adapter's low-rank pair
    and applies the delta next to the base projection, pre-RoPE.

    `attn_timer` (tracing on a card) takes one event pair around the
    paged attention, from the K/V append through the weighted sum."""
    positions = lengths[:, None]                      # [B,1]
    h = _rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    q, k, v = G._qkv(cfg, h, layer, lora)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if attn_timer is not None:
        attn_timer.begin()
    o = PA.paged_attention(q, k, v, ck, cv, tables, lengths, active,
                           block_size)
    if attn_timer is not None:
        attn_timer.end()
    x = x + G._attn_out(cfg, o, layer, lora)
    h = _rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    return x + _mlp(h, layer, cfg)


def decode_logits(params: Params, tokens: torch.Tensor, kp: torch.Tensor,
                  vp: torch.Tensor, tables: torch.Tensor,
                  lengths: torch.Tensor, active: torch.Tensor,
                  cfg: TransformerConfig, block_size: int,
                  lora=None,
                  attn_timer: Optional[devtime.DeviceTimer] = None
                  ) -> torch.Tensor:
    """The decode step's forward: tokens [B] (each slot's last token),
    kp/vp [L,N,bs,Hkv,Dh] pools (written in place), tables [B,M],
    lengths/active [B] -> logits [B, vocab] f32.  `lora` as in
    `generate.forward_step`: {"planes", "idx" [B], "scale"};
    `attn_timer` times every layer's attention (`_decode_layer`)."""
    x = _embed_lookup(params["embed"], tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        layer_lora = None if lora is None else (
            LO.layer_planes(lora["planes"], i), lora["idx"], lora["scale"])
        x = _decode_layer(cfg, x, layer_params(params, i), kp[i], vp[i],
                          tables, lengths, active, block_size, layer_lora,
                          attn_timer)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_f32(x, params, cfg)[:, 0, :]


def decode_step(params: Params, tokens: torch.Tensor, kp: torch.Tensor,
                vp: torch.Tensor, tables: torch.Tensor,
                lengths: torch.Tensor, active: torch.Tensor,
                temps: Optional[torch.Tensor],
                generator: Optional[torch.Generator],
                cfg: TransformerConfig, block_size: int, top_k: int,
                lora=None, attn_timer: Optional[devtime.DeviceTimer] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One token for every active slot, paged.

    tokens [B], kp/vp [L,N,bs,Hkv,Dh] block pools, tables [B,M],
    lengths/active [B]; temps [B] f32, or None when every lane is greedy
    (no draw is made).  Returns (next_tokens, kp, vp, new_lengths), the
    pools updated in place; inactive slots keep their state.  `lora`
    enables the gathered batched-adapter path (`decode_logits`): a batch
    mixing N adapters and base-model lanes on the null slot 0 is still
    one step; `attn_timer` times each layer's attention."""
    logits = decode_logits(params, tokens, kp, vp, tables, lengths, active,
                           cfg, block_size, lora=lora, attn_timer=attn_timer)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, _NEG),
                             logits)
    nxt = logits.argmax(-1)
    if temps is not None:
        temps = temps.clamp_min(1e-6)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled = (logits / temps[:, None] + gumbel).argmax(-1)
        nxt = torch.where(temps > 1e-5, sampled, nxt)
    nxt = torch.where(active, nxt, tokens)
    new_lengths = torch.where(active, lengths + 1, lengths)
    return nxt, kp, vp, new_lengths


class DecodeEngine:
    """Host loop + device work for continuous-batching generation.

    submit() is thread-safe; callers block on Request.wait().  One
    background thread owns all device state, the block pool and the
    adapter pool, so neither allocator needs locking.  `params` (and the
    draft's, and the adapter pool's base) must lie on `device` (None: the
    card); `generator` (default: seeded 0 on that device) draws the
    sampled tokens.  `draft=(params, cfg)` with `EngineConfig.spec` turns
    on speculative decoding; `adapters` serves LoRA adapters and
    `adapter_drafts` maps an adapter_id to its own draft weights (over the
    draft's architecture).  `migrator` (serve/migration.py) makes this a
    prefill-role engine that exports each finished prompt's KV blocks
    instead of decoding them; `role` labels the serve gauges and the block
    pool (default "prefill" with a migrator, else "engine")."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 engine_config: Optional[EngineConfig] = None,
                 generator: Optional[torch.Generator] = None,
                 draft: Optional[Tuple[Params, TransformerConfig]] = None,
                 migrator: Optional[migration.BlockMigrator] = None,
                 role: Optional[str] = None,
                 adapters: Optional[AdapterPool] = None,
                 adapter_drafts: Optional[Dict[str, Params]] = None,
                 device: DeviceLike = None):
        self.ec = engine_config or EngineConfig()
        if self.ec.admission not in ("fifo", "wfq"):
            raise ValueError(
                f"unknown admission policy {self.ec.admission!r}; "
                "expected 'fifo' or 'wfq'")
        self.device = resolve_device(device)
        for what, tree in (("params", params),
                           ("the draft's params", draft and draft[0]),
                           ("the adapter pool's base",
                            adapters and adapters.base)):
            if tree and tree["embed"].device.type != self.device.type:
                raise ValueError(
                    f"{what} lie on {tree['embed'].device}, the engine "
                    f"runs on {self.device}")
        self._params = params
        self.cfg = cfg
        self._generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        B, T = self.ec.slots, self.ec.max_len
        bs = self.ec.block_size
        # per-request logical capacity, in blocks (rounded UP: the
        # table covers max_len even when block_size doesn't divide it)
        self._blocks_per_req = kvcache.blocks_for(T, bs)
        self._capacity_tokens = self._blocks_per_req * bs
        # the serve gauges' `role` label, so two engines in one process
        # (a disaggregated prefill/decode pair) never overwrite each
        # other's series; monolithic engines report role="engine"
        self._role = role if role is not None else (
            "prefill" if migrator is not None else "engine")
        num_blocks = self.ec.num_blocks
        if num_blocks is None:
            num_blocks = B * self._blocks_per_req + 1   # + null block
        self.pool = BlockPool(num_blocks, bs, role=self._role)
        # bucket ladder = chunk-size ladder: it must cover the largest
        # prefill chunk, so extend the configured rungs by doubling
        buckets = sorted({b for b in self.ec.prefill_buckets if b <= T})
        if not buckets:
            buckets = [min(16, T)]
        chunk_max = min(self.ec.chunk_size or buckets[-1], T)
        while buckets[-1] < chunk_max:
            buckets.append(min(buckets[-1] * 2, T))
        self._buckets = tuple(buckets)
        self._chunk_max = chunk_max
        self._kp, self._vp = G.init_block_pool(cfg, num_blocks, bs,
                                               self.device)
        self._tables_np = np.zeros((B, self._blocks_per_req), np.int64)
        self._lengths = torch.zeros(B, dtype=torch.long, device=self.device)
        self._tokens = torch.zeros(B, dtype=torch.long, device=self.device)
        self._slots: List[Optional[_Slot]] = [None] * B
        self._queue: "queue.Queue[Request]" = queue.Queue()
        # loop-owned admission deque: exhaustion leaves requests here
        # (FIFO), preemption re-queues at the FRONT so the victim
        # re-admits as soon as blocks free up
        self._waiting: "collections.deque[Request]" = collections.deque()
        self._tenants_gauged: set = set()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serve-side goodput: decode-step wall time split into busy
        # lanes vs slot_idle, anchored when the engine starts serving
        self._ledger = goodput.get_ledger("serve")
        # traced device time (telemetry/devtime.py): event pairs on the
        # spans of the decode steps and prefill chunks, read after the
        # loop's own syncs (loop-thread only; none on the CPU)
        self._make_event = devtime.event_maker(self.device)
        self._timers: List[devtime.DeviceTimer] = []

        # -- multi-tenant LoRA adapters (serve/adapters.py) ----------------
        # heterogeneous-adapter lanes decode in ONE step: the stacked
        # planes plus per-slot plane indices ride the decode and prefill
        # forwards; a batch-HOMOGENEOUS step (every active lane on the
        # same adapter) runs the plain step on the pool's cached merged
        # weights, with no gather arithmetic.
        self._adapters = adapters
        self._adapter_idx = np.zeros((B,), np.int64)
        # loop-thread-only counters: which decode path each step took
        self._merged_steps = 0
        self._gathered_steps = 0

        # -- KV-block migration (serve/migration.py) -----------------------
        # prefill role: `migrator` set — a finished prefill exports its
        # blocks through the transport instead of decoding here.  decode
        # role: `import_blocks()` feeds `_imports` from any thread; the
        # loop thread copies arrived planes to the device and scatters
        # them into this pool.
        self._migrator = migrator
        self._imports: "queue.Queue[tuple]" = queue.Queue()
        self._pending_imports: "collections.deque" = collections.deque()

        # -- draft-model speculative decoding (EngineConfig.spec) ----------
        self._spec = self.ec.spec
        if self._spec is not None and migrator is not None:
            raise ValueError(
                "a prefill-role engine (migrator=...) never decodes, "
                "so EngineConfig.spec would only waste draft prefills "
                "— configure spec on the decode role instead")
        # per-adapter draft weights (adapter_id -> draft params over the
        # SAME draft architecture).  On a spec-enabled multi-tenant
        # engine a request carrying an adapter_id speculates ONLY when its
        # adapter has a draft registered here: the base draft proposing
        # for an adapter-shifted target would verify at ~0 acceptance, so
        # unmatched adapter requests take the plain decode path.
        self._adapter_drafts = dict(adapter_drafts or {})
        if self._adapter_drafts and self._spec is None:
            raise ValueError(
                "adapter_drafts without EngineConfig.spec has no effect — "
                "per-adapter drafts are a speculative-decoding surface")
        if self._adapter_drafts and adapters is None:
            raise ValueError(
                "adapter_drafts without an adapter pool: the engine could "
                "never serve the adapters those drafts propose for")
        if self._spec is not None:
            if draft is None:
                raise ValueError(
                    "EngineConfig.spec is set but no draft model was "
                    "passed — DecodeEngine(..., draft=(params, cfg))")
            if self._spec.k < 1:
                raise ValueError("SpecConfig.k must be >= 1")
            if self._spec.k > chunk_max:
                # the draft plane's scratch tail is chunk_max wide: k
                # proposals past the capacity must land in it (JAX clamps
                # such a write silently; the port's forward refuses it)
                raise ValueError(
                    f"SpecConfig.k ({self._spec.k}) must not exceed the "
                    f"prefill chunk ({chunk_max} tokens)")
            self._draft_params, self._draft_cfg = draft
            if self._draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({self._draft_cfg.vocab_size}) must "
                    f"match the target's ({cfg.vocab_size}) — the verify "
                    "step compares token ids")
            # the draft's per-slot plane carries a chunk_max scratch tail:
            # a padded prefill bucket overrunning the capacity lands there
            self._draft_plane = self._capacity_tokens + chunk_max
            # cumulative totals behind the acceptance-rate and
            # tokens-per-verify gauges (loop-thread only)
            self._spec_draft_total = 0
            self._spec_accepted_total = 0
            self._spec_emitted_total = 0
            self._spec_verifies = 0

    # -- public ----------------------------------------------------------
    def _submit_check(self, request: Request,
                      prompt_only: Optional[bool] = None
                      ) -> Optional[RequestRejected]:
        """Submit-time feasibility in KV-pool-capacity terms; None when
        schedulable.  A PREFILL-ROLE engine (migrator set) only ever holds
        the prompt blocks (prefill, export, free), so it charges the
        prompt-only footprint; the decode side's worst case is the
        composer's to check against the decode engine
        (`DisaggServing.submit` does, with ``prompt_only=False``)."""
        if not request.prompt:
            return RequestRejected("empty prompt",
                                   reason="empty_prompt")
        if request.adapter_id is not None and self._adapters is None:
            return RequestRejected(
                f"request names adapter {request.adapter_id!r} but "
                "this engine serves the base model only (no adapter "
                "pool configured)", reason="adapter")
        V = self.cfg.vocab_size
        if not all(0 <= t < V for t in request.prompt) or (
                request.eos_id is not None
                and not 0 <= request.eos_id < V):
            return RequestRejected(f"token ids must lie in [0, {V})",
                                   reason="token_ids")
        if prompt_only is None:
            prompt_only = self._migrator is not None
        bs = self.ec.block_size
        total = len(request.prompt) + (
            0 if prompt_only else request.max_new_tokens)
        what = "prompt" if prompt_only else "prompt+max_new"
        need = kvcache.blocks_for(total, bs)
        if total > self._capacity_tokens:
            return RequestRejected(
                f"{what} ({total} tokens) needs {need} KV blocks of "
                f"{bs} tokens; per-request block-table capacity is "
                f"{self._blocks_per_req} blocks "
                f"({self._capacity_tokens} tokens)")
        if need > self.pool.usable_blocks:
            return RequestRejected(
                f"{what} ({total} tokens) needs {need} KV blocks of "
                f"{bs} tokens, but the engine's whole pool holds "
                f"{self.pool.usable_blocks} usable blocks "
                f"({self.pool.usable_blocks * bs} tokens) — the "
                "request can never be scheduled")
        return None

    def submit(self, request: Request) -> Request:
        rejected = self._submit_check(request)
        if rejected is None and self.ec.max_queue_depth is not None:
            # bounded admission: sustained overload must surface as a
            # clean 429 + Retry-After, not as an unbounded loop-owned
            # deque.  The depth read races admissions harmlessly — the
            # cap is a back-pressure threshold, not an exact budget.
            depth = self._queue.qsize() + len(self._waiting)
            if depth >= self.ec.max_queue_depth:
                rejected = RequestRejected(
                    f"admission queue is full ({depth} waiting, cap "
                    f"{self.ec.max_queue_depth}); retry shortly",
                    reason="queue_full")
        if rejected is not None:
            self._finish_request(request, "rejected", rejected)
            return request
        request._engine = self
        with telemetry.span("serve.enqueue",
                            request=request.request_id,
                            prompt_len=len(request.prompt)) as span:
            request.traceparent = getattr(span, "traceparent", None)
            self._queue.put(request)
        ti.SERVE_QUEUE_DEPTH.set(self._queue.qsize()
                                 + len(self._waiting),
                                 role=self._role)
        self._wake.set()
        return request

    def generate(self, prompt: List[int], **kw) -> List[int]:
        """Convenience: submit + wait."""
        return self.submit(Request(prompt, **kw)).wait(timeout=600)

    def import_blocks(self, request: Request, header: Dict[str, Any],
                      k: torch.Tensor, v: torch.Tensor) -> Request:
        """Thread-safe: queue a migrated-in request for the loop thread to
        import (decode role).  `k`/`v` are the exported host planes
        ``[L, M, bs, Hkv, Dh]`` in table order; `request` is the live
        Request the caller owns (the loopback hands the original object
        over; a cross-host receiver constructs one from the header).  No
        device work happens here: the transport's thread may call it."""
        request._engine = self
        self._imports.put((request, header, k, v))
        self._wake.set()
        return request

    def stats(self) -> Dict[str, Any]:
        """Load snapshot: queue depth, occupied slots, slot-idle
        fraction.  Read-only and loop-thread-free — a racy glance at
        the slot list is fine for a scaling signal."""
        occupied = sum(1 for s in self._slots if s is not None)
        return {
            "queue_depth": self._queue.qsize() + len(self._waiting),
            "active_slots": occupied,
            "slots": self.ec.slots,
            "slot_idle_fraction": 1.0 - occupied / self.ec.slots,
        }

    def start(self) -> None:
        self._ledger.start_job()
        self._thread = threading.Thread(
            target=self._loop, name="tik-decode-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            if thread.is_alive():
                # wedged mid-step (e.g. a stuck device call): the loop
                # thread still OWNS the slot state, so it runs slot
                # teardown itself whenever it does exit.  The queue is
                # thread-safe though: fail never-admitted requests NOW
                # rather than leaving callers blocked until their wait
                # timeout.
                logger.warning(
                    "decode loop did not exit within 10s; deferring "
                    "slot teardown to the loop thread")
                self._drain_queue("engine stopped")
                return
        # loop exited (its finally already drained) or never started:
        # a second drain here is an idempotent no-op, and the only way
        # to fail requests queued on a never-started engine
        self._teardown()

    def _finish_request(self, req: Request, result: str,
                        error: Optional[Exception] = None,
                        finish: Optional[str] = None) -> None:
        """Single completion point: stamp done_time, emit lifecycle
        metrics + the per-request decode-window span, append the
        request-ledger record, wake the waiter.  Atomic per request —
        safe from both the loop thread and a caller thread cancelling.

        `finish` is the ledger's finish reason (done|cancelled|error|
        drained); by default it is derived from `result`."""
        with req._finish_lock:
            if req._done.is_set():
                return
            self._finish_request_locked(req, result, error, finish)

    def _finish_request_locked(self, req: Request, result: str,
                               error: Optional[Exception],
                               finish: Optional[str] = None) -> None:
        req.done_time = time.time()
        req.done_mono = time.monotonic()
        if error is not None:
            req.error = error
        first = req.first_token_time
        if first is not None:
            if len(req.tokens) > 1:
                tpot = (req.done_time - first) / (len(req.tokens) - 1)
                ti.SERVE_TPOT.observe(tpot)
                ti.SERVE_TENANT_TPOT.observe(tpot, tenant=req.tenant)
            with telemetry.trace_context(req.traceparent):
                telemetry.add_span(
                    "serve.decode", first, req.done_time - first,
                    request=req.request_id, tokens=len(req.tokens),
                    result=result)
        if result == "cancelled":
            # in the request's trace, not the cancelling thread's
            with telemetry.trace_context(req.traceparent):
                events.emit("tik_serve_cancel", request=req.request_id)
        ti.SERVE_REQUESTS.inc(result=result)
        ti.SERVE_TENANT_REQUESTS.inc(tenant=req.tenant, result=result)
        if finish is None:
            # "rejected" stays distinct from "error": submit-time
            # refusals are client-caused and spend no availability
            # budget
            finish = {"ok": reqlog.FINISH_DONE,
                      "cancelled": reqlog.FINISH_CANCELLED,
                      "rejected": reqlog.FINISH_REJECTED}.get(
                          result, reqlog.FINISH_ERROR)
        if _telemetry_state.enabled:
            for phase, seconds in reqlog.derive_phases(req).items():
                if seconds is not None:
                    ti.SERVE_PHASE_SECONDS.observe(
                        seconds, phase=phase[: -len("_s")])
        reqlog.record(req, finish)
        req._done.set()

    def _drain_queue(self, reason: str) -> None:
        while True:
            try:
                req = self._waiting.popleft()
            except IndexError:
                break
            self._finish_request(req, "error", RuntimeError(reason),
                                 finish=reqlog.FINISH_DRAINED)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._finish_request(req, "error", RuntimeError(reason),
                                 finish=reqlog.FINISH_DRAINED)
        # migrated-in requests waiting for import
        while self._pending_imports:
            self._finish_request(self._pending_imports.popleft()[0],
                                 "error", RuntimeError(reason),
                                 finish=reqlog.FINISH_DRAINED)
        while True:
            try:
                req = self._imports.get_nowait()[0]
            except queue.Empty:
                break
            self._finish_request(req, "error", RuntimeError(reason),
                                 finish=reqlog.FINISH_DRAINED)
        ti.SERVE_QUEUE_DEPTH.set(0, role=self._role)
        if self._tenants_gauged:
            self._emit_tenant_queue_depth()

    def _teardown(self, reason: str = "engine stopped") -> None:
        """Fail everything still queued or mid-decode — callers must not
        sit in wait() until their timeout after a shutdown.  The ledger
        books these as `drained`.  Every slot's blocks go back to the
        pool: after stop, used() is zero."""
        self._drain_queue(reason)
        for slot_id, slot in enumerate(self._slots):
            if slot is not None:
                self._release_slot(slot_id)
                self._finish_request(slot.request, "error",
                                     RuntimeError(reason),
                                     finish=reqlog.FINISH_DRAINED)

    # -- block-table plumbing ---------------------------------------------
    def _sync_table(self, slot_id: int) -> None:
        """Mirror a slot's block table into the host table array."""
        slot = self._slots[slot_id]
        row = self._tables_np[slot_id]
        row[:] = kvcache.NULL_BLOCK
        if slot is not None:
            row[:len(slot.table)] = slot.table

    def _release_slot(self, slot_id: int) -> None:
        """Return a slot's blocks to the pool and clear its lane.

        Released in REVERSE table order: prefix-registered blocks park
        on the evictable LRU in release order, and chain keys only
        match behind an intact head — parking the chain TAIL as the
        eviction-first entry means partial eviction leaves a usable
        prefix instead of a headless chain."""
        slot = self._slots[slot_id]
        if slot is None:
            return
        self._slots[slot_id] = None
        self.pool.release(list(reversed(slot.table)))
        slot.table = []
        if self._adapters is not None:
            # drop this request's pin; a refcount-0 adapter parks on the
            # pool's idle LRU (planes stay warm, reclaimable)
            self._adapters.release(slot.request.adapter_id)
            self._adapter_idx[slot_id] = 0
        self._sync_table(slot_id)

    def _stamp_first_token(self, slot_id: int, slot: _Slot,
                           first_tok: int) -> None:
        """The first generated token becomes visible: append it, stamp
        TTFT, seed the device-side token/length lanes.  ONE implementation
        for the monolithic prefill-completion path and the migration
        import path (imported requests stamp at IMPORT)."""
        req = slot.request
        req.tokens.append(first_tok)
        req.first_token_time = time.time()
        req.first_token_mono = time.monotonic()
        ttft = req.first_token_time - req.created
        ti.SERVE_TTFT.observe(ttft)
        ti.SERVE_TENANT_TTFT.observe(ttft, tenant=req.tenant)
        ti.SERVE_TOKENS.inc()
        slot.length = slot.true_len
        self._tokens[slot_id] = first_tok
        self._lengths[slot_id] = slot.true_len

    def _newest_slot(self) -> Optional[int]:
        """The most recently admitted occupied slot (preemption victim
        — the oldest request always progresses)."""
        newest, newest_mono = None, -1.0
        for slot_id, slot in enumerate(self._slots):
            if slot is None:
                continue
            mono = slot.request.admitted_mono or 0.0
            if mono >= newest_mono:
                newest, newest_mono = slot_id, mono
        return newest

    def _tenant_weight(self, tenant: str) -> float:
        weights = self.ec.tenant_weights or {}
        return max(float(weights.get(tenant, 1.0)), 1e-9)

    def _preempt_victim(self) -> Optional[int]:
        """Pool-exhaustion victim.  FIFO: the newest slot overall.
        WFQ: the newest slot of the MOST over-share tenant
        (slots-held / weight) — the burster pays for its own burst."""
        if self.ec.admission != "wfq":
            return self._newest_slot()
        held: Dict[str, List[int]] = {}
        for slot_id, slot in enumerate(self._slots):
            if slot is not None:
                held.setdefault(slot.request.tenant, []).append(slot_id)
        if not held:
            return None
        tenant = max(held, key=lambda t: (
            len(held[t]) / self._tenant_weight(t)))
        return max(held[tenant], key=lambda i: (
            self._slots[i].request.admitted_mono or 0.0))

    def _preempt(self, slot_id: int) -> None:
        """Pool exhausted: evict this slot's request and requeue it at
        the admission front.  The victim's computed prompt blocks are
        SALVAGED: registering them in the prefix map before release
        parks them on the evictable prefix LRU, so re-admission is a
        prefix-cache hit and only the prompt tail re-prefills."""
        slot = self._slots[slot_id]
        req = slot.request
        # prompt tokens whose prefill work is at stake right now
        at_stake = min(slot.prefill_pos, slot.true_len)
        salvaged = 0
        if self.ec.prefix_cache and at_stake >= self.ec.block_size:
            salvaged = self.pool.register_prefix(
                req.prompt[:at_stake], slot.table,
                namespace=req.adapter_id)
        self._release_slot(slot_id)
        req.tokens.clear()
        req.admitted = None
        req.admitted_mono = None
        req.first_token_time = None
        req.first_token_mono = None
        req.preemptions += 1
        ti.SERVE_PREEMPTIONS.inc()
        if at_stake:
            ti.SERVE_PREEMPTED_TOKENS.inc(at_stake)
        with telemetry.trace_context(req.traceparent):
            events.emit("tik_serve_preemption", request=req.request_id,
                        slot=slot_id, preemptions=req.preemptions,
                        tokens_at_stake=at_stake,
                        blocks_salvaged=salvaged)
        self._waiting.appendleft(req)
        ti.SERVE_QUEUE_DEPTH.set(self._queue.qsize()
                                 + len(self._waiting),
                                 role=self._role)

    def _alloc_blocks(self, slot_id: int, n: int) -> Optional[List[int]]:
        """Allocate n blocks for the slot, preempting the newest other
        request on exhaustion.  Returns None when the slot ITSELF was
        the newest and got preempted (caller abandons the operation);
        an injected `serve.kvcache.alloc` fault lands here too."""
        while True:
            try:
                return self.pool.alloc(n)
            except (BlockPoolExhausted, FaultInjected):
                victim = self._preempt_victim()
                if victim is None:
                    raise     # no slot held — submit() sizing bug
                self._preempt(victim)
                if victim == slot_id:
                    return None

    def _grow_table(self, slot_id: int, slot: _Slot, n: int) -> bool:
        blocks = self._alloc_blocks(slot_id, n)
        if blocks is None:
            return False
        slot.table.extend(blocks)
        slot.request.kv_blocks = max(slot.request.kv_blocks,
                                     len(slot.table))
        self._sync_table(slot_id)
        return True

    def _cow_block(self, slot_id: int, slot: _Slot, j: int) -> bool:
        """Copy-on-write table entry `j` if another holder shares it:
        allocate a fresh block, device-copy the contents, drop this
        holder's share.  Returns False when the slot itself was
        preempted mid-alloc."""
        if not self.pool.needs_copy(slot.table[j]):
            return True
        fresh = self._alloc_blocks(slot_id, 1)
        if fresh is None:
            return False
        G.copy_block(self._kp, self._vp, slot.table[j], fresh[0])
        self.pool.release([slot.table[j]])
        slot.table[j] = fresh[0]
        self._sync_table(slot_id)
        return True

    # -- KV-block migration (serve/migration.py) --------------------------
    def _migrate_out(self, slot_id: int, slot: _Slot,
                     first_tok: int) -> None:
        """Prefill role: export this slot's prompt KV blocks through the
        migrator and free the lane — the request lives on wherever the
        transport delivered it.  The covered blocks are gathered on the
        device and copied to the host in ONE copy, which the stream runs
        after the prefill chunk that wrote them.  A fault mid-transfer
        degrades the request to the migrator's fallback (re-prefill on
        the decode role, stamps reset like a preemption); it is never
        lost."""
        req = slot.request
        bs = self.ec.block_size
        covered = kvcache.blocks_for(slot.true_len, bs)
        table = torch.tensor(slot.table[:covered], device=self.device)
        with telemetry.trace_context(req.traceparent):
            with telemetry.span("serve.kvcache.migrate",
                                request=req.request_id,
                                tokens=slot.true_len, blocks=covered):
                k, v = G.gather_block_planes(self._kp, self._vp, table)
                # block-major [2, M, L, ...]: one dense device-to-host
                # copy, into page-locked memory on the card (the caching
                # host allocator reuses it from one migration to the next)
                planes = torch.stack((k.transpose(0, 1), v.transpose(0, 1)))
                host = torch.empty(
                    planes.shape, dtype=planes.dtype,
                    pin_memory=self.device.type == "cuda")
                host.copy_(planes)
                try:
                    self._migrator.export(
                        req, first_token=first_tok,
                        length=slot.true_len, k=host[0].transpose(0, 1),
                        v=host[1].transpose(0, 1), block_size=bs)
                except (FaultInjected, migration.MigrationError,
                        OSError) as e:
                    ti.SERVE_KV_MIGRATION_FAILURES.inc()
                    events.emit("tik_serve_migration",
                                request=req.request_id,
                                direction="out", result="failed",
                                tokens=slot.true_len, error=str(e))
                    self._release_slot(slot_id)
                    req.admitted = None
                    req.admitted_mono = None
                    fallback = self._migrator.fallback
                    if fallback is not None:
                        fallback(req)
                    else:
                        self._finish_request(req, "error", e)
                    return
            ti.SERVE_KV_MIGRATIONS.inc(direction="out")
            ti.SERVE_KV_MIGRATED_TOKENS.inc(slot.true_len,
                                            direction="out")
            events.emit("tik_serve_migration", request=req.request_id,
                        direction="out", result="ok",
                        tokens=slot.true_len, blocks=covered)
        # release AFTER the export: registered full prompt blocks park on
        # the evictable LRU, keeping this role's prefix cache warm
        self._release_slot(slot_id)

    def _import_refusal(self, req: Request, header: Dict[str, Any],
                        k: torch.Tensor) -> Optional[RequestRejected]:
        """Why a migrated-in request can never decode HERE (geometry,
        worst case past this pool, an adapter this engine lacks), or
        None.  Such a request fails alone: a FIFO head waiting for blocks
        that cannot exist would wedge every later import behind it."""
        bs = self.ec.block_size
        total = int(header["length"]) + req.max_new_tokens
        L, _M, kbs, H, D = k.shape
        if int(header["block_size"]) != bs or kbs != bs \
                or (L, H, D) != (self.cfg.n_layers, self.cfg.n_kv_heads,
                                 self.cfg.head_dim) \
                or total > self._capacity_tokens \
                or kvcache.blocks_for(total, bs) > self.pool.usable_blocks:
            return RequestRejected(
                f"migrated request carries {k.shape[1]} blocks of "
                f"{header['block_size']} tokens x {L} layers x {H} heads x "
                f"{D} and needs {total} tokens worst-case; this engine "
                f"holds {self.pool.usable_blocks} usable blocks of {bs} "
                f"tokens x {self.cfg.n_layers} x {self.cfg.n_kv_heads} x "
                f"{self.cfg.head_dim} ({self._capacity_tokens} tokens per "
                "request)")
        if req.adapter_id is not None and self._adapters is None:
            return RequestRejected(
                f"migrated request names adapter {req.adapter_id!r} but "
                "this decode engine serves the base model only (no "
                "adapter pool configured)", reason="adapter")
        return None

    def _import_tick(self) -> None:
        """Decode role: admit migrated-in requests.  Imported planes are
        copied to the device and scattered into this pool at block
        granularity, on this (the loop's) thread, before the decode step
        that reads them; full prompt blocks register in the prefix map
        (shared prefixes keep hitting across roles), and the slot starts
        DECODING from the header's first token.  Exhaustion leaves
        imports queued FIFO, exactly like `_admit`."""
        while True:
            try:
                self._pending_imports.append(self._imports.get_nowait())
            except queue.Empty:
                break
        while self._pending_imports:
            req, header, k, v = self._pending_imports[0]
            if req._done.is_set():
                self._pending_imports.popleft()
                continue
            if req._cancel:
                self._pending_imports.popleft()
                self._finish_request(
                    req, "cancelled", RequestCancelled("request cancelled"))
                continue
            slot_id = next((i for i, s in enumerate(self._slots)
                            if s is None), None)
            if slot_id is None:
                break
            refused = self._import_refusal(req, header, k)
            if refused is not None:
                self._pending_imports.popleft()
                self._finish_request(req, "error", refused)
                continue
            true_len = int(header["length"])
            n_blocks = int(k.shape[1])
            adapter_slot = 0
            if self._adapters is not None:
                try:
                    adapter_slot = self._adapters.acquire(req.adapter_id)
                except AdapterSlotsExhausted:
                    break     # every plane slot pinned: wait, FIFO
                except AdapterLoadError as e:
                    # the load failure fails the REQUEST, never the pool
                    self._pending_imports.popleft()
                    self._finish_request(req, "error", e)
                    continue
            # identical prefix blocks already cached HERE are reused (a
            # shared prompt imports once); only tail planes scatter.
            # count=False: these tokens arrived computed, so the reuse
            # saves transfer, not prefill recompute
            reuse_blocks: List[int] = []
            if self.ec.prefix_cache:
                reuse_blocks, _ = self.pool.match_prefix(
                    req.prompt, count=False, namespace=req.adapter_id)
            start = len(reuse_blocks)
            try:
                fresh = self.pool.alloc(n_blocks - start)
            except (BlockPoolExhausted, FaultInjected):
                if reuse_blocks:
                    self.pool.release(reuse_blocks)
                if self._adapters is not None:
                    self._adapters.release(req.adapter_id)
                break             # wait for blocks, FIFO
            self._pending_imports.popleft()
            try:
                with telemetry.trace_context(req.traceparent):
                    with telemetry.span("serve.kvcache.import",
                                        request=req.request_id,
                                        tokens=true_len,
                                        blocks=n_blocks - start,
                                        reused=start):
                        self._scatter_imported(reuse_blocks + fresh,
                                               start, k, v)
                        first_tok = int(header["first_token"])
                        slot = _Slot(
                            request=req, table=reuse_blocks + fresh,
                            true_len=true_len, prefill_pos=true_len,
                            length=true_len,
                            remaining=req.max_new_tokens - 1,
                            decoding=True, adapter_slot=adapter_slot)
                        if req.admitted is None:   # cross-host import
                            req.admitted = time.time()
                            req.admitted_mono = time.monotonic()
                        req.migrations += 1
                        req.migrated_tokens += true_len
                        req.kv_blocks = max(req.kv_blocks, len(slot.table))
                        self._slots[slot_id] = slot
                        self._adapter_idx[slot_id] = adapter_slot
                        self._sync_table(slot_id)
                        self._stamp_first_token(slot_id, slot, first_tok)
                        if self.ec.prefix_cache:
                            self.pool.register_prefix(
                                req.prompt, slot.table, start_block=start,
                                namespace=req.adapter_id)
                    ti.SERVE_KV_MIGRATIONS.inc(direction="in")
                    ti.SERVE_KV_MIGRATED_TOKENS.inc(true_len,
                                                    direction="in")
                    events.emit("tik_serve_migration",
                                request=req.request_id, direction="in",
                                result="ok", tokens=true_len, slot=slot_id,
                                blocks=n_blocks - start)
            except Exception as e:   # surface per-request failures
                if self._slots[slot_id] is not None:
                    self._release_slot(slot_id)
                else:     # failed before the slot took ownership
                    self.pool.release(reuse_blocks + fresh)
                    if self._adapters is not None:
                        self._adapters.release(req.adapter_id)
                self._finish_request(req, "error", e)

    def _scatter_imported(self, table: List[int], start: int,
                          k: torch.Tensor, v: torch.Tensor) -> None:
        """Copy the imported planes of `table[start:]` to the device and
        scatter them into the live pool in place.  Only those blocks are
        written: no padding, and never the null block (the pool never
        hands it out)."""
        tail = table[start:]
        if not tail:
            return
        G.scatter_block_planes(
            self._kp, self._vp, torch.tensor(tail, device=self.device),
            k[:, start:].to(self.device), v[:, start:].to(self.device))

    # -- engine loop ------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(f"chunk length {n} exceeds largest bucket")

    def _pick_waiting(self) -> int:
        """Index into the waiting deque of the next request to admit.

        FIFO: always the head.  WFQ: the head-of-line request (per-
        tenant arrival order is preserved) of the tenant with the
        LOWEST slots-held/weight share; equal shares tie-break to
        arrival order."""
        if self.ec.admission != "wfq" or len(self._waiting) <= 1:
            return 0
        held: Dict[str, int] = {}
        for slot in self._slots:
            if slot is not None:
                tenant = slot.request.tenant
                held[tenant] = held.get(tenant, 0) + 1
        best_i = 0
        best_share: Optional[float] = None
        seen: set = set()
        for i, req in enumerate(self._waiting):
            tenant = req.tenant
            if tenant in seen:
                continue       # only each tenant's head-of-line counts
            seen.add(tenant)
            share = held.get(tenant, 0) / self._tenant_weight(tenant)
            if best_share is None or share < best_share:
                best_i, best_share = i, share
        return best_i

    def _emit_tenant_queue_depth(self) -> None:
        """Per-tenant waiting counts (gauges for tenants that emptied
        out reset to 0 so a burst's tail is visible ending)."""
        if not _telemetry_state.enabled:
            return
        counts: Dict[str, int] = {}
        for req in self._waiting:
            counts[req.tenant] = counts.get(req.tenant, 0) + 1
        for tenant in self._tenants_gauged - set(counts):
            ti.SERVE_TENANT_QUEUE_DEPTH.set(0, tenant=tenant,
                                            role=self._role)
        for tenant, n in counts.items():
            ti.SERVE_TENANT_QUEUE_DEPTH.set(n, tenant=tenant,
                                            role=self._role)
        self._tenants_gauged = set(counts)

    def _admit(self) -> None:
        """Move submissions into slots.  Pool exhaustion stops
        admission (requests stay queued) — it must never crash the
        loop or drop a request.  `_pick_waiting` is the admission
        policy: FIFO arrival order, or weighted-fair across tenants."""
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        while self._waiting:
            slot_id = next((i for i, s in enumerate(self._slots)
                            if s is None), None)
            if slot_id is None:
                break
            i = self._pick_waiting()
            req = self._waiting[i]
            if req._done.is_set():
                del self._waiting[i]
                continue
            if req._cancel:   # cancelled while queued: no slot taken
                del self._waiting[i]
                self._finish_request(
                    req, "cancelled",
                    RequestCancelled("request cancelled"))
                continue
            true_len = len(req.prompt)
            if req.preemptions and self.pool.available() < \
                    kvcache.blocks_for(
                        true_len + req.max_new_tokens,
                        self.ec.block_size):
                # a preemption victim re-admits only once its WORST
                # case fits — optimistic re-admission would thrash
                break
            adapter_slot = 0
            if self._adapters is not None:
                try:
                    adapter_slot = self._adapters.acquire(req.adapter_id)
                except AdapterSlotsExhausted:
                    break     # every plane slot pinned: wait, like
                    #           KV-block exhaustion
                except AdapterLoadError as e:
                    # the load failure fails the REQUEST, never the
                    # engine: record it and admit the next one
                    del self._waiting[i]
                    self._finish_request(req, "error", e)
                    continue
            reuse_blocks: List[int] = []
            reuse_len = 0
            if self.ec.prefix_cache:
                # chain keys are salted with the adapter_id: identical
                # prompts under different adapters NEVER share KV
                reuse_blocks, reuse_len = self.pool.match_prefix(
                    req.prompt, namespace=req.adapter_id)
            need = kvcache.blocks_for(true_len, self.ec.block_size) \
                - len(reuse_blocks)
            try:
                fresh = self.pool.alloc(need)
            except (BlockPoolExhausted, FaultInjected):
                if reuse_blocks:
                    self.pool.release(reuse_blocks)
                if self._adapters is not None:
                    self._adapters.release(req.adapter_id)
                break         # exhaustion queues new admissions
            del self._waiting[i]
            try:
                req.admitted = time.time()
                req.admitted_mono = time.monotonic()
                ti.SERVE_QUEUE_WAIT.observe(req.admitted - req.created)
                req.bucket = self._bucket(
                    min(true_len - reuse_len, self._chunk_max))
                req.prefix_blocks = len(reuse_blocks)
                req.prefix_tokens = reuse_len
                slot = _Slot(request=req,
                             table=reuse_blocks + fresh,
                             true_len=true_len,
                             prefill_pos=reuse_len,
                             remaining=req.max_new_tokens - 1,
                             adapter_slot=adapter_slot)
                draft_params = self._draft_for(req)
                if draft_params is not None and req.temperature <= 0.0:
                    # private draft cache; the draft prefills the WHOLE
                    # prompt (prefix reuse only skips target compute — the
                    # draft has no shared pool).  Sampled requests never
                    # speculate, nor do adapter requests without a
                    # registered draft: they get no draft cache
                    slot.draft_cache = G.init_cache(
                        self._draft_cfg, 1, self._draft_plane, self.device)
                    slot.draft_params = draft_params
                req.kv_blocks = max(req.kv_blocks, len(slot.table))
                self._slots[slot_id] = slot
                self._adapter_idx[slot_id] = adapter_slot
                self._sync_table(slot_id)
                # re-enter the request's trace: this is the loop
                # thread, so the submit-side context does not carry over
                with telemetry.trace_context(req.traceparent):
                    events.emit("tik_serve_admission",
                                request=req.request_id, slot=slot_id,
                                prompt_len=true_len,
                                prefix_tokens=reuse_len)
            except Exception as e:   # surface per-request failures
                if self._slots[slot_id] is not None:
                    self._release_slot(slot_id)
                else:     # failed before the slot took ownership
                    self.pool.release(reuse_blocks + fresh)
                    if self._adapters is not None:
                        self._adapters.release(req.adapter_id)
                self._finish_request(req, "error", e)
        ti.SERVE_QUEUE_DEPTH.set(self._queue.qsize()
                                 + len(self._waiting),
                                 role=self._role)
        self._emit_tenant_queue_depth()

    def _device_timer(self, sp, key: str
                      ) -> Optional[devtime.DeviceTimer]:
        """A timer of span `sp`'s device time under `key`, read after
        the loop's next sync; None with telemetry off (one check) or on
        a device that keeps no times."""
        if sp is telemetry.NOOP_SPAN or self._make_event is None:
            return None
        timer = devtime.DeviceTimer(self._make_event, sp.attrs, key)
        self._timers.append(timer)
        return timer

    def _prefill_tick(self) -> None:
        """Run ONE prompt chunk for the oldest prefilling slot.  One
        chunk per loop iteration is the Sarathi interleave: a decode
        step runs between chunks, so in-flight TPOT is bounded by one
        chunk's compute, not a whole long prompt's.  With speculative
        decoding on, the draft model prefills the SAME prompt into the
        slot's private cache one chunk per tick alongside the target's;
        the slot starts decoding once BOTH caches cover the prompt (the
        first token still arrives at target-prefill completion)."""
        cand = [(s.request.admitted_mono or 0.0, i)
                for i, s in enumerate(self._slots)
                if s is not None and not s.decoding]
        if not cand:
            return
        slot_id = min(cand)[1]
        slot = self._slots[slot_id]
        req = slot.request
        try:
            if slot.prefill_pos < slot.true_len:
                chunk = min(slot.true_len - slot.prefill_pos,
                            self._chunk_max)
                covered = kvcache.blocks_for(slot.prefill_pos + chunk,
                                             self.ec.block_size)
                if len(slot.table) < covered:
                    if not self._grow_table(slot_id, slot,
                                            covered - len(slot.table)):
                        return    # preempted itself; re-admits later
                bucket = self._bucket(chunk)
                with telemetry.trace_context(req.traceparent):
                    with telemetry.span("serve.prefill",
                                        request=req.request_id,
                                        slot=slot_id,
                                        start=slot.prefill_pos,
                                        chunk_len=chunk,
                                        device_ms=None) as sp:
                        padded = np.zeros((1, bucket), np.int64)
                        padded[0, :chunk] = req.prompt[
                            slot.prefill_pos:slot.prefill_pos + chunk]
                        lora = None
                        if self._adapters is not None:
                            # the gathered-adapter prefill: the slot's
                            # adapter delta next to the base forward
                            lora = {"planes": self._adapters.planes,
                                    "idx": torch.tensor(
                                        [slot.adapter_slot],
                                        device=self.device),
                                    "scale": self._adapters.lora_cfg.scale}
                        table = torch.tensor(self._tables_np[slot_id],
                                             device=self.device)
                        ids = torch.tensor(padded, device=self.device)
                        timer = self._device_timer(sp, "device_ms")
                        if timer is not None:
                            timer.begin()
                        _, _, logits = G.paged_prefill_chunk(
                            self._params, self._kp, self._vp, table, ids,
                            slot.prefill_pos, self.cfg, lora=lora)
                        if timer is not None:
                            timer.end()
                        tok = logits[0, chunk - 1].argmax(-1)
                slot.prefill_pos += chunk
                req.prefill_chunks += 1
                ti.SERVE_PREFILL_CHUNKS.inc()
                if slot.prefill_pos >= slot.true_len:
                    # prompt complete: the final chunk's last logits ARE
                    # the first generated token
                    first_tok = int(tok)
                    if self._timers:
                        self._timers = devtime.settle(self._timers, True)
                    if self.ec.prefix_cache:
                        self.pool.register_prefix(
                            req.prompt, slot.table,
                            start_block=req.prefix_blocks,
                            namespace=req.adapter_id)
                    done_now = (req.eos_id is not None
                                and first_tok == req.eos_id) \
                        or slot.remaining <= 0
                    if self._migrator is not None and not done_now:
                        # prefill role: stream the finished blocks to the
                        # decode role and free the lane — TTFT is stamped
                        # at IMPORT, the first token rides the header
                        self._migrate_out(slot_id, slot, first_tok)
                        return
                    self._stamp_first_token(slot_id, slot, first_tok)
                    if done_now:
                        self._release_slot(slot_id)
                        self._finish_request(req, "ok")
                        return
            if slot.draft_cache is not None \
                    and slot.draft_pos < slot.true_len:
                self._draft_prefill_chunk(slot)
            if slot.prefill_pos >= slot.true_len \
                    and (slot.draft_cache is None
                         or slot.draft_pos >= slot.true_len):
                slot.decoding = True
        except Exception as e:   # surface per-request failures
            self._release_slot(slot_id)
            self._finish_request(req, "error", e)

    def _draft_prefill_chunk(self, slot: _Slot) -> None:
        """One draft-model prompt chunk into the slot's private cache,
        padded to the same bucket ladder as the target's chunks.  Pad
        garbage lands beyond the cursor and is overwritten by the next
        chunk before any query can attend it; the plane's scratch tail
        absorbs a bucket overrunning the capacity."""
        req = slot.request
        chunk = min(slot.true_len - slot.draft_pos, self._chunk_max)
        padded = np.zeros((1, self._bucket(chunk)), np.int64)
        padded[0, :chunk] = req.prompt[
            slot.draft_pos:slot.draft_pos + chunk]
        slot.draft_cache["length"] = slot.draft_pos
        G.forward_step(slot.draft_params,
                       torch.tensor(padded, device=self.device),
                       slot.draft_cache, self._draft_cfg)
        slot.draft_pos += chunk
        slot.draft_len = slot.draft_pos
        # forward_step advanced length by the PADDED width; pin it to the
        # real cursor so the next chunk overwrites the pad garbage
        slot.draft_cache["length"] = slot.draft_pos

    def _reap_cancelled(self) -> None:
        """Free slots whose request was cancelled — runs on the loop
        thread, which owns slot state."""
        for slot_id, slot in enumerate(self._slots):
            if slot is not None and slot.request._cancel:
                self._release_slot(slot_id)
                self._finish_request(
                    slot.request, "cancelled",
                    RequestCancelled("request cancelled"))

    def _prepare_decode(self, skip=frozenset()) -> None:
        """Host pre-pass before the decode step: every decoding slot's
        next write position must land in an allocated, privately-owned
        block — grow tables across block boundaries, copy-on-write any
        block another holder shares (pool.needs_copy).  Slots in `skip`
        already advanced speculatively this iteration and take no plain
        decode write."""
        for slot_id, slot in enumerate(self._slots):
            if slot is None or not slot.decoding or slot_id in skip:
                continue
            j = slot.length // self.ec.block_size
            if j >= len(slot.table):
                self._grow_table(slot_id, slot, 1)
                continue      # preempt handled inside; mask re-reads
            self._cow_block(slot_id, slot, j)

    # -- speculative decoding ---------------------------------------------
    def _draft_for(self, req: Request) -> Optional[Params]:
        """The draft weights allowed to propose for this request: the base
        draft for base-model requests; for adapter requests, the
        REGISTERED per-adapter draft or nothing (a base-model draft
        proposing for an adapter-shifted target would be rejected almost
        always), so an unmatched adapter request decodes plain."""
        if self._spec is None:
            return None
        if req.adapter_id is None:
            return self._draft_params
        return self._adapter_drafts.get(req.adapter_id)

    def _spec_width(self, slot: _Slot) -> int:
        """Verify width for a slot: pending token + proposals, capped so
        the emitted tokens can never overshoot max_new_tokens or the
        per-request KV capacity."""
        return min(self._spec.k + 1, slot.remaining,
                   self._capacity_tokens - slot.length)

    def _spec_eligible(self, slot: _Slot) -> bool:
        """Spec rounds run for greedy decoding slots only: sampled and
        verify-faulted (degraded) requests take the plain batched step,
        and a width under 2 leaves nothing worth speculating on."""
        return (slot.decoding and not slot.spec_off
                and slot.draft_cache is not None
                and slot.request.temperature <= 0.0
                and self._spec_width(slot) >= 2)

    def _spec_pass(self) -> set:
        """One draft/verify round for every eligible slot; returns the
        slot ids that advanced speculatively (they skip the plain decode
        step this iteration).  Serve-side goodput books the round's wall
        time into busy lanes vs slot_idle, like a plain decode step."""
        done: set = set()
        spec_ids = [i for i, s in enumerate(self._slots)
                    if s is not None and self._spec_eligible(s)]
        if not spec_ids:
            return done
        t_spec = time.perf_counter()
        for slot_id in spec_ids:
            slot = self._slots[slot_id]
            if slot is None or not slot.decoding:
                continue   # preempted/finished by an earlier lane
            if self._spec_step(slot_id, slot):
                done.add(slot_id)
        if done and _telemetry_state.enabled:
            dt = time.perf_counter() - t_spec
            busy = dt * len(done) / self.ec.slots
            self._ledger.attribute(goodput.BUCKET_STEP_COMPUTE, busy)
            self._ledger.attribute(goodput.BUCKET_SLOT_IDLE, dt - busy)
            self._ledger.tick()
        return done

    def _draft_propose(self, slot: _Slot, n: int) -> List[int]:
        """Catch the draft cache up to the slot's cursor ([1,1] replay of
        already-emitted tokens — at most the bonus token in steady
        state), then run the k-step draft.  Returns the first n
        proposals; the host syncs once, after the k forwards."""
        req = slot.request
        cache = slot.draft_cache
        while slot.draft_len < slot.length:
            tok = req.tokens[slot.draft_len - slot.true_len]
            G.forward_step(slot.draft_params,
                           torch.tensor([[tok]], device=self.device),
                           cache, self._draft_cfg)
            slot.draft_len += 1
        toks, _ = G.draft_propose(
            slot.draft_params, torch.tensor(req.tokens[-1],
                                            device=self.device),
            cache, self._draft_cfg, self._spec.k)
        slot.draft_len += self._spec.k
        return toks.tolist()[:n]

    def _spec_step(self, slot_id: int, slot: _Slot) -> bool:
        """One draft/verify round for a slot: k draft forwards plus ONE
        target verify over the paged pool, emitting 1..k+1 tokens.  The
        longest proposal prefix matching the target's greedy tokens is
        accepted and the target's own token at the first mismatch (or the
        bonus token) is always emitted.  Rejected positions rewind the
        write cursor (stale K/V past it is masked and overwritten before
        it can be attended) and speculation-only blocks go back to the
        pool; any shared block the verify would write is copied first.
        Returns True when the slot advanced (or finished)."""
        req = slot.request
        bs = self.ec.block_size
        length = slot.length
        W = self._spec_width(slot)
        try:
            fire_verify_seam(req.request_id, W)
        except FaultInjected:
            # degrade THIS request to plain decode; nothing was written
            # and the draft cache can never be read again — release it
            slot.spec_off = True
            slot.draft_cache = None
            return False
        try:
            # the verify writes positions [length, length+W): cover them,
            # and COW any block another holder shares before appending
            covered = kvcache.blocks_for(length + W, bs)
            if len(slot.table) < covered:
                if not self._grow_table(slot_id, slot,
                                        covered - len(slot.table)):
                    return False   # preempted itself; re-admits later
            for j in range(length // bs, (length + W - 1) // bs + 1):
                if not self._cow_block(slot_id, slot, j):
                    return False   # preempted itself; re-admits later
            # the verify scores the REQUEST'S target: for an adapter slot
            # that is base+delta, the pool's cached merged weights
            target_params = self._params if req.adapter_id is None \
                else self._adapters.merged(req.adapter_id)
            with telemetry.trace_context(req.traceparent):
                with telemetry.span("serve.spec.verify",
                                    request=req.request_id,
                                    slot=slot_id, width=W):
                    proposals = self._draft_propose(slot, W - 1)
                    padded = np.zeros((1, self._spec.k + 1), np.int64)
                    padded[0, 0] = req.tokens[-1]
                    padded[0, 1:W] = proposals
                    _, _, logits = G.paged_verify(
                        target_params, self._kp, self._vp,
                        torch.tensor(self._tables_np[slot_id],
                                     device=self.device),
                        torch.tensor(padded, device=self.device),
                        length, self.cfg)
                    target = logits[0].argmax(-1).tolist()
            accepted = 0
            while accepted < W - 1 \
                    and target[accepted] == proposals[accepted]:
                accepted += 1
            emitted = proposals[:accepted] + [target[accepted]]
            req.spec_steps += 1
            req.draft_tokens += W - 1
            req.accepted_tokens += accepted
            ti.SERVE_SPEC_STEPS.inc()
            ti.SERVE_SPEC_DRAFT_TOKENS.inc(W - 1)
            if accepted:
                ti.SERVE_SPEC_ACCEPTED_TOKENS.inc(accepted)
            if _telemetry_state.enabled:
                self._spec_draft_total += W - 1
                self._spec_accepted_total += accepted
                self._spec_emitted_total += len(emitted)
                self._spec_verifies += 1
                ti.SERVE_SPEC_ACCEPTANCE.set(
                    self._spec_accepted_total / self._spec_draft_total)
                ti.SERVE_SPEC_TOKENS_PER_VERIFY.set(
                    self._spec_emitted_total / self._spec_verifies)
            eos = req.eos_id
            hit_eos = False
            kept: List[int] = []
            for tok in emitted:
                kept.append(tok)
                if eos is not None and tok == eos:
                    hit_eos = True
                    break
            req.tokens.extend(kept)
            ti.SERVE_TOKENS.inc(len(kept))
            new_length = length + accepted + 1
            slot.length = new_length
            slot.remaining -= len(kept)
            if hit_eos or slot.remaining <= 0 \
                    or new_length + 1 >= self._capacity_tokens:
                self._release_slot(slot_id)
                self._finish_request(req, "ok")
                return True
            self._tokens[slot_id] = kept[-1]
            self._lengths[slot_id] = new_length
            # rewind the draft behind any rejected positions; a full
            # acceptance leaves it one token (the bonus) behind and the
            # next round's catch-up replays it
            if slot.draft_len > new_length:
                slot.draft_len = new_length
                slot.draft_cache["length"] = new_length
            # free speculation-only blocks past the accepted cursor (one
            # block of headroom stays for the pending token)
            needed = kvcache.blocks_for(new_length + 1, bs)
            if len(slot.table) > needed:
                extra = slot.table[needed:]
                del slot.table[needed:]
                self.pool.release(extra)
                self._sync_table(slot_id)
            return True
        except Exception as e:   # surface per-request failures
            self._release_slot(slot_id)
            self._finish_request(req, "error", e)
            return False

    def _step(self) -> None:
        spec_done: set = frozenset()
        if self._spec is not None:
            spec_done = self._spec_pass()
        self._prepare_decode(skip=spec_done)
        decoding = [s is not None and s.decoding and i not in spec_done
                    for i, s in enumerate(self._slots)]
        n_active = sum(decoding)
        # spec slots whose request finished inside the round are free
        # lanes now — count only the ones still occupied as active
        n_spec = sum(1 for i in spec_done if self._slots[i] is not None)
        ti.SERVE_ACTIVE_SLOTS.set(n_active + n_spec, role=self._role)
        if n_active == 0:
            return
        seams.fire("serve.decode_step", active=n_active)
        with telemetry.span("serve.decode_step", active=n_active,
                            device_ms=None, attn_device_ms=None,
                            paged_attn_launches=None) as sp:
            with telemetry.span("serve.decode.prepare"):
                temps = np.array(
                    [s.request.temperature if decoding[i] else 0.0
                     for i, s in enumerate(self._slots)], np.float32)
                dev = self.device
                params, lora = self._params, None
                if self._adapters is not None:
                    active_ids = {self._slots[i].request.adapter_id
                                  for i, on in enumerate(decoding) if on}
                    if len(active_ids) == 1:
                        # batch-HOMOGENEOUS step: every active lane wears
                        # the same adapter — the pool's cached merged
                        # weights ride the plain step, with no gather
                        # arithmetic
                        self._merged_steps += 1
                        params = self._adapters.merged(
                            next(iter(active_ids)))
                    else:
                        # heterogeneous adapters decode in ONE step:
                        # per-slot plane indices gather each lane's
                        # low-rank pair
                        self._gathered_steps += 1
                        lora = {"planes": self._adapters.planes,
                                "idx": torch.tensor(self._adapter_idx,
                                                    device=dev),
                                "scale": self._adapters.lora_cfg.scale}
                tables = torch.tensor(self._tables_np, device=dev)
                active = torch.tensor(decoding, device=dev)
                temps_t = torch.tensor(temps, device=dev) \
                    if (temps > 1e-5).any() else None
            step_timer = self._device_timer(sp, "device_ms")
            attn_timer = self._device_timer(sp, "attn_device_ms")
            with telemetry.span("serve.decode.launch"):
                if step_timer is not None:
                    step_timer.begin()
                launched = PA.LAUNCHES
                nxt, self._kp, self._vp, self._lengths = decode_step(
                    params, self._tokens, self._kp, self._vp, tables,
                    self._lengths, active, temps_t, self._generator,
                    self.cfg, self.ec.block_size, self.ec.top_k, lora=lora,
                    attn_timer=attn_timer)
                if step_timer is not None:
                    step_timer.end()
                sp.set(paged_attn_launches=PA.LAUNCHES - launched)
            self._tokens = nxt
            with telemetry.span("serve.decode.wait"):
                host_tokens = nxt.tolist()      # the step's one host sync
        ti.SERVE_TOKENS.inc(n_active)
        if self._timers:
            self._timers = devtime.settle(self._timers, True)
        if sp is not telemetry.NOOP_SPAN:
            # slot-idle accounting: a decode step's wall time (its
            # span's) splits into productive lanes (occupied slots) and
            # idle lanes — the serve-side goodput view
            dt = sp.dur
            busy = dt * n_active / self.ec.slots
            self._ledger.attribute(goodput.BUCKET_STEP_COMPUTE, busy)
            self._ledger.attribute(goodput.BUCKET_SLOT_IDLE, dt - busy)
            ti.SERVE_SLOT_IDLE_FRACTION.set(
                1.0 - n_active / self.ec.slots, role=self._role)
            self._ledger.tick()
        for slot_id, slot in enumerate(self._slots):
            if slot is None or not decoding[slot_id]:
                continue
            tok = host_tokens[slot_id]
            slot.request.tokens.append(tok)
            slot.length += 1
            slot.remaining -= 1
            done = slot.remaining <= 0 or \
                (slot.request.eos_id is not None
                 and tok == slot.request.eos_id) or \
                slot.length + 1 >= self._capacity_tokens
            if done:
                self._release_slot(slot_id)
                self._finish_request(slot.request, "ok")

    def _loop(self) -> None:
        # grad mode is thread-local: the caller's no_grad does not reach
        # this thread
        with torch.inference_mode():
            try:
                while not self._stop.is_set():
                    try:
                        self._reap_cancelled()
                        self._import_tick()
                        self._admit()
                        prefilling = any(
                            s is not None and not s.decoding
                            for s in self._slots)
                        if prefilling:
                            self._prefill_tick()
                        if _telemetry_state.enabled:
                            ti.SERVE_PREFILL_PENDING.set(sum(
                                s.true_len - s.prefill_pos
                                for s in self._slots
                                if s is not None and not s.decoding),
                                role=self._role)
                        if any(s is not None and s.decoding
                               for s in self._slots):
                            self._step()
                        elif not prefilling \
                                and all(s is None for s in self._slots) \
                                and self._queue.empty() \
                                and not self._pending_imports \
                                and self._imports.empty():
                            self._wake.wait(timeout=0.5)
                            self._wake.clear()
                            # waiting with no work: fold the gap into idle
                            self._ledger.tick()
                    except Exception:
                        logger.exception("decode engine loop error")
                        # fail everything in flight rather than hang
                        # callers
                        for slot_id, slot in enumerate(self._slots):
                            if slot is not None:
                                self._release_slot(slot_id)
                                self._finish_request(
                                    slot.request, "error", RuntimeError(
                                        "engine loop failed; see logs"))
            finally:
                # slot/queue teardown happens HERE, on the thread that
                # owns the slot state
                self._teardown()
                # device times left after the last sync: read those the
                # stream has passed (no sync added)
                if self._timers:
                    self._timers = devtime.settle(self._timers, False)
