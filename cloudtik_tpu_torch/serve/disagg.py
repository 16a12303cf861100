"""Disaggregated prefill/decode serving: two engines, one request path.

Counterpart of `cloudtik_tpu/serve/disagg.py` (the DistServe / Splitwise
split on the paged engine), on PyTorch:

  * the **prefill role** is a `DecodeEngine` handed a
    :class:`~cloudtik_tpu_torch.serve.migration.BlockMigrator`: it runs
    chunked prefill only and, at prompt completion, exports the request's
    KV blocks and first token through the migration transport, freeing
    the lane for the next prompt;
  * the **decode role** is a plain `DecodeEngine` fed through
    `import_blocks()`: its loop thread copies the planes to the device and
    scatters them into its own pool, full prompt blocks register in its
    prefix map, and the slot starts decoding from the first token.

:class:`DisaggServing` wires the pair with an in-process
:class:`~cloudtik_tpu_torch.serve.migration.LoopbackTransport` (the
transport is dumb bytes: a socket transport moves the decode role to
another host without changing either engine).  Requests submit to the
prefill role, after the decode role's up-front capacity check; a
mid-transfer `serve.kvcache.migrate` fault degrades the request to a plain
submit on the decode role (re-prefill there), so a torn transfer costs
recompute, never the request.

The decode role should hold most of the block budget: prefill-role slots
and blocks turn over per prompt (held for one prefill, then exported and
freed).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch

from cloudtik_tpu_torch.serve import migration
from cloudtik_tpu_torch.serve.engine import DecodeEngine, Request


class DisaggServing:
    """One prefill-role + one decode-role engine behind a submit().

    Drop-in for a `DecodeEngine` where callers only submit/generate:
    `submit()` routes to the prefill role, completion (and the request
    ledger record) happens on the decode role.  `transport_factory` builds
    the sender-side transport from the receiver callable (default: the
    in-process loopback).  Both engines run on `device`; `generator`
    draws the decode role's sampled tokens (the prefill role's first
    token is its chunk's argmax, as in the reference)."""

    def __init__(self, params, cfg, prefill_config, decode_config,
                 transport_factory=None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        self._inbox = migration.MigrationInbox(self._deliver)
        factory = transport_factory or migration.LoopbackTransport
        transport = factory(self._inbox.feed)
        migrator = migration.BlockMigrator(transport,
                                           fallback=self._fallback)
        self.prefill = DecodeEngine(params, cfg, prefill_config,
                                    migrator=migrator, device=device)
        self.decode = DecodeEngine(params, cfg, decode_config,
                                   generator=generator, role="decode",
                                   device=device)
        # requests in flight between export and import, by id: the
        # loopback's out-of-band handoff of the live Request object
        self._pending: Dict[int, Request] = {}
        self._lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self.decode.start()
        self.prefill.start()

    def stop(self) -> None:
        self.prefill.stop()
        self.decode.stop()
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for req in pending:
            req.cancel()

    # -- request path -----------------------------------------------------
    def submit(self, request: Request) -> Request:
        # the prefill role only charges the PROMPT footprint, so the
        # decode role's worst case is checked here, up front — before any
        # prefill work is spent on a request that could never finish
        rejected = self.decode._submit_check(request, prompt_only=False)
        if rejected is not None:
            self.decode._finish_request(request, "rejected", rejected)
            return request
        with self._lock:
            # purge entries whose request already finished on the
            # prefill role (rejected/cancelled before migration)
            for rid in [r for r, q in self._pending.items()
                        if q._done.is_set()]:
                del self._pending[rid]
            self._pending[request.request_id] = request
        return self.prefill.submit(request)

    def generate(self, prompt, **kw):
        """Convenience: submit + wait (mirrors DecodeEngine)."""
        return self.submit(Request(prompt, **kw)).wait(timeout=600)

    # -- migration plumbing (runs on the prefill engine's loop thread) ----
    def _claim(self, request_id: int) -> Optional[Request]:
        with self._lock:
            return self._pending.pop(request_id, None)

    def _deliver(self, header: Dict[str, Any], k: torch.Tensor,
                 v: torch.Tensor) -> None:
        req = self._claim(int(header["request_id"]))
        if req is None:
            return          # finished/cancelled while in flight
        self.decode.import_blocks(req, header, k, v)

    def _fallback(self, req: Request) -> None:
        """Degrade path for a torn transfer: plain re-prefill submit on
        the decode role (it keeps full prefill capability for this)."""
        self._claim(req.request_id)
        self.decode.submit(req)
