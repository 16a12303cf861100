"""Model-serving HTTP server (`tik-serve`), on PyTorch.

Counterpart of `cloudtik_tpu/serve/server.py`: one stdlib-threaded HTTP
server in front of the port's `generate` (one request at a time) or, with
`--engine`, of the continuous-batching `DecodeEngine` (serve/engine.py):

  POST /v1/generate  {"tokens": [[...]], "max_new_tokens": 8, ...}
  GET  /healthz                                       liveness
  GET  /v1/models                                     what's loaded

`BackendError`, `ModelBackend` and `ServeServer` (with its graceful drain
and its adoption of a caller's `traceparent` header) are this package's
own copies of the JAX package's, which this package does not import.  The
daemon installs the request ledger (serve/reqlog.py) at boot.  The engine
serves speculatively with `--spec-model`, LoRA adapters through
`--adapters-dir` or `engine_backend(adapter_loader=...)`, and, with
`--disagg`, through a prefill-role and a decode-role engine joined by
KV-block migration (serve/disagg.py).  Weights come from a trainer
checkpoint with `--checkpoint-dir` (and the draft's with
`--spec-checkpoint-dir`), read by a partial restore of its params
(train/checkpoint.py; `tools/import_jax_checkpoint.py` converts the JAX
package's).  With `--replica-id` and `--state-host` the server heartbeats
into the serving fabric's replica registry (serve/replicas.py), where the
prefix-affinity router (`python -m cloudtik_tpu_torch.serve.router`)
finds it; SIGTERM drains the registration first.  Not here yet: the GBDT
backend.

    python -m cloudtik_tpu_torch.serve.server --model tpu_1b
    python -m cloudtik_tpu_torch.serve.server --engine --model tpu_1b
    python -m cloudtik_tpu_torch.serve.server --engine --model tpu_1b \
        --spec-model tpu_120m --spec-k 4
    python -m cloudtik_tpu_torch.serve.server --engine --model tpu_1b \
        --disagg --prefill-slots 2
    python -m cloudtik_tpu_torch.serve.server --model tpu_1b \
        --checkpoint-dir /path/to/run/checkpoints
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch import telemetry

logger = logging.getLogger(__name__)


class BackendError(Exception):
    """A request that failed AFTER acquiring an identity: carries the
    response headers so the error response still identifies the request."""

    def __init__(self, message: str,
                 headers: Optional[Dict[str, str]] = None,
                 status: int = 400, reason: Optional[str] = None):
        super().__init__(message)
        self.headers = dict(headers or {})
        self.status = status
        # machine-readable rejection reason echoed in the response body
        self.reason = reason


class ModelBackend:
    """name + callable endpoints: {route_suffix: fn(payload) -> dict}."""

    def __init__(self, name: str,
                 endpoints: Dict[str, Callable[[Dict[str, Any]],
                                               Dict[str, Any]]]):
        self.name = name
        self.endpoints = endpoints


def transformer_backend(model: str = "tiny",
                        checkpoint_dir: Optional[str] = None,
                        device=None, params=None,
                        **config_overrides) -> ModelBackend:
    """Generation endpoint on the transformer family.

    The weights are the params of the newest checkpoint under
    `checkpoint_dir` (a partial restore, in the preset's `param_dtype`);
    else `params`, a numpy tree as the JAX `init_params` gives it
    (converted by `convert.params_from_jax`); else `init_params` with a
    generator seeded 0.  The backend keeps its `params` and `cfg` as
    attributes."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch.device import resolve_device
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = T.config(model, **config_overrides)
    params = _initial_params(cfg, dev, checkpoint_dir, params)

    def generate(payload: Dict[str, Any]) -> Dict[str, Any]:
        tokens = np.asarray(payload["tokens"], np.int64)
        max_new = int(payload.get("max_new_tokens", 16))
        temperature = float(payload.get("temperature", 0.0))
        top_k = int(payload.get("top_k", 0))
        seed = int(payload.get("seed", 0))
        # validate on the host: a bad id would fault the device mid-kernel
        if tokens.ndim != 2 or tokens.shape[1] == 0:
            raise ValueError(f"tokens must be [batch, seq] with seq >= 1, "
                             f"got shape {tokens.shape}")
        if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            raise ValueError(f"token ids must lie in [0, {cfg.vocab_size})")
        if not 0 <= top_k <= cfg.vocab_size:
            raise ValueError(f"top_k must lie in [0, {cfg.vocab_size}]")
        out = G.generate(
            params, torch.from_numpy(tokens).to(dev), cfg,
            max_new_tokens=max_new, temperature=temperature, top_k=top_k,
            generator=torch.Generator(device=dev).manual_seed(seed))
        return {"tokens": out.cpu().tolist()}

    backend = ModelBackend(f"transformer:{model}", {"generate": generate})
    backend.params = params
    backend.cfg = cfg
    return backend


def _initial_params(cfg, dev, checkpoint_dir: Optional[str], params):
    """A backend's weights: restored from `checkpoint_dir`, converted from
    a numpy `params` tree (a tree of tensors, such as a trainer's, is
    taken as it is, moved to `dev`), or made from seed 0."""
    import torch

    from cloudtik_tpu_torch import convert
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.train.checkpoint import restore_params
    from cloudtik_tpu_torch.tree import tree_leaves, tree_map

    if checkpoint_dir:
        return restore_params(checkpoint_dir, T.init_params(
            torch.Generator(), cfg, "meta"), dev)
    if params is not None:
        if all(isinstance(p, torch.Tensor) for p in tree_leaves(params)):
            return tree_map(lambda p: p.detach().to(dev), params)
        return convert.params_from_jax(params, dev)
    return T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)


def engine_backend(model: str = "tiny",
                   checkpoint_dir: Optional[str] = None,
                   slots: int = 4, max_len: int = 512,
                   block_size: int = 16,
                   num_blocks: Optional[int] = None,
                   spec_model: Optional[str] = None,
                   spec_checkpoint_dir: Optional[str] = None,
                   spec_k: int = 4,
                   disagg: bool = False,
                   prefill_slots: int = 2,
                   prefill_blocks: Optional[int] = None,
                   adapters_dir: Optional[str] = None,
                   adapter_loader: Optional[Callable[[str], Any]] = None,
                   adapter_slots: int = 8,
                   lora_rank: int = 16,
                   lora_alpha: float = 32.0,
                   admission: str = "fifo",
                   tenant_weights: Optional[Dict[str, float]] = None,
                   max_queue_depth: Optional[int] = None,
                   device=None, params=None,
                   **config_overrides) -> ModelBackend:
    """Continuous-batching generation endpoint (serve/engine.py).

    Each HTTP request submits ONE prompt to the shared DecodeEngine and
    blocks on its result; the ThreadingHTTPServer's concurrency is what
    fills the engine's decode slots.  `spec_model` enables draft-model
    speculative decoding: the named preset, its weights made from seed 0
    as the target's are, proposes `spec_k` greedy tokens per round and
    ONE target verify accepts the matching prefix (so `spec_model` equal
    to `model` is a self-draft), or restored from `spec_checkpoint_dir`.
    `disagg` splits serving into a prefill-role engine (`prefill_slots`,
    `prefill_blocks`) streaming finished KV blocks to a decode-role engine
    (`slots`, `num_blocks`) over the in-process migration transport
    (serve/disagg.py); admission, `tenant_weights` and `max_queue_depth`
    then apply to the prefill role, where requests arrive, and `disagg`
    with `spec_model` or with adapters raises ValueError, as the
    reference does.
    `adapters_dir` (adapters restored from `<adapters_dir>/<adapter_id>`
    checkpoints) or `adapter_loader` (adapter_id -> adapter tree) turns
    on multi-tenant LoRA: requests naming ``"adapter": "<id>"`` load into
    an adapter pool of `adapter_slots` plane slots at rank `lora_rank`
    and alpha `lora_alpha`; ``"tenant"`` tags a request for per-tenant
    metrics and (with ``admission="wfq"`` + `tenant_weights`)
    weighted-fair admission.  `max_queue_depth` bounds the admission
    queue (overflow is a 429 + Retry-After).  `checkpoint_dir`, `params`
    and `device` as in `transformer_backend`.  The backend keeps `engine`
    (a `DecodeEngine`, or the `DisaggServing` pair; for stop()), `params`
    and `cfg` as attributes."""
    from cloudtik_tpu_torch.device import resolve_device
    from cloudtik_tpu_torch.models import transformer as T
    from cloudtik_tpu_torch.models.lora import LoRAConfig
    from cloudtik_tpu_torch.serve.adapters import (
        AdapterPool, checkpoint_loader)
    from cloudtik_tpu_torch.serve.disagg import DisaggServing
    from cloudtik_tpu_torch.serve.engine import (
        DecodeEngine, EngineConfig, Request, RequestRejected, SpecConfig)

    if disagg and (adapters_dir or adapter_loader is not None):
        raise ValueError("--disagg and --adapters-dir are mutually "
                         "exclusive for now (migration headers carry no "
                         "adapter identity)")
    if disagg and spec_model:
        raise ValueError("--disagg and --spec-model are mutually "
                         "exclusive (imported requests decode plain; run "
                         "spec on a monolithic engine)")
    cfg = T.config(model, **config_overrides)
    lora_cfg = LoRAConfig(rank=lora_rank, alpha=lora_alpha)
    if adapters_dir:
        adapter_loader = checkpoint_loader(adapters_dir, cfg, lora_cfg)
    dev = resolve_device(device)
    params = _initial_params(cfg, dev, checkpoint_dir, params)
    draft = spec = None
    if spec_model:
        draft_cfg = T.config(spec_model, **config_overrides)
        draft = (_initial_params(draft_cfg, dev, spec_checkpoint_dir, None),
                 draft_cfg)
        spec = SpecConfig(k=spec_k)
    pool = None
    if adapter_loader is not None:
        pool = AdapterPool(params, cfg, lora_cfg, loader=adapter_loader,
                           capacity=adapter_slots)
    if disagg:
        # admission happens on the PREFILL role (DisaggServing.submit
        # forwards there), so the queue bound and fairness policy wire
        # into its config
        engine = DisaggServing(
            params, cfg,
            EngineConfig(slots=prefill_slots, max_len=max_len,
                         block_size=block_size, num_blocks=prefill_blocks,
                         admission=admission, tenant_weights=tenant_weights,
                         max_queue_depth=max_queue_depth),
            EngineConfig(slots=slots, max_len=max_len,
                         block_size=block_size, num_blocks=num_blocks),
            device=dev)
    else:
        engine = DecodeEngine(
            params, cfg, EngineConfig(
                slots=slots, max_len=max_len, block_size=block_size,
                num_blocks=num_blocks, spec=spec, admission=admission,
                tenant_weights=tenant_weights,
                max_queue_depth=max_queue_depth),
            draft=draft, adapters=pool, device=dev)
    engine.start()

    def generate(payload: Dict[str, Any]):
        tokens = payload["tokens"]
        prompt = tokens[0] if tokens and isinstance(tokens[0], list) \
            else tokens
        req = engine.submit(Request(
            [int(t) for t in prompt],
            max_new_tokens=int(payload.get("max_new_tokens", 16)),
            temperature=float(payload.get("temperature", 0.0)),
            eos_id=(int(payload["eos_id"])
                    if "eos_id" in payload else None),
            tenant=str(payload.get("tenant", "default")),
            adapter_id=payload.get("adapter")))
        # the request's identity goes back in response headers, on the
        # error path too: the client joins its call to the request
        # ledger (by request_id) and to the trace (by the traceparent)
        headers = {"x-tik-request-id": str(req.request_id)}
        if req.traceparent:
            headers["x-tik-traceparent"] = req.traceparent
        try:
            tokens = req.wait(timeout=600)
        except RequestRejected as e:
            # submit-time refusal: 413 for a request the pool can never
            # hold, 429 + Retry-After for a full admission queue, 400
            # for a malformed one; the machine-readable reason rides
            # the body
            if e.reason == "capacity":
                status = 413
            elif e.reason == "queue_full":
                status = 429
                headers["Retry-After"] = "1"
            else:
                status = 400
            raise BackendError(str(e), headers, status=status,
                               reason=e.reason) from e
        except Exception as e:
            raise BackendError(str(e), headers) from e
        return ({"tokens": [tokens],
                 "request_id": req.request_id}, headers)

    name = f"transformer-engine-disagg:{model}" if disagg \
        else f"transformer-engine:{model}"
    backend = ModelBackend(name, {"generate": generate})
    backend.engine = engine          # exposes stop() for clean shutdown
    backend.params = params
    backend.cfg = cfg
    return backend


class _HTTPServer(ThreadingHTTPServer):
    # a listen backlog for a burst of concurrent clients (the stdlib's 5
    # lets a burst of 16 connects be reset before they are accepted)
    request_queue_size = 128


class ServeServer:
    """Threaded HTTP server over one or more backends.

    ``drain()`` begins graceful shutdown: new submits are REFUSED with
    503 + a ``Retry-After`` hint, while requests already being handled
    finish normally.  A request is never accepted-then-drained."""

    def __init__(self, backends, host: str = "0.0.0.0", port: int = 0):
        self.backends = list(backends)
        routes: Dict[str, Callable] = {}
        for b in self.backends:
            for suffix, fn in b.endpoints.items():
                routes[f"/v1/{suffix}"] = fn
        models = [b.name for b in self.backends]
        self._draining = threading.Event()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, obj: Dict[str, Any],
                      extra_headers: Optional[Dict[str, str]] = None
                      ) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (extra_headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    self._send(200, {"models": models})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                fn = routes.get(self.path)
                if fn is None:
                    self._send(404, {"error": "not found"})
                    return
                # refuse BEFORE accepting, so a router/client can spill
                if not server._admit():
                    self._send(503, {"error": "server is draining",
                                     "reason": "draining"},
                               {"Retry-After": "1"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(
                        self.rfile.read(length) or b"{}")
                    # adopt the caller's W3C traceparent header, so the
                    # served request (engine spans included) is one trace
                    with telemetry.trace_context(
                            self.headers.get("traceparent")):
                        result = fn(payload)
                    # backends may return (payload, headers)
                    if isinstance(result, tuple):
                        obj, extra_headers = result
                        self._send(200, obj, extra_headers)
                    else:
                        self._send(200, result)
                except BackendError as e:
                    logger.exception("serve request failed")
                    body = {"error": str(e)}
                    if e.reason:
                        body["reason"] = e.reason
                    self._send(e.status, body, e.headers)
                except Exception as e:
                    logger.exception("serve request failed")
                    self._send(400, {"error": str(e)})
                finally:
                    server._done()

        self._server = _HTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tik-serve",
            daemon=True)
        self._thread.start()

    # -- graceful drain ---------------------------------------------------
    def _admit(self) -> bool:
        """Count a request in unless drain began; the refusal happens
        under the lock so drain() can never miss an in-flight one."""
        with self._inflight_cv:
            if self._draining.is_set():
                return False
            self._inflight += 1
            return True

    def _done(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_cv.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, grace_s: float = 30.0) -> bool:
        """Refuse new submits (503 + Retry-After) and wait up to
        ``grace_s`` for in-flight requests to finish.  Returns True
        when the server emptied in time.  stop() still owns the actual
        socket teardown."""
        with self._inflight_cv:
            self._draining.set()
            deadline = time.monotonic() + grace_s
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(timeout=remaining)
            return True

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def drain_and_stop(server: ServeServer, backends,
                   grace_s: float = 30.0) -> bool:
    """Graceful shutdown: refuse new submits (503 + Retry-After), let
    in-flight requests finish for up to `grace_s`, then stop each
    backend's engine and the server.  Returns whether the server emptied
    in time."""
    drained = server.drain(grace_s=grace_s)
    for backend in backends:
        engine = getattr(backend, "engine", None)
        if engine is not None:
            engine.stop()
    server.stop()
    return drained


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("tik-serve")
    p.add_argument("--model", default="tiny",
                   help="transformer preset to serve")
    p.add_argument("--checkpoint-dir", default=None,
                   help="serve the params of the newest checkpoint under "
                        "this trainer checkpoint directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--engine", action="store_true",
                   help="continuous-batching decode engine (concurrent "
                        "requests share decode steps)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--block-size", type=int, default=16,
                   help="KV cache page size in tokens (engine mode)")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV pool size in blocks (engine mode; default "
                        "fully provisions slots x max_len)")
    p.add_argument("--spec-model", default=None,
                   help="draft-model preset for speculative decoding "
                        "(engine mode; greedy output stays what plain "
                        "decode gives)")
    p.add_argument("--spec-checkpoint-dir", default=None,
                   help="the draft's weights from this trainer checkpoint "
                        "directory (default: seed 0)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens proposed per verify")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated serving (engine mode): a "
                        "prefill-role engine streams finished KV blocks "
                        "to the decode-role engine; --slots/--num-blocks "
                        "size the decode role")
    p.add_argument("--prefill-slots", type=int, default=2,
                   help="prefill-role lanes (--disagg)")
    p.add_argument("--prefill-blocks", type=int, default=None,
                   help="prefill-role KV pool size in blocks (--disagg; "
                        "default fully provisions the prefill slots)")
    p.add_argument("--adapters-dir", default=None,
                   help="LoRA adapters from trainer checkpoints: "
                        "<dir>/<adapter_id> each (engine mode)")
    p.add_argument("--adapter-slots", type=int, default=8,
                   help="resident-adapter capacity (LRU evicts idle "
                        "adapters past it)")
    p.add_argument("--lora-rank", type=int, default=16,
                   help="LoRA rank the adapters were trained at")
    p.add_argument("--lora-alpha", type=float, default=32.0,
                   help="LoRA alpha (delta scale = alpha / rank)")
    p.add_argument("--admission", choices=["fifo", "wfq"],
                   default="fifo",
                   help="admission policy: fifo (arrival order) or "
                        "wfq — weighted-fair across tenants")
    p.add_argument("--tenant-weight", action="append", default=[],
                   metavar="TENANT=WEIGHT",
                   help="wfq share weight for a tenant (repeatable; "
                        "unlisted tenants weigh 1.0)")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="admission-queue bound: submits past this "
                        "many waiting requests get 429 + Retry-After")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--replica-id", default=None,
                   help="register this server in the serving-fabric "
                        "replica registry under this id (needs "
                        "--state-host); the affinity router then routes "
                        "to it")
    p.add_argument("--state-host", default=None,
                   help="head state server holding the replica registry")
    p.add_argument("--state-port", type=int, default=None)
    p.add_argument("--version", default="0",
                   help="deploy version label for this replica (shown by "
                        "the registry, stamped on its ledger records)")
    p.add_argument("--advertise-url", default=None,
                   help="URL the router should reach this replica at "
                        "(default http://<host>:<port>)")
    p.add_argument("--drain-grace-s", type=float, default=30.0,
                   help="SIGTERM drain: seconds to let in-flight "
                        "requests finish before exiting")
    args = p.parse_args(argv)

    if args.engine:
        tenant_weights = {}
        for entry in args.tenant_weight:
            name, _, weight = entry.partition("=")
            try:
                tenant_weights[name] = float(weight)
            except ValueError:
                p.error(f"--tenant-weight {entry!r}: expected "
                        "TENANT=WEIGHT with a numeric weight")
        backends = [engine_backend(
            args.model, checkpoint_dir=args.checkpoint_dir,
            slots=args.slots, max_len=args.max_len,
            block_size=args.block_size, num_blocks=args.num_blocks,
            spec_model=args.spec_model,
            spec_checkpoint_dir=args.spec_checkpoint_dir,
            spec_k=args.spec_k, disagg=args.disagg,
            prefill_slots=args.prefill_slots,
            prefill_blocks=args.prefill_blocks,
            adapters_dir=args.adapters_dir,
            adapter_slots=args.adapter_slots, lora_rank=args.lora_rank,
            lora_alpha=args.lora_alpha, admission=args.admission,
            tenant_weights=tenant_weights or None,
            max_queue_depth=args.max_queue_depth, device=args.device)]
    else:
        backends = [transformer_backend(
            args.model, checkpoint_dir=args.checkpoint_dir,
            device=args.device)]

    # daemon boot installs the request ledger (libraries never do); the
    # engine appends one durable record per finished request
    from cloudtik_tpu_torch.serve import reqlog
    try:
        reqlog.install()
    except OSError:
        # serve without a ledger rather than refuse to boot — but say so
        logger.warning("request ledger not installed", exc_info=True)

    server = ServeServer(backends, host=args.host, port=args.port)
    server.start()
    print(f"tik-serve listening on {args.host}:{server.port}", flush=True)
    beater = None
    if args.replica_id and args.state_host:
        beater = register_replica(
            backends[0], server, args.replica_id, args.state_host,
            state_port=args.state_port, host=args.host, slots=args.slots,
            version=args.version, advertise_url=args.advertise_url)

    stop_event = threading.Event()
    import signal
    signal.signal(signal.SIGTERM, lambda signum, frame: stop_event.set())
    try:
        stop_event.wait()
    except KeyboardInterrupt:
        pass
    # graceful drain: mark the replica not routable first, then refuse
    # new submits (503 + Retry-After), let in-flight finish, stop the
    # engine and the server, and leave the registry
    if beater is not None:
        beater.drain()
    drain_and_stop(server, backends, grace_s=args.drain_grace_s)
    if beater is not None:
        beater.stop(deregister=True)
    return 0


def register_replica(backend: ModelBackend, server: ServeServer,
                     replica_id: str, state_host: str,
                     state_port: Optional[int] = None,
                     host: str = "0.0.0.0", slots: int = 0,
                     version: str = "0",
                     advertise_url: Optional[str] = None):
    """Serving-fabric registration: a started `ReplicaHeartbeat` beating
    liveness and the engine's load stats into the head state server's
    replica registry, so the affinity router can route here.  A
    `DisaggServing` pair registers as role ``prefill`` with its prefill
    engine's stats, as the reference does; the engines' ledger records
    carry `replica_id` and `version`."""
    import socket

    from cloudtik_tpu_torch.control.state import StateClient, TcpStateBackend
    from cloudtik_tpu_torch.serve.replicas import (
        ReplicaHeartbeat, ReplicaRegistry)

    backend_kw = {} if state_port is None else {"port": state_port}
    registry = ReplicaRegistry(StateClient(
        TcpStateBackend(state_host, **backend_kw)))
    engine = getattr(backend, "engine", None)
    role, stats_fn = "engine", None
    if engine is not None:
        engines = [engine]
        if hasattr(engine, "prefill"):       # DisaggServing pair
            role, stats_fn = "prefill", engine.prefill.stats
            engines = [engine.prefill, engine.decode]
        else:
            stats_fn = engine.stats
        for eng in engines:
            eng.replica_id = replica_id
            eng.version = version
    # a wildcard bind address is not a reachable URL: advertise the
    # hostname instead
    advertise_host = host
    if advertise_host in ("0.0.0.0", "::", ""):
        advertise_host = socket.gethostname()
    url = advertise_url or f"http://{advertise_host}:{server.port}"
    beater = ReplicaHeartbeat(registry, replica_id, url, role=role,
                              slots=slots, stats_fn=stats_fn,
                              version=version)
    beater.start()
    return beater


if __name__ == "__main__":
    raise SystemExit(main())
