"""Model-serving HTTP server (`tik-serve`), the non-engine path, on PyTorch.

Counterpart of `cloudtik_tpu/serve/server.py`: one stdlib-threaded HTTP
server in front of the port's `generate`:

  POST /v1/generate  {"tokens": [[...]], "max_new_tokens": 8, ...}
  GET  /healthz                                       liveness
  GET  /v1/models                                     what's loaded

`BackendError`, `ModelBackend` and `ServeServer` (with its graceful drain)
are this package's own copies of the JAX package's, which this package
does not import.  Not here yet: the continuous-batching engine
(`--engine`), the GBDT backend, replica registration, the request ledger
and trace-context adoption.

    python -m cloudtik_tpu_torch.serve.server --model tpu_1b
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

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

    `params` takes a numpy tree as the JAX `init_params` gives it
    (converted by `convert.params_from_jax`); without it the weights come
    from `init_params` with a generator seeded 0.  The backend keeps its
    `params` and `cfg` as attributes."""
    import numpy as np
    import torch

    from cloudtik_tpu_torch import convert
    from cloudtik_tpu_torch.device import resolve_device
    from cloudtik_tpu_torch.models import generate as G
    from cloudtik_tpu_torch.models import transformer as T

    if checkpoint_dir:
        raise NotImplementedError(
            "checkpoint_dir is not supported yet: restoring a checkpoint "
            "comes with the checkpoint slice")
    dev = resolve_device(device)
    cfg = T.config(model, **config_overrides)
    if params is None:
        params = T.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    else:
        params = convert.params_from_jax(params, dev)

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

        self._server = ThreadingHTTPServer((host, port), Handler)
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


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("tik-serve")
    p.add_argument("--model", default="tiny",
                   help="transformer preset to serve")
    p.add_argument("--checkpoint-dir", default=None,
                   help="not supported yet (checkpoint slice)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--drain-grace-s", type=float, default=30.0,
                   help="SIGTERM drain: seconds to let in-flight "
                        "requests finish before exiting")
    args = p.parse_args(argv)

    backends = [transformer_backend(
        args.model, checkpoint_dir=args.checkpoint_dir, device=args.device)]
    server = ServeServer(backends, host=args.host, port=args.port)
    server.start()
    print(f"tik-serve listening on {args.host}:{server.port}", flush=True)

    stop_event = threading.Event()

    def _drain_and_exit(signum, frame):
        # refuse new submits (503 + Retry-After), let in-flight finish
        server.drain(grace_s=args.drain_grace_s)
        stop_event.set()

    import signal
    signal.signal(signal.SIGTERM, _drain_and_exit)
    try:
        stop_event.wait()
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
