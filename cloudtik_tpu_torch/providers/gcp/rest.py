"""Minimal GCP REST transport (stdlib-only; no google SDK dependency).

The reference drives GCP through google-api-python-client discovery docs
(providers/_private/gcp/utils.py:25 builds the `tpu` v2alpha service).  This
build talks straight REST with urllib so the provider has zero extra
dependencies; the transport is injectable, which is also how unit tests run
the whole provider against a fake cloud (SURVEY.md §4 MockProvider pattern,
applied one layer lower).

Auth resolution order: explicit token_provider > GOOGLE_OAUTH_ACCESS_TOKEN
env > `gcloud auth print-access-token` > GCE metadata server.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, Optional

from cloudtik_tpu_torch import telemetry
from cloudtik_tpu_torch.telemetry import instruments as ti
from cloudtik_tpu_torch.utils.retry import (
    RetriesExhausted, RetryPolicy, call_with_retry)

Transport = Callable[[str, str, Optional[Dict[str, Any]], Dict[str, str]],
                     "RestResponse"]


class GCPApiError(Exception):
    def __init__(self, status: int, message: str, body: Any = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.body = body
        # set per-request by RestClient (429/5xx and not an ambiguous
        # transport failure on a non-idempotent method)
        self.retriable = False

    @property
    def not_found(self) -> bool:
        return self.status == 404

    @property
    def conflict(self) -> bool:
        return self.status == 409


class RestResponse:
    def __init__(self, status: int, body: Any):
        self.status = status
        self.body = body


def _default_token_provider() -> str:
    token = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
    if token:
        return token
    try:
        out = subprocess.run(
            ["gcloud", "auth", "print-access-token"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    # GCE/TPU-VM metadata server.
    req = urllib.request.Request(
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token",
        headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())["access_token"]


def _urllib_transport(method: str, url: str, body: Optional[Dict[str, Any]],
                      headers: Dict[str, str]) -> RestResponse:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read()
            return RestResponse(
                resp.status, json.loads(raw) if raw else {})
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw)
        except (ValueError, TypeError):
            parsed = {"error": {"message": raw.decode(errors="replace")}}
        return RestResponse(e.code, parsed)
    except (urllib.error.URLError, OSError) as e:
        # Transport failure (DNS, refused, timeout): surface as a retriable
        # 503 so RestClient's retry loop handles it.  Marked so the client
        # can refuse to retry non-idempotent methods on ambiguous failures
        # (a timed-out POST may have been accepted server-side).
        return RestResponse(
            503, {"error": {"message": f"transport: {e}"},
                  "transport_error": True})


class RestClient:
    """Authenticated JSON REST client with retry on 429/5xx.

    Backoff obeys the tree-wide audited RetryPolicy (utils/retry.py):
    exponential with jitter, retrying only retriable statuses — and
    never a non-idempotent method on an ambiguous transport failure
    (a timed-out POST may have been accepted server-side).
    """

    RETRIABLE_STATUSES = (429, 500, 502, 503, 504)

    def __init__(
        self,
        transport: Optional[Transport] = None,
        token_provider: Optional[Callable[[], str]] = None,
        max_retries: int = 4,
        retry_base_delay: float = 1.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._transport = transport or _urllib_transport
        self._token_provider = token_provider or _default_token_provider
        self._policy = RetryPolicy(
            max_attempts=max_retries + 1,
            base_delay_s=retry_base_delay,
            multiplier=2.0,
            max_delay_s=60.0,
            retryable=lambda exc: (
                isinstance(exc, GCPApiError) and exc.retriable),
        )
        self._sleep = sleep
        self._token: Optional[str] = None
        self._token_time = 0.0

    def _headers(self) -> Dict[str, str]:
        now = time.time()
        if self._token is None or now - self._token_time > 600:
            self._token = self._token_provider()
            self._token_time = now
        return {"Authorization": f"Bearer {self._token}",
                "Content-Type": "application/json"}

    def request(self, method: str, url: str,
                body: Optional[Dict[str, Any]] = None) -> Any:
        def once() -> Any:
            resp = self._transport(method, url, body, self._headers())
            if resp.status < 400:
                return resp.body
            message = ""
            if isinstance(resp.body, dict):
                message = (resp.body.get("error") or {}).get("message", "")
            ambiguous_transport = (
                isinstance(resp.body, dict)
                and resp.body.get("transport_error")
                and method not in ("GET", "DELETE"))
            error = GCPApiError(resp.status, message, resp.body)
            error.retriable = (
                resp.status in self.RETRIABLE_STATUSES
                and not ambiguous_transport)
            raise error

        t0 = time.perf_counter()
        code = "ok"
        with telemetry.span("gcp.rest.request", method=method,
                            url=url.split("?", 1)[0]):
            try:
                return call_with_retry(once, self._policy,
                                       sleep=self._sleep)
            except RetriesExhausted as e:
                code = str(getattr(e.last, "status", "error"))
                raise e.last from None
            except GCPApiError as e:
                code = str(e.status)
                raise
            except Exception:
                # non-API failure (e.g. token acquisition): must not
                # count as code="ok" or a credentials outage reads as a
                # healthy request rate
                code = "error"
                raise
            finally:
                ti.GCP_REST_LATENCY.observe(
                    time.perf_counter() - t0, method=method)
                ti.GCP_REST_REQUESTS.inc(method=method, code=code)

    def get(self, url: str) -> Any:
        return self.request("GET", url)

    def post(self, url: str, body: Dict[str, Any]) -> Any:
        return self.request("POST", url, body)

    def patch(self, url: str, body: Dict[str, Any]) -> Any:
        return self.request("PATCH", url, body)

    def delete(self, url: str) -> Any:
        return self.request("DELETE", url)
