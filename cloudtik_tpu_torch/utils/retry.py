"""Unified retry policy: exponential backoff + jitter + deadline.

Every retry loop in the tree (GCP REST transport, SSH wait_ready, the
discovery sync poller, ...) routes through this module so retry behavior
is audited in ONE place and is itself fault-injectable: each backoff
sleep fires the `utils.retry` seam, which lets a chaos plan add latency
or abort a retry loop deterministically.

Two call styles:

    policy = RetryPolicy(max_attempts=4, base_delay_s=1.0)
    call_with_retry(fetch, policy=policy)          # explicit

    @retry(RetryPolicy(deadline_s=30, retryable=is_transient))
    def fetch(): ...                               # decorator

Determinism: jitter comes from the `rng` handed to the call (default: a
module-level Random seeded from the clock); tests pass `random.Random(k)`
and an injectable `sleep`/`clock` for instant, reproducible schedules.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import threading
import time
from typing import Any, Callable, Optional, Tuple

from cloudtik_tpu_torch.faults import seams

_default_rng = random.Random()


def _always_retryable(exc: BaseException) -> bool:
    return isinstance(exc, Exception)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a retried call backs off.

    max_attempts: total attempts including the first (0 = unlimited,
                  only sane together with deadline_s).
    base_delay_s: delay before the first retry.
    multiplier:   exponential growth factor per retry.
    max_delay_s:  backoff ceiling.
    jitter:       +- fraction applied to each delay (0.1 = +-10%).
    deadline_s:   wall budget across ALL attempts (0 = none); a retry is
                  never started if its sleep would cross the deadline.
    retryable:    predicate deciding which exceptions are retried;
                  everything else propagates immediately.
    """

    max_attempts: int = 4
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    jitter: float = 0.1
    deadline_s: float = 0.0
    retryable: Callable[[BaseException], bool] = _always_retryable


class RetriesExhausted(Exception):
    """Raised when attempts/deadline run out; chains the last error."""

    def __init__(self, message: str, last: BaseException):
        super().__init__(f"{message}: {type(last).__name__}: {last}")
        self.last = last


def backoff_delay(policy: RetryPolicy, attempt: int,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry number `attempt` (0-based), with jitter."""
    delay = min(policy.base_delay_s * (policy.multiplier ** attempt),
                policy.max_delay_s)
    if policy.jitter:
        rng = rng or _default_rng
        delay *= 1.0 + rng.uniform(-policy.jitter, policy.jitter)
    return max(delay, 0.0)


def poll_delay(interval: float, consecutive_failures: int,
               max_delay_s: float = 60.0, jitter: float = 0.1,
               rng: Optional[random.Random] = None) -> float:
    """Steady-state poller delay: the base interval while healthy,
    exponential backoff (with jitter, so a restarting head is not
    hammered by every poller at once) while failing."""
    if consecutive_failures <= 0:
        delay = interval
    else:
        delay = min(interval * (2 ** consecutive_failures), max_delay_s)
    if jitter:
        rng = rng or _default_rng
        delay *= 1.0 + rng.uniform(-jitter, jitter)
    return max(delay, 0.0)


def call_with_retry(
    fn: Callable[[], Any],
    policy: RetryPolicy = RetryPolicy(),
    *,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
) -> Any:
    """Run `fn()` under `policy`.

    Raises the last exception unchanged when it is not retryable, and
    RetriesExhausted (chaining it) when attempts or the deadline run out.
    `on_retry(attempt, exc, delay)` observes each scheduled retry.
    """
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:
            if not policy.retryable(exc):
                raise
            if policy.max_attempts and attempt + 1 >= policy.max_attempts:
                raise RetriesExhausted(
                    f"gave up after {attempt + 1} attempts", exc) from exc
            delay = backoff_delay(policy, attempt, rng)
            if policy.deadline_s and \
                    clock() - start + delay >= policy.deadline_s:
                raise RetriesExhausted(
                    f"deadline {policy.deadline_s}s exceeded after "
                    f"{attempt + 1} attempts", exc) from exc
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            seams.fire("utils.retry",
                       fn=getattr(fn, "__name__", "call"),
                       attempt=attempt)
            sleep(delay)
            attempt += 1


def run_with_deadline(fn: Callable[[], Any], deadline_s: float,
                      name: str = "deadline-call"
                      ) -> Tuple[bool, Any]:
    """Run ``fn()`` but wait at most ``deadline_s`` for it to return.

    The deadline half of the retry policy's timeout discipline, for
    calls that take no timeout themselves (orbax ``wait_until_finished``
    / ``close``): the call runs on a daemon helper thread and the
    caller blocks up to the deadline.  Returns ``(True, result)`` when
    the call finished (exceptions re-raise in the caller), or
    ``(False, None)`` on timeout — the helper thread is left to finish
    (or stay wedged) in the background; it can no longer block the
    caller's teardown.
    """
    if deadline_s <= 0:
        return True, fn()
    box: dict = {}

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:     # noqa: BLE001 - re-raised below
            box["error"] = e

    thread = threading.Thread(target=_run, name=name, daemon=True)
    thread.start()
    thread.join(timeout=deadline_s)
    if thread.is_alive():
        return False, None
    if "error" in box:
        raise box["error"]
    return True, box.get("result")


def retry(policy: RetryPolicy = RetryPolicy(), **call_kw):
    """Decorator form of call_with_retry."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(
                lambda: fn(*args, **kwargs), policy, **call_kw)
        return wrapped

    return decorate
