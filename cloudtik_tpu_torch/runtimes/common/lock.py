"""Distributed locks over the cluster state store.

Reference parity: runtime/common/lock/ (consul_lock.py, etcd_lock.py,
redis_lock.py — session/lease based mutual exclusion).  The reference used
whichever coordination service a cluster ran; this build needs no extra
daemon: the head state server's compare-and-swap primitive
(control/state.py StateBackend.cas) provides the atomicity, and TTL leases
provide liveness when a holder dies.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from typing import Optional

from cloudtik_tpu_torch.control.state import StateClient

LOCK_NS = "locks"
DEFAULT_TTL_S = 30.0


class LockAcquireError(RuntimeError):
    pass


def _now() -> float:
    return time.time()


def _encode(owner: str, expires: float) -> bytes:
    return json.dumps({"owner": owner, "expires": expires}).encode()


def _decode(raw: Optional[bytes]):
    if raw is None:
        return None
    try:
        return json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None


def default_owner_id() -> str:
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"


class StateLock:
    """TTL-leased mutex keyed in the state store.

    Acquisition is CAS-on-absent (or CAS-on-expired); the holder renews the
    lease from a background thread while held.  Release is CAS-on-own-value
    so a lock that expired and was re-acquired elsewhere is never clobbered.
    """

    def __init__(self, state: StateClient, name: str,
                 ttl_s: float = DEFAULT_TTL_S,
                 owner_id: Optional[str] = None):
        self.state = state
        self.name = name
        self.ttl_s = ttl_s
        self.owner_id = owner_id or default_owner_id()
        self._held_value: Optional[bytes] = None
        self._renewer: Optional[threading.Thread] = None
        self._stop_renew = threading.Event()

    # -- core -------------------------------------------------------------
    def try_acquire(self) -> bool:
        current = self.state.backend.get(LOCK_NS, self.name)
        info = _decode(current)
        new_value = _encode(self.owner_id, _now() + self.ttl_s)
        if current is None or info is None or info["expires"] < _now():
            # absent or stale: take over atomically vs the observed value
            if self.state.backend.cas(LOCK_NS, self.name, current, new_value):
                self._held_value = new_value
                return True
            return False
        if info["owner"] == self.owner_id:
            # reentrant refresh
            if self.state.backend.cas(LOCK_NS, self.name, current, new_value):
                self._held_value = new_value
                return True
        return False

    def acquire(self, timeout_s: Optional[float] = None,
                poll_s: float = 0.2) -> None:
        deadline = None if timeout_s is None else _now() + timeout_s
        while True:
            if self.try_acquire():
                self._start_renewer()
                return
            if deadline is not None and _now() > deadline:
                raise LockAcquireError(
                    f"timed out acquiring lock {self.name!r}")
            time.sleep(poll_s)

    def renew(self) -> bool:
        if self._held_value is None:
            return False
        new_value = _encode(self.owner_id, _now() + self.ttl_s)
        if self.state.backend.cas(LOCK_NS, self.name, self._held_value,
                                  new_value):
            self._held_value = new_value
            return True
        self._held_value = None
        return False

    def release(self) -> None:
        self._stop_renewer()
        if self._held_value is None:
            return
        # Release by CAS-ing our lease to an already-expired one.  If the CAS
        # fails the lease was taken over (our TTL lapsed) — never touch it.
        self.state.backend.cas(LOCK_NS, self.name, self._held_value,
                               _encode(self.owner_id, 0.0))
        self._held_value = None

    def held(self) -> bool:
        if self._held_value is None:
            return False
        info = _decode(self.state.backend.get(LOCK_NS, self.name))
        return (info is not None and info.get("owner") == self.owner_id
                and info.get("expires", 0) > _now())

    # -- lease renewal ----------------------------------------------------
    def _start_renewer(self) -> None:
        self._stop_renew.clear()
        interval = max(self.ttl_s / 3.0, 0.05)

        def _loop():
            while not self._stop_renew.wait(interval):
                if not self.renew():
                    return

        self._renewer = threading.Thread(
            target=_loop, name=f"tik-lock-renew-{self.name}", daemon=True)
        self._renewer.start()

    def _stop_renewer(self) -> None:
        self._stop_renew.set()
        if self._renewer is not None:
            self._renewer.join(timeout=1.0)
            self._renewer = None

    # -- context manager --------------------------------------------------
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class FileLock:
    """Single-host fcntl lock (reference: file_state_store.py transaction
    locks) for providers that coordinate through the filesystem."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def acquire(self) -> None:
        import fcntl
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "w")
        fcntl.flock(self._fh, fcntl.LOCK_EX)

    def release(self) -> None:
        import fcntl
        if self._fh is not None:
            fcntl.flock(self._fh, fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
