"""Flight recorder: a bounded, crash-safe journal of control-plane events.

Spans say how long things took; the flight recorder says WHY things
happened — and survives the process that wrote it.  Each record is one
JSON line ``{ts, seq, name, traceparent?, ...fields}`` appended with an
explicit flush, so after a crash the journal replays the control plane's
decisions up to at most one torn final line, which readers skip (never
fatal).  Every event name is cataloged in telemetry/names.py (EVENTS)
under the same one-declaration law as metrics, each record is stamped
with the active traceparent so decisions join the distributed trace they
belong to, and `tik events tail|dump` is the operator surface.  Cluster
dumps (control/cluster_dump.py) include the journal automatically.

Emit sites pay the usual discipline: ``events.emit(...)`` behind
``TIK_TELEMETRY=off``, or with no journal installed, is attribute checks
only — no dict walk, no serialization, no I/O.  Daemons install the
default journal at boot (control/services.py); libraries never install.

The journal is bounded: at ``max_bytes`` the current file rotates to
``<path>.1`` (one rotated generation kept), so the newest events are
always retained and disk use stays capped at ~2x the cap.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import DIRECTIVE_TORN_WRITE
from cloudtik_tpu_torch.telemetry import core

logger = logging.getLogger(__name__)

DEFAULT_MAX_BYTES = 4 * 1024 * 1024
ROTATED_SUFFIX = ".1"


def default_path() -> str:
    """`~/.tik/logs/events.jsonl` (inside the shipped log dirs so the
    log agent and cluster dumps pick it up); TIK_EVENTS_PATH overrides."""
    override = os.environ.get("TIK_EVENTS_PATH")
    if override:
        return os.path.expanduser(override)
    from cloudtik_tpu_torch.utils.constants import tik_home
    return os.path.join(tik_home(), "logs", "events.jsonl")


class EventJournal:
    """Append-only JSONL journal with size-capped rotation.

    The serve request ledger (serve/reqlog.py) subclasses this to reuse
    the rotation + torn-line discipline under its own fault seam."""

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = os.path.expanduser(path)
        self.max_bytes = max(int(max_bytes), 1024)
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._seq = 0
        self._torn = False

    def _fire_seam(self, name: str) -> Optional[str]:
        # the torn-write drill point: same cooperative directive as the
        # checkpoint seam — the line lands truncated, mid-record, which
        # is exactly what a host dying mid-append leaves behind
        return seams.fire("events.append", name=name, path=self.path)

    def append(self, name: str, fields: Dict[str, Any]) -> Dict[str, Any]:
        """Write one event record; returns the record as written."""
        directive = self._fire_seam(name)
        traceparent = core.current_traceparent()
        with self._lock:
            self._seq += 1
            record: Dict[str, Any] = {
                "ts": time.time(), "seq": self._seq, "name": name}
            if traceparent is not None:
                record["traceparent"] = traceparent
            for key, value in fields.items():
                if key not in record:
                    record[key] = value
            data = (json.dumps(record, separators=(",", ":"),
                               default=str) + "\n").encode()
            if directive == DIRECTIVE_TORN_WRITE:
                data = data[: max(len(data) // 2, 1)]
            if self._torn:
                # terminate the torn line so only IT is lost on read,
                # not the next good record glued onto it
                data = b"\n" + data
            self._torn = directive == DIRECTIVE_TORN_WRITE
            fh = self._ensure_open()
            fh.write(data)
            fh.flush()
            self._size += len(data)
            if self._size >= self.max_bytes:
                self._rotate_locked()
        return record

    def _ensure_open(self):
        if self._fh is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "ab")
            self._size = self._fh.tell()
        return self._fh

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._fh = None
        self._size = 0
        os.replace(self.path, self.path + ROTATED_SUFFIX)

    def files(self) -> List[str]:
        """Existing journal files, oldest first."""
        return [p for p in (self.path + ROTATED_SUFFIX, self.path)
                if os.path.isfile(p)]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ------------------------------------------------------------- module api --

class JournalSlot:
    """The module-level journal state one journal family owns: install /
    installed / uninstall / file listing, plus the warn-once append
    guard.  events.py and the serve request ledger (serve/reqlog.py)
    each hold one instance, so the rotation-listing and disk-failure
    discipline exist in exactly one place."""

    def __init__(self, journal_cls, default_path_fn, max_bytes_env: str,
                 label: str):
        self.journal_cls = journal_cls
        self.default_path_fn = default_path_fn
        self.max_bytes_env = max_bytes_env
        self.label = label
        self.journal = None
        self._write_warned = False

    def install(self, path: Optional[str] = None,
                max_bytes: Optional[int] = None):
        if max_bytes is None:
            # malformed env falls back to the default — a bad knob must
            # never take a daemon down at boot
            from cloudtik_tpu_torch.utils.constants import env_integer
            max_bytes = env_integer(self.max_bytes_env,
                                    DEFAULT_MAX_BYTES)
        if self.journal is not None:
            self.journal.close()
        self.journal = self.journal_cls(path or self.default_path_fn(),
                                        max_bytes)
        return self.journal

    def uninstall(self) -> None:
        if self.journal is not None:
            self.journal.close()
        self.journal = None

    def files(self, path: Optional[str] = None) -> List[str]:
        """Existing journal files for `path` (default: the installed
        journal's path, else the family default), oldest first."""
        if path is None:
            path = self.journal.path if self.journal is not None \
                else self.default_path_fn()
        path = os.path.expanduser(path)
        return [p for p in (path + ROTATED_SUFFIX, path)
                if os.path.isfile(p)]

    def guarded_append(self, journal, name: str,
                       fields: Dict[str, Any]) -> None:
        try:
            journal.append(name, fields)
        except OSError as e:
            # a full/readonly disk must never take the writer down
            if not self._write_warned:
                self._write_warned = True
                logger.warning("%s write failed: %s", self.label, e)


_SLOT = JournalSlot(EventJournal, default_path, "TIK_EVENTS_MAX_BYTES",
                    "flight recorder")


def install(path: Optional[str] = None,
            max_bytes: Optional[int] = None) -> EventJournal:
    """Install the process journal (daemons call this at boot)."""
    return _SLOT.install(path, max_bytes)


def installed() -> Optional[EventJournal]:
    return _SLOT.journal


def uninstall() -> None:
    _SLOT.uninstall()


def emit(name: str, **fields) -> None:
    """Journal one control-plane event.  Fast path (telemetry off, or no
    journal installed) is attribute checks only."""
    if not core.STATE.enabled:
        return
    journal = _SLOT.journal
    if journal is None:
        return
    _SLOT.guarded_append(journal, name, fields)


# --------------------------------------------------------------- readers --

def read_file(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """(records, skipped_lines).  A line that does not parse — the torn
    tail a crash mid-append leaves — is skipped, never fatal."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0
    records: List[Dict[str, Any]] = []
    skipped = 0
    for line in raw.splitlines():
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(record, dict):
            records.append(record)
        else:
            skipped += 1
    return records, skipped


def journal_files(path: Optional[str] = None) -> List[str]:
    """Existing journal files for `path` (default: the installed
    journal's path, else default_path()), oldest first."""
    return _SLOT.files(path)


def read_events(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All journal records (rotated generation first — append order for
    a single writer), torn lines skipped."""
    out: List[Dict[str, Any]] = []
    for p in journal_files(path):
        records, _skipped = read_file(p)
        out.extend(records)
    return out
