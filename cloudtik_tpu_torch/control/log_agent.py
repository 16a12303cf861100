"""Log agent: tails runtime log dirs, publishes lines to the state store.

Reference parity: core/_private/service/cloudtik_log_agent.py
(LogMonitor:127, check_log_files_and_publish_updates:362).
"""

from __future__ import annotations

import glob
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from cloudtik_tpu_torch.control.state import StateClient

logger = logging.getLogger(__name__)

LOG_NS = "logs"
MAX_LINES_PER_PUBLISH = 200
# Zero-padded so batch keys sort lexicographically == numerically; this
# is what lets consumers use the state store's ranged key reads
# (`keys(after=high_water_key)`) instead of refetching the table.
SEQ_KEY_WIDTH = 12


def batch_key(node_id: str, seq: int) -> str:
    return f"{node_id}:{seq:0{SEQ_KEY_WIDTH}d}"
# Each node keeps a bounded window of its own published batches in the
# head table (consumers tail with per-node high-water marks, so pruning
# old batches never causes replay — it only caps the table's size and
# `tik logs`' per-poll transfer).
RETAINED_BATCHES = 500


class LogAgent:
    def __init__(
        self,
        state_client: StateClient,
        node_id: str,
        log_dirs: Dict[str, str],
        poll_period_s: float = 2.0,
        retained_batches: int = RETAINED_BATCHES,
    ):
        self.state = state_client
        self.node_id = node_id
        self.log_dirs = log_dirs              # name -> directory
        self.poll_period_s = poll_period_s
        self.retained_batches = retained_batches
        self._offsets: Dict[str, int] = {}    # file path -> read offset
        self._stop = threading.Event()
        self._seq: Optional[int] = None       # seeded on first poll

    def discover_files(self) -> List[str]:
        files = []
        for _name, log_dir in self.log_dirs.items():
            # *.jsonl: the flight-recorder journal (telemetry/events.py)
            # ships alongside service logs, so the head's copy of each
            # node's decision record survives the node
            for pattern in ("*.log", "*.out", "*.jsonl"):
                files.extend(glob.glob(os.path.join(
                    os.path.expanduser(log_dir), "**", pattern),
                    recursive=True))
        return sorted(set(files))

    def _seed_seq(self) -> int:
        """Restart-safe sequence start: resume AFTER the highest batch
        this node already shipped instead of restarting at 0 — a
        restarted agent overwriting old keys would hand consumers
        already-seen sequence numbers with different content (their
        high-water dedup would silently drop the new lines)."""
        try:
            top = -1
            for key in self.state.table_keys(
                    LOG_NS, prefix=f"{self.node_id}:"):
                try:
                    top = max(top, int(key.rpartition(":")[2]))
                except ValueError:
                    continue
            return top + 1
        except Exception:
            logger.warning("cannot seed log batch sequence; starting "
                           "at 0", exc_info=True)
            return 0

    def poll_once(self) -> int:
        """Read new lines from all files and publish; returns lines read."""
        if self._seq is None:
            self._seq = self._seed_seq()
        published = 0
        for path in self.discover_files():
            try:
                size = os.path.getsize(path)
                offset = self._offsets.get(path, 0)
                if size < offset:     # rotated
                    offset = 0
                if size == offset:
                    continue
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(512 * 1024)
                    self._offsets[path] = f.tell()
                lines = chunk.decode(errors="replace").splitlines()
                for start in range(0, len(lines), MAX_LINES_PER_PUBLISH):
                    batch = lines[start:start + MAX_LINES_PER_PUBLISH]
                    self.state.table_put(
                        LOG_NS, batch_key(self.node_id, self._seq), {
                            "node_id": self.node_id,
                            "file": path,
                            "time": time.time(),
                            "lines": batch,
                        })
                    self._seq += 1
                    published += len(batch)
                    # just published seq-1: retain [seq-retained, seq-1]
                    old = self._seq - 1 - self.retained_batches
                    if old >= 0:
                        self.state.table_delete(
                            LOG_NS, batch_key(self.node_id, old))
            except OSError:
                continue
        return published

    def run_forever(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                logger.exception("log agent poll failed")
            self._stop.wait(self.poll_period_s)

    def start(self) -> None:
        threading.Thread(target=self.run_forever, name="tik-log-agent",
                         daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
