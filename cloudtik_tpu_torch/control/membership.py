"""Slice membership: which pod slices are alive, from the head state path.

Elastic multislice training (train/elastic.py) needs ONE question
answered at every step boundary: which data-parallel slices can take
the next step?  The answer already flows through the cluster — every
node agent heartbeats into the head state server's heartbeat table
(control/node_agent.py), and agents launched as part of a slice stamp
their ``slice_id`` on each beat.  :class:`SliceMembership` is the read
side: a slice is **alive** while at least one of its members
heartbeated within ``deadline_s``; a slice whose every member went
dark (preemption takes the whole ICI domain down at once) ages out and
the elastic coordinator re-meshes without it.  When the scaler recycles
the slice, its new hosts' first beats bring it straight back.

This is deliberately the same signal the scaler's health judgment uses
(metrics.heartbeat_on_time), read at a different granularity: the
scaler condemns and recycles node groups; the trainer only needs the
boolean per slice, with no provider round-trip on the hot path.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Set

from cloudtik_tpu_torch.control.state import StateClient, TABLE_HEARTBEAT
from cloudtik_tpu_torch.utils.constants import TIK_HEARTBEAT_PERIOD_S

# A slice is condemned for elastic purposes after this many missed
# heartbeat periods.  Deliberately shorter than the scaler's node
# timeout: the trainer pauses at a step boundary either way, and a
# false shrink costs one cheap re-mesh, not a slice recycle.
DEFAULT_SLICE_DEADLINE_S = 5 * TIK_HEARTBEAT_PERIOD_S


class SliceMembership:
    """Heartbeat-backed view of live slices for the elastic coordinator.

    ``alive_slices()`` returns the slice ids with at least one fresh
    heartbeat.  Records carrying no ``slice_id`` (plain worker beats)
    are ignored — slice membership is opt-in per agent.
    """

    def __init__(self, state_client: StateClient, num_slices: int,
                 deadline_s: float = DEFAULT_SLICE_DEADLINE_S):
        if num_slices < 1:
            raise ValueError(f"num_slices must be >= 1, got {num_slices}")
        self.state = state_client
        self.num_slices = int(num_slices)
        self.deadline_s = float(deadline_s)

    def last_beat_by_slice(self) -> Dict[int, float]:
        """Newest heartbeat time per slice id (raw, no deadline)."""
        newest: Dict[int, float] = {}
        for record in self.state.table_list(TABLE_HEARTBEAT).values():
            slice_id = record.get("slice_id")
            if slice_id is None:
                continue
            try:
                sid = int(slice_id)
                beat = float(record.get("time", 0.0))
            except (TypeError, ValueError):
                continue
            if beat > newest.get(sid, float("-inf")):
                newest[sid] = beat
        return newest

    def alive_slices(self, now: Optional[float] = None) -> Set[int]:
        """Slice ids with a heartbeat within the deadline."""
        now = time.time() if now is None else now
        return {sid for sid, beat in self.last_beat_by_slice().items()
                if now - beat <= self.deadline_s
                and 0 <= sid < self.num_slices}
