"""Host-granular autoscaling signal for the port's AI runtime.

Counterpart of `cloudtik_tpu/runtimes/ai/scaling.py`: pending training jobs
(published to the state store by the launcher) demand `slice_resources`
each.  The reference's unit is a pod slice of 16 TPU chips; here it is a
GPU host, `{"GPU": 8}` by default: one 8-card HGX H100 node, the NVLink
domain a job's tensor and pipe axes span (ROADMAP, deliberate
differences).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from cloudtik_tpu_torch.core.scaling_policy import (
    ScalingPolicy, ScalingState, make_autoscaling_instructions)

DEFAULT_SLICE_RESOURCES = {"GPU": 8}


class AISliceScalingPolicy(ScalingPolicy):
    def __init__(self, config: Dict[str, Any], head_host: str,
                 scaling_config: Optional[Dict[str, Any]] = None,
                 state_client=None):
        super().__init__(config, head_host)
        sc = scaling_config or {}
        self.slice_resources = sc.get("slice_resources",
                                      dict(DEFAULT_SLICE_RESOURCES))
        self.max_pending_slices = sc.get("max_pending_slices", 4)
        self.state_client = state_client

    def name(self) -> str:
        return "ai-slice-scaling"

    def get_scaling_state(self) -> Optional[ScalingState]:
        pending_jobs = 0
        if self.state_client is not None:
            jobs = self.state_client.table_list("ai_jobs")
            pending_jobs = sum(
                1 for j in jobs.values() if j.get("status") == "pending")
        pending_jobs = min(pending_jobs, self.max_pending_slices)
        state = ScalingState()
        state.set_autoscaling_instructions(make_autoscaling_instructions(
            [dict(self.slice_resources)] * pending_jobs))
        return state
