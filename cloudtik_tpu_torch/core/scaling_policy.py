"""ScalingPolicy — pluggable autoscaling signal source.

Reference parity: core/scaling_policy.py (`ScalingState`:22, `ScalingPolicy`:53).
A policy (built-in or runtime-provided) publishes a ScalingState each tick;
the controller's ResourceScalingPolicy bridge feeds it into the scaler.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class ScalingState:
    """Snapshot of autoscaling intent + per-node resource state."""

    def __init__(
        self,
        autoscaling_instructions: Optional[Dict[str, Any]] = None,
        node_resource_states: Optional[Dict[str, Any]] = None,
        lost_nodes: Optional[Dict[str, Any]] = None,
    ):
        # autoscaling_instructions:
        #   {"scaling_time": t, "resource_demands": [{"CPU": 4}, {"TPU": 8}, ...]}
        self.autoscaling_instructions = autoscaling_instructions
        # node_resource_states: node_id -> {
        #   "node_id", "node_ip", "resource_time",
        #   "total_resources": {...}, "available_resources": {...},
        #   "resource_load": {"utilization": {...}, "on_time": bool}}
        self.node_resource_states = node_resource_states
        # lost_nodes: node_id -> node_ip, nodes the runtime declares dead
        self.lost_nodes = lost_nodes

    def set_autoscaling_instructions(self, instr: Dict[str, Any]) -> None:
        self.autoscaling_instructions = instr

    def add_node_resource_state(self, node_id: str, state: Dict[str, Any]) -> None:
        if self.node_resource_states is None:
            self.node_resource_states = {}
        self.node_resource_states[node_id] = state

    def add_lost_node(self, node_id: str, node_ip: str) -> None:
        if self.lost_nodes is None:
            self.lost_nodes = {}
        self.lost_nodes[node_id] = node_ip


class ScalingPolicy:
    """Base class.  Implementations read whatever signal they like (load
    metrics, YARN queues, a time table, TPU slice utilization) and emit a
    ScalingState."""

    def __init__(self, config: Dict[str, Any], head_host: str):
        self.config = config
        self.head_host = head_host

    def name(self) -> str:
        return "none"

    def get_scaling_state(self) -> Optional[ScalingState]:
        raise NotImplementedError


def make_resource_demand(resource_id: str, amount: float) -> Dict[str, float]:
    return {resource_id: amount}


def make_autoscaling_instructions(
    resource_demands: List[Dict[str, float]]
) -> Dict[str, Any]:
    return {
        "scaling_time": time.time(),
        "resource_demands": resource_demands,
    }
