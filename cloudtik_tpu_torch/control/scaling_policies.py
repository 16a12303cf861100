"""Built-in scaling policies: resource-load, time-table, by-node-type.

Reference parity: core/_private/cluster/scaling_policies.py
(ScalingWithResources:43, ScalingWithLoad:171, ScalingWithTime:358,
ScalingByNodeType:595, factory _create_scaling_policy:688).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from cloudtik_tpu_torch.core.scaling_policy import (
    ScalingPolicy, ScalingState, make_autoscaling_instructions)
from cloudtik_tpu_torch.control.state import StateClient, TABLE_METRICS


class ScalingWithResources(ScalingPolicy):
    """Scale to satisfy explicitly requested resources (api-level asks)."""

    def __init__(self, config: Dict[str, Any], head_host: str,
                 state_client: Optional[StateClient] = None):
        super().__init__(config, head_host)
        self.state_client = state_client
        self.requests: List[Dict[str, float]] = []

    def name(self) -> str:
        return "scaling-with-resources"

    def set_requests(self, requests: List[Dict[str, float]]) -> None:
        self.requests = list(requests)

    def get_scaling_state(self) -> Optional[ScalingState]:
        state = ScalingState()
        state.set_autoscaling_instructions(
            make_autoscaling_instructions(self.requests))
        return state


class ScalingWithLoad(ScalingPolicy):
    """Scale on observed CPU/memory utilization published by node agents."""

    def __init__(self, config: Dict[str, Any], head_host: str,
                 state_client: StateClient,
                 scaling_config: Optional[Dict[str, Any]] = None):
        super().__init__(config, head_host)
        self.state_client = state_client
        sc = scaling_config or {}
        self.cpu_load_threshold = sc.get("cpu_load_threshold", 0.85)
        self.memory_load_threshold = sc.get("memory_load_threshold", 0.85)
        self.step_resource = sc.get("scaling_step_resource", {"CPU": 4})
        self.in_use_cpu_threshold = sc.get("in_use_cpu_load_threshold", 0.15)

    def name(self) -> str:
        return "scaling-with-load"

    def get_scaling_state(self) -> Optional[ScalingState]:
        state = ScalingState()
        metrics = self.state_client.table_list(TABLE_METRICS)
        overloaded = 0
        for node_id, m in metrics.items():
            cpu = m.get("cpu_percent", 0.0) / 100.0
            mem = m.get("memory_percent", 0.0) / 100.0
            state.add_node_resource_state(node_id, {
                "node_id": node_id,
                "node_ip": m.get("node_ip"),
                "resource_time": m.get("time", time.time()),
                "total_resources": m.get("total_resources", {}),
                "available_resources": m.get("available_resources", {}),
                "resource_load": {
                    "utilization": {"cpu": cpu, "memory": mem},
                    "in_use": cpu > self.in_use_cpu_threshold,
                },
            })
            if cpu >= self.cpu_load_threshold or \
                    mem >= self.memory_load_threshold:
                overloaded += 1
        demands = [dict(self.step_resource)] * overloaded
        state.set_autoscaling_instructions(
            make_autoscaling_instructions(demands))
        return state


class ScalingWithTime(ScalingPolicy):
    """Time-table scaling: desired worker count by hour-of-day/day-of-week.

    scaling_config: {"scaling_periods": [{"start": "HH:MM", "end": "HH:MM",
    "days": ["mon",...], "min_workers": N}], "resource_per_worker": {...}}
    """

    _DAYS = ["mon", "tue", "wed", "thu", "fri", "sat", "sun"]

    def __init__(self, config: Dict[str, Any], head_host: str,
                 scaling_config: Optional[Dict[str, Any]] = None):
        super().__init__(config, head_host)
        sc = scaling_config or {}
        self.periods = sc.get("scaling_periods", [])
        self.resource_per_worker = sc.get("resource_per_worker", {"CPU": 4})
        self.base_min_workers = sc.get("min_workers", 0)

    def name(self) -> str:
        return "scaling-with-time"

    def _desired_workers(self, now: Optional[time.struct_time] = None) -> int:
        now = now or time.localtime()
        day = self._DAYS[now.tm_wday]
        minutes = now.tm_hour * 60 + now.tm_min
        desired = self.base_min_workers
        for period in self.periods:
            days = [d.lower()[:3] for d in period.get("days", self._DAYS)]
            if day not in days:
                continue
            start = _parse_hhmm(period.get("start", "00:00"))
            end = _parse_hhmm(period.get("end", "24:00"))
            if start <= minutes < end:
                desired = max(desired, period.get("min_workers", 0))
        return desired

    def get_scaling_state(self) -> Optional[ScalingState]:
        desired = self._desired_workers()
        state = ScalingState()
        state.set_autoscaling_instructions(make_autoscaling_instructions(
            [dict(self.resource_per_worker)] * desired))
        return state


class ServeDemandPolicy(ScalingPolicy):
    """Serving-fabric demand: size the replica fleet from serve load.

    Wraps :class:`~cloudtik_tpu_torch.serve.replicas.ReplicaAutoscaler` —
    queue depth and slot-idle fraction from the replica registry's
    heartbeat stats, serve-ttft fast/slow burn rates from an injectable
    ``burn_source`` — and publishes ``target_replicas x
    resource_per_replica`` as resource demands, so the cluster scaler
    launches and retires serving nodes through the same demand path as
    every other signal.  Each add/remove/replace decision is
    WHY-labeled (``serve_demand`` / ``serve_idle`` / ``lost_node``)
    and journaled by the autoscaler itself.

    scaling_config: ``{"resource_per_replica": {"GPU": 1},
    "min_replicas": 1, "max_replicas": 8, "burn_threshold": 1.0,
    "sustain_cycles": 3, "idle_cycles": 5, "slo_url":
    "http://head:9090"}`` — ``slo_url`` points at the collector whose
    `/api/v1/slos` carries the serve-ttft fast/slow burn rates; without
    it (and no explicit ``burn_source``) demand adds are disabled and
    only lost-replica replacement / idle removal fire.
    """

    def __init__(self, config: Dict[str, Any], head_host: str,
                 state_client: StateClient,
                 scaling_config: Optional[Dict[str, Any]] = None,
                 burn_source=None):
        super().__init__(config, head_host)
        from cloudtik_tpu_torch.serve.replicas import (
            AutoscalerConfig, ReplicaAutoscaler, ReplicaRegistry,
            slo_burn_source)
        sc = scaling_config or {}
        if burn_source is None and sc.get("slo_url"):
            burn_source = slo_burn_source(sc["slo_url"])
        self.resource_per_replica = sc.get("resource_per_replica",
                                           {"GPU": 1})
        self.registry = ReplicaRegistry(state_client)
        self.autoscaler = ReplicaAutoscaler(
            self.registry,
            config=AutoscalerConfig(
                min_replicas=sc.get("min_replicas", 1),
                max_replicas=sc.get("max_replicas", 8),
                burn_threshold=sc.get("burn_threshold", 1.0),
                sustain_cycles=sc.get("sustain_cycles", 3),
                idle_cycles=sc.get("idle_cycles", 5)),
            burn_source=burn_source)

    def name(self) -> str:
        return "serve-demand"

    def get_scaling_state(self) -> Optional[ScalingState]:
        self.autoscaler.evaluate()
        # a role-split fabric publishes PER-ROLE demands, each tagged
        # with a role resource ("tik-serve-role-<role>": 1) so the
        # scaler bin-packs the ask onto node types that advertise the
        # role (i.e. whose launch boots `tik-serve --role <role>`) —
        # an untagged generic launch could join as the wrong role and
        # leave the asked role's deficit standing forever; a
        # monolithic fleet keeps the plain single-target shape
        role_targets = self.autoscaler.role_targets
        if role_targets:
            demands = []
            for role, target in sorted(role_targets.items()):
                tag = {f"tik-serve-role-{role}": 1}
                demands.extend(
                    [dict(self.resource_per_replica, **tag)] * target)
        else:
            demands = ([dict(self.resource_per_replica)]
                       * self.autoscaler.total_target())
        state = ScalingState()
        state.set_autoscaling_instructions(
            make_autoscaling_instructions(demands))
        return state


class ScalingByNodeType(ScalingPolicy):
    """Direct per-node-type worker-count asks (e.g. 'tpu_v5p_32: 2')."""

    def __init__(self, config: Dict[str, Any], head_host: str,
                 node_type_counts: Optional[Dict[str, int]] = None):
        super().__init__(config, head_host)
        self.node_type_counts = node_type_counts or {}

    def name(self) -> str:
        return "scaling-by-node-type"

    def get_scaling_state(self) -> Optional[ScalingState]:
        node_types = self.config.get("available_node_types", {})
        demands = []
        for name, count in self.node_type_counts.items():
            res = node_types.get(name, {}).get("resources", {})
            demands.extend([dict(res)] * count)
        state = ScalingState()
        state.set_autoscaling_instructions(
            make_autoscaling_instructions(demands))
        return state


def _parse_hhmm(text: str) -> int:
    hh, mm = text.split(":")
    return int(hh) * 60 + int(mm)


def create_scaling_policy(
    name: str, config: Dict[str, Any], head_host: str,
    state_client: Optional[StateClient] = None,
    scaling_config: Optional[Dict[str, Any]] = None,
) -> Optional[ScalingPolicy]:
    """Factory (reference parity: scaling_policies.py:688)."""
    if name in (None, "", "none"):
        return None
    if name == "scaling-with-resources":
        return ScalingWithResources(config, head_host, state_client)
    if name == "scaling-with-load":
        return ScalingWithLoad(config, head_host, state_client, scaling_config)
    if name == "scaling-with-time":
        return ScalingWithTime(config, head_host, scaling_config)
    if name == "scaling-by-node-type":
        counts = (scaling_config or {}).get("node_type_counts")
        return ScalingByNodeType(config, head_host, counts)
    if name == "serve-demand":
        return ServeDemandPolicy(config, head_host, state_client,
                                 scaling_config)
    raise ValueError(f"Unknown scaling policy {name!r}")
