"""Operator-driven chaos drills: run a fault plan against a live scaler.

`tik chaos run plan.yaml --config cluster.yaml` arms the plan, drives N
reconciliation passes of a ClusterScaler built from the cluster config
(virtual/mock providers — this is a drill harness, not a production
wrecking ball), and reports the injection trace next to the scaler's
view of the aftermath.  The same driver backs the end-to-end drill
tests, so `tik chaos` exercises exactly the code the CI drills gate.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from cloudtik_tpu_torch.faults import seams
from cloudtik_tpu_torch.faults.plan import FaultPlan


def run_drill(config: Dict[str, Any], plan: FaultPlan,
              passes: int = 5, interval_s: float = 0.5,
              provider=None, metrics=None,
              executor_factory=None) -> Dict[str, Any]:
    """Arm `plan`, run `passes` scaler reconciliation ticks, disarm.

    Returns {"trace", "points", "summary", "passes", "errors"} — the
    deterministic injection trace plus the scaler's post-drill summary.
    Pass provider/metrics/executor_factory to drill pre-built fixtures
    (tests); otherwise they are created from the cluster config.
    """
    from cloudtik_tpu_torch.control.metrics import ClusterMetrics
    from cloudtik_tpu_torch.control.scaler import ClusterScaler

    if provider is None:
        from cloudtik_tpu_torch.providers.factory import create_node_provider
        provider = create_node_provider(
            config["provider"], config["cluster_name"])
    metrics = metrics or ClusterMetrics()
    scaler = ClusterScaler(
        config, provider, metrics,
        executor_factory=executor_factory, num_launcher_threads=1)
    errors = []
    with seams.armed(plan):
        try:
            for _ in range(max(passes, 1)):
                try:
                    scaler.update()
                except Exception as e:  # injected faults may surface here
                    errors.append(f"{type(e).__name__}: {e}")
                if interval_s:
                    time.sleep(interval_s)
        finally:
            scaler.shutdown()
    summary = plan.summary()
    return {
        "trace": summary["trace"],
        "points": summary["points"],
        "summary": scaler.summary(),
        "passes": passes,
        "errors": errors,
    }


def validate_plan(path: str) -> Dict[str, Any]:
    """Parse + schema-check a plan.yaml; returns its spec summary."""
    from cloudtik_tpu_torch.faults.plan import load_plan
    plan = load_plan(path)
    return {
        "name": plan.name,
        "seed": plan.seed,
        "faults": [
            {"seam": p.seam, "kind": p.kind, "at_call": p.at_call,
             "times": p.times, "probability": p.probability,
             "match": p.match, "args": p.args}
            for p in plan.points],
    }


def format_trace(result: Dict[str, Any]) -> str:
    lines = []
    for entry in result["trace"]:
        extra = {k: v for k, v in entry.items()
                 if k not in ("seam", "kind", "call", "fired")}
        suffix = f"  {extra}" if extra else ""
        lines.append(f"  [{entry['fired']}] {entry['seam']} "
                     f"({entry['kind']}, call #{entry['call']}){suffix}")
    if not lines:
        lines.append("  (no faults fired)")
    return "\n".join(lines)


def wait_for(predicate, timeout: float = 10.0,
             poll_s: float = 0.05) -> bool:
    """Poll helper shared by drills."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return False
