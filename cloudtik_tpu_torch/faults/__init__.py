"""Deterministic fault-injection subsystem (chaos drills for the
control plane, trainer, and serve engine).

Usage:
    from cloudtik_tpu_torch.faults import seams
    from cloudtik_tpu_torch.faults.plan import FaultPlan, FaultPoint

    plan = FaultPlan([FaultPoint("state.put", "raise", times=2)], seed=7)
    with seams.armed(plan):
        ...  # two state puts fail, everything after succeeds

See docs/fault-injection.md for the fault model and the seam registry.
"""

from cloudtik_tpu_torch.faults.plan import (  # noqa: F401
    DIRECTIVE_DROP, DIRECTIVE_TORN_WRITE, FaultInjected, FaultPlan,
    FaultPoint, load_plan, plan_from_dict)
from cloudtik_tpu_torch.faults import seams  # noqa: F401
