"""Shared arithmetic of the metric readers (not a metric)."""

import math
from typing import List, Optional


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The q-quantile by nearest rank (the ceil(q n)-th smallest); None
    when it is missing (an infinite latency) or there are no values."""
    if not values:
        return None
    v = sorted(values)[max(math.ceil(q * len(values)) - 1, 0)]
    return None if math.isinf(v) else v


def idle_percent(record) -> Optional[float]:
    p = record.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
