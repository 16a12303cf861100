"""Uniform dataframe/dataset API for AI workloads.

Reference parity: runtime/ai/data/api.py:27 — the reference exposes one
dataframe namespace that switches between pandas and modin (distributed
pandas on the cluster) by config.  The TPU build keeps the same contract:
`dataframe()` returns the active engine's module, `read_*` dispatch
through it, and device feeding goes through `to_device_batches`, which
turns a dataframe into the padded numpy batches the sharded Trainer
consumes (`train/data.py` global_batches assembles them across hosts).

modin is not bundled in this image; requesting it falls back to pandas
with a warning rather than failing the workload (same soft-degrade the
reference applies when modin's engine is absent).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_ENGINE = "pandas"


def set_engine(engine: str) -> str:
    """Select 'pandas' or 'modin' (falls back to pandas if unavailable).
    Returns the engine actually in effect."""
    global _ENGINE
    if engine not in ("pandas", "modin"):
        raise ValueError(f"unknown dataframe engine {engine!r}")
    if engine == "modin":
        try:
            import modin.pandas  # noqa: F401
        except ImportError:
            logger.warning(
                "modin requested but not installed; using pandas")
            engine = "pandas"
    _ENGINE = engine
    return _ENGINE


def get_engine() -> str:
    return _ENGINE


def dataframe():
    """The active dataframe module (pandas-compatible namespace)."""
    if _ENGINE == "modin":
        import modin.pandas as pd
        return pd
    import pandas as pd
    return pd


def read_csv(path: str, **kwargs):
    return dataframe().read_csv(path, **kwargs)


def read_parquet(path: str, **kwargs):
    return dataframe().read_parquet(path, **kwargs)


def read_json(path: str, **kwargs):
    return dataframe().read_json(path, **kwargs)


def to_device_batches(
    df,
    feature_columns: Sequence[str],
    label_column: Optional[str] = None,
    *,
    batch_size: int = 256,
    repeat: bool = True,
    drop_remainder: bool = True,
    dtype=np.float32,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Dataframe -> {'features': [B, F], 'labels': [B]} numpy batches.

    The host-side half of the data path: shuffled epochs, fixed batch
    shape (drop_remainder keeps XLA from recompiling on a ragged tail).
    Feed through train.data.global_batches for multi-host assembly.
    """
    feats = df[list(feature_columns)].to_numpy().astype(dtype)
    labels = (df[label_column].to_numpy() if label_column is not None
              else None)
    n = len(feats)
    if n < batch_size:
        raise ValueError(
            f"dataframe has {n} rows < batch_size {batch_size}")
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        end = n - batch_size + 1 if drop_remainder else n
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            batch: Dict[str, np.ndarray] = {"features": feats[idx]}
            if labels is not None:
                batch["labels"] = labels[idx]
            yield batch
        if not repeat:
            return
