"""Synthetic training batches.

Counterpart of `cloudtik_tpu/train/data.py`'s `synthetic_lm_batches`, byte
for byte: the same numpy generator, seed and draws, so that both packages
train on identical batches.  Batches are numpy arrays; the trainer moves
them to its device.  The per-host sharded loaders come with the parallel
slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic next-token-prediction batches."""
    rng = np.random.default_rng(seed)
    while True:
        tokens = rng.integers(
            0, vocab_size, (batch_size, seq_len), dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        yield {"tokens": tokens, "labels": labels.astype(np.int32)}
