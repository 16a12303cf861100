"""Synthetic training batches.

Counterpart of `cloudtik_tpu/train/data.py`'s `synthetic_lm_batches` and
`synthetic_mlm_batches`, byte for byte: the same numpy generator, seed and
draws, so that both packages train on identical batches.  Batches are
numpy arrays; the trainer moves them to its device.  The per-host sharded
loaders come with the parallel slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

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


def synthetic_mlm_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    mask_token: int = 1,
    max_predictions: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic masked-LM batches (BERT objective).

    Emits the gathered layout (mlm_positions/mlm_labels, P =
    max_predictions) so the vocab projection runs only on masked
    positions; P defaults to ceil(mask_prob * seq_len).
    """
    rng = np.random.default_rng(seed)
    P = max_predictions or max(int(np.ceil(mask_prob * seq_len)), 1)
    while True:
        tokens = rng.integers(
            2, vocab_size, (batch_size, seq_len), dtype=np.int32)
        positions = np.stack([
            rng.choice(seq_len, size=P, replace=False)
            for _ in range(batch_size)]).astype(np.int32)
        labels = np.take_along_axis(tokens, positions, axis=1)
        masked = tokens.copy()
        np.put_along_axis(masked, positions, mask_token, axis=1)
        yield {"tokens": masked,
               "mlm_positions": positions,
               "mlm_labels": labels.astype(np.int32)}
