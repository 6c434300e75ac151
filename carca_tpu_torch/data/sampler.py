"""Host-side negative sampling with the reference's semantics (counterpart
of ``carca_tpu/data/sampler.py``; numpy, bit-identical to it for one
generator state).

Uniform item ids in [1, n_items−1], rejected against the user's full
history and against duplicates within the sample (``src/data.py:77-87``),
drawn in vectorized batches that loop only on a shortfall.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def sample_negatives(rng: np.random.Generator, profile_set: np.ndarray, n_items: int,
                     n: int) -> np.ndarray:
    """n distinct ids from [1, n_items−1] avoiding ``profile_set`` (a 1-D
    array of the user's item ids)."""
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    out = np.zeros(0, dtype=np.int64)
    need = n
    while need > 0:
        draws = rng.integers(1, n_items, size=max(2 * need, need + 8))
        good = draws[~np.isin(draws, profile_set)]
        if out.size:
            good = good[~np.isin(good, out)]
        # first-occurrence dedup (np.unique sorts; restore draw order)
        _, first = np.unique(good, return_index=True)
        good = good[np.sort(first)]
        out = np.concatenate([out, good[:need]])
        need = n - out.size
    return out.astype(np.int32)


def sample_negatives_batch(rng: np.random.Generator, profile_sets: Sequence[np.ndarray],
                           user_rows: np.ndarray, counts: np.ndarray, n_items: int,
                           width: int) -> np.ndarray:
    """``counts[b]`` negatives for user ``user_rows[b]``, zero-padded to [B,
    width]; rows with ``user_rows[b] < 0`` (batch padding) stay zero."""
    out = np.zeros((len(user_rows), width), dtype=np.int32)
    for b in range(len(user_rows)):
        u, n = int(user_rows[b]), int(counts[b])
        if u < 0 or n <= 0:
            continue
        out[b, :n] = sample_negatives(rng, profile_sets[u], n_items, n)
    return out
