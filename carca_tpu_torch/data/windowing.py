"""Leave-one-out windowing over user histories (a copy of
``carca_tpu/data/windowing.py``: numpy only).

Contract (``pad_profile``, ``src/data.py:53-74``): returns the index window
[start, end) into a user's temporally-ordered history, per split:

* train (len > 1): exclude the last 2 items when ``test=True`` else 1;
  ``end = max(1, len − n_exc)``, ``start = max(0, len − n_exc − max_len − 1)``
* val (len > 2): exclude 1 if ``test`` else 0; ``end = max(2, len − n_exc)``
* test (len > 3): exclude 0; ``end = max(3, len)``

A user is valid for a split iff its window is non-empty
(``CARCADataset.valid_user_ids``, ``src/data.py:247-248``). The example
builders consume ``window[:-1]`` as profile sources (train targets are the
successors; eval's held-out positive is ``window[-1]``).

Vectorized over all users (the reference computes this per example in
Python).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_N_EXCLUDED = {
    # mode: (n_excluded if test else, n_excluded if not test, min_len, min_end)
    "train": (2, 1, 1, 1),
    "val": (1, 0, 2, 2),
    "test": (0, 0, 3, 3),
}


def window_bounds(
    lengths: np.ndarray, max_len: int, mode: str, test: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``pad_profile``: per-user (start, end) windows.

    Users failing the split's minimum-length requirement get (0, 0)
    (empty window → filtered by ``valid_users``).
    """
    if mode not in _N_EXCLUDED:
        raise ValueError(f"invalid mode: {mode}")
    exc_t, exc_f, min_len, min_end = _N_EXCLUDED[mode]
    n_exc = exc_t if test else exc_f

    lengths = np.asarray(lengths, dtype=np.int64)
    ok = lengths > min_len
    start = np.maximum(0, lengths - n_exc - max_len - 1)
    end = np.maximum(min_end, lengths - n_exc)
    return np.where(ok, start, 0), np.where(ok, end, 0)


def valid_users(lengths: np.ndarray, max_len: int, mode: str, test: bool) -> np.ndarray:
    """Indices of users with non-empty windows (``src/data.py:247-248``)."""
    start, end = window_bounds(lengths, max_len, mode, test)
    return np.flatnonzero(end > start)
