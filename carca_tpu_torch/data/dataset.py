"""User-row batching (counterpart of ``carca_tpu/data/dataset.py``; only
``epoch_batches`` is ported — the host ``BatchBuilder`` is not, since
batches are assembled on the device, ``data/device_pipeline.py``)."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def epoch_batches(
    users: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_remainder: bool = False,
) -> Iterator[np.ndarray]:
    """Yield fixed-size user-row batches; the last partial batch is padded
    with −1 rows (the assembler emits all-zero rows for them)."""
    users = np.asarray(users)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle requires an rng")
        users = rng.permutation(users)
    n = len(users)
    for i in range(0, n, batch_size):
        chunk = users[i: i + batch_size]
        if len(chunk) < batch_size:
            if drop_remainder:
                return
            pad = np.full(batch_size - len(chunk), -1, dtype=chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        yield chunk
