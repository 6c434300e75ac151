"""Host batch assembly and user-row batching (counterpart of
``carca_tpu/data/dataset.py``): the numpy path, or the native C++ assembler
(``carca_tpu_torch/native``) in the ``native`` slot, which gives the same
batches but for the negatives, drawn from its own streams under the same
sampler contract.

* Train examples (``src/data.py:90-137``): a right-aligned length-L window;
  ``p_x[t] = item_t``, positives ``o_x[t] = item_{t+1}``, negatives at
  ``o_x[L + t]`` inheriting the positive's context (``src/data.py:130``);
  ``y_true`` 1 where ``p_x > 0`` in the first half. Fresh negatives on
  every call.
* Eval examples (``src/data.py:140-192``): slot 0 the held-out positive,
  slots 1..T sampled negatives, all with the positive's context; the
  profile is the up to L preceding items, right-aligned.

Batches have a fixed shape: a partial batch is padded with all-zero rows
and ``n_valid`` counts the real ones. Arrays are numpy; the fit loop moves
them to the device.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator, Optional

import numpy as np

from carca_tpu_torch.data.loaders import Catalog, host_catalog
from carca_tpu_torch.data.sampler import sample_negatives_batch
from carca_tpu_torch.data.windowing import valid_users, window_bounds

Batch = Dict[str, np.ndarray]


class BatchBuilder:
    """Fixed-shape train and eval batches from a packed Catalog, drawing
    negatives from the ``np.random.Generator`` each call is given; with
    ``native`` (a ``NativeAssembler``) the batches are assembled by it."""

    def __init__(self, catalog: Catalog, seq_len: int, target_len: int = 100,
                 test: bool = True, native: Optional[object] = None):
        catalog = host_catalog(catalog)  # a device catalog is copied to the host once
        self.cat = catalog
        self.L = int(seq_len)
        self.T = int(target_len)
        self.test = bool(test)
        self.native = native
        lengths = np.diff(catalog.offsets)
        self._windows = {m: window_bounds(lengths, self.L, m, self.test)
                         for m in ("train", "val", "test")}
        self._valid = {m: valid_users(lengths, self.L, m, self.test)
                       for m in ("train", "val", "test")}

    @functools.cached_property
    def _sets(self) -> list:
        """Each user's history, for the numpy sampler alone."""
        off, items = self.cat.offsets, self.cat.items
        return [items[off[u]: off[u + 1]] for u in range(self.cat.n_users)]

    def users(self, mode: str) -> np.ndarray:
        """Users with non-empty windows for the split (``src/data.py:247``)."""
        return self._valid[mode]

    def _profile_slots(self, user_rows: np.ndarray, mode: str):
        """Right-aligned window positions: slot j ∈ [0, L) reads event
        e − L − 1 + j, valid from the window's start (``src/data.py:112-127``)."""
        start, end = self._windows[mode]
        rows = np.maximum(user_rows, 0)
        s, e = start[rows], end[rows]
        alive = (user_rows >= 0) & (e > s)
        j = np.arange(self.L, dtype=np.int64)[None, :]
        pi = e[:, None] - self.L - 1 + j
        valid = (pi >= s[:, None]) & alive[:, None]
        off = self.cat.offsets[rows]
        p_evt = np.where(valid, off[:, None] + pi, 0)
        return p_evt, valid, alive, e, off

    def train_batch(self, user_rows: np.ndarray, rng: np.random.Generator) -> Batch:
        if self.native is not None:
            return self.native.train_batch(self, user_rows, rng)
        cat, L = self.cat, self.L
        p_evt, valid, alive, _, _ = self._profile_slots(user_rows, "train")
        p_x = np.where(valid, cat.items[p_evt], 0).astype(np.int32)
        o_pos_evt = np.where(valid, p_evt + 1, 0)
        o_pos = np.where(valid, cat.items[o_pos_evt], 0).astype(np.int32)
        p_c = cat.ctx_vals[p_evt] * valid[..., None]
        o_pos_c = cat.ctx_vals[o_pos_evt] * valid[..., None]
        packed = sample_negatives_batch(rng, self._sets, user_rows, valid.sum(axis=1),
                                        cat.n_items, L)
        # the left-packed negatives into the right-aligned valid slots
        o_neg = np.zeros_like(o_pos)
        o_neg[valid] = packed[packed > 0] if packed.any() else 0
        y = np.concatenate([(p_x > 0).astype(np.float32),
                            np.zeros_like(p_x, dtype=np.float32)], axis=1)
        return {"p_x": p_x, "p_c": p_c.astype(np.float32),
                "o_x": np.concatenate([o_pos, o_neg], axis=1),
                "o_c": np.concatenate([o_pos_c, o_pos_c], axis=1).astype(np.float32),
                "y_true": y, "n_valid": np.int32(alive.sum())}

    def eval_batch(self, user_rows: np.ndarray, rng: np.random.Generator, mode: str) -> Batch:
        if self.native is not None:
            return self.native.eval_batch(self, user_rows, rng, mode)
        cat, L, T = self.cat, self.L, self.T
        p_evt, valid, alive, end, off = self._profile_slots(user_rows, mode)
        p_x = np.where(valid, cat.items[p_evt], 0).astype(np.int32)
        p_c = cat.ctx_vals[p_evt] * valid[..., None]
        one_out_evt = np.where(alive, off + end - 1, 0)
        pos = np.where(alive, cat.items[one_out_evt], 0).astype(np.int32)
        pos_c = cat.ctx_vals[one_out_evt] * alive[:, None]
        negs = sample_negatives_batch(rng, self._sets, np.where(alive, user_rows, -1),
                                      np.where(alive, T, 0), cat.n_items, T)
        o_x = np.concatenate([pos[:, None], negs], axis=1)
        # negatives share the held-out positive's context (src/data.py:185)
        o_c = np.broadcast_to(pos_c[:, None, :], (len(user_rows), T + 1, cat.n_ctx)).copy()
        o_c[:, 1:][negs == 0] = 0.0
        y = np.zeros((len(user_rows), T + 1), dtype=np.float32)
        y[:, 0] = alive.astype(np.float32)
        return {"p_x": p_x, "p_c": p_c.astype(np.float32), "o_x": o_x.astype(np.int32),
                "o_c": o_c.astype(np.float32), "y_true": y, "n_valid": np.int32(alive.sum())}


def epoch_batches(
    users: np.ndarray,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    drop_remainder: bool = False,
) -> Iterator[np.ndarray]:
    """Yield fixed-size user-row batches; the last partial batch is padded
    with −1 rows (the builders emit all-zero rows for them)."""
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
