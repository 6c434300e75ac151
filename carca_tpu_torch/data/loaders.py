"""Dataset loading (counterpart of ``carca_tpu/data/loaders.py``): the
reference's file formats into the packed ``Catalog`` (item catalog + CSR
user histories, as numpy arrays).

* profiles: a text file of ``"user_id item_id"`` lines in temporal order per
  user (``src/data.py:38-50``);
* attrs: a pickled ``[n_items, n_attrs]`` float array; a zero pad row is
  prepended so item id 0 is ``<pad>`` (``src/data.py:28-35``);
* ctx: a pickled ``{(user_id, item_id): float vector}`` dict
  (``src/data.py:17-25``).
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Catalog:
    """Packed dataset: item catalog + CSR user histories.

    ``attrs`` includes the pad row (row 0 = zeros) so ``attrs.shape[0]`` is
    the model's ``n_items`` (``src/data.py:28-35``). A catalog generated on
    a device (``data/synthetic.py``) holds ``attrs``, ``items`` and
    ``ctx_vals`` as torch tensors there; ``host_catalog`` copies it.
    """

    attrs: np.ndarray  # [n_items, n_attrs] float32, row 0 = pad
    user_ids: np.ndarray  # [n_users] original user ids
    items: np.ndarray  # [n_events] int32 item ids, per-user temporal order
    offsets: np.ndarray  # [n_users + 1] int64 CSR offsets into items/ctx_vals
    ctx_vals: np.ndarray  # [n_events, n_ctx] float32, aligned with items

    @property
    def n_items(self) -> int:
        return int(self.attrs.shape[0])

    @property
    def n_attrs(self) -> int:
        return int(self.attrs.shape[1])

    @property
    def n_ctx(self) -> int:
        return int(self.ctx_vals.shape[1])

    @property
    def n_users(self) -> int:
        return int(len(self.offsets) - 1)

    def profile_sets(self) -> List[frozenset]:
        """Per-user item-id sets (the reference's sampler rejects against the
        user's full history, ``src/data.py:77-87``)."""
        return [frozenset(self.items[self.offsets[u]: self.offsets[u + 1]].tolist())
                for u in range(self.n_users)]


def host_catalog(cat: Catalog) -> Catalog:
    """``cat`` with every array on the host as numpy (itself when it
    already is): an explicit copy for the consumers that read a catalog
    on the host."""
    fields = (cat.attrs, cat.user_ids, cat.items, cat.offsets, cat.ctx_vals)
    if not any(isinstance(a, torch.Tensor) for a in fields):
        return cat
    return Catalog(*(a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in fields))


def load_attrs(path: str) -> np.ndarray:
    """Pickled [n, a] float array → [n+1, a] float32 with a zero pad row."""
    with open(path, "rb") as fh:
        attrs = pickle.load(fh)
    attrs = np.asarray(attrs, dtype=np.float32)
    pad = np.zeros((1, attrs.shape[1]), dtype=np.float32)
    return np.concatenate([pad, attrs], axis=0)


def load_ctx(path: str) -> Dict[Tuple[int, int], np.ndarray]:
    """Pickled {(user, item): vec} dict."""
    with open(path, "rb") as fh:
        ctx = pickle.load(fh)
    return {k: np.asarray(v, dtype=np.float32) for k, v in ctx.items()}


def load_profiles(path: str) -> Tuple[List[int], List[int], Dict[int, List[int]]]:
    """Text "user item" lines → (user_ids, item_ids, {user: [items...]}),
    keeping each user's temporal order."""
    user_ids, item_ids = set(), set()
    profiles: Dict[int, List[int]] = defaultdict(list)
    with open(path, "r") as fh:
        for line in fh:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            u, i = int(parts[0]), int(parts[1])
            user_ids.add(u)
            item_ids.add(i)
            profiles[u].append(i)
    return list(user_ids), list(item_ids), profiles


def build_catalog(profiles: Dict[int, List[int]], attrs: np.ndarray,
                  ctx: Optional[Dict[Tuple[int, int], np.ndarray]],
                  n_ctx: Optional[int] = None) -> Catalog:
    """Pack dict-of-lists profiles and the ctx dict into CSR arrays; without
    ``ctx`` the context has width ``n_ctx`` (default 0) and is zero."""
    users = list(profiles.keys())
    lengths = np.array([len(profiles[u]) for u in users], dtype=np.int64)
    offsets = np.zeros(len(users) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    n_events = int(offsets[-1])
    items = np.zeros(n_events, dtype=np.int32)
    if ctx:
        c_len = len(next(iter(ctx.values()))) if n_ctx is None else n_ctx
    else:
        c_len = n_ctx or 0
    ctx_vals = np.zeros((n_events, c_len), dtype=np.float32)
    for ui, u in enumerate(users):
        s = offsets[ui]
        seq = profiles[u]
        items[s: s + len(seq)] = seq
        if ctx:
            for j, it in enumerate(seq):
                ctx_vals[s + j] = ctx[(u, it)]
    return Catalog(attrs=np.asarray(attrs, dtype=np.float32),
                   user_ids=np.asarray(users, dtype=np.int64), items=items,
                   offsets=offsets, ctx_vals=ctx_vals)


def load_dataset(data_dir: str, profile_file: str, attr_file: str, ctx_file: str) -> Catalog:
    """The reference CLI's loading (``scripts/training.py:106-117``)."""
    attrs = load_attrs(f"{data_dir}/{attr_file}")
    ctx = load_ctx(f"{data_dir}/{ctx_file}") if ctx_file else None
    _, _, profiles = load_profiles(f"{data_dir}/{profile_file}")
    return build_catalog(profiles, attrs, ctx)
