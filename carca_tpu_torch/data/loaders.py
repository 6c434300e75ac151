"""The packed dataset container (counterpart of
``carca_tpu/data/loaders.py::Catalog``): item catalog + CSR user histories,
as numpy arrays."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Catalog:
    """Packed dataset: item catalog + CSR user histories.

    ``attrs`` includes the pad row (row 0 = zeros) so ``attrs.shape[0]`` is
    the model's ``n_items`` (``src/data.py:28-35``).
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
