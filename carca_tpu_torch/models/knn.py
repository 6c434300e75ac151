"""The non-learned KNN content baseline (counterpart of
``carca_tpu/models/knn.py``; contract ``src/knn.py:8-21``): each candidate
scores the dot product of the last profile item's attribute vector with
its own; scores concatenate over target groups. It has no parameters and
shares the eval harness with CARCA."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def knn_apply(profile, targets: Sequence, *,
              attrs_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """profile (p_x [B, L], p_a or None, _), targets [(o_x [B, T], o_a or
    None, _), ...] → scores [B, ΣT]; missing attrs come from
    ``attrs_table``."""
    p_x, p_a, _ = profile
    if p_a is None:
        p_a = attrs_table[p_x.long()]
    last_p = p_a[:, -1:, :]
    y_preds = []
    for o_x, o_a, _ in targets:
        if o_a is None:
            o_a = attrs_table[o_x.long()]
        y_preds.append(torch.sum(last_p * o_a, dim=-1))
    return torch.cat(y_preds, dim=-1)
