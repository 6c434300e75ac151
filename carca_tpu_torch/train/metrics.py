"""Ranking metrics: HR@k and NDCG@k (counterpart of
``carca_tpu/train/metrics.py``).

Contract (``src/train.py:15-32``): sort the scores descending, gather the
labels, read the top k. HR = Σ labels in the top k; NDCG = Σ 1/log₂(rank+2)
over the positives there. Both are batch sums; the evaluator divides by the
users counted. Ties go to the lowest index (``lax.top_k``'s order: a stable
sort, never ``torch.topk``), and a NaN score ranks last and earns nothing,
so a diverged model cannot report HR = 1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def hr_ndcg_sums(y_pred: torch.Tensor, y_true: torch.Tensor, k: int,
                 row_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_pred/y_true [B, T] → (HR sum, NDCG sum) over the rows, 0-d float32
    tensors; ``row_mask`` [B] zeroes batch-padding rows."""
    k = min(k, y_pred.shape[-1])
    y_pred = torch.where(torch.isnan(y_pred), float("-inf"), y_pred)
    order = torch.sort(y_pred, dim=-1, descending=True, stable=True)
    vals, idx = order.values[..., :k], order.indices[..., :k]
    top = torch.gather(y_true.to(torch.float32), -1, idx) * torch.isfinite(vals)
    gains = 1.0 / torch.log2(torch.arange(k, dtype=torch.float32, device=y_pred.device) + 2.0)
    hr_rows = top.sum(dim=-1)
    ndcg_rows = (top * gains).sum(dim=-1)
    if row_mask is not None:
        hr_rows = hr_rows * row_mask
        ndcg_rows = ndcg_rows * row_mask
    return hr_rows.sum(), ndcg_rows.sum()
