"""Train-time losses (counterpart of ``carca_tpu/models/losses.py``).

``masked_bce`` is the reference objective (``src/carca.py:437-444``): the
model outputs sigmoid probabilities and the loss is
``−[y·log(ŷ+1e−8) + (1−y)·log(1−ŷ+1e−8)]`` summed under the mask and divided
by the mask sum; the mask is ``get_mask(o_x)`` over the whole candidate axis
(``src/train.py:92-93``). ``sampled_softmax`` is the retrieval-aligned
objective over [positive ‖ K negatives], with optional logQ correction.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_bce(y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    y_pred = y_pred.to(torch.float32)
    y_true = y_true.to(torch.float32)
    # maximum() keeps 1 − ŷ ≥ 0 for a sigmoid saturated at exactly 1.0, as
    # the JAX package does against XLA's reassociation: log(0 + eps) is
    # finite, and so is its gradient (torch.maximum splits a tie's
    # gradient in half, as jnp.maximum does)
    zero = torch.zeros((), device=y_pred.device)
    loss = -(y_true * torch.log(y_pred + eps)
             + (1.0 - y_true) * torch.log(torch.maximum(1.0 - y_pred, zero) + eps))
    # guarded denominator: an all-masked batch yields 0, not NaN
    return torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), eps)


def sampled_softmax(logits: torch.Tensor, o_x: torch.Tensor, n_groups: int,
                    logq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-position sampled-softmax loss over [positive ‖ K negatives].

    ``logits`` [B, G·L] group-major pre-sigmoid scores (group 0 the
    positives); ``o_x`` [B, G·L] candidate ids (group 0's zeros mark padded
    positions); ``logq`` optional [n_items] log sampling probability: each
    sampled (negative) candidate's logit becomes ``s − log q(item)``; the
    positive is given, not sampled, and is not corrected. Mean over valid
    positions; an all-padded batch yields 0, not NaN."""
    b = logits.shape[0]
    z = logits.reshape(b, n_groups, -1).to(torch.float32)
    ids = o_x.reshape(b, n_groups, -1)
    if logq is not None:
        negative = (torch.arange(n_groups, device=z.device) > 0)[None, :, None]
        z = z - torch.where(negative, logq[ids.long()], 0.0)
    valid = (ids[:, 0] > 0).to(torch.float32)  # [B, L]
    logp_pos = z[:, 0] - torch.logsumexp(z, dim=1)
    return -torch.sum(logp_pos * valid) / torch.clamp_min(torch.sum(valid), 1.0)
