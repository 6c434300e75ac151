"""Candidate-scoring decoders (counterpart of
``carca_tpu/models/decoders.py``): (candidate embeddings o [B,T,d],
candidate mask, encoded profile p [B,L,d], profile mask) → [B, T].

* ``ca`` — cross-attention (``src/carca.py:322-349``): candidates attend
  over the profile with causal offset −1 in training and no causal mask
  at eval; optional residual ``s + o``; Linear(d→1) + sigmoid.
* ``dot`` — train: Σ(p⊙o) per aligned position; eval: the last profile
  state against every candidate (``src/carca.py:352-365``).
* ``wdot`` — the closed form of ``src/carca.py:368-395``: p[b, i] scaled by
  Σ_{j≤i} γ^j; optional L2 normalisation by x·rsqrt(Σx² + eps) (finite
  gradient at a zero vector), cosine mapped to [0, 1].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models import attention, layers


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-12)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        if cfg.decoder == "ca":
            self.attn = attention.MHA(cfg.d, generator)
            self.ffn = layers.Dense(cfg.d, 1, generator)

    def forward(
        self,
        o: torch.Tensor,
        o_mask: torch.Tensor,
        p: torch.Tensor,
        p_mask: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
        return_logits: bool = False,
    ) -> torch.Tensor:
        """``return_logits=True`` skips the probability mapping."""
        cfg = self.cfg
        train = self.training
        if cfg.decoder == "ca":
            s = self.attn(o, p, p, o_mask, p_mask, n_heads=cfg.n_heads,
                          causal=-1 if train else None,  # src/carca.py:339
                          dropout_rate=cfg.dropout, train=train,
                          generator=generator, seed_generator=seed_generator,
                          compute_dtype=cfg.compute_dtype, use_kernel=cfg.use_kernel)
            if cfg.residual_ca:
                s = s + o
            y = self.ffn(s, cfg.compute_dtype)[..., 0].to(torch.float32)
            return y if return_logits else torch.sigmoid(y)

        if cfg.decoder == "dot":
            y = (p * o if train else p[:, -1:, :] * o).sum(dim=-1).to(torch.float32)
            return y if return_logits else torch.sigmoid(y)

        # wdot
        L = p.shape[1]
        scale = torch.cumsum(cfg.gamma ** torch.arange(L, dtype=torch.float32,
                                                       device=p.device), dim=0)
        pw = p * scale[None, :, None]
        ow = o
        if cfg.l2_norm:
            pw, ow = _l2n(pw), _l2n(ow)
        y = (pw * ow if train else pw[:, -1:, :] * ow).sum(dim=-1).to(torch.float32)
        if return_logits:
            return y
        if cfg.l2_norm:
            return (y + 1.0) / 2.0  # cosine → [0, 1] (src/carca.py:391)
        return torch.sigmoid(y)
