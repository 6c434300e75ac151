"""Profile self-attention encoder block (counterpart of
``carca_tpu/models/encoder.py``; contract at ``src/carca.py:272-318``):

* pre-norm on the **query only**: ``q = LN1(x)``; K and V are the raw x;
* self-attention with causal offset 0;
* optional residual ``s + q`` — onto the normed query, not x;
* ``LN2``, then two position-wise dense layers with LeakyReLU and dropout
  after each, and an optional residual ``f + s``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models import attention, layers


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.norm1 = layers.LayerNorm(cfg.d)
        self.attn = attention.MHA(cfg.d, generator)
        self.norm2 = layers.LayerNorm(cfg.d)
        self.ffn1 = layers.Dense(cfg.d, cfg.d, generator)
        self.ffn2 = layers.Dense(cfg.d, cfg.d, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, L, d], mask [B, L] → [B, L, d]."""
        cfg = self.cfg
        train = self.training
        q = self.norm1(x)
        s = self.attn(q, x, x, mask, mask, n_heads=cfg.n_heads, causal=0,
                      dropout_rate=cfg.dropout, train=train, generator=generator,
                      compute_dtype=cfg.compute_dtype, use_kernel=cfg.use_kernel)
        if cfg.residual_sa:
            s = s + q  # residual onto the normed query (src/carca.py:301-302)
        s = self.norm2(s)
        f = layers.leaky_relu(self.ffn1(s, cfg.compute_dtype))
        f = layers.dropout(f, cfg.dropout, train, generator)
        f = self.ffn2(f, cfg.compute_dtype)
        f = layers.dropout(f, cfg.dropout, train, generator)
        if cfg.residual_sa:
            f = f + s
        return f.to(torch.float32)
