"""Multi-head attention with the reference's exact (nonstandard) semantics
(counterpart of ``carca_tpu/models/attention.py``; contract at
``src/carca.py:204-265``):

* Q/K/V projections with bias; **no output projection W_O**;
* pair mask q_mask ⊗ k_mask, tril'd at offset ``causal`` (``:246-250``);
* additive −(2³²−1) mask added **before** the division by √(d/H)
  (``:253-254``), logits in float32;
* post-softmax **re-mask** (``:256``): fully masked query rows come out
  exactly 0;
* dropout on the attention weights (``:258``).

``masked_attention`` is the plain version: the oracle for the CUDA kernels
in ``ops/flash_attention.py`` (autograd over it is the oracle of the
backward kernel) and their CPU path. Only the ``bhqk`` formulation of the
JAX package is ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from carca_tpu_torch.models import layers

NEG_MASK = -(2.0**32) + 1.0  # src/carca.py:251


def pair_mask(q_mask: torch.Tensor, k_mask: torch.Tensor,
              causal: Optional[int]) -> torch.Tensor:
    """[B, Lq, Lk] float mask: q_mask ⊗ k_mask, keeping k_pos ≤ q_pos +
    ``causal`` when ``causal`` is not None (``torch.tril(diagonal=causal)``,
    src/carca.py:250)."""
    m = q_mask[:, :, None] * k_mask[:, None, :]
    if causal is not None:
        lq, lk = q_mask.shape[1], k_mask.shape[1]
        rows = torch.arange(lq, device=m.device)[:, None]
        cols = torch.arange(lk, device=m.device)[None, :]
        m = m * (cols <= rows + causal).to(m.dtype)[None]
    return m


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads).permute(0, 2, 1, 3)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: torch.Tensor,
    k_mask: torch.Tensor,
    *,
    n_heads: int,
    causal: Optional[int],
    scale: float,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    compute_dtype: str = "float32",
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference attention on post-projection tensors: q [B, Lq, d],
    k/v [B, Lk, d], masks [B, Lq]/[B, Lk] (float 0/1) → [B, Lq, d] float32.
    ``compute_dtype`` rounds only the product inputs; sums are float32.

    ``keep_mask`` [B, H, Lq, Lk] (bool), when given, replaces the
    generator's draw: the weights are kept where it is True and divided by
    1 − ``dropout_rate`` (``train`` and ``generator`` are then unused).
    This is how the plain version is fed the kernels' own Philox bits."""
    b, lq, d = q.shape
    m = pair_mask(q_mask.to(torch.float32), k_mask.to(torch.float32), causal)
    add = torch.where(m > 0, 0.0, NEG_MASK).to(torch.float32)

    qh = _split_heads(layers.round_to(q, compute_dtype), n_heads)
    kh = _split_heads(layers.round_to(k, compute_dtype), n_heads)
    vh = _split_heads(layers.round_to(v, compute_dtype), n_heads)

    logits = torch.einsum("bhqe,bhke->bhqk", qh, kh)
    logits = (logits + add[:, None]) / scale
    w = torch.softmax(logits, dim=-1)
    w = w * m[:, None]  # post-softmax re-mask (src/carca.py:256)
    if keep_mask is not None:  # on weights (:258)
        wd = torch.where(keep_mask, w / (1.0 - dropout_rate), torch.zeros((), device=w.device))
    else:
        wd = layers.dropout(w, dropout_rate, train, generator)
    out = torch.einsum("bhqk,bhke->bhqe", layers.round_to(wd, compute_dtype), vh)
    return out.permute(0, 2, 1, 3).reshape(b, lq, d)


class MHA(nn.Module):
    """Q/K/V projections + the reference attention (no W_O)."""

    def __init__(self, d: int, generator: torch.Generator):
        super().__init__()
        self.wq = layers.Dense(d, d, generator)
        self.wk = layers.Dense(d, d, generator)
        self.wv = layers.Dense(d, d, generator)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        q_mask: torch.Tensor,
        k_mask: torch.Tensor,
        *,
        n_heads: int,
        causal: Optional[int],
        dropout_rate: float,
        train: bool,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
        compute_dtype: str = "float32",
        use_kernel=False,
        seed=None,
    ) -> torch.Tensor:
        """query [B,Lq,d], key/value [B,Lk,d], masks [B,Lq]/[B,Lk] → [B,Lq,d].

        ``use_kernel`` True or "auto" hands the call to ``fused_attention``,
        which alone picks by device: the plain version on CPU tensors, the
        kernels on CUDA tensors (K1 forward, K2 backward under autograd,
        weight dropout keyed by a seed from the CPU ``seed_generator``) —
        or a raise, never the plain version. ``False`` runs the plain
        version on any device, its dropout drawn from ``generator``.
        ``seed``, when given, is the kernels' Philox seed drawn already
        (``flash_attention.kernel_seed``: a value or a slot)."""
        if train and dropout_rate > 0.0 and generator is None:
            raise ValueError("dropout requires a generator when train=True and rate>0")
        q = self.wq(query, compute_dtype)
        k = self.wk(key, compute_dtype)
        v = self.wv(value, compute_dtype)
        scale = (q.shape[-1] / n_heads) ** 0.5
        if use_kernel is not False:
            from carca_tpu_torch.ops.flash_attention import fused_attention
            return fused_attention(
                q, k, v, q_mask, k_mask, causal=causal, scale=scale,
                dropout_rate=dropout_rate if train else 0.0, generator=generator,
                seed_generator=seed_generator, n_heads=n_heads, compute_dtype=compute_dtype,
                seed=seed)
        return masked_attention(
            q, k, v, q_mask, k_mask, n_heads=n_heads, causal=causal,
            scale=scale, dropout_rate=dropout_rate, train=train,
            generator=generator, compute_dtype=compute_dtype)
