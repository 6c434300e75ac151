"""Fused masked multi-head attention (counterpart of
``carca_tpu/ops/flash_attention.py::fused_attention``).

The wrapper for kernel K1 (``csrc/attention_fwd.cu``), which replaces the
TPU's ``_fwd_kernel``: the pair mask, the additive −(2³²−1) mask before the
√(d/H) division, the fp32 softmax, the post-softmax re-mask and w·V in one
launch, with no [B, H, Lq, Lk] tensor in device memory. Its plain version
is ``models.attention.masked_attention``.

This is the one place that picks kernel or plain, by device alone. On CPU
tensors ``fused_attention`` runs the plain version (with weight dropout
drawn from ``generator`` in training). On CUDA tensors it launches K1 or
raises — it never falls back. What K1 does not take yet raises: weight
dropout and inputs that need a gradient (the backward kernel and its
Philox dropout are a later slice), and a key length whose K/V tiles
overflow shared memory. A caller that wants the plain version on the card
calls ``masked_attention`` (``use_kernel=False``).
"""

from __future__ import annotations

from typing import Optional

import torch

from carca_tpu_torch.models.attention import masked_attention
from carca_tpu_torch.ops import _build


def _check_cuda_inputs(q, k, v, q_mask, k_mask, n_heads):
    for name, t in (("q", q), ("k", k), ("v", v), ("q_mask", q_mask),
                    ("k_mask", k_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the attention kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the attention kernel takes a contiguous {name}")
    b, lq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if q_mask.shape != (b, lq) or k_mask.shape != (b, k.shape[1]):
        raise ValueError("masks must be [B, Lq] and [B, Lk]")
    if d % n_heads:
        raise ValueError(f"d={d} is not divisible by n_heads={n_heads}")
    if b > 65_535 or n_heads > 65_535:
        raise ValueError(f"batch {b} or heads {n_heads} exceed the kernel's grid")


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: torch.Tensor,
    k_mask: torch.Tensor,
    *,
    causal: Optional[int],
    scale: float,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    n_heads: int = 1,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Attention on post-projection tensors: q [B, Lq, d], k/v [B, Lk, d],
    masks [B, Lq]/[B, Lk] (float 0/1) → merged-head context [B, Lq, d]
    float32. ``generator`` draws the weight dropout of the CPU path."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    if q.device.type == "cpu":
        return masked_attention(
            q, k, v, q_mask, k_mask, n_heads=n_heads, causal=causal,
            scale=scale, dropout_rate=dropout_rate, train=dropout_rate > 0.0,
            generator=generator, compute_dtype=compute_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda tensors, got {q.device}")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "weight dropout in the attention kernel lands with its backward "
            "kernel (ROADMAP queue B, B2); run the plain masked_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the attention kernel has no backward yet (ROADMAP queue B, B2); "
            "call it under torch.no_grad() or run the plain masked_attention")
    _check_cuda_inputs(q, k, v, q_mask, k_mask, n_heads)
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // n_heads
    out = torch.empty_like(q)
    if b == 0 or lq == 0:
        return out
    if lk == 0:
        raise ValueError("the attention kernel needs at least one key")
    lib = _build.library()
    smem = lib.carca_attention_fwd_smem_bytes(lk, dh)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"Lk={lk}, dh={dh} needs {smem} bytes of shared memory for K/V; "
            f"the kernel holds at most {_build.SMEM_LIMIT}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.carca_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_mask.data_ptr(),
            k_mask.data_ptr(), out.data_ptr(), b, n_heads, lq, lk, dh,
            int(causal is not None), int(causal or 0), float(scale),
            int(compute_dtype == "bfloat16"), stream)
    _build.check(err, "attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0  # kernel launches, for checks that the path ran K1
