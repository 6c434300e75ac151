"""Primitive layers (counterpart of ``carca_tpu/models/layers.py``).

``Dense`` keeps the JAX parameter names and layout (``w`` [in, out], ``b``
[out]) so converted weights load without transposes. Weights are float32;
with ``compute_dtype="bfloat16"`` the matmul inputs are rounded to bf16 and
the products accumulate in float32, as the JAX package's
``preferred_element_type=float32`` dots do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from carca_tpu_torch.utils.initializers import xavier_uniform


def round_to(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """Round ``x`` to the compute dtype and back to float32: a product of
    two such values is exact in float32, so a float32 matmul of rounded
    inputs equals a bf16 matmul with float32 accumulation."""
    if compute_dtype == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x.to(torch.float32)


class Dense(nn.Module):
    """Linear layer: xavier-uniform weight, zero bias
    (``src/carca.py:220-226``)."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(xavier_uniform((d_in, d_out), generator))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, compute_dtype: str = "float32") -> torch.Tensor:
        return torch.matmul(round_to(x, compute_dtype),
                            round_to(self.w, compute_dtype)) + self.b


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, torch semantics (biased variance, eps
    inside the sqrt; ``src/carca.py:279,283,408``), with the JAX parameter
    names ``scale`` and ``bias``."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (``nn.Dropout`` semantics: scale by 1/(1-p) at
    train, identity at eval). The keep mask is drawn from ``generator``,
    which must live on ``x``'s device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout requires a generator when train=True and rate>0")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """``nn.LeakyReLU()`` default slope (``src/carca.py:285``)."""
    return torch.where(x >= 0, x, negative_slope * x)
