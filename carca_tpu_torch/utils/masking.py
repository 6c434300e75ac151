"""Padding-mask semantics: item id 0 is the universal pad
(``src/utils.py:6-7``)."""

from __future__ import annotations

import torch


def get_mask(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """1.0 where ``x != 0`` else 0.0 (``src/utils.py:6-7``)."""
    return (x != 0).to(dtype)
