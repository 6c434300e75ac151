"""Positional encodings (counterpart of ``carca_tpu/models/encodings.py``).

Applied only to profile embeddings, never to targets
(``src/carca.py:91-92``). "positional" is a fixed sin/cos table held as a
registered buffer: it moves with the module and is not a parameter. Both
tables are made on the generator's device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from carca_tpu_torch.utils.initializers import xavier_uniform


def sinusoid_table(max_len: int, d: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Fixed sin/cos table (``src/carca.py:43-52``) on ``device``."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d))
    pe = torch.zeros(max_len, d, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class Encoding(nn.Module):
    """``kind``: "identity" (no-op), "learnable" (xavier table, row 0 not
    zeroed, ``src/carca.py:15-22``) or "positional"."""

    def __init__(self, kind: str, d: int, max_len: int, generator: torch.Generator):
        super().__init__()
        self.kind = kind
        if kind == "learnable":
            self.table = nn.Parameter(xavier_uniform((max_len, d), generator))
        elif kind == "positional":
            self.register_buffer("pe", sinusoid_table(max_len, d, generator.device))
        elif kind != "identity":
            raise ValueError(f"unknown encoding kind {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, L, d] → x + positions[:L] (``src/carca.py:25-31,54-60``)."""
        if self.kind == "learnable":
            return x + self.table[None, : x.shape[1], :]
        if self.kind == "positional":
            return x + self.pe[None, : x.shape[1], :]
        return x
