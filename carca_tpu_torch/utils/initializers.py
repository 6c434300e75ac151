"""Parameter initializers matching the reference's init scheme: Xavier
uniform weights, zero biases (``src/carca.py:77-83,220-226,291-295``).

Randomness comes only from the ``torch.Generator`` the caller passes, so a
seed gives the same weights on every run. The stream differs from JAX's
for the same seed; tests that compare the two packages load JAX weights
through ``carca_tpu_torch.bridge`` instead.
"""

from __future__ import annotations

import math

import torch


def xavier_uniform(shape, generator: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """Glorot uniform U(-a, a), a = gain·sqrt(6 / (shape[0] + shape[1])).

    Symmetric in the two fans, so the JAX [in, out] layout kept by the
    port's dense weights draws from the same distribution as torch's
    [out, in] ``nn.init.xavier_uniform_``.
    """
    a = gain * math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (2.0 * a) - a


def embedding_init(n: int, d: int, generator: torch.Generator, *,
                   zero_pad_row: bool) -> torch.Tensor:
    """Xavier-uniform [n, d] table; optionally zero row 0 (the pad),
    as ``nn.Embedding(..., padding_idx=0)`` does (``src/carca.py:73,77,81``)."""
    w = xavier_uniform((n, d), generator)
    if zero_pad_row:
        w[0] = 0.0
    return w
