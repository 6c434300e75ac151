"""Train state (counterpart of ``carca_tpu/train/state.py``): the model,
its optimizer, the run's generators and the step count, in one object.

``make_optimizer`` is ``torch.optim.Adam`` with the reference's settings
(``scripts/training.py:174``): betas (beta1, beta2), eps 1e-8 and classic
L2 (``weight_decay`` adds l2·p to the gradient before the moments), which
is what the JAX package builds as ``add_decayed_weights`` ahead of
``scale_by_adam``. The sinusoidal ``pe`` table is a buffer here, not a
parameter, so it needs no decay mask. On the card it is built
``capturable``, its lr a 0-dim float32 tensor on the device and its step
counts device tensors, so that the K-step call can be one CUDA graph
(``train/graph.py``); the card's eager steps run the same arithmetic. The
CPU keeps the plain Adam (``capturable`` is CUDA-only).

With ``sparse_items`` (``train/sparse_adam.py``) the Adam covers every
parameter but ``embed.items``, and the item table's row state (``munu``,
``count``) sits beside it in ``TrainState.items_state``: the JAX package's
``opt_state = {"dense", "items"}``. Over a mesh,
``parallel.mesh.prepare_state_for_mesh`` then rebuilds both for the
rank's block of a row-sharded table (``fit`` creates such a state dense
and lets that call build the block's row state).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.train import sparse_adam


@dataclass
class TrainState:
    """``generator`` lives on the model's device and draws the plain
    dropouts and the negatives; ``seed_generator`` lives on the CPU and
    draws each attention kernel's Philox seed, so no draw waits for the
    device. ``step`` counts optimizer updates on the host. ``items_state``
    is the row-sparse Adam's state of the item table, None when the dense
    Adam holds the table."""

    model: CARCA
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    seed_generator: torch.Generator
    schedule: Optional[Callable[[int], float]] = None
    step: int = 0
    items_state: Optional[Dict[str, object]] = None


def make_schedule(tc: TrainConfig) -> Optional[Callable[[int], float]]:
    """The learning rate as a function of the update count (None for a
    constant lr): ``optax.cosine_decay_schedule(lr, steps, alpha=rate)`` or
    ``optax.exponential_decay(lr, steps, rate)`` (``carca_tpu/train/
    state.py:46-58``)."""
    if tc.lr_schedule == "none" or tc.lr_decay_steps <= 0:
        return None
    lr, steps, rate = tc.lr, tc.lr_decay_steps, tc.lr_decay_rate
    if tc.lr_schedule == "cosine":
        def cosine(count: int) -> float:
            frac = min(count, steps) / steps
            return lr * ((1.0 - rate) * 0.5 * (1.0 + math.cos(math.pi * frac)) + rate)
        return cosine
    if tc.lr_schedule == "exponential":
        return lambda count: lr * rate ** (count / steps)
    raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")


def make_optimizer(tc: TrainConfig, params) -> torch.optim.Adam:
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if device.type != "cuda":
        return torch.optim.Adam(params, lr=tc.lr, betas=(tc.beta1, tc.beta2), eps=1e-8,
                                weight_decay=tc.l2_reg)
    lr = torch.tensor(tc.lr, dtype=torch.float32, device=device)
    opt = torch.optim.Adam(params, lr=lr, betas=(tc.beta1, tc.beta2), eps=1e-8,
                           weight_decay=tc.l2_reg, capturable=True)
    # its eager steps are meant (the graph's warm-up and the eager A/B): no warning
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def create_train_state(mc: ModelConfig, tc: TrainConfig,
                       device: torch.device | str | None = None,
                       model: Optional[CARCA] = None,
                       sparse_items: bool = False) -> TrainState:
    """Fresh weights from ``tc.seed``, unless ``model`` is given; fresh Adam
    moments (with ``sparse_items``, the item table's in a fresh row state
    instead); generators seeded from ``tc.seed``. ``device`` defaults to
    ``model``'s device, else the card. The weights are drawn on ``device``
    by a generator there, as the JAX package draws them on its device: on
    the card from the card's stream (the same weights for a seed on one
    kind of card; others than the CPU's), on the CPU from the CPU's."""
    if device is None:
        device = next(model.parameters()).device if model is not None else "cuda"
    device = torch.device(device)
    if model is None:
        model = CARCA(mc, generator=torch.Generator(device=device).manual_seed(tc.seed),
                      device=device)
    params = [p for n, p in model.named_parameters() if not (sparse_items and n == "embed.items")]
    return TrainState(
        model=model,
        optimizer=make_optimizer(tc, params),
        generator=torch.Generator(device=device).manual_seed(tc.seed + 1),
        seed_generator=torch.Generator().manual_seed(tc.seed + 2),
        schedule=make_schedule(tc),
        items_state=sparse_adam.init_state(model.embed.items.detach()) if sparse_items else None,
    )
