"""The train step (counterpart of ``carca_tpu/train/loop.py``, its step
functions only; ``fit`` and the eval steps wait for the eval slice).

Per step, as in the JAX package: assemble the batch on the device from a
[B] vector of user rows (``data/device_pipeline.assemble_train``), split the
target block into its groups, run the model in train mode with targets
[positives, negatives], take masked BCE over the whole candidate block
(``src/train.py:86-93``) or the sampled softmax, and apply one Adam update.

PyTorch runs eagerly, so there is no jit: a step function updates the
``TrainState`` in place and returns it with the loss, a device tensor that
is never read on the host inside the step. The JAX package's ``lax.scan``
over K steps per dispatch is a Python loop of K steps per call here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.data.device_pipeline import assemble_train
from carca_tpu_torch.models.carca import CARCA, carca_apply
from carca_tpu_torch.models.losses import masked_bce, sampled_softmax
from carca_tpu_torch.train.state import TrainState
from carca_tpu_torch.utils.masking import get_mask


def train_loss(model: CARCA, batch, attrs_table: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               seed_generator: Optional[torch.Generator] = None,
               loss_kind: str = "bce", logq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The train-time loss, shared by every step variant: the target-group
    split (group count from the batch width), the forward in the model's
    current mode, then the objective (``carca_tpu/train/loop.py:62-90``)."""
    L = model.cfg.seq_len
    o_x, o_c = batch["o_x"], batch["o_c"]
    n_groups = o_x.shape[1] // L
    targets = [(o_x[:, i * L:(i + 1) * L], None, o_c[:, i * L:(i + 1) * L])
               for i in range(n_groups)]
    y_pred = carca_apply(model, (batch["p_x"], None, batch["p_c"]), targets,
                         attrs_table=attrs_table, generator=generator,
                         seed_generator=seed_generator,
                         return_logits=loss_kind == "softmax")
    if loss_kind == "softmax":
        return sampled_softmax(y_pred, o_x, n_groups, logq=logq)
    return masked_bce(y_pred, batch["y_true"], get_mask(o_x))


def apply_gradients(state: TrainState, loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """Backward + one Adam update at the schedule's learning rate + the step
    count, shared by every step variant. Returns the detached loss."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    if state.schedule is not None:
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_device_train_step(mc: ModelConfig, tc: Optional[TrainConfig] = None,
                           reject_width: int = 0, neg_pop: bool = False,
                           sparse_items: bool = False,
                           logq: Optional[torch.Tensor] = None) -> Callable:
    """Train step with on-device batch assembly: (state, attrs_table,
    catalog arrays, user_rows [B]) → (state, loss). The state is updated in
    place."""
    if sparse_items:
        raise NotImplementedError(
            "the row-sparse item-table Adam is not ported yet (ROADMAP slice 6, "
            "10M-item training)")
    tc = tc or TrainConfig()
    n_neg = tc.n_train_negatives
    lq = logq if tc.loss == "softmax" else None

    def train_step(state: TrainState, attrs_table, arrays, user_rows):
        state.model.train()
        batch = assemble_train(arrays, mc.seq_len, mc.n_items, user_rows, state.generator,
                               reject_width, neg_pop, n_neg=n_neg)
        loss = apply_gradients(state, lambda: train_loss(
            state.model, batch, attrs_table, generator=state.generator,
            seed_generator=state.seed_generator, loss_kind=tc.loss, logq=lq))
        return state, loss

    return train_step


def make_scanned_device_train_step(mc: ModelConfig, inner_steps: int,
                                   tc: Optional[TrainConfig] = None,
                                   reject_width: int = 0, neg_pop: bool = False,
                                   sparse_items: bool = False,
                                   logq: Optional[torch.Tensor] = None) -> Callable:
    """``inner_steps`` train steps per call: (state, attrs_table, catalog
    arrays, user_rows [K, B]) → (state, losses [K], a device tensor). Each
    step is exactly ``make_device_train_step``'s, drawing from the same
    generators in the same order, so K steps in one call equal K single
    steps."""
    step = make_device_train_step(mc, tc, reject_width, neg_pop, sparse_items, logq)

    def scanned_step(state: TrainState, attrs_table, arrays, user_rows):
        if user_rows.shape[0] != inner_steps:
            raise ValueError(f"user_rows holds {user_rows.shape[0]} batches, "
                             f"the step takes {inner_steps}")
        losses = []
        for rows in user_rows:
            state, loss = step(state, attrs_table, arrays, rows)
            losses.append(loss)
        return state, torch.stack(losses)

    return scanned_step
