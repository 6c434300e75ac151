"""Device-resident dataset: batch assembly as index math on the card
(counterpart of ``carca_tpu/data/device_pipeline.py``).

The packed CSR catalog (items, contexts, offsets, leave-one-out window
bounds) lives in device memory once, and a train batch is assembled there
from a [B] vector of user rows — the only per-step host→device transfer.
Semantics follow the JAX package: the same window formulas and right
alignment, positives = the profile window shifted by one event, negatives
inheriting the positives' contexts (``src/data.py:112-130``), labels 1 on
valid positive slots. Negatives come from ``parallel.sampling`` on the
card, rejected against the visible window (``reject_width = 0``) or the
user's full history (``reject_width > 0``, the reference's protocol).

``assemble_eval`` builds the eval batch the same way: the held-out
positive and T negatives, rejected against the visible window and the
positive, or the user's full history with ``reject_width > 0``.

Items and contexts are two gathers; the JAX package's fused
``evt_packed`` gather exists only for the TPU's per-row gather cost and is
not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from carca_tpu_torch.data.loaders import Catalog
from carca_tpu_torch.data.windowing import valid_users, window_bounds
from carca_tpu_torch.parallel.sampling import device_sample_negatives, retries_for


class DeviceDataset:
    """The catalog and per-split window bounds as tensors on ``device``
    (the card unless the caller asks for the CPU). A catalog generated on
    the device is taken as it is."""

    def __init__(self, catalog: Catalog, seq_len: int, target_len: int,
                 test: bool = True, device: torch.device | str = "cuda"):
        self.L = int(seq_len)
        self.T = int(target_len)
        self.n_items = catalog.n_items
        self.n_ctx = catalog.n_ctx
        lengths = np.diff(catalog.offsets)
        self._users = {m: valid_users(lengths, self.L, m, test)
                       for m in ("train", "val", "test")}
        self.hist_max = int(lengths.max()) if len(lengths) else 0

        def put(a, dtype):  # a device catalog's tensors move without a host copy
            return torch.as_tensor(a, dtype=dtype, device=device)

        self.arrays: Dict[str, torch.Tensor] = {
            "items": put(catalog.items, torch.int32),
            "ctx": put(catalog.ctx_vals, torch.float32),
            "offsets": put(catalog.offsets[:-1], torch.int64),
            "hist_len": put(lengths, torch.int64),
        }
        for m in ("train", "val", "test"):
            s, e = window_bounds(lengths, self.L, m, test)
            self.arrays[f"start_{m}"] = put(s, torch.int64)
            self.arrays[f"end_{m}"] = put(e, torch.int64)

    def users(self, mode: str) -> np.ndarray:
        return self._users[mode]


def _window_slots(arrays, mode: str, user_rows: torch.Tensor, L: int, n_slots: int):
    """Right-aligned window event indices. ``n_slots`` = L gives the profile
    window; L+1 extends it by one slot so the final event (the shifted
    positives' last item) shares the same gather. Slot j covers event
    position ``e - L - 1 + j``."""
    rows = user_rows.long().clamp_min(0)
    s = arrays[f"start_{mode}"][rows]
    e = arrays[f"end_{mode}"][rows]
    off = arrays["offsets"][rows]
    alive = (user_rows >= 0) & (e > s)
    j = torch.arange(n_slots, device=user_rows.device)[None, :]
    pi = e[:, None] - L - 1 + j
    valid = (pi >= s[:, None]) & alive[:, None]
    p_evt = torch.where(valid, off[:, None] + pi, 0)
    return p_evt, valid, alive, e, off


def _profile_slots(arrays, mode: str, user_rows: torch.Tensor, L: int):
    return _window_slots(arrays, mode, user_rows, L, L)


def _history_rows(arrays, user_rows: torch.Tensor, H: int) -> torch.Tensor:
    """[B, H] of each user's full history item ids, 0-padded (H = the
    dataset's longest history)."""
    rows = user_rows.long().clamp_min(0)
    off = arrays["offsets"][rows]
    n = arrays["hist_len"][rows]
    j = torch.arange(H, device=user_rows.device)[None, :]
    valid = (j < n[:, None]) & (user_rows >= 0)[:, None]
    idx = torch.where(valid, off[:, None] + j, 0)
    return torch.where(valid, arrays["items"][idx], 0)


def assemble_train(arrays, L: int, n_items: int, user_rows: torch.Tensor,
                   generator: torch.Generator, reject_width: int = 0,
                   neg_pop: bool = False, n_neg: int = 1) -> Dict[str, torch.Tensor]:
    """[B] user rows (−1 = padding) → train batch, on ``user_rows``' device:
    p_x [B, L], p_c [B, L, C], o_x [B, (1+n_neg)L] = [positives ‖
    negatives], o_c (the positives' contexts, repeated per group), y_true
    [B, (1+n_neg)L] and n_valid. ``generator`` (on the same device) draws
    the negatives."""
    evt, validw, alive, _, _ = _window_slots(arrays, "train", user_rows, L, L + 1)
    w_x = torch.where(validw, arrays["items"][evt], 0)
    w_c = arrays["ctx"][evt] * validw[..., None]

    valid = validw[:, :L]
    p_x = w_x[:, :L]
    p_c = w_c[:, :L]
    # slot j's positive is window slot j+1, re-zeroed under the profile's
    # validity (slot L is valid whenever the user is alive)
    o_pos = torch.where(valid, w_x[:, 1:], 0)
    o_pos_c = w_c[:, 1:] * valid[..., None]

    reject = _history_rows(arrays, user_rows, reject_width) if reject_width > 0 else w_x
    negs = device_sample_negatives(
        generator, reject, n_items, n_neg * L,
        retries_for(reject.shape[1], n_items, popularity=neg_pop),
        events=arrays["items"] if neg_pop else None)
    o_neg = torch.where(valid.repeat(1, n_neg), negs, 0)

    o_x = torch.cat([o_pos, o_neg], dim=1)
    o_c = torch.cat([o_pos_c] * (1 + n_neg), dim=1)  # src/data.py:130
    y = torch.cat([valid.to(torch.float32),
                   torch.zeros(valid.shape[0], n_neg * L, device=valid.device)], dim=1)
    return {"p_x": p_x, "p_c": p_c, "o_x": o_x, "o_c": o_c, "y_true": y,
            "n_valid": alive.sum()}


def assemble_eval(arrays, L: int, T: int, n_items: int, mode: str, user_rows: torch.Tensor,
                  generator: torch.Generator, reject_width: int = 0) -> Dict[str, torch.Tensor]:
    """[B] user rows (−1 = padding) → eval batch on ``user_rows``' device:
    p_x [B, L], p_c [B, L, C], o_x [B, T+1] = [held-out positive ‖ T
    negatives], o_c (the positive's context on every live slot), y_true
    (1 at slot 0 of a live row) and n_valid. Negatives are distinct, never
    the positive, and miss the visible window, or with ``reject_width`` =
    the dataset's longest history, the user's whole history."""
    ctx, items = arrays["ctx"], arrays["items"]
    p_evt, valid, alive, e, off = _profile_slots(arrays, mode, user_rows, L)
    one_out = torch.where(alive, off + e - 1, 0)
    p_x = torch.where(valid, items[p_evt], 0)
    p_c = ctx[p_evt] * valid[..., None]
    pos = torch.where(alive, items[one_out], 0)
    pos_c = ctx[one_out] * alive[:, None]
    visible = (_history_rows(arrays, user_rows, reject_width) if reject_width > 0
               else torch.cat([p_x, pos[:, None]], dim=1))
    negs = device_sample_negatives(generator, visible, n_items, T,
                                   retries_for(visible.shape[1], n_items))
    negs = torch.where(alive[:, None], negs, 0)
    o_x = torch.cat([pos[:, None], negs], dim=1)
    o_c = pos_c[:, None, :].expand(pos.shape[0], T + 1, ctx.shape[1]) * (o_x > 0)[..., None]
    y = torch.zeros(pos.shape[0], T + 1, device=pos.device)
    y[:, 0] = alive.to(torch.float32)
    return {"p_x": p_x, "p_c": p_c, "o_x": o_x, "o_c": o_c, "y_true": y,
            "n_valid": alive.sum()}
