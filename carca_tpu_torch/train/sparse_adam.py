"""Lazy (row-sparse) Adam for the item table (counterpart of
``carca_tpu/train/sparse_adam.py``).

A train step touches at most 3·B·L item rows (38,400 at B = 256, L = 50)
of a table that may hold 10M, while a dense Adam reads and writes the whole
table and both moment tables every step. Here:

* the loss is differentiated with respect to a gathered ``[cap, W]``
  sub-table of the batch's unique ids (``cap = |p_x| + |o_x|``), which the
  model reads through each id's slot (``models/embeddings.ItemRows``), so
  no dense ``[R, W]`` gradient exists;
* the moments stay whole on the device as one interleaved ``[R, 2W]``
  tensor (mu ‖ nu); only the touched rows are gathered, updated and written
  back.

Semantics, as the JAX package's: for a row with zero moments (its first
touch) the update is Adam's; a row touched at steps t₁ and t₂ skips the
moment decay of the gap (the standard "lazy Adam"); bias correction uses
the row state's own count; classic L2 applies to touched rows only;
untouched rows and their moments stay bit-for-bit unchanged. The table is
never lane-packed here (pack = 1).

The unique ids come from a sort, a first-of-run mask and a cumsum, at the
static size ``cap`` (``torch.unique`` would sync with the host every step).
Slots past the unique count are fill slots (row 0, ``valid`` False). The
JAX package writes them out of range and drops them; torch's index writes
raise on an out-of-range index instead, so ``apply_rows_update`` points
every slot that writes nothing (a fill slot, or under a mesh a row of
another rank's block) at the row of the first slot that does write, with
that slot's value: duplicate indices then write identical bytes, in any
order. (Writing back what a fill slot read at row 0 races with row 0's own
write: harmless for the pad row, whose gradient is zero, but on the block
of model rank m > 0 local row 0 is a real item.)

Over a mesh (``parallel/mesh.py``) the rows are the global batch's, the
sub-table's gradient is summed over ``data``, and each model rank updates
the rows of its own block ``[lo, lo + n)`` with the block's moments
(``apply_rows_update(..., lo=)``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


def resolve(cfg) -> bool:
    """The sparse-items-Adam decision for a Config, as the JAX package takes
    it: forced on by ``sparse_items_adam=True`` (device pipeline and an item
    table required), or ``"auto"`` for a device-pipeline, one-device run
    with an item table of at least 1M rows at a batch of at most 1024."""
    tc, dc, mc = cfg.train, cfg.data, cfg.model
    has_table = mc.embedding in ("all", "id", "mlpid")
    if tc.sparse_items_adam is True:
        if not dc.device_pipeline:
            raise ValueError("sparse_items_adam requires device_pipeline=true")
        if not has_table:
            raise ValueError(
                f"sparse_items_adam needs an item table; embedding="
                f"{mc.embedding!r} has none (attr/attrctx are id-free)")
        return True
    return (tc.sparse_items_adam == "auto"
            and dc.device_pipeline
            and not (tc.mesh_shape and int(np.prod(tc.mesh_shape)) > 1)
            and has_table
            and mc.n_items >= 1_000_000
            and tc.batch_size <= 1024)


def touched_rows(batch: Dict[str, torch.Tensor], n_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(unique rows [cap], valid [cap], position map [n_rows]) of a train
    batch's profile and target ids, ``cap = |p_x| + |o_x|``. The unique
    rows ascend in slots ``0 .. U-1``; the fill slots ``U .. cap-1`` hold
    row 0 and ``valid`` is False there. ``posmap[id]`` is the slot of every
    id in the batch (0 elsewhere). No host sync."""
    ids = torch.cat([batch["p_x"].reshape(-1), batch["o_x"].reshape(-1)]).long()
    srt = torch.sort(ids).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    slot = torch.cumsum(first, 0) - 1  # the slot of each sorted id
    cap = ids.shape[0]
    # every id of a run writes its own value into its slot: no write races
    uphys = torch.zeros(cap, dtype=torch.int64, device=ids.device).scatter_(0, slot, srt)
    valid = torch.arange(cap, device=ids.device) <= slot[-1]
    posmap = torch.zeros(n_rows, dtype=torch.int64, device=ids.device).scatter_(0, srt, slot)
    return uphys, valid, posmap


def init_state(table: torch.Tensor) -> Dict[str, object]:
    """The row state of ``table`` (the whole table, or a model rank's block
    of it): moments interleaved in one ``[n, 2W]`` tensor (mu ‖ nu per row,
    one gather and one write per step) and the update count, a host int
    like ``TrainState.step``."""
    r, w = table.shape
    return {"munu": torch.zeros((r, 2 * w), dtype=table.dtype, device=table.device),
            "count": 0}


Scalar = Union[float, torch.Tensor]  # a host float, or a 0-dim float32 tensor on the table's device


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 − b1^count, 1 − b2^count) in float32, as the JAX package's
    ``scale_by_adam`` has them, for the update that brings the row state's
    count to ``count``."""
    c = np.float32(count)
    return (float(np.float32(1.0) - np.power(np.float32(b1), c)),
            float(np.float32(1.0) - np.power(np.float32(b2), c)))


@torch.no_grad()
def apply_rows_update(
    table: torch.Tensor,
    sstate: Dict[str, object],
    uphys: torch.Tensor,
    valid: torch.Tensor,
    g_rows: torch.Tensor,
    sub_rows: torch.Tensor,
    *,
    lr: Scalar,
    b1: float,
    b2: float,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    lo: int = 0,
    corrections: Optional[Tuple[Scalar, Scalar]] = None,
) -> None:
    """One Adam step restricted to rows ``uphys`` (global row ids; fill
    slots, ``valid`` False, change nothing), in place on ``table`` and
    ``sstate``: the elementwise arithmetic of optax's
    ``add_decayed_weights → scale_by_adam → scale(−lr)`` chain,
    bias-corrected by the row state's count (``corrections``, by default
    ``bias_corrections`` of the count after this update).

    ``lr`` and ``corrections`` may be 0-dim float32 tensors on the table's
    device, as the device step passes them (``loop._sparse_device_update``)
    so that a CUDA graph reads each replay's values from device memory. On
    the CPU they give the host floats' result bit for bit; on the card a
    host float divisor becomes a multiplication by its reciprocal, so the
    card's eager steps take the tensors too.

    ``table`` and ``sstate`` may be one block of the table, rows ``[lo, lo
    + n)`` with their ``[n, 2W]`` moments: only the slots whose row falls
    in the block update; every other slot changes nothing."""
    count = int(sstate["count"]) + 1
    c1, c2 = bias_corrections(b1, b2, count) if corrections is None else corrections
    munu_all = sstate["munu"]
    n = table.shape[0]
    if weight_decay:
        g_rows = g_rows + weight_decay * sub_rows
    w = g_rows.shape[-1]
    loc = uphys - lo
    keep = valid & (loc >= 0) & (loc < n)
    # a slot that writes nothing takes the first writing slot's row and
    # value (row 0 and what it holds when no slot writes), so no duplicate
    # index carries another value
    first = torch.argmax(keep.to(torch.int32))
    slot = torch.where(keep, torch.arange(keep.shape[0], device=keep.device), first)
    loc = torch.where(keep.any(), loc[slot], 0)  # keep[first], read with no host sync
    munu = munu_all[loc]
    mu = b1 * munu[:, :w] + (1.0 - b1) * g_rows[slot]
    nu = b2 * munu[:, w:] + (1.0 - b2) * torch.square(g_rows[slot])
    mu_hat = mu / c1
    nu_hat = nu / c2
    delta = (-lr) * mu_hat / (torch.sqrt(nu_hat) + eps)
    write = keep[slot][:, None]
    # a non-writing slot adds +0 to its row; the moments it writes are the
    # first writing slot's new ones (or row 0's own when none writes)
    table.index_add_(0, loc, torch.where(keep[:, None], delta, 0.0).to(table.dtype))
    munu_all.index_copy_(0, loc, torch.where(write, torch.cat([mu, nu], dim=-1), munu))
    sstate["count"] = count


def lr_at(tc, count: int) -> float:
    """The step's learning rate under TrainConfig's schedule (the same
    ``make_schedule`` the dense Adam uses), at the row state's count
    before its increment."""
    from carca_tpu_torch.train.state import make_schedule  # state.py imports this module

    sched = make_schedule(tc)
    return float(tc.lr) if sched is None else float(sched(count))


def step_scalars(tc, count: int) -> np.ndarray:
    """(lr, 1 − b1^(count+1), 1 − b2^(count+1)) as float32: the host values
    of the update that takes the row state from ``count`` to ``count`` + 1
    (``lr_at`` and ``bias_corrections``), which the device step passes as
    device tensors."""
    return np.array([lr_at(tc, count), *bias_corrections(tc.beta1, tc.beta2, count + 1)],
                    dtype=np.float32)
