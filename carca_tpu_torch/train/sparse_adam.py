"""The row-sparse item-table Adam's on/off decision (counterpart of
``carca_tpu/train/sparse_adam.py::resolve``). The lazy Adam itself is not
ported yet (ROADMAP slice 6): every caller raises where this says True."""

from __future__ import annotations

import numpy as np

SLICE_6 = ("the row-sparse item-table Adam is not ported yet (ROADMAP slice 6, "
           "10M-item training)")


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


def refuse_sparse(cfg) -> None:
    """Raise NotImplementedError when ``resolve`` turns the sparse Adam on."""
    if resolve(cfg):
        raise NotImplementedError(SLICE_6)
