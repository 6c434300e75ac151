"""Train and eval steps over the ``(data, model)`` grid (counterpart of
``carca_tpu/parallel/step.py``), under the JAX package's names.

Each is the single-device step builder of ``train/loop.py`` in its
``mesh`` form, with the sharded lookup (``parallel.embedding``) where
``shard_embeddings`` row-shards the item and attrs tables over ``model``.
There the step is the one-device step's, as the JAX package's SPMD step
is, by two rules:

* **The loss is normalised over the global batch.** Each rank sums its
  numerator locally, all-reduces the denominator (Σmask, no gradient)
  over ``data`` and divides by it; the gradients are then **summed** over
  ``data``, in one flat buffer per dtype (``loop.apply_gradients``).
* **Batches are the single-device step's.** Every rank draws the global
  ``[B, …]`` batch (``assemble_train`` / ``assemble_eval``, negatives from
  the shared generator, or the same host batch) and keeps its slice, so
  the data ranks' slices together are the one-device batch, bit for bit,
  and the shared generators stay in step on every rank.

Dropout under more than one data rank: each step draws one seed from the
shared CPU generator and folds the data index into it
(``parallel.mesh.rank_generators``). Eval sums (HR, NDCG, the loss's
numerator and denominator) are all-reduced over ``data``
(``loop.eval_metrics``).

With ``sparse_items`` the device step trains the item table with the
row-sparse Adam (``loop._sparse_device_update``'s mesh form): the unique
rows and the sub-table are the global batch's, the sub-table's gradient is
summed over ``data`` and each model rank updates its block's rows; the
state is built by ``prepare_state_for_mesh(..., sparse_items=True)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.parallel.embedding import make_sharded_lookup
from carca_tpu_torch.parallel.mesh import Mesh
from carca_tpu_torch.parallel.sampling import device_sample_negatives, retries_for
from carca_tpu_torch.train.loop import (make_device_eval_step, make_device_train_step,
                                        make_eval_step, make_scanned_device_eval_step,
                                        make_scanned_device_train_step, make_train_step)
from carca_tpu_torch.train.state import TrainState


def _on(mesh: Mesh, shard_embeddings: bool) -> dict:
    """The step builders' mesh arguments: the sharded lookup where the
    tables are row-sharded, else None (the model's own gathers)."""
    sharded = shard_embeddings and mesh.n_model > 1
    return {"mesh": mesh, "lookup": make_sharded_lookup(mesh) if sharded else None}


def make_sharded_train_step(mc: ModelConfig, tc: Optional[TrainConfig], mesh: Mesh, *,
                            shard_embeddings: bool = False, device_negatives: bool = False,
                            logq: Optional[torch.Tensor] = None) -> Callable:
    """(state, attrs_table, global batch) → (state, loss), the host-pipeline
    step over the mesh. Every rank passes the same global batch and trains
    on its slice; ``attrs_table`` is this rank's block under
    ``shard_embeddings``. With ``device_negatives`` the batch's negative
    half is ignored: [B, L] negatives are drawn on the device each step
    from the shared generator over the global batch, rejected against the
    profile and the positives, and take the positives' contexts."""
    step = make_train_step(mc, tc, logq, **_on(mesh, shard_embeddings))
    if not device_negatives:
        return step
    L = mc.seq_len

    def train_step(state: TrainState, attrs_table, batch):
        visible = torch.cat([batch["p_x"], batch["o_x"][:, :L]], dim=1)
        o_neg = device_sample_negatives(state.generator, visible, mc.n_items, L,
                                        retries_for(visible.shape[1], mc.n_items))
        o_neg = torch.where(batch["p_x"] > 0, o_neg, 0)
        o_c_pos = batch["o_c"][:, :L]
        batch = dict(batch, o_x=torch.cat([batch["o_x"][:, :L], o_neg], dim=1),
                     o_c=torch.cat([o_c_pos, o_c_pos], dim=1))
        return step(state, attrs_table, batch)

    return train_step


def make_sharded_device_train_step(mc: ModelConfig, tc: Optional[TrainConfig], mesh: Mesh, *,
                                   shard_embeddings: bool = False, inner_steps: int = 1,
                                   reject_width: int = 0, neg_pop: bool = False,
                                   logq: Optional[torch.Tensor] = None,
                                   on_step: Optional[Callable[[TrainState], None]] = None,
                                   sparse_items: bool = False) -> Callable:
    """The device-pipeline step over the mesh: (state, attrs_table, catalog
    arrays, global user rows) → (state, loss). The catalog is replicated;
    every rank assembles the global batch from the shared generator (as
    ``make_device_train_step`` does) and trains on its slice. With
    ``inner_steps`` > 1 the rows are [K, B], the step returns the K
    losses and ``on_step(state)`` runs after each of them (the fit loop's
    EMA). ``sparse_items`` takes the row-sparse item Adam (the state must
    hold its row state)."""
    on = _on(mesh, shard_embeddings)
    if inner_steps > 1:
        return make_scanned_device_train_step(mc, inner_steps, tc, reject_width, neg_pop, logq,
                                              on_step, sparse_items, **on)
    if on_step is not None:
        raise ValueError("on_step runs inside a K-step call: it needs inner_steps > 1")
    return make_device_train_step(mc, tc, reject_width, neg_pop, logq, sparse_items, **on)


def make_sharded_eval_step(mc: ModelConfig, top_k: int, mesh: Mesh, *,
                           shard_embeddings: bool = False) -> Callable:
    """(model, attrs_table, global batch) → (hr_sum, ndcg_sum, loss) of the
    whole batch, the same on every rank."""
    return make_eval_step(mc, top_k, **_on(mesh, shard_embeddings))


def make_sharded_device_eval_step(mc: ModelConfig, top_k: int, mesh: Mesh, mode: str, *,
                                  shard_embeddings: bool = False, inner_steps: int = 1,
                                  reject_width: int = 0) -> Callable:
    """(model, attrs_table, catalog arrays, global user rows, generator) →
    (hr_sum, ndcg_sum, loss, n_valid) of the global batch, the batch
    assembled from ``generator`` as ``make_device_eval_step`` assembles it;
    with ``inner_steps`` > 1, [K, B] rows and length-K tensors."""
    on = _on(mesh, shard_embeddings)
    if inner_steps > 1:
        return make_scanned_device_eval_step(mc, top_k, mode, inner_steps, reject_width, **on)
    return make_device_eval_step(mc, top_k, mode, reject_width, **on)
