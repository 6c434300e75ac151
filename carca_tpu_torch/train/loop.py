"""The train and eval steps and the fit loop (counterpart of
``carca_tpu/train/loop.py``).

The protocol is the reference's (``src/train.py:56-152``): per epoch the
shuffled train batches, each split into its positive and negative target
groups, a forward in train mode, masked BCE over the whole candidate block
(or the sampled softmax) and one Adam update; then the val split (1
held-out positive + ``target_len`` sampled negatives per user, HR@k and
NDCG@k); the best-val-NDCG parameters kept, early stop after
``early_stop`` epochs without improvement, the best reloaded and the test
split run. Progress goes to stdout, to the CSV ``time;epoch;split;loss;HR;
NDCG`` and to ``metrics.jsonl``; the config to ``args.json``.

Batches come from the host (``BatchBuilder`` on a prefetch thread, with
the native C++ assembler unless ``use_native`` is off, staged to the device
per step) or, with ``device_pipeline``, are assembled on the
device from a [B] vector of user rows. A step function updates the
``TrainState`` in place and returns it with the loss, a device tensor that
is read on the host once per epoch. The JAX package's ``lax.scan`` over K
steps per dispatch is a Python loop of K steps per call. On one card every
train and eval step the JAX package jits (the retrieval evaluator's index
build and batches, and the KNN baseline's step, among them) is one CUDA
graph replay from its second call on (``train/graph.py``), its eager call
the ``graph=False`` twin; over a mesh the steps run eagerly.

Where ``sparse_adam.resolve`` says so (a device-pipeline run with an item
table of at least 1M rows), the device step updates the item table with
the lazy row-sparse Adam (``_sparse_device_update``). With
``eval_retrieval_every`` the fit ranks each val user's held-out item
against the whole catalog (``RetrievalEvaluator``) and logs
``retrieval_val_*``; ``select_by=retrieval_*`` retains the checkpoint on
that metric. ``evaluate_knn`` runs the KNN content baseline through the
sampled eval. With ``mesh_shape`` the fit runs on every rank of a
``torch.distributed`` group: the step builders' ``mesh`` form (named as
the JAX package's in ``parallel/step.py``) puts the batch over ``data``
and the tables, row-sharded, over ``model``, with either item-table Adam.
``device_sampling`` is read under a mesh only (the host pipeline's
negatives drawn on the device), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import time
from datetime import datetime
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.dataset import BatchBuilder, epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_eval, assemble_train
from carca_tpu_torch.data.device_pipeline import _profile_slots
from carca_tpu_torch.data.loaders import Catalog
from carca_tpu_torch.data.prefetch import prefetch
from carca_tpu_torch.models.carca import CARCA, carca_apply
from carca_tpu_torch.models.embeddings import ItemRows, Lookup
from carca_tpu_torch.models.knn import knn_apply
from carca_tpu_torch.models.losses import (Terms, masked_bce, masked_bce_terms, masked_mean,
                                           sampled_softmax_terms)
from carca_tpu_torch.ops.retrieval_topk import QuantizedIndex, quantize_index
from carca_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum, rank_generators,
                                           shard_batch, sum_gradients)
from carca_tpu_torch.parallel.retrieval import (catalog_in_decoder_space, embed_catalog,
                                                queries, retrieval_hr_ndcg, topk_given_queries)
from carca_tpu_torch.train import graph as step_graph
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.checkpoint import CheckpointKeeper, _selection_metric
from carca_tpu_torch.train.metrics import hr_ndcg_sums
from carca_tpu_torch.train.state import TrainState, create_train_state
from carca_tpu_torch.utils.masking import get_mask

TEST_SALT = 999_983  # the test eval's seed next to the run seed (the JAX package's)


def attrs_dtype(mc: ModelConfig) -> torch.dtype:
    """The device dtype of the attrs catalog: bf16 under bf16 compute, where
    the first layer rounds attr values to bf16 anyway (a bf16 table is
    value-identical and half the memory: 240 MB at 10M items), else f32."""
    return torch.bfloat16 if mc.compute_dtype == "bfloat16" else torch.float32


def train_loss(model: CARCA, batch, attrs_table: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               seed_generator: Optional[torch.Generator] = None,
               loss_kind: str = "bce", logq: Optional[torch.Tensor] = None,
               item_rows: Optional[ItemRows] = None) -> torch.Tensor:
    """The train-time loss, shared by every step variant: the target-group
    split (group count from the batch width), the forward in the model's
    current mode, then the objective (``carca_tpu/train/loop.py:62-90``).
    ``item_rows`` routes the item lookups (the row-sparse Adam's
    sub-table)."""
    return masked_mean(train_loss_terms(model, batch, attrs_table, generator=generator,
                                        seed_generator=seed_generator, loss_kind=loss_kind,
                                        logq=logq, item_rows=item_rows))


def train_loss_terms(model: CARCA, batch, attrs_table: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     seed_generator: Optional[torch.Generator] = None,
                     loss_kind: str = "bce", logq: Optional[torch.Tensor] = None,
                     item_rows: Optional[ItemRows] = None,
                     lookup: Optional[Lookup] = None) -> Terms:
    """``train_loss`` as (numerator, denominator, floor), the form a step
    over several data ranks normalises by the global denominator;
    ``lookup`` routes the item and attrs lookups (the row-sharded tables)."""
    L = model.cfg.seq_len
    o_x, o_c = batch["o_x"], batch["o_c"]
    n_groups = o_x.shape[1] // L
    targets = [(o_x[:, i * L:(i + 1) * L], None, o_c[:, i * L:(i + 1) * L])
               for i in range(n_groups)]
    y_pred = carca_apply(model, (batch["p_x"], None, batch["p_c"]), targets,
                         attrs_table=attrs_table, generator=generator,
                         seed_generator=seed_generator,
                         return_logits=loss_kind == "softmax", item_rows=item_rows,
                         lookup=lookup)
    if loss_kind == "softmax":
        return sampled_softmax_terms(y_pred, o_x, n_groups, logq=logq)
    return masked_bce_terms(y_pred, batch["y_true"], get_mask(o_x))


def apply_gradients(state: TrainState, terms_fn: Callable[[], Terms],
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Backward of the loss ``terms_fn()`` gives as (numerator, denominator,
    floor) + one Adam update at the schedule's learning rate + the step
    count, shared by every step variant. Returns the detached loss.

    Over a ``mesh`` the terms are this rank's data slice's, and the loss is
    the global batch's, as the JAX package's SPMD step has it: the
    denominator (no gradient) is all-reduced over ``data`` before the
    division and the gradients are summed over ``data`` (averaging
    per-rank means would be wrong whenever the data ranks hold different
    numbers of valid targets). Replicated parameters and table blocks
    alike: the model ranks of one data index see the same batch and agree.
    The returned loss is the same on every rank."""
    group = None if mesh is None else mesh.data_group
    state.optimizer.zero_grad(set_to_none=True)
    num, den, floor = terms_fn()
    if group is not None:
        den = all_reduce_sum(den.detach().clone(), group)
    loss = num / torch.clamp_min(den, floor)
    loss.backward()
    sum_gradients([p for g in state.optimizer.param_groups for p in g["params"]], group)
    _set_lr(state)
    state.optimizer.step()
    state.step += 1
    return all_reduce_sum(loss.detach().clone(), group)


def _set_lr(state: TrainState) -> None:
    """The schedule's learning rate of this update into Adam: a float on
    the CPU; on the card written into Adam's lr tensor (``fill_``), or under
    a ``train/graph.py`` capture copied from the call's lr slot, which each
    replay rewrites."""
    if state.schedule is None:
        return  # Adam keeps tc.lr
    groups = state.optimizer.param_groups
    cap = step_graph.capture_in_progress(groups[0]["params"][0].device)
    if cap is not None:
        slot = cap.lr()
        for g in groups:
            g["lr"].copy_(slot)
        return
    lr = state.schedule(state.step)
    for g in groups:
        if torch.is_tensor(g["lr"]):
            g["lr"].fill_(lr)
        else:
            g["lr"] = lr


def _dense_update(state: TrainState, tc: TrainConfig, batch, attrs_table: torch.Tensor,
                  logq: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None,
                  lookup: Optional[Lookup] = None) -> torch.Tensor:
    """One dense-Adam update on ``batch`` (over a ``mesh``, the global batch,
    of which this rank trains on its data slice), in place; ``lookup``
    routes the item and attrs lookups of row-sharded tables. Returns the
    detached loss."""
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    gen, sgen = rank_generators(state, mesh, state.model.cfg.dropout)
    return apply_gradients(state, lambda: train_loss_terms(
        state.model, batch, attrs_table, generator=gen, seed_generator=sgen,
        loss_kind=tc.loss, logq=logq, lookup=lookup), mesh)


def _sparse_device_update(tc: TrainConfig, state: TrainState, batch,
                          attrs_table: torch.Tensor,
                          logq: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None,
                          lookup: Optional[Lookup] = None) -> torch.Tensor:
    """One train update of a sparse-items state on ``batch``, in place
    (``carca_tpu/train/loop.py:166-205``): the loss is differentiated with
    respect to the gathered sub-table of the batch's unique ids, the dense
    Adam updates every other parameter, and the row-sparse Adam the touched
    rows of the item table. Returns the detached loss.

    Over a ``mesh`` ``batch`` is the global batch: its unique rows and the
    sub-table are the global batch's on every rank (a rank's slice alone
    would give each data rank other slots), gathered from the row-sharded
    block by ``lookup`` when it is given (the attrs lookups keep it); the
    rank's loss terms are its slice's, the sub-table's gradient is summed
    over ``data``, and each model rank updates the rows of its block."""
    items = state.model.embed.items
    uphys, valid, posmap = sparse_adam.touched_rows(batch, state.model.cfg.n_items)
    if lookup is None:
        sub, lo = items.detach()[uphys], 0
    else:  # the block's rows, all-reduced over model; no autograd (a detached block)
        sub, lo = lookup(items.detach(), uphys), mesh.m_idx * items.shape[0]
    sub.requires_grad_(True)  # the [cap, W] leaf the gradient reaches
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    gen, sgen = rank_generators(state, mesh, state.model.cfg.dropout)
    loss = apply_gradients(state, lambda: train_loss_terms(
        state.model, batch, attrs_table, generator=gen, seed_generator=sgen, loss_kind=tc.loss,
        logq=logq, item_rows=ItemRows(sub, posmap), lookup=lookup), mesh)
    g_rows = sub.grad
    if mesh is not None:
        all_reduce_sum(g_rows, mesh.data_group)
    rows = state.items_state
    cap = step_graph.capture_in_progress(items.device)
    if cap is not None:  # the call's slots, which each replay rewrites
        lr, c1, c2 = cap.row_scalars()
    else:  # host float32 values as device tensors (a fill each: no host sync)
        lr, c1, c2 = (torch.full((), float(v), dtype=torch.float32, device=items.device)
                      for v in sparse_adam.step_scalars(tc, rows["count"]))
    sparse_adam.apply_rows_update(items, rows, uphys, valid, g_rows, sub.detach(), lr=lr,
                                  b1=tc.beta1, b2=tc.beta2, weight_decay=tc.l2_reg, lo=lo,
                                  corrections=(c1, c2))
    return loss


def _graphed(graph: Optional[bool], mesh: Optional[Mesh]) -> bool:
    """Whether a step builder makes its step a CUDA graph (``train/graph.py``):
    ``graph`` None or True with no ``mesh``. True with a mesh raises: there
    the step is the eager call by construction, since gloo's collectives run
    on the host, outside any graph, and capturing NCCL's waits for a machine
    with a card per rank (ROADMAP A4). A graph step on a CPU state runs
    eagerly, or raises at its call when ``graph`` is True."""
    if graph and mesh is not None:
        raise ValueError("graph=True: a step over a mesh stays the eager loop (gloo's "
                         "collectives run on the host; NCCL's are not captured)")
    return graph is not False and mesh is None


def _eager(step: Callable) -> Callable:
    step.mode = "eager"
    return step


def _device_step(mc: ModelConfig, tc: TrainConfig, reject_width: int, neg_pop: bool,
                 logq: Optional[torch.Tensor], sparse_items: Optional[bool],
                 mesh: Optional[Mesh], lookup: Optional[Lookup]) -> Callable:
    """The eager one-step call of ``make_device_train_step``."""
    if sparse_items is None:
        sparse_items = mesh is None and sparse_adam.resolve(
            Config(mc, DataConfig(device_pipeline=True), tc))
    n_neg = tc.n_train_negatives
    lq = logq if tc.loss == "softmax" else None

    def train_step(state: TrainState, attrs_table, arrays, user_rows):
        if (state.items_state is not None) != sparse_items:
            raise ValueError(f"the step uses the {'sparse' if sparse_items else 'dense'} item-"
                             "table Adam, the state the other (create_train_state(sparse_items=))")
        state.model.train()
        user_rows = torch.as_tensor(user_rows, device=arrays["items"].device)
        batch = assemble_train(arrays, mc.seq_len, mc.n_items, user_rows, state.generator,
                               reject_width, neg_pop, n_neg=n_neg)
        if sparse_items:
            return state, _sparse_device_update(tc, state, batch, attrs_table, lq, mesh, lookup)
        return state, _dense_update(state, tc, batch, attrs_table, lq, mesh, lookup)

    return train_step


def make_device_train_step(mc: ModelConfig, tc: Optional[TrainConfig] = None,
                           reject_width: int = 0, neg_pop: bool = False,
                           logq: Optional[torch.Tensor] = None,
                           sparse_items: Optional[bool] = None, *,
                           mesh: Optional[Mesh] = None,
                           lookup: Optional[Lookup] = None,
                           on_step: Optional[Callable[[TrainState], None]] = None,
                           watch: Optional[Callable[[], list]] = None,
                           graph: Optional[bool] = None) -> Callable:
    """Train step with on-device batch assembly: (state, attrs_table,
    catalog arrays, user_rows [B] on the host or the device) → (state,
    loss). The state is updated in place; ``on_step(state)`` runs after the
    update (the fit loop's EMA), and ``watch()`` lists the tensors it
    updates in place. The item table takes the row-sparse Adam where
    ``sparse_items`` says so, by default where ``sparse_adam.resolve`` turns
    it on for (mc, tc) on the device pipeline; the state must be built the
    same way.

    ``graph`` None makes the call one CUDA graph on a CUDA state with no
    ``mesh`` (``train/graph.py`` at K = 1: the first call runs eagerly, the
    second captures, each later one is a replay equal to the eager call),
    the counterpart of the JAX package's jitted step; ``False`` is the eager
    call; ``True`` raises with a mesh, and on a CPU state at its call.

    Over a ``mesh`` every rank assembles the global batch from the shared
    generator (so the generators stay in step and the data slices together
    are the one-device batch, bit for bit) and trains on its slice
    (``apply_gradients``, or ``_sparse_device_update``'s mesh form);
    ``lookup`` routes the lookups of row-sharded tables. There
    ``sparse_items`` defaults to the dense Adam, as ``sparse_adam.resolve``
    decides "auto" under a mesh."""
    tc = tc or TrainConfig()
    graphed = _graphed(graph, mesh)
    step = _device_step(mc, tc, reject_width, neg_pop, logq, sparse_items, mesh, lookup)

    def one_step(state: TrainState, attrs_table, arrays, user_rows):
        state, loss = step(state, attrs_table, arrays, user_rows)
        if on_step is not None:
            on_step(state)
        return state, loss

    if not graphed:
        return _eager(one_step)
    return step_graph.GraphedStep(one_step, 1, tc, required=bool(graph), watch=watch,
                                  feed=step_graph.device_feed(None))


def make_scanned_device_train_step(mc: ModelConfig, inner_steps: int,
                                   tc: Optional[TrainConfig] = None,
                                   reject_width: int = 0, neg_pop: bool = False,
                                   logq: Optional[torch.Tensor] = None,
                                   on_step: Optional[Callable[[TrainState], None]] = None,
                                   sparse_items: Optional[bool] = None, *,
                                   mesh: Optional[Mesh] = None,
                                   lookup: Optional[Lookup] = None,
                                   graph: Optional[bool] = None,
                                   watch: Optional[Callable[[], list]] = None) -> Callable:
    """``inner_steps`` train steps per call: (state, attrs_table, catalog
    arrays, user_rows [K, B] on the host or the device) → (state, losses
    [K], a device tensor). Each step is exactly ``make_device_train_step``'s
    (``mesh`` and ``lookup`` as there), drawing from the same generators in
    the same order, so K steps in one call equal K single steps;
    ``on_step(state)`` runs after each (the fit loop's EMA), and ``watch()``
    lists the tensors it updates in place.

    ``graph`` as ``make_device_train_step`` takes it: None makes the call
    one CUDA graph on a CUDA state with no ``mesh``, the counterpart of the
    JAX package's jitted scan; ``False`` is the eager loop on any device."""
    graphed = _graphed(graph, mesh)
    tc = tc or TrainConfig()
    step = _device_step(mc, tc, reject_width, neg_pop, logq, sparse_items, mesh, lookup)

    def scanned_step(state: TrainState, attrs_table, arrays, user_rows):
        if user_rows.shape[0] != inner_steps:
            raise ValueError(f"user_rows holds {user_rows.shape[0]} batches, "
                             f"the step takes {inner_steps}")
        user_rows = user_rows.to(arrays["items"].device)
        losses = []
        for rows in user_rows:
            state, loss = step(state, attrs_table, arrays, rows)
            if on_step is not None:
                on_step(state)
            losses.append(loss)
        return state, torch.stack(losses)

    if not graphed:
        return _eager(scanned_step)
    return step_graph.GraphedStep(scanned_step, inner_steps, tc, required=bool(graph),
                                  watch=watch)


def make_train_step(mc: ModelConfig, tc: Optional[TrainConfig] = None,
                    logq: Optional[torch.Tensor] = None, *, mesh: Optional[Mesh] = None,
                    lookup: Optional[Lookup] = None,
                    on_step: Optional[Callable[[TrainState], None]] = None,
                    watch: Optional[Callable[[], list]] = None,
                    graph: Optional[bool] = None) -> Callable:
    """Train step over a host-assembled batch: (state, attrs_table, batch of
    ``BatchBuilder.train_batch``'s arrays, numpy or tensors) → (state,
    loss). The state is updated in place; ``on_step`` and ``watch`` as
    ``make_device_train_step`` takes them. It takes the dense Adam only: a
    row-sparse state raises. Over a ``mesh`` every rank passes the same
    global batch and trains on its data slice (``make_device_train_step``'s
    mesh form).

    ``graph`` as ``make_device_train_step`` takes it: None makes the step
    one CUDA graph on a CUDA state with no ``mesh``, the batch staged
    through the graph's pinned region (p_x, p_c, o_x, o_c, y_true), the
    counterpart of the JAX package's jitted step with the state donated;
    ``False`` is the eager step, which copies the batch with
    ``to_device``."""
    graphed = _graphed(graph, mesh)
    tc = tc or TrainConfig()
    lq = logq if tc.loss == "softmax" else None

    def train_step(state: TrainState, attrs_table, batch):
        if state.items_state is not None:
            raise ValueError("the host-pipeline step uses the dense item-table Adam; the "
                             "row-sparse Adam needs device_pipeline=true")
        state.model.train()
        batch = to_device(batch, attrs_table.device)
        loss = _dense_update(state, tc, batch, attrs_table, lq, mesh, lookup)
        if on_step is not None:
            on_step(state)
        return state, loss

    if not graphed:
        return _eager(train_step)
    return step_graph.GraphedStep(train_step, 1, tc, required=bool(graph), watch=watch,
                                  feed=step_graph.host_feed)


def eval_metrics(model: CARCA, top_k: int, batch, attrs_table: torch.Tensor, *,
                 mesh: Optional[Mesh] = None, lookup: Optional[Lookup] = None):
    """The eval computation every eval step shares: the forward on the [B,
    T+1] candidate block in the model's current mode, masked BCE, and the
    HR/NDCG sums over live rows (``src/train.py:35-53``). Returns (hr,
    ndcg, loss), 0-d device tensors. Over a ``mesh`` ``batch`` is the
    global batch: the rank evaluates its data slice, and the sums (HR,
    NDCG, the loss's numerator and denominator) are all-reduced over
    ``data``, so every rank returns the global batch's (the model ranks of
    one data index hold the same sums)."""
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    hr, ndcg, terms = eval_terms(model, top_k, batch, attrs_table, lookup)
    if mesh is None:
        return hr, ndcg, masked_mean(terms)
    num, den, floor = terms
    sums = all_reduce_sum(torch.stack([hr, ndcg, num, den]).to(torch.float32), mesh.data_group)
    return sums[0], sums[1], sums[2] / torch.clamp_min(sums[3], floor)


def eval_terms(model: CARCA, top_k: int, batch, attrs_table: torch.Tensor,
               lookup: Optional[Lookup] = None):
    """``eval_metrics`` with the loss as (numerator, denominator, floor):
    (hr, ndcg, terms). ``lookup`` routes the item and attrs lookups."""
    y_pred = carca_apply(model, (batch["p_x"], None, batch["p_c"]),
                         [(batch["o_x"], None, batch["o_c"])], attrs_table=attrs_table,
                         lookup=lookup)
    terms = masked_bce_terms(y_pred, batch["y_true"], get_mask(batch["o_x"]))
    row_mask = get_mask(batch["o_x"][:, 0])  # batch-padding rows
    hr, ndcg = hr_ndcg_sums(y_pred, batch["y_true"], top_k, row_mask)
    return hr, ndcg, terms


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module, decay: float) -> None:
    """One EMA step in place: shadow = d·shadow + (1−d)·params, parameter by
    parameter, with d and 1 − d rounded to float32 as the JAX package's
    ``ema_update`` has them."""
    d = np.float32(decay)
    shadow = list(ema.parameters())
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, torch._foreach_mul(list(model.parameters()),
                                                   float(np.float32(1.0) - d)))


def make_eval_step(mc: ModelConfig, top_k: int, *, mesh: Optional[Mesh] = None,
                   lookup: Optional[Lookup] = None, graph: Optional[bool] = None) -> Callable:
    """(model, attrs_table, batch of ``BatchBuilder.eval_batch``'s arrays,
    numpy or tensors, without ``n_valid``) → (hr_sum, ndcg_sum, loss), in
    eval mode (``mesh`` and ``lookup`` as ``eval_metrics`` takes them).
    ``graph`` as ``make_device_train_step`` takes it: None makes each call
    a CUDA graph replay on a CUDA model with no ``mesh``
    (``train/graph.py``'s ``GraphedEval``, the batch staged through its
    pinned region), ``False`` the eager call."""
    graphed = _graphed(graph, mesh)

    def eval_step(model: CARCA, attrs_table, batch):
        model.eval()
        batch = to_device(batch, attrs_table.device)
        with torch.inference_mode():
            return eval_metrics(model, top_k, batch, attrs_table, mesh=mesh, lookup=lookup)

    if not graphed:
        return _eager(eval_step)
    return step_graph.GraphedEval(eval_step, step_graph.host_feed, required=bool(graph))


def _device_eval(mc: ModelConfig, top_k: int, mode: str, reject_width: int,
                 mesh: Optional[Mesh], lookup: Optional[Lookup]) -> Callable:
    """The eager call of ``make_device_eval_step``."""

    def eval_step(model: CARCA, attrs_table, arrays, user_rows, generator):
        model.eval()
        user_rows = torch.as_tensor(user_rows, device=arrays["items"].device)
        with torch.inference_mode():
            batch = assemble_eval(arrays, mc.seq_len, mc.target_len, mc.n_items, mode,
                                  user_rows, generator, reject_width)
            hr, ndcg, loss = eval_metrics(model, top_k, batch, attrs_table, mesh=mesh,
                                          lookup=lookup)
        return hr, ndcg, loss, batch["n_valid"]

    return eval_step


def make_device_eval_step(mc: ModelConfig, top_k: int, mode: str, reject_width: int = 0, *,
                          mesh: Optional[Mesh] = None, lookup: Optional[Lookup] = None,
                          graph: Optional[bool] = None) -> Callable:
    """(model, attrs_table, catalog arrays, user_rows [B] on the host or the
    device, generator) → (hr_sum, ndcg_sum, loss, n_valid), the batch
    assembled on the device (over a ``mesh``, the global batch on every
    rank, of which each evaluates its slice: ``eval_metrics``). ``graph``
    as ``make_eval_step`` takes it; the graph registers ``generator``."""
    graphed = _graphed(graph, mesh)
    step = _device_eval(mc, top_k, mode, reject_width, mesh, lookup)
    if not graphed:
        return _eager(step)
    return step_graph.GraphedEval(step, step_graph.device_feed(None), required=bool(graph))


def make_scanned_device_eval_step(mc: ModelConfig, top_k: int, mode: str, inner_steps: int,
                                  reject_width: int = 0, *, mesh: Optional[Mesh] = None,
                                  lookup: Optional[Lookup] = None,
                                  graph: Optional[bool] = None) -> Callable:
    """``inner_steps`` eval batches per call: (model, attrs_table, arrays,
    user_rows [K, B], generator) → per-batch (hr, ndcg, loss, n_valid)
    tensors of length K, the generator drawn in the single steps' order.
    ``graph`` as ``make_eval_step`` takes it: None makes the call one CUDA
    graph replay, the counterpart of the JAX package's jitted scan."""
    graphed = _graphed(graph, mesh)
    step = _device_eval(mc, top_k, mode, reject_width, mesh, lookup)

    def scanned_eval(model, attrs_table, arrays, user_rows, generator):
        if user_rows.shape[0] != inner_steps:
            raise ValueError(f"user_rows holds {user_rows.shape[0]} batches, "
                             f"the step takes {inner_steps}")
        user_rows = torch.as_tensor(user_rows, device=arrays["items"].device)
        outs = [step(model, attrs_table, arrays, rows, generator) for rows in user_rows]
        return tuple(torch.stack(x) for x in zip(*outs))

    if not graphed:
        return _eager(scanned_eval)
    return step_graph.GraphedEval(scanned_eval, step_graph.device_feed(inner_steps),
                                  required=bool(graph))


def _totals(results) -> Tuple[float, float, float]:
    """(HR/total, NDCG/total, mean batch loss) of per-batch (hr, ndcg, loss,
    n_valid) tensors, read from the device once."""
    if not results:
        return 0.0, 0.0, 0.0
    cols = [torch.cat([r[i].reshape(-1).double() for r in results]) for i in range(4)]
    hr, ndcg, loss, n_valid = (c.cpu().numpy() for c in cols)
    total = int(n_valid.sum())
    if total == 0:
        return 0.0, 0.0, 0.0
    return float(hr.sum()) / total, float(ndcg.sum()) / total, float(loss.sum()) / len(loss)


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A host batch's numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def evaluate(eval_step: Callable, model: CARCA, attrs_table: torch.Tensor,
             builder: BatchBuilder, users: np.ndarray, batch_size: int,
             rng: np.random.Generator, mode: str) -> Tuple[float, float, float]:
    """Host-pipeline evaluator: (HR/total, NDCG/total, mean batch loss)
    (``src/train.py:35-53``); batches are built on a prefetch thread from
    ``rng`` and handed to ``eval_step`` as numpy arrays (an eager step
    copies them to ``attrs_table``'s device, a graph stages them)."""
    def produce():
        for rows in epoch_batches(users, batch_size, shuffle=False):
            b = builder.eval_batch(rows, rng, mode)
            yield b.pop("n_valid"), b

    results = []
    for n_valid, batch in prefetch(produce()):
        hr, ndcg, loss = eval_step(model, attrs_table, batch)
        results.append((hr, ndcg, loss, torch.tensor(int(n_valid))))
    return _totals(results)


def evaluate_device(eval_step: Callable, model: CARCA, attrs_table: torch.Tensor, arrays,
                    users: np.ndarray, batch_size: int, generator: torch.Generator,
                    scanned_step: Optional[Callable] = None,
                    inner_steps: int = 1) -> Tuple[float, float, float]:
    """Device-pipeline evaluator, the same protocol as ``evaluate``; with
    ``scanned_step``, whole [inner_steps, B] blocks go through one call (the
    generator is drawn in the same order either way)."""
    batches = list(epoch_batches(users, batch_size, shuffle=False))
    results = []
    i = 0
    if scanned_step is not None and inner_steps > 1:
        while i + inner_steps <= len(batches):  # rows on the host: the step moves or stages them
            block = torch.as_tensor(np.stack(batches[i:i + inner_steps]), dtype=torch.int64)
            results.append(scanned_step(model, attrs_table, arrays, block, generator))
            i += inner_steps
    for rows in batches[i:]:
        results.append(eval_step(model, attrs_table, arrays,
                                 torch.as_tensor(rows, dtype=torch.int64), generator))
    return _totals(results)


def eval_generator(seed: int, salt: int, device,
                   generator: Optional[torch.Generator] = None) -> torch.Generator:
    """The device pipeline's eval negatives for (run seed, epoch or test
    salt): a generator on ``device`` seeded from both; with ``generator``,
    that one re-seeded in place (``manual_seed``), which then draws what a
    new one would (an eval graph keeps the generator it registered)."""
    s = int(np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)[0])
    return (generator or torch.Generator(device=device)).manual_seed(s)


class RetrievalEvaluator:
    """Full-catalog leave-one-out retrieval on one device
    (``carca_tpu/train/loop.py:354-479``): ``evaluator(model)`` →
    ``{retrieval_{mode}_hr, retrieval_{mode}_ndcg}``. Everything that does
    not depend on the weights (the seen index's rows, the user batches) is
    built once, so per-epoch monitoring rebuilds only the index.

    ``seen_only`` indexes the items with at least one training event,
    counted over the actual train windows of the users the train split
    iterates (a held-out positive alone does not make an item seen; id 0
    is never indexed); else every id. The index is bf16 at 4M items and
    more unless ``quantized`` (which embeds in f32 and quantizes to int8),
    in decoder space once per build. A user's visible window is excluded
    from its top-k; dead rows never match. ``eval_subsample`` users are
    drawn from ``default_rng(seed)``. ``dd`` reuses a DeviceDataset already
    on ``device``. ``batch(..., use_kernel=False)`` scores one batch with
    the plain top-k on any device.

    ``graph`` as the eval step builders take it: None makes the index build
    (the JAX package's jitted ``embed_fn``, ``space_fn`` and ``quant_fn``)
    and each batch (its ``batch_metrics``: the queries, the top-k, the
    dead-row mask and the HR/NDCG sums) a CUDA graph replay on a CUDA model
    (``train/graph.py``'s ``GraphedEval``: a key's first call eager, its
    second the capture, later calls replays), ``False`` the eager calls,
    ``True`` raises on a CPU model. ``index()`` writes into the evaluator's
    own index tensors, the first build's, so the batch graph, keyed by
    them, the parameters, ``attrs``, ``row_ids`` and the batch's shape,
    keeps its key from one build to the next. ``batch()`` stays eager;
    ``batch_metrics()`` is the graphed batch."""

    def __init__(self, cfg: Config, catalog: Catalog, mode: str = "test",
                 k: Optional[int] = None, log: bool = True, seen_only: bool = True,
                 quantized: bool = False, device: torch.device | str = "cuda",
                 dd: Optional[DeviceDataset] = None, graph: Optional[bool] = None):
        mc, tc = cfg.model, cfg.train
        if mc.decoder == "ca":
            raise ValueError("full-catalog retrieval applies to the dot/wdot decoders; the "
                             "cross-attention decoder is a ranking model (see retrieval.py)")
        self.cfg, self.mode, self.log = cfg, mode, log
        self.k = k or tc.top_k
        self.quantized = quantized
        device = torch.device(device)
        if dd is None:
            dd = DeviceDataset(catalog, mc.seq_len, mc.target_len, test=tc.test, device=device)
        self.arrays = dd.arrays
        self.attrs = torch.as_tensor(catalog.attrs, dtype=torch.float32, device=device)
        # bf16 rows at multi-million-item scale halve the index (2.56 GB f32
        # at 10M, d=64); the int8 measurement embeds in f32, as serving does
        self.emb_dtype = (torch.bfloat16 if mc.n_items >= 4_000_000 and not quantized
                          else torch.float32)
        self.row_ids = None
        self.note = f"{mc.n_items} ids"
        if seen_only:
            self.row_ids = self._seen_rows(dd, mc.n_items)
            self.note = f"{len(self.row_ids) - 1}/{mc.n_items - 1} seen items"
        if quantized:
            self.note += ", int8"
        users = dd.users(mode)
        if len(users) > cfg.data.eval_subsample:
            users = np.random.default_rng(tc.seed).choice(users, cfg.data.eval_subsample,
                                                          replace=False)
        self.row_batches = [torch.as_tensor(rows, dtype=torch.int64, device=device)
                            for rows in epoch_batches(users, tc.batch_size, shuffle=False)]
        self._index: Optional[tuple] = None  # (rows,) or (qvals, scales), the first build's
        self._inputs: Dict[str, torch.Tensor] = {}  # what batch_metrics reads in place
        self._row_ids = {} if self.row_ids is None else {"row_ids": self.row_ids}
        if graph is False:
            self._build, self._metrics = self._build_eager, self._metrics_eager
        else:
            self._build = step_graph.GraphedEval(self._build_eager, step_graph.fixed_feed,
                                                 required=bool(graph))
            self._metrics = step_graph.GraphedEval(self._metrics_eager,
                                                   step_graph.device_feed(None),
                                                   required=bool(graph))

    @staticmethod
    def _seen_rows(dd: DeviceDataset, n_items: int) -> torch.Tensor:
        """[0] ‖ the ids with a training event, ascending."""
        arrays = dd.arrays
        dev = arrays["items"].device
        lengths = arrays["hist_len"]
        n_users = lengths.shape[0]
        user_of = torch.repeat_interleave(torch.arange(n_users, device=dev), lengths)
        pos_in_user = (torch.arange(user_of.shape[0], device=dev)
                       - torch.repeat_interleave(arrays["offsets"], lengths))
        trains = torch.zeros(n_users, dtype=torch.bool, device=dev)
        trains[torch.as_tensor(dd.users("train"), device=dev)] = True
        sel = (trains[user_of] & (pos_in_user >= arrays["start_train"][user_of])
               & (pos_in_user < arrays["end_train"][user_of]))
        counts = torch.bincount(arrays["items"].long()[sel], minlength=n_items)
        seen = torch.nonzero(counts[1:]).reshape(-1) + 1  # never the pad id
        return torch.cat([seen.new_zeros(1), seen])

    def _build_eager(self, model: CARCA, attrs: torch.Tensor, row_ids) -> tuple:
        """The eager index build: the first build's tensors (which become
        the evaluator's index), later builds copied into them. ``row_ids``
        ({} or {"row_ids": ...}) is passed for the graph's key alone."""
        model.eval()
        with torch.inference_mode():
            if self.row_ids is not None:
                attrs = attrs[self.row_ids]
            emb = catalog_in_decoder_space(
                embed_catalog(model, attrs, global_ids=self.row_ids, out_dtype=self.emb_dtype),
                model.cfg)
            built = tuple(quantize_index(emb)) if self.quantized else (emb.contiguous(),)
            if self._index is None:
                return built
            for dst, src in zip(self._index, built):
                dst.copy_(src)
        return ()

    def index(self, model: CARCA):
        """The index of ``model``'s item tower: decoder-space rows (int8 when
        ``quantized``), over the seen rows or every id, built into the
        evaluator's own index tensors (the same on every call)."""
        built = self._build(model, self.attrs, self._row_ids)
        if self._index is None:
            self._index = built
            self._inputs = dict(self.arrays, index=built[0], **self._row_ids)
            if self.quantized:
                self._inputs["scales"] = built[1]
        return QuantizedIndex(*self._index) if self.quantized else self._index[0]

    def batch(self, model: CARCA, emb, rows: torch.Tensor, use_kernel: bool = True):
        """One batch of user rows: (queries [B, d], top-k ids [B, k] (−1 on
        dead rows), held-out positives [B], alive [B])."""
        mc = model.cfg
        arrays = self.arrays
        model.eval()
        with torch.inference_mode():
            p_evt, valid, alive, e, off = _profile_slots(arrays, self.mode, rows, mc.seq_len)
            p_x = torch.where(valid, arrays["items"][p_evt], 0)
            p_c = arrays["ctx"][p_evt] * valid[..., None]
            pos = torch.where(alive, arrays["items"][torch.where(alive, off + e - 1, 0)], 0)
            q = queries(model, (p_x, None, p_c), self.attrs)
            _, ids = topk_given_queries(q, emb, mc, self.k, exclude=p_x, row_ids=self.row_ids,
                                        in_decoder_space=True, use_kernel=use_kernel)
            ids = torch.where(alive[:, None], ids, -1)  # dead rows never match
        return q, ids, pos.long(), alive

    def _metrics_eager(self, model: CARCA, attrs: torch.Tensor, inputs, rows: torch.Tensor):
        """``batch_metrics``' eager call over the index in ``inputs`` (the
        catalog arrays beside it)."""
        emb = inputs["index"] if not self.quantized else QuantizedIndex(inputs["index"],
                                                                        inputs["scales"])
        _, ids, pos, alive = self.batch(model, emb, rows)
        with torch.inference_mode():
            hr, ndcg = retrieval_hr_ndcg(ids, pos, self.k)
            return hr, ndcg, alive.sum().to(torch.float32), ids

    def batch_metrics(self, model: CARCA, rows: torch.Tensor) -> tuple:
        """One batch of user rows [B] on the device, over the index the last
        ``index()`` built: (HR sum, NDCG sum, live users), 0-dim device
        tensors, and the top-k ids [B, k] (−1 on dead rows)."""
        return self._metrics(model, self.attrs, self._inputs, rows)

    def __call__(self, model: CARCA) -> Dict[str, float]:
        self.index(model)
        sums = [torch.stack(self.batch_metrics(model, rows)[:3]) for rows in self.row_batches]
        hr = ndcg = 0.0
        total = 0
        for h, n, t in torch.stack(sums).cpu().tolist() if sums else []:
            hr, ndcg, total = hr + h, ndcg + n, total + int(t)
        m = self.mode
        out = {f"retrieval_{m}_hr": hr / max(total, 1), f"retrieval_{m}_ndcg": ndcg / max(total, 1)}
        if self.cfg.train.verbose and self.log:
            print(f"Retrieval@{self.k} ({m}, index: {self.note}): "
                  f"HR = {out[f'retrieval_{m}_hr']:.4f}, NDCG = {out[f'retrieval_{m}_ndcg']:.4f}")
        return out


def evaluate_retrieval(cfg: Config, catalog: Catalog, model: CARCA, mode: str = "test",
                       k: Optional[int] = None, log: bool = True, seen_only: bool = True,
                       quantized: bool = False, *, graph: Optional[bool] = None
                       ) -> Dict[str, float]:
    """Leave-one-out evaluation against the full catalog (BASELINE
    configs[4]; the reference's eval samples 100 negatives instead,
    ``src/data.py:140-192``), on ``model``'s device: each user's held-out
    item ranked among all items (the visible window excluded), HR@k and
    NDCG@k of its rank averaged. ``seen_only`` indexes the items with a
    training event (the serving posture; unseen items carry random
    embeddings), ``quantized`` scores the int8 serving index
    (``RetrievalEvaluator``, ``graph`` as it takes it: on a card the
    batches after the first are graph replays)."""
    device = next(model.parameters()).device
    return RetrievalEvaluator(cfg, catalog, mode=mode, k=k, log=log, seen_only=seen_only,
                              quantized=quantized, device=device, graph=graph)(model)


def make_knn_eval_step(top_k: int, *, graph: Optional[bool] = None) -> Callable:
    """Eval step of the KNN content baseline (``src/knn.py``), pluggable into
    ``evaluate`` as (model, attrs_table, batch) → (hr, ndcg, loss); the
    model is unused (None). The BCE loss takes the scores clipped into (0,
    1) (the reference feeds raw dot products to BCE, ``src/train.py:45``,
    which is NaN on negative dots); the ranking metrics use the raw scores.
    ``graph`` as ``make_eval_step`` takes it: None makes each call a CUDA
    graph replay when ``attrs_table`` lies on a card (the JAX package jits
    the step), keyed by the attrs table and the batch's shapes."""

    def eval_step(model, attrs_table, batch):
        batch = to_device(batch, attrs_table.device)
        with torch.inference_mode():
            y_pred = knn_apply((batch["p_x"], None, None), [(batch["o_x"], None, None)],
                               attrs_table=attrs_table)
            loss = masked_bce(y_pred.clamp(1e-7, 1.0 - 1e-7), batch["y_true"],
                              get_mask(batch["o_x"]))
            hr, ndcg = hr_ndcg_sums(y_pred, batch["y_true"], top_k,
                                    get_mask(batch["o_x"][:, 0]))
        return hr, ndcg, loss

    if graph is False:
        return _eager(eval_step)
    return step_graph.GraphedEval(eval_step, step_graph.host_feed, required=bool(graph))


def evaluate_knn(cfg: Config, catalog: Catalog, log: bool = True,
                 device: torch.device | str = "cuda", *,
                 graph: Optional[bool] = None) -> Dict[str, float]:
    """The KNN baseline through the shared eval harness (the reference pairs
    ``KNN()`` with the same ``evaluate``) on ``device``: val and test HR,
    NDCG and loss over host batches (``graph`` as ``make_knn_eval_step``
    takes it)."""
    mc, tc = cfg.model, cfg.train
    builder = BatchBuilder(catalog, mc.seq_len, mc.target_len, test=tc.test)
    attrs_table = torch.as_tensor(builder.cat.attrs, dtype=torch.float32, device=device)
    step = make_knn_eval_step(tc.top_k, graph=graph)
    rng = np.random.default_rng(tc.seed)
    host_root = np.random.default_rng(tc.seed)
    out: Dict[str, float] = {}
    for mode in ("val", "test"):
        users = builder.users(mode)
        if len(users) > cfg.data.eval_subsample:
            users = host_root.choice(users, cfg.data.eval_subsample, replace=False)
        hr, ndcg, loss = evaluate(step, None, attrs_table, builder, users, tc.batch_size, rng,
                                  mode)
        out.update({f"{mode}_hr": hr, f"{mode}_ndcg": ndcg, f"{mode}_loss": loss})
        if tc.verbose and log:
            print(f"KNN {mode}: HR = {hr:.4f}, NDCG = {ndcg:.4f}")
    return out


def uses_mesh(cfg: Config) -> bool:
    return bool(cfg.train.mesh_shape) and int(np.prod(cfg.train.mesh_shape)) > 1


def gather_model(model: CARCA, mesh, sharded: bool) -> Optional[CARCA]:
    """The whole model on rank 0 (None elsewhere): with ``sharded`` the
    item table's blocks are gathered on rank 0 (the ranks of data index 0
    take part) into a copy with the whole table, else rank 0's own model."""
    if not sharded:
        return model if mesh.rank == 0 else None
    from carca_tpu_torch.parallel.mesh import gather_rows_on_rank0

    block = model.embed.items.detach()
    items = gather_rows_on_rank0(block, mesh, model.cfg.n_items, block.device)
    if mesh.rank != 0:
        return None
    whole = CARCA(model.cfg, device=items.device)
    whole.load_state_dict(dict(model.state_dict(), **{"embed.items": items}))
    return whole.eval()


def fit(cfg: Config, catalog: Catalog, state: Optional[TrainState] = None,
        log: bool = True, device: torch.device | str = "cuda", *,
        graph: Optional[bool] = None) -> Tuple[TrainState, Dict[str, float]]:
    """Train per the reference protocol on ``device`` (the card unless the
    caller asks for the CPU), from ``state`` or fresh weights, and return
    the final state, holding the best (or under EMA the evaluated) weights,
    and the final metrics ``{val_*, test_*, epochs_run}``. Writes
    ``args.json`` and ``ckpt/`` under ``cfg.train.out_dir``, and with
    ``log`` the CSV, ``metrics.jsonl`` and stdout lines.

    With ``mesh_shape`` of more than one device, every rank of the process
    group (``parallel.mesh.initialize_distributed``) calls ``fit`` with the
    same arguments and its own ``device``: the batch is split over
    ``data`` and, with ``shard_embeddings``, the item and attrs tables are
    row-sharded over ``model`` (``parallel/step.py``). Rank 0 alone writes
    the logs, ``args.json`` and the checkpoints; every decision comes from
    metrics all-reduced over the ranks, so all ranks take the same
    branches. The retrieval monitor runs on rank 0 over the gathered
    tables, as the JAX package runs it on one device, and its two numbers
    are broadcast. The returned state holds this rank's blocks.

    ``graph`` goes to every step builder and to the retrieval monitor:
    None makes each train and eval step one CUDA graph replay on one card
    (the steps and the monitor over a mesh stay eager), ``False`` is the
    eager A/B twin, ``True`` requires the graphs. ``debug_nans`` runs
    eagerly: anomaly mode reads every gradient on the host.

    The checkpoint saves return after their host snapshot and write in the
    background (``train/checkpoint.py``); ``fit`` closes its keeper, so
    every write has ended, or raised, before it returns."""
    mc, tc, dc = cfg.model, cfg.train, cfg.data
    device = torch.device(device)
    mesh = None
    shard_emb = False
    if uses_mesh(cfg):
        from carca_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(tc.mesh_shape, tc.mesh_axes)
        if tc.batch_size % mesh.n_data:
            raise ValueError(f"batch_size {tc.batch_size} not divisible by the data-axis "
                             f"size {mesh.n_data}")
        shard_emb = tc.shard_embeddings and mesh.n_model > 1
        # the logs, args.json and the checkpoints are rank 0's
        log = log and mesh.rank == 0
    if tc.ema_decay and not 0.0 < tc.ema_decay < 1.0:
        raise ValueError(f"TrainConfig.ema_decay must be 0 (off) or in (0, 1), "
                         f"got {tc.ema_decay}")
    neg_pop = dc.neg_distribution == "popularity"
    if neg_pop and not dc.device_pipeline:
        raise ValueError("neg_distribution='popularity' draws from the event array on the "
                         "device: it requires device_pipeline=true")
    if tc.n_train_negatives > 1 and not dc.device_pipeline:
        raise ValueError("n_train_negatives > 1 draws negatives on the device: it requires "
                         "device_pipeline=true")
    os.makedirs(tc.out_dir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        cfg.dump_args_json(os.path.join(tc.out_dir, "args.json"))
    if tc.debug_nans:
        torch.autograd.set_detect_anomaly(True)
        graph = False

    dd = None
    if dc.device_pipeline:
        dd = DeviceDataset(catalog, mc.seq_len, mc.target_len, test=tc.test, device=device)
        builder = dd  # the users() source
    else:
        # the native assembler raises when it cannot be built: no fallback
        native = None
        if dc.use_native:
            from carca_tpu_torch.native import get_assembler
            native = get_assembler()
        builder = BatchBuilder(catalog, mc.seq_len, mc.target_len, test=tc.test, native=native)
        if tc.verbose and log:
            print(f"assembler: {'numpy' if native is None else 'native'}", flush=True)
    train_users = builder.users("train")
    host_root = np.random.default_rng(tc.seed)
    # val/test subsample, fixed once per run (scripts/training.py:154-157)
    val_users, test_users = builder.users("val"), builder.users("test")
    if len(val_users) > dc.eval_subsample:
        val_users = host_root.choice(val_users, dc.eval_subsample, replace=False)
    if len(test_users) > dc.eval_subsample:
        test_users = host_root.choice(test_users, dc.eval_subsample, replace=False)

    # the row-sparse item Adam: one decision, which a resumed checkpoint of
    # the other structure overrides below
    sparse_items = sparse_adam.resolve(cfg)
    if state is None:
        # a row-sharded table's row state is built for the block alone
        # (prepare_state_for_mesh), never for the whole table
        state = create_train_state(mc, tc, device,
                                   sparse_items=sparse_items and not shard_emb)
    elif (state.items_state is not None) != sparse_items:
        raise ValueError(f"the config resolves sparse_items_adam to {sparse_items}, the given "
                         "state was built the other way")
    attrs_table = torch.as_tensor(catalog.attrs, dtype=attrs_dtype(mc), device=device)
    if mesh is not None:
        from carca_tpu_torch.parallel.mesh import barrier, local_rows, prepare_state_for_mesh

        # before a restore, which then loads this rank's blocks
        state = prepare_state_for_mesh(state, mesh, shard_emb, sparse_items=sparse_items)
        if shard_emb:
            attrs_table = local_rows(attrs_table, mesh).contiguous()

    start_epoch = 1
    keeper = None
    if tc.checkpoint:
        ckpt_dir = os.path.join(tc.out_dir, "ckpt")
        if not tc.checkpoint_resume and os.path.isdir(ckpt_dir) and (mesh is None
                                                                     or mesh.rank == 0):
            # a fresh run: a stale best/ would be compared against and reloaded
            shutil.rmtree(ckpt_dir)
        if mesh is not None:
            barrier()
        keeper = CheckpointKeeper(ckpt_dir, select_by=tc.select_by, mesh=mesh,
                                  table_rows=mc.n_items if shard_emb else None)
    if tc.checkpoint_resume and keeper is not None:
        try:
            restored = keeper.restore_latest(state)
        except ValueError:
            # latest/ holds the other item-table optimizer ("auto" depends on
            # the batch size and the catalog, which may have changed): adopt
            # it, where the run's step can take it. The host step has no
            # row-sparse Adam, so a host run refuses a sparse latest/.
            if not dc.device_pipeline:
                raise
            state = create_train_state(mc, tc, device, model=state.model,
                                       sparse_items=not sparse_items)
            restored = keeper.restore_latest(state)
            sparse_items = not sparse_items
            if tc.verbose and log:
                print(f"note: resumed checkpoint uses {'sparse' if sparse_items else 'dense'} "
                      f"item-table Adam; adopting it over the configured setting")
        if restored is not None:
            start_epoch = restored + 1
    # the EMA shadow, seeded from the live weights after a restore; a resumed
    # run restores the shadow saved with latest/ (at latest/'s step)
    ema = None
    if tc.ema_decay:
        ema = copy.deepcopy(state.model).eval()
        for p in ema.parameters():
            p.requires_grad_(False)
        if keeper is not None and start_epoch > 1:
            keeper.restore_latest_ema(ema, state.step)

    def ema_after(st: TrainState) -> None:
        if ema is not None:
            ema_update(ema, st.model, tc.ema_decay)

    def ema_shadow() -> list:  # what ema_after updates in place, for the graphs' keys
        return [] if ema is None else list(ema.parameters())

    # device-pipeline negative rejection: the user's full history (the
    # reference's protocol) unless histories are long enough that the
    # all-pairs compare would dominate the step
    rw = 0
    logq = None
    if dd is not None:
        er = dc.exact_rejection
        if er is True or (er == "auto" and dd.hist_max <= 4 * mc.seq_len):
            rw = dd.hist_max
        elif tc.verbose and log:
            print(f"note: negative rejection uses the visible window only "
                  f"(hist_max={dd.hist_max} > 4x seq_len={mc.seq_len}, exact_rejection={er!r}); "
                  f"set exact_rejection=true for the reference's full-history protocol")
        if tc.loss == "softmax" and neg_pop:
            ev = dd.arrays["items"].long()
            counts = torch.bincount(ev, minlength=mc.n_items).to(torch.float32)
            logq = torch.log(counts.clamp_min(1.0)) - float(np.log(ev.shape[0]))
    on_mesh = {"mesh": mesh, "lookup": None}
    if shard_emb:
        from carca_tpu_torch.parallel.embedding import make_sharded_lookup

        on_mesh["lookup"] = make_sharded_lookup(mesh)
    # every step runs the EMA after its update (inside the graph, where the
    # step is one) and is a graph unless under a mesh or told otherwise
    on_ema = {"on_step": ema_after, "watch": ema_shadow, "graph": graph}
    if dd is not None:
        # over a mesh the catalog is replicated, every rank assembling the
        # global batch and training on its slice
        train_step = make_device_train_step(mc, tc, rw, neg_pop, logq=logq,
                                            sparse_items=sparse_items, **on_ema, **on_mesh)
        scanned_step = (make_scanned_device_train_step(
            mc, tc.inner_steps, tc, rw, neg_pop, logq=logq, sparse_items=sparse_items,
            **on_ema, **on_mesh) if tc.inner_steps > 1 else None)
        eval_steps = {m: make_device_eval_step(mc, tc.top_k, m, rw, graph=graph, **on_mesh)
                      for m in ("val", "test")}
        scanned_evals = {m: (make_scanned_device_eval_step(mc, tc.top_k, m, tc.inner_steps, rw,
                                                           graph=graph, **on_mesh)
                             if tc.inner_steps > 1 else None) for m in ("val", "test")}
        eval_gens: Dict[str, torch.Generator] = {}  # one per mode, re-seeded per epoch

        def eval_gen(mode: str, salt: int) -> torch.Generator:
            eval_gens[mode] = eval_generator(tc.seed, salt, device, eval_gens.get(mode))
            return eval_gens[mode]
    else:
        if mesh is not None:
            from carca_tpu_torch.parallel.step import make_sharded_train_step

            sharded_step = make_sharded_train_step(mc, tc, mesh, shard_embeddings=shard_emb,
                                                   device_negatives=dc.device_sampling)

            def train_step(st: TrainState, attrs, batch):
                st, loss = sharded_step(st, attrs, to_device(batch, device))
                ema_after(st)
                return st, loss
        else:
            train_step = make_train_step(mc, tc, **on_ema)
        eval_step = make_eval_step(mc, tc.top_k, graph=graph, **on_mesh)

    start = datetime.now()
    logpath = os.path.join(tc.out_dir, f"{start.year}-{start.month}-{start.day}T{start.hour}-"
                                       f"{start.minute}-{start.second}.csv")
    with contextlib.ExitStack() as files:
        logfile = files.enter_context(open(logpath, "a")) if log else None
        metrics_file = (files.enter_context(open(os.path.join(tc.out_dir, "metrics.jsonl"), "a"))
                        if log else None)

        def emit(line: str) -> None:
            if tc.verbose and log:
                print(line, flush=True)

        # per-epoch full-catalog retrieval on the val split, built once
        retrieval_eval = None
        if tc.eval_retrieval_every:
            if mc.decoder == "ca":
                if tc.select_by != "ndcg":
                    raise ValueError("select_by=retrieval_* needs a dot-family decoder (the ca "
                                     "decoder has no retrieval index)")
                emit("note: eval_retrieval_every applies to the dot/wdot decoders; skipping "
                     "retrieval monitoring")
            elif mesh is None or mesh.rank == 0:
                # under a mesh eager, as the mesh steps are: rank 0 evaluates a
                # model gathered anew each epoch, so no graph key would repeat
                retrieval_eval = RetrievalEvaluator(cfg, catalog, mode="val", log=False,
                                                    device=device, dd=dd,
                                                    graph=graph if mesh is None else False)
        monitoring = tc.eval_retrieval_every and mc.decoder != "ca"

        def monitor(model) -> Dict[str, float]:
            """The retrieval monitor: on rank 0 over the gathered tables
            under a mesh, its two numbers broadcast to every rank."""
            if mesh is None:
                return retrieval_eval(model)
            import torch.distributed as dist

            whole = gather_model(model, mesh, shard_emb)
            vals = torch.zeros(2, dtype=torch.float64, device=device)
            if whole is not None:
                m = retrieval_eval(whole)
                vals = torch.tensor([m["retrieval_val_hr"], m["retrieval_val_ndcg"]],
                                    dtype=torch.float64, device=device)
            dist.broadcast(vals, src=0)
            return {"retrieval_val_hr": float(vals[0]), "retrieval_val_ndcg": float(vals[1])}
        if tc.select_by != "ndcg" and not monitoring:
            raise ValueError(f"select_by={tc.select_by!r} selects on the monitored full-catalog "
                             "metric: set eval_retrieval_every >= 1")

        # retention resumes where latest/ left it (best/ may already hold a
        # later epoch of a killed run); else from best/, counting afresh
        progress = keeper.latest_progress() if keeper is not None else None
        resumed = progress is not None and progress["select_by"] == tc.select_by
        if resumed:
            best, no_improve = progress["best"], progress["no_improve"]
        else:
            best_m = keeper.best_metrics() if keeper is not None else None
            best = _selection_metric(best_m, tc.select_by) if best_m else 0.0
            no_improve = 0
        best_in_memory = -1  # the epoch whose improving save still matches the live state
        final: Dict[str, float] = {}
        epoch = start_epoch - 1
        # a resumed run whose latest/ was saved at its early stop stays stopped
        stopped = resumed and no_improve >= tc.early_stop
        if stopped:
            emit(f"No improvement in {no_improve} epochs, early stopping...")
        epochs = () if stopped else range(start_epoch, tc.epochs + 1)

        for epoch in epochs:
            ep_rng = np.random.default_rng([tc.seed, epoch])
            t0 = time.perf_counter()
            n_batches, n_examples = 0, 0
            losses = []  # device tensors; read once after the epoch
            vb = [0, 0.0]  # verbose=2: the reference's running mean per batch

            def note_batches(vals, _e=epoch) -> None:
                if tc.verbose < 2 or not log:
                    return
                for v in np.ravel(vals.detach().cpu().numpy()):
                    vb[0] += 1
                    vb[1] += float(v)
                    print(f"Epoch {_e:03d} Batch {vb[0]:04d}: Train Loss = {vb[1] / vb[0]:.4f}")

            profiler = None
            if (tc.profile and epoch == start_epoch + 1  # the second epoch: builds are done
                    and (mesh is None or mesh.rank == 0)):
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if device.type == "cuda" else [])
                profiler = profile(activities=acts)
                profiler.__enter__()
            if dd is not None:
                pending = []  # [K, B] blocks for the K-step call
                for rows in epoch_batches(train_users, tc.batch_size, ep_rng, shuffle=True):
                    n_batches += 1
                    n_examples += int((rows >= 0).sum())
                    if scanned_step is None:  # rows on the host: the step moves or stages them
                        state, loss = train_step(state, attrs_table, dd.arrays,
                                                 torch.as_tensor(rows, dtype=torch.int64))
                        losses.append(loss.reshape(1))
                        note_batches(loss)
                        continue
                    pending.append(rows)
                    if len(pending) == tc.inner_steps:  # rows on the host: the call stages them
                        state, k_losses = scanned_step(
                            state, attrs_table, dd.arrays,
                            torch.as_tensor(np.stack(pending), dtype=torch.int64))
                        losses.append(k_losses)
                        note_batches(k_losses)
                        pending = []
                for rows in pending:  # the remainder, one step per call
                    state, loss = train_step(state, attrs_table, dd.arrays,
                                             torch.as_tensor(rows, dtype=torch.int64))
                    losses.append(loss.reshape(1))
                    note_batches(loss)
            else:
                def produce():
                    for rows in epoch_batches(train_users, tc.batch_size, ep_rng, shuffle=True):
                        b = builder.train_batch(rows, ep_rng)
                        yield int(b.pop("n_valid")), b

                for n_valid, batch in prefetch(produce()):  # numpy: the step copies or stages it
                    state, loss = train_step(state, attrs_table, batch)
                    losses.append(loss.reshape(1))
                    note_batches(loss)
                    n_batches += 1
                    n_examples += n_valid
            sum_loss = float(torch.cat(losses).sum()) if losses else 0.0  # the device sync
            if profiler is not None:
                profiler.__exit__(None, None, None)
                os.makedirs(os.path.join(tc.out_dir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(os.path.join(tc.out_dir, "profile",
                                                          f"epoch{epoch:03d}.trace.json"))
            dt = time.perf_counter() - t0

            now = datetime.now().strftime("%H:%M:%S")
            train_loss_ = sum_loss / max(n_batches, 1)
            emit(f"{now} - Epoch {epoch:03d}: Train Loss = {train_loss_:.4f} "
                 f"({n_examples / max(dt, 1e-9):.0f} ex/s)")
            if logfile:
                logfile.write(f"{now};{epoch};train;{train_loss_};;\n")

            t1 = time.perf_counter()
            # under EMA every evaluation, retention and the test run on the shadow
            emodel = state.model if ema is None else ema
            if dd is not None:
                hr, ndcg, val_loss = evaluate_device(
                    eval_steps["val"], emodel, attrs_table, dd.arrays, val_users, tc.batch_size,
                    eval_gen("val", epoch), scanned_step=scanned_evals["val"],
                    inner_steps=tc.inner_steps)
            else:
                hr, ndcg, val_loss = evaluate(eval_step, emodel, attrs_table, builder, val_users,
                                              tc.batch_size, ep_rng, "val")
            dt_eval = time.perf_counter() - t1

            now = datetime.now().strftime("%H:%M:%S")
            emit(f"{now} - Epoch {epoch:03d}: Val Loss = {val_loss:.4f} "
                 f"HR = {hr:.4f}, NDCG = {ndcg:.4f}")
            if logfile:
                logfile.write(f"{now};{epoch};val;{val_loss};{hr};{ndcg}\n")
                logfile.flush()
            if metrics_file:
                metrics_file.write(json.dumps({
                    "epoch": epoch, "train_loss": train_loss_, "val_loss": val_loss,
                    "val_hr": hr, "val_ndcg": ndcg,
                    "examples_per_sec": n_examples / max(dt, 1e-9),
                    "candidates_per_sec": len(val_users) * (mc.target_len + 1) / max(dt_eval, 1e-9),
                    "epoch_seconds": dt}) + "\n")
                metrics_file.flush()
            final = {"val_hr": hr, "val_ndcg": ndcg, "val_loss": val_loss, "epochs_run": epoch}
            rmetrics = None
            if monitoring and epoch % tc.eval_retrieval_every == 0:
                t2 = time.perf_counter()
                rmetrics = monitor(emodel)
                now = datetime.now().strftime("%H:%M:%S")
                emit(f"{now} - Epoch {epoch:03d}: Retrieval@{tc.top_k} (val) "
                     f"HR = {rmetrics['retrieval_val_hr']:.4f}, "
                     f"NDCG = {rmetrics['retrieval_val_ndcg']:.4f} "
                     f"({time.perf_counter() - t2:.1f}s)")
                if metrics_file:
                    metrics_file.write(json.dumps({"epoch": epoch, **rmetrics}) + "\n")
                    metrics_file.flush()
                final.update(rmetrics)

            # retention on sampled NDCG, or with select_by=retrieval_* on the
            # monitored metric, decided on monitored epochs only
            if tc.select_by == "ndcg":
                candidate = ndcg
            else:
                candidate = (rmetrics[f"retrieval_val{tc.select_by[9:]}"]
                             if rmetrics is not None else None)
            if candidate is not None:
                if candidate > best:
                    best, no_improve = candidate, 0
                    best_in_memory = epoch
                    if keeper is not None:
                        m = {"ndcg": ndcg, "hr": hr, "epoch": epoch}
                        if tc.select_by != "ndcg":
                            m.update(select=candidate, select_by=tc.select_by, **rmetrics)
                        if ema is not None:
                            m["ema_decay"] = tc.ema_decay
                        keeper.save(epoch, emodel, m)  # best/ holds the evaluated weights
                else:
                    no_improve += 1
            # the resume point, on its cadence and at a run's first epoch
            if keeper is not None and (epoch % max(tc.checkpoint_interval, 1) == 0
                                       or epoch == start_epoch):
                keeper.save_latest(epoch, state, ema=ema, progress={
                    "best": best, "no_improve": no_improve, "select_by": tc.select_by})
            if no_improve >= tc.early_stop:
                emit(f"No improvement in {no_improve} epochs, early stopping...")
                break

        # the best weights for the test split (src/train.py:141-149), read
        # once best/'s write has ended; when the last epoch improved, the
        # live state already holds them
        if keeper is not None and best_in_memory != epoch:
            if keeper.restore_best(state.model) is None and ema is not None:
                state.model.load_state_dict(ema.state_dict())
        elif ema is not None:
            state.model.load_state_dict(ema.state_dict())
        if len(test_users) and tc.test:
            if dd is not None:
                hr, ndcg, test_loss = evaluate_device(
                    eval_steps["test"], state.model, attrs_table, dd.arrays, test_users,
                    tc.batch_size, eval_gen("test", TEST_SALT),
                    scanned_step=scanned_evals["test"], inner_steps=tc.inner_steps)
            else:
                hr, ndcg, test_loss = evaluate(eval_step, state.model, attrs_table, builder,
                                               test_users, tc.batch_size,
                                               np.random.default_rng([tc.seed, TEST_SALT]), "test")
            now = datetime.now().strftime("%H:%M:%S")
            emit(f"{now} - Epoch {epoch:03d}: Test Loss = {test_loss:.4f} "
                 f"HR = {hr:.4f}, NDCG = {ndcg:.4f}")
            if logfile:
                logfile.write(f"{now};{epoch};test;{test_loss};{hr};{ndcg}\n")
            final.update({"test_hr": hr, "test_ndcg": ndcg, "test_loss": test_loss})

    if keeper is not None:
        keeper.close()  # latest/'s last write may still be in flight
    return state, final
