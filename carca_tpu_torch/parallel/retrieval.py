"""Full-catalog retrieval (counterpart of ``carca_tpu/parallel/retrieval.py``).

The catalog is embedded once with the item tower (a query-independent
context, zeros by default: the two-tower approximation for ctx-fusing
embeddings), and queries are the dot decoder's eval query — the last
profile state (``src/carca.py:362``). ``topk_given_queries`` ranks an f32,
bf16 or int8 (``QuantizedIndex``) index through
``ops.retrieval_topk.catalog_topk`` (kernels K3 and K4 on CUDA tensors),
over-retrieving ``k + E`` when E history items are excluded;
``retrieval_hr_ndcg`` scores a held-out positive's rank in it.

Row-sharded over a mesh's ``model`` axis (``parallel/mesh.py``),
``topk_given_queries_sharded`` ranks a precomputed index of which each
model rank holds one block of rows (the serving index), and
``full_catalog_topk`` with a mesh embeds each rank's block of the catalog
itself. Each rank runs ``catalog_topk`` over its block with
``id_offset`` = the block's first global row; the ranks' [B, k'] lists are
all-gathered over ``model`` and merged with ``stable_topk`` in shard
order, so ties go to the lowest global id as on one device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models.carca import encode_profile
from carca_tpu_torch.models.embeddings import Lookup
from carca_tpu_torch.ops.retrieval_topk import (Index, QuantizedIndex, catalog_topk,
                                                catalog_topk_plain, stable_desc)
from carca_tpu_torch.parallel.embedding import make_sharded_lookup
from carca_tpu_torch.parallel.mesh import Mesh, all_gather

NEG_INF = float("-inf")


def embed_catalog(
    model,
    attrs_rows: torch.Tensor,
    ctx: Optional[torch.Tensor] = None,
    *,
    global_ids: Optional[torch.Tensor] = None,
    row_chunk: int = 1 << 20,
    out_dtype: torch.dtype = torch.float32,
    lookup: Optional[Lookup] = None,
) -> torch.Tensor:
    """Item-tower embeddings [R, d] of the rows ``attrs_rows`` [R, n_attrs]
    whose item ids are ``global_ids`` [R] (default ``arange(R)``), in
    ``out_dtype`` (bf16 makes a bf16 index). Id 0 and ids ≥ n_items embed
    to zero. No positional encoding (targets, ``src/carca.py:91-92``).
    Catalogs beyond ``row_chunk`` rows are embedded in slices, so the
    [R, g] hidden layer never exists whole. ``lookup`` routes the item
    table's gather (``embeddings.Embedding``)."""
    cfg = model.cfg
    r = attrs_rows.shape[0]
    dev = attrs_rows.device
    if global_ids is None:
        global_ids = torch.arange(r, device=dev)
    if ctx is None:
        ctx = torch.zeros(cfg.n_ctx, device=dev)
    out = []
    for s in range(0, r, row_chunk):
        a = attrs_rows[s:s + row_chunk]
        gid = global_ids[s:s + row_chunk].long()
        cc = ctx[None, :].expand(a.shape[0], cfg.n_ctx)
        mask = ((gid != 0) & (gid < cfg.n_items)).to(torch.float32)
        out.append(model.embed(gid[None], a[None], cc[None], mask[None], target=True,
                               lookup=lookup)[0].to(out_dtype))
    return out[0] if len(out) == 1 else torch.cat(out, 0)


def query_from_encoded(p_e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Encoded profile [B, L, d] → retrieval query [B, d]: the last state,
    with the wdot γ-scale (and cosine-mode normalisation) folded in."""
    q = p_e[:, -1, :]
    if cfg.decoder == "wdot":
        L = p_e.shape[1]
        scale = torch.cumsum(cfg.gamma ** torch.arange(L, dtype=torch.float32,
                                                       device=q.device), dim=0)[-1]
        q = q * scale
        if cfg.l2_norm:
            q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return q


def queries(model, profile, attrs_table: torch.Tensor,
            lookup: Optional[Lookup] = None) -> torch.Tensor:
    """Encode the profile (p_x, p_a, p_c) in the model's mode (eval for
    retrieval) and reduce it to the retrieval query [B, d]."""
    p_e, _ = encode_profile(model, profile, attrs_table=attrs_table, lookup=lookup)
    return query_from_encoded(p_e, model.cfg)


def catalog_in_decoder_space(e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Catalog embeddings → the space the decoder scores in (the wdot
    cosine mode normalises both sides, ``src/carca.py:381-391``)."""
    if cfg.decoder == "wdot" and cfg.l2_norm:
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return e


def stable_topk(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k largest along the last axis in
    ``lax.top_k``'s order (``retrieval_topk.stable_desc``: −0.0 below +0.0,
    ties to the lowest position; ``torch.topk`` leaves ties unspecified)."""
    pos = stable_desc(v, k)
    return torch.gather(v, -1, pos), pos


def filter_excluded(v: torch.Tensor, ids: torch.Tensor, exclude: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask retrieved ids found in ``exclude`` [B, E] (0 entries never
    match a real id) to −inf, then re-top-k down to ``k``."""
    hit = (ids[:, :, None] == exclude[:, None, :]).any(dim=-1)
    v = v.masked_fill(hit, NEG_INF)
    v, sel = stable_topk(v, k)
    return v, torch.gather(ids, 1, sel)


def topk_given_queries(
    q: torch.Tensor,
    e: Index,
    cfg: ModelConfig,
    k: int,
    *,
    exclude: Optional[torch.Tensor] = None,
    in_decoder_space: bool = False,
    row_ids: Optional[torch.Tensor] = None,
    method: str = "auto",
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of queries [B, d] against an index [R, d] (f32, bf16 or a
    ``QuantizedIndex``): (scores [B, k], item ids [B, k]). ``exclude``
    [B, E] masks ids per user. ``row_ids`` [R] makes ``e`` a compacted index
    whose row r holds item ``row_ids[r]`` (row 0 is the pad, id 0); returned
    ids are global. A ``QuantizedIndex`` is built from decoder-space rows
    (its scales bake the row geometry in), so it needs
    ``in_decoder_space=True``. ``use_kernel=False`` takes the plain version
    (``catalog_topk_plain``) on any device."""
    quantized = isinstance(e, QuantizedIndex)
    rows = e.rows if quantized else e.shape[0]
    if k > rows:
        raise ValueError(f"top-k k={k} exceeds the catalog size {rows}")
    if quantized and not in_decoder_space:
        raise ValueError("a QuantizedIndex is built from decoder-space embeddings; "
                         "pass in_decoder_space=True (see quantize_index)")
    if not in_decoder_space:
        e = catalog_in_decoder_space(e, cfg)
    n_local = rows if row_ids is not None else cfg.n_items
    kk = min(k + (exclude.shape[1] if exclude is not None else 0), rows)
    if use_kernel:
        v, rid = catalog_topk(q.contiguous(), e, kk, n_items=n_local, method=method)
    else:
        v, rid = catalog_topk_plain(q, e, kk, n_items=n_local)
    if row_ids is not None:
        rid = row_ids[rid]
    if exclude is None:  # then kk == k — nothing to re-rank
        return v, rid
    return filter_excluded(v, rid, exclude.long(), k)


def merge_shard_topk(vals: List[torch.Tensor], ids: List[torch.Tensor], kk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-``kk`` of the shards' (values, global ids) [B, k'] lists,
    concatenated in shard order: ties go to the lowest shard, and within a
    shard to the lowest id, as on one device."""
    fv, pos = stable_topk(torch.cat(vals, dim=1), kk)
    return fv, torch.gather(torch.cat(ids, dim=1), 1, pos)


def _shard_topk(q: torch.Tensor, e: Index, kk: int, n_true: int, lo: int, mesh: Mesh,
                use_kernel: bool, method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's top-k over its block (global rows ``lo ..``), merged over
    the model group. A shard holds at most its row count of winners, so
    clamping its k to that is exact."""
    rows = e.rows if isinstance(e, QuantizedIndex) else e.shape[0]
    k_local = min(kk, rows)
    if use_kernel:
        v, rid = catalog_topk(q.contiguous(), e, k_local, n_items=n_true, id_offset=lo,
                              method=method)
    else:
        v, rid = catalog_topk_plain(q, e, k_local, n_items=n_true, id_offset=lo)
    return merge_shard_topk(all_gather(v, mesh.model_group, mesh.n_model),
                            all_gather(rid, mesh.model_group, mesh.n_model), kk)


def topk_given_queries_sharded(
    q: torch.Tensor,
    e: Index,
    cfg: ModelConfig,
    k: int,
    mesh: Mesh,
    *,
    exclude: Optional[torch.Tensor] = None,
    row_ids: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_given_queries`` over an index row-sharded on the model axis
    (``carca_tpu/parallel/retrieval.py:332``): ``e`` is this rank's block
    [R_pad / n, d] (or a ``QuantizedIndex`` block) of decoder-space rows,
    R_pad a multiple of the model axis. The queries [B, d] are the same on
    every model rank. ``row_ids`` [R] maps index rows to item ids (row 0 =
    pad, as in ``topk_given_queries``); its length is the true row count,
    and rows beyond it (the sharding pad) are masked by global row, as the
    kernel masks its own pad rows. Without ``row_ids`` the true count is
    ``cfg.n_items``. Every model rank returns the same (scores [B, k], item
    ids [B, k])."""
    local = e.rows if isinstance(e, QuantizedIndex) else e.shape[0]
    rows = local * mesh.n_model
    n_true = row_ids.shape[0] if row_ids is not None else cfg.n_items
    if k > min(rows, n_true):
        raise ValueError(f"top-k k={k} exceeds the index size {min(rows, n_true)}")
    kk = min(k + (exclude.shape[1] if exclude is not None else 0), rows)
    fv, fi = _shard_topk(q, e, kk, n_true, mesh.m_idx * local, mesh, use_kernel, method)
    if row_ids is not None:
        fi = row_ids[fi]
    fi = torch.where(fv > NEG_INF, fi, 0)
    if exclude is None:
        return fv, fi
    return filter_excluded(fv, fi, exclude.long(), k)


def full_catalog_topk(
    model,
    profile,
    attrs_table: torch.Tensor,
    k: int,
    *,
    ctx: Optional[torch.Tensor] = None,
    exclude: Optional[torch.Tensor] = None,
    catalog_emb: Optional[Index] = None,
    method: str = "auto",
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items over the whole catalog: (scores [B, k], item ids [B, k]).
    ``exclude`` [B, E] removes ids per user (0 entries are no-ops).
    ``catalog_emb``: a precomputed ``embed_catalog`` output, or a
    ``QuantizedIndex`` (decoder space by construction), so that a sweep of
    many query batches embeds the catalog once (one device only).

    With a ``mesh`` whose model axis has more than one rank, the model's
    item table and ``attrs_table`` are this rank's row blocks of the padded
    tables (``mesh.local_rows``) and ``profile`` is this data rank's slice
    of the batch: the profile lookups go through the sharded lookup, each
    rank embeds its block of the catalog, and the blocks' top-k lists merge
    over ``model``."""
    cfg = model.cfg
    if mesh is None or mesh.n_model == 1:
        q = queries(model, profile, attrs_table)
        e = catalog_emb if catalog_emb is not None else embed_catalog(
            model, attrs_table, ctx,
            global_ids=torch.arange(attrs_table.shape[0], device=attrs_table.device))
        return topk_given_queries(q, e, cfg, k, exclude=exclude, method=method,
                                  in_decoder_space=isinstance(e, QuantizedIndex))
    q = queries(model, profile, attrs_table, lookup=make_sharded_lookup(mesh))
    rows = attrs_table.shape[0]
    lo = mesh.m_idx * rows
    gids = lo + torch.arange(rows, device=attrs_table.device)
    e = catalog_in_decoder_space(embed_catalog(
        model, attrs_table, ctx, global_ids=gids,
        lookup=lambda block, ids: torch.nn.functional.embedding(ids.long() - lo, block)), cfg)
    kk = min(k + (exclude.shape[1] if exclude is not None else 0), rows * mesh.n_model)
    fv, fi = _shard_topk(q, e, kk, cfg.n_items, lo, mesh, True, method)
    if exclude is None:
        return fv, fi
    return filter_excluded(fv, fi, exclude.long(), k)


def retrieval_hr_ndcg(topk_ids: torch.Tensor, positives: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch sums of HR@k and NDCG@k of each held-out positive's rank in
    its full-catalog top-k (the sampled evaluator's arithmetic,
    ``src/train.py:15-32``): 0-d float32 tensors."""
    hit = topk_ids[:, :k] == positives[:, None]  # [B, k]
    any_hit = hit.any(dim=1)
    hr = any_hit.to(torch.float32).sum()
    ranks = torch.argmax(hit.to(torch.int32), dim=1)  # the first (only) hit
    gain = 1.0 / torch.log2(ranks.to(torch.float32) + 2.0)
    return hr, torch.where(any_hit, gain, 0.0).sum()
