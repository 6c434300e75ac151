"""Full-catalog retrieval on one device (counterpart of the single-device
part of ``carca_tpu/parallel/retrieval.py``).

The catalog is embedded once with the item tower (a query-independent
context, zeros by default: the two-tower approximation for ctx-fusing
embeddings), and queries are the dot decoder's eval query — the last
profile state (``src/carca.py:362``). ``topk_given_queries`` streams the
index through ``ops.retrieval_topk.catalog_topk`` (kernel K3 on a CUDA
tensor), over-retrieving ``k + E`` when E history items are excluded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.ops.retrieval_topk import catalog_topk

NEG_INF = float("-inf")


def embed_catalog(
    model,
    attrs_rows: torch.Tensor,
    ctx: Optional[torch.Tensor] = None,
    *,
    global_ids: Optional[torch.Tensor] = None,
    row_chunk: int = 1 << 20,
) -> torch.Tensor:
    """Item-tower embeddings [R, d] of the rows ``attrs_rows`` [R, n_attrs]
    whose item ids are ``global_ids`` [R] (default ``arange(R)``). Id 0 and
    ids ≥ n_items embed to zero. No positional encoding (targets,
    ``src/carca.py:91-92``). Catalogs beyond ``row_chunk`` rows are
    embedded in slices, so the [R, g] hidden layer never exists whole."""
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
        out.append(model.embed(gid[None], a[None], cc[None], mask[None],
                               target=True)[0])
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


def catalog_in_decoder_space(e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Catalog embeddings → the space the decoder scores in (the wdot
    cosine mode normalises both sides, ``src/carca.py:381-391``)."""
    if cfg.decoder == "wdot" and cfg.l2_norm:
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return e


def stable_topk(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k largest along the last axis, ties to
    the lowest position (``lax.top_k``'s order; ``torch.topk`` leaves it
    unspecified)."""
    vals, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


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
    e: torch.Tensor,
    cfg: ModelConfig,
    k: int,
    *,
    exclude: Optional[torch.Tensor] = None,
    in_decoder_space: bool = False,
    row_ids: Optional[torch.Tensor] = None,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of queries [B, d] against an f32 index [R, d]: (scores [B, k],
    item ids [B, k]). ``exclude`` [B, E] masks ids per user. ``row_ids``
    [R] makes ``e`` a compacted index whose row r holds item
    ``row_ids[r]`` (row 0 is the pad, id 0); returned ids are global."""
    rows = e.shape[0]
    if k > rows:
        raise ValueError(f"top-k k={k} exceeds the catalog size {rows}")
    if not in_decoder_space:
        e = catalog_in_decoder_space(e, cfg)
    n_local = rows if row_ids is not None else cfg.n_items
    kk = min(k + (exclude.shape[1] if exclude is not None else 0), rows)
    v, rid = catalog_topk(q, e, kk, n_items=n_local, method=method)
    if row_ids is not None:
        rid = row_ids[rid]
    if exclude is None:  # then kk == k — nothing to re-rank
        return v, rid
    return filter_excluded(v, rid, exclude.long(), k)
