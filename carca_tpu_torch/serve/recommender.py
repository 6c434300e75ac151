"""Two-stage top-k recommender for online serving (counterpart of
``carca_tpu/serve/recommender.py``).

* **Stage 1 — retrieval.** The catalog is embedded once at load time with
  the item tower and kept on the device. Per request the profile tower
  encodes the history, and ``catalog_topk`` (kernel K3 on the GPU) streams
  the index against the last profile state; the [B, n_items] score matrix
  never exists. The user's visible history is excluded (over-retrieve
  k + L, filter, re-top-k).
* **Stage 2 — reranking.** For ``decoder="ca"`` the shortlist is rescored
  by the real decoder under the request context (eval semantics, no
  causal mask) — the encoder and decoder attention run kernel K1 on the
  GPU. For the dot-family decoders stage 1 is the decoder's eval math,
  so only the score mapping is applied.
* **Batch buckets.** Requests are padded up to the nearest of a few batch
  sizes, as in the JAX package (where each bucket is one compiled
  executable); padded rows are all-pad histories, whose outputs are cut.

Not ported yet: the index mesh (row-sharded index) and
``load_recommender`` (reading an orbax checkpoint) — both wait for later
slices (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from carca_tpu_torch.models.carca import CARCA, encode_profile, score_targets
from carca_tpu_torch.parallel.retrieval import (catalog_in_decoder_space,
                                                embed_catalog,
                                                query_from_encoded, stable_topk,
                                                topk_given_queries)

NEG_INF = float("-inf")


def pad_histories(
    histories: Sequence[Sequence[int]],
    seq_len: int,
    ctxs: Optional[Sequence[np.ndarray]] = None,
    n_ctx: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-align each history into a fixed [B, seq_len] window, keeping
    the most recent ``seq_len`` events (``src/data.py:112-124``); ``ctxs``
    are per-event context rows aligned with each history (missing →
    zeros). Returns (p_x int32, p_c float32)."""
    b = len(histories)
    p_x = np.zeros((b, seq_len), np.int32)
    p_c = np.zeros((b, seq_len, n_ctx), np.float32)
    for i, hist in enumerate(histories):
        tail = list(hist)[-seq_len:]
        if not tail:
            continue
        p_x[i, seq_len - len(tail):] = tail
        if ctxs is not None and ctxs[i] is not None:
            c = np.asarray(ctxs[i], np.float32)[-seq_len:]
            p_c[i, seq_len - len(tail):] = c
    return p_x, p_c


def _map_scores(raw: torch.Tensor, cfg) -> torch.Tensor:
    """Raw dot scores → the decoder's output range (src/carca.py:358-395)."""
    if cfg.decoder == "wdot" and cfg.l2_norm:
        return (raw + 1.0) / 2.0
    return torch.sigmoid(raw)


class Recommender:
    """Top-k recommendation over a fixed catalog, on the model's device.

    ``model``: a ``CARCA`` module (its weights and device are used as they
    are; it is put in eval mode). ``attrs_table``: [n_items, n_attrs] item
    attributes (row 0 = pad). ``shortlist``: stage-1 candidates fed to the
    reranker (``ca`` only). ``index_ids``: optional global ids to index
    (e.g. items with ≥1 event — the seen-items posture); stage 1 then
    embeds and streams only those rows. The int8 stage-1 index of the JAX
    package (``quantize``) comes with its kernel (ROADMAP slice 2).
    """

    def __init__(
        self,
        model: CARCA,
        attrs_table,
        *,
        shortlist: int = 512,
        exclude_history: bool = True,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
        default_ctx: Optional[np.ndarray] = None,
        index_ids: Optional[np.ndarray] = None,
    ):
        cfg = model.cfg
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.exclude_history = exclude_history
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.attrs = torch.as_tensor(np.asarray(attrs_table, np.float32),
                                     device=self.device)
        self.default_ctx = (np.zeros((cfg.n_ctx,), np.float32) if default_ctx is None
                            else np.asarray(default_ctx, np.float32))
        self.row_ids = None
        index_size = cfg.n_items
        if index_ids is not None:
            ids = np.asarray(index_ids, np.int64)
            ids = np.unique(ids[(ids > 0) & (ids < cfg.n_items)])
            self.row_ids = torch.as_tensor(np.concatenate([[0], ids]),
                                           device=self.device)
            index_size = len(ids)
        self.shortlist = min(shortlist, index_size)
        # real candidates only: the pad row can never be a recommendation
        self._index_rows = index_size if index_ids is not None else cfg.n_items - 1
        with torch.inference_mode():
            rows = self.attrs if self.row_ids is None else self.attrs[self.row_ids]
            e = catalog_in_decoder_space(
                embed_catalog(self.model, rows, global_ids=self.row_ids), cfg)
            self.catalog_emb = e.contiguous()
        self._rerank = cfg.decoder == "ca"

    def _bucket(self, b: int) -> int:
        for size in self.batch_buckets:
            if b <= size:
                return size
        return b  # oversized request: served at its exact size

    def _inputs(self, histories, ctxs, request_ctx, extra=None):
        """Pad a request to its bucket and move it to the device."""
        b = len(histories)
        bb = self._bucket(b)
        cfg = self.cfg
        p_x, p_c = pad_histories(histories, cfg.seq_len, ctxs, cfg.n_ctx)
        rc = self.default_ctx if request_ctx is None else np.asarray(request_ctx, np.float32)
        if bb != b:
            p_x = np.pad(p_x, ((0, bb - b), (0, 0)))
            p_c = np.pad(p_c, ((0, bb - b), (0, 0), (0, 0)))
            if extra is not None:
                extra = np.pad(extra, ((0, bb - b), (0, 0)))
        rc = (np.broadcast_to(rc, (bb, cfg.n_ctx)) if rc.ndim == 1
              else np.pad(rc, ((0, bb - b), (0, 0))))
        dev = self.device
        out = [torch.as_tensor(p_x, device=dev), torch.as_tensor(p_c, device=dev),
               torch.as_tensor(np.array(rc, np.float32), device=dev)]  # a writable copy
        if extra is not None:
            out.append(torch.as_tensor(extra, device=dev))
        return out

    def recommend(
        self,
        histories: Sequence[Sequence[int]],
        *,
        k: int = 10,
        ctxs: Optional[Sequence[np.ndarray]] = None,
        request_ctx: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (ids [B, k], scores [B, k]) for a batch of histories.
        ``ctxs``: per-event context rows aligned with each history;
        ``request_ctx``: [n_ctx] or [B, n_ctx] context the candidates are
        scored under (default ``default_ctx``)."""
        b = len(histories)
        if self._rerank and k > self.shortlist:
            raise ValueError(f"k={k} exceeds shortlist={self.shortlist}")
        if k > self._index_rows:
            raise ValueError(f"k={k} exceeds the stage-1 index ({self._index_rows})")
        p_x, p_c, rc = self._inputs(histories, ctxs, request_ctx)
        with torch.inference_mode():
            v, ids = self._recommend(p_x, p_c, rc, int(k))
        return ids[:b].cpu().numpy(), v[:b].cpu().numpy()

    def _recommend(self, p_x, p_c, req_ctx, k: int):
        cfg = self.cfg
        p_e, p_mask = encode_profile(self.model, (p_x, None, p_c),
                                     attrs_table=self.attrs)
        q = query_from_encoded(p_e, cfg).contiguous()
        n1 = self.shortlist if self._rerank else k
        sv, sids = topk_given_queries(
            q, self.catalog_emb, cfg, n1,
            exclude=p_x if self.exclude_history else None,
            in_decoder_space=True, row_ids=self.row_ids)
        if not self._rerank:
            # pad/exhausted slots stay -inf (sigmoid would fold them to 0.0)
            return torch.where(torch.isfinite(sv), _map_scores(sv, cfg),
                               torch.full_like(sv, NEG_INF)), sids
        o_c = req_ctx[:, None, :].expand(p_x.shape[0], n1, cfg.n_ctx)
        y = score_targets(self.model, p_e, p_mask, [(sids, None, o_c)],
                          attrs_table=self.attrs)
        y = torch.where(torch.isfinite(sv), y, torch.full_like(y, NEG_INF))
        v, sel = stable_topk(y, k)
        return v, torch.gather(sids, 1, sel)

    def score_candidates(
        self,
        histories: Sequence[Sequence[int]],
        candidates: np.ndarray,
        *,
        ctxs: Optional[Sequence[np.ndarray]] = None,
        request_ctx: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Decoder scores [B, N] for explicit candidate ids [B, N]."""
        b, n = candidates.shape
        p_x, p_c, rc, cand = self._inputs(histories, ctxs, request_ctx,
                                          np.asarray(candidates, np.int64))
        with torch.inference_mode():
            p_e, p_mask = encode_profile(self.model, (p_x, None, p_c),
                                         attrs_table=self.attrs)
            o_c = rc[:, None, :].expand(p_x.shape[0], n, self.cfg.n_ctx)
            y = score_targets(self.model, p_e, p_mask, [(cand, None, o_c)],
                              attrs_table=self.attrs)
        return y[:b].cpu().numpy()

    def warmup(self, k: int = 10) -> None:
        """Run every batch bucket once ahead of traffic (builds the kernels
        and warms the allocator)."""
        for bb in self.batch_buckets:
            self.recommend([[1]] * bb, k=k)
