"""Two-stage top-k recommender for online serving (counterpart of
``carca_tpu/serve/recommender.py``).

* **Stage 1 — retrieval.** The catalog is embedded once at load time with
  the item tower and kept on the device, as float32 or, with ``quantize``,
  as a per-row int8 ``QuantizedIndex``. Per request the profile tower
  encodes the history, and ``catalog_topk`` ranks the index against the
  last profile state: kernel K3 (stream) or K4 (tournament) on the GPU, as
  "auto" picks; the [B, n_items] score matrix never exists. The user's
  visible history is excluded (over-retrieve k + L, filter, re-top-k).
* **Stage 2 — reranking.** For ``decoder="ca"`` the shortlist is rescored
  by the real decoder under the request context (eval semantics, no
  causal mask) — the encoder and decoder attention run kernel K1 on the
  GPU. For the dot-family decoders stage 1 is the decoder's eval math,
  so only the score mapping is applied.
* **Batch buckets.** Requests are padded up to the nearest of a few batch
  sizes, as in the JAX package (where each bucket is one compiled
  executable); padded rows are all-pad histories, whose outputs are cut.
  On the card each bucket's call is one CUDA graph replay
  (``serve/graph.py``): one graph per (bucket, k) of ``recommend`` and per
  (bucket, n) of ``score_candidates``, the JAX package's jit keys,
  captured at a key's first call (``warmup`` captures every bucket).

``load_recommender`` restores a trained run directory (``args.json`` and
``ckpt/``, written by ``train/loop.fit``).

With a ``mesh`` (``parallel/mesh.py``, a ``model`` axis over N ranks,
each its own process) the stage-1 index is row-sharded: each rank embeds
and quantizes only its block of the padded rows, so the whole index never
exists on one rank (an index beyond one card's memory serves this way),
and stage 1 merges the ranks' top-k lists
(``parallel.retrieval.topk_given_queries_sharded``). The parameters and
the attrs table stay whole on every rank. Every rank must call
``recommend`` with the same requests, in lockstep
(``serve/service.py --index_shards``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.models.carca import CARCA, encode_profile, score_targets
from carca_tpu_torch.ops.retrieval_topk import quantize_index
from carca_tpu_torch.parallel.mesh import local_rows
from carca_tpu_torch.parallel.retrieval import (catalog_in_decoder_space,
                                                embed_catalog,
                                                query_from_encoded, stable_topk,
                                                topk_given_queries,
                                                topk_given_queries_sharded)
from carca_tpu_torch.serve.graph import GraphedServe

NEG_INF = float("-inf")
# quantize="auto" stores an index of this many rows or more as int8. It is
# the JAX package's rule (carca_tpu/serve/recommender.py:182-183) and is
# kept: it changes which answers come back, not only their speed.
QUANTIZE_AUTO_MIN_ROWS = 1_000_000


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
    attributes (row 0 = pad), numpy or a tensor on any device. ``shortlist``: stage-1 candidates fed to the
    reranker (``ca`` only). ``index_ids``: optional global ids to index
    (e.g. items with ≥1 event — the seen-items posture); stage 1 then
    embeds and streams only those rows. ``quantize``: ``True | False |
    "auto"``, store the stage-1 index as per-row symmetric int8
    (``quantize_index``), a quarter of the f32 scan; stage-1 scores become
    approximate and the ``ca`` reranker rescores the shortlist exactly.
    "auto" quantizes an index of ≥ ``QUANTIZE_AUTO_MIN_ROWS`` rows.
    ``mesh``: a ``parallel.mesh.Mesh`` whose model axis row-shards the
    stage-1 index (module docstring).

    ``graph``: ``None`` serves each bucket's call as one CUDA graph replay
    (``serve/graph.py``) on a CUDA model with no mesh, and eagerly
    otherwise; ``False`` is the eager call on any device (for A/B runs and
    parity checks); ``True`` raises on a CPU model or with a mesh. Two
    kinds of request run eagerly on the card even so, through the same
    kernels: one larger than the largest bucket, served at its exact size
    (a graph per size would pin a memory pool per size for good), and every
    request under a mesh (the stage-1 merge is a gloo all-gather, which
    runs on the host and cannot be captured; the card's machine has one
    GPU).
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
        quantize=False,
        mesh=None,
        graph: Optional[bool] = None,
    ):
        # identity checks: `1 in (True, False, "auto")` holds because 1 == True
        if not (quantize is True or quantize is False or quantize == "auto"):
            raise ValueError(f"quantize must be True/False/'auto', got {quantize!r}")
        cfg = model.cfg
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        if graph and mesh is not None:
            raise ValueError("graph=True: a Recommender over a mesh stays eager (its stage-1 "
                             "all-gather runs on the host and cannot be captured)")
        if graph and self.device.type != "cuda":
            raise ValueError("graph=True needs a CUDA model: a CUDA graph captures the card's "
                             f"work, and this model lies on {self.device}")
        self.exclude_history = exclude_history
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.attrs = torch.as_tensor(attrs_table, dtype=torch.float32, device=self.device)
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
        do_quant = quantize is True or (quantize == "auto"
                                        and index_size >= QUANTIZE_AUTO_MIN_ROWS)
        # real candidates only: the pad row can never be a recommendation
        self._index_rows = index_size if index_ids is not None else cfg.n_items - 1
        self.mesh = mesh if mesh is not None and mesh.n_model > 1 else None
        ids = self.row_ids
        if self.mesh is not None:
            # this rank's block of the rows, padded with id 0 (which embeds
            # to zero and lies past the true row count the top-k masks by)
            if ids is None:
                ids = torch.arange(cfg.n_items, device=self.device)
            ids = local_rows(ids, self.mesh)
        with torch.inference_mode():
            rows = self.attrs if ids is None else self.attrs[ids]
            e = catalog_in_decoder_space(embed_catalog(self.model, rows, global_ids=ids), cfg)
            self.catalog_emb = quantize_index(e) if do_quant else e.contiguous()
            del e
        self._rerank = cfg.decoder == "ca"
        self._graphs = (GraphedServe(self) if graph is not False and self.mesh is None
                        and self.device.type == "cuda" else None)

    @property
    def mode(self) -> str:
        """"graph" when bucket-sized calls replay CUDA graphs, else "eager"."""
        return "eager" if self._graphs is None else "graph"

    def _bucket(self, b: int) -> int:
        for size in self.batch_buckets:
            if b <= size:
                return size
        return b  # oversized request: served at its exact size

    def _padded(self, histories, ctxs, request_ctx, extra=None) -> list:
        """A request padded to its bucket: numpy (p_x, p_c, rc[, extra])."""
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
        out = [p_x, p_c, np.array(rc, np.float32)]  # a writable copy
        return out if extra is None else out + [extra]

    def _inputs(self, histories, ctxs, request_ctx, extra=None) -> list:
        """Pad a request to its bucket and move it to the device."""
        return [torch.as_tensor(a, device=self.device)
                for a in self._padded(histories, ctxs, request_ctx, extra)]

    def _graphed(self, bb: int) -> bool:
        return self._graphs is not None and bb in self.batch_buckets

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
        self.check_k(k)
        p_x, p_c, rc = self._padded(histories, ctxs, request_ctx)
        return self.recommend_padded(p_x, p_c, rc, len(histories), int(k))

    def check_k(self, k: int) -> None:
        if self._rerank and k > self.shortlist:
            raise ValueError(f"k={k} exceeds shortlist={self.shortlist}")
        if k > self._index_rows:
            raise ValueError(f"k={k} exceeds the stage-1 index ({self._index_rows})")

    def recommend_padded(self, p_x, p_c, rc, b: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``recommend`` of a request already padded to its bucket (numpy
        arrays as ``_padded`` gives them; under a mesh, ``Lockstep``'s
        tensors on this rank's device): the first ``b`` rows' (ids, scores).
        One graph replay at a bucket size, else eager."""
        if self._graphed(p_x.shape[0]):
            return self._graphs.recommend((p_x, p_c, rc), b, k)
        p_x, p_c, rc = (torch.as_tensor(a, device=self.device) for a in (p_x, p_c, rc))
        with torch.inference_mode():
            v, ids = self._recommend(p_x, p_c, rc, k)
        return ids[:b].cpu().numpy(), v[:b].cpu().numpy()

    def _recommend(self, p_x, p_c, req_ctx, k: int):
        cfg = self.cfg
        p_e, p_mask = encode_profile(self.model, (p_x, None, p_c),
                                     attrs_table=self.attrs)
        q = query_from_encoded(p_e, cfg).contiguous()
        n1 = self.shortlist if self._rerank else k
        exclude = p_x if self.exclude_history else None
        if self.mesh is not None:
            sv, sids = topk_given_queries_sharded(q, self.catalog_emb, cfg, n1, self.mesh,
                                                  exclude=exclude, row_ids=self.row_ids)
        else:
            sv, sids = topk_given_queries(q, self.catalog_emb, cfg, n1, exclude=exclude,
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
        """Decoder scores [B, N] for explicit candidate ids [B, N]: one graph
        replay per (bucket, N) at a bucket size, else eager."""
        b = candidates.shape[0]
        arrays = self._padded(histories, ctxs, request_ctx, np.asarray(candidates, np.int64))
        if self._graphed(arrays[0].shape[0]):
            return self._graphs.score(arrays, b)
        with torch.inference_mode():
            y = self._score(*(torch.as_tensor(a, device=self.device) for a in arrays))
        return y[:b].cpu().numpy()

    def _score(self, p_x, p_c, req_ctx, cand):
        p_e, p_mask = encode_profile(self.model, (p_x, None, p_c), attrs_table=self.attrs)
        o_c = req_ctx[:, None, :].expand(p_x.shape[0], cand.shape[1], self.cfg.n_ctx)
        return score_targets(self.model, p_e, p_mask, [(cand, None, o_c)],
                             attrs_table=self.attrs)

    def warmup(self, k: int = 10) -> None:
        """Run every batch bucket once ahead of traffic: builds the kernels
        and, on the card, captures each bucket's graph for ``k``, as the JAX
        package compiles each bucket."""
        for bb in self.batch_buckets:
            self.recommend([[1]] * bb, k=k)


# fields of a JAX run's args.json with no counterpart here: TPU-only knobs
_JAX_ONLY = ("pack_tables",)


def config_from_run_dir(run_dir: str) -> Config:
    """Rebuild the training Config from a run directory's flat
    ``args.json``: this package's, or the JAX package's (whose
    ``use_pallas`` maps to ``use_kernel``; ``pack_tables`` is dropped,
    ``remat`` kept)."""
    with open(os.path.join(run_dir, "args.json")) as fh:
        flat = json.load(fh)
    if "use_pallas" in flat:
        flat.setdefault("use_kernel", flat.pop("use_pallas"))
    for name in _JAX_ONLY:
        flat.pop(name, None)

    def pick(cls):
        kw = {f.name: flat[f.name] for f in dataclasses.fields(cls) if f.name in flat}
        # tuples come back from JSON as lists
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})

    return Config(model=pick(ModelConfig), data=pick(DataConfig), train=pick(TrainConfig))


def load_recommender(run_dir: str, attrs_table: np.ndarray, *, which: str = "best",
                     device: torch.device | str = "cuda", **kwargs) -> Recommender:
    """A Recommender over a trained run's weights (``{run_dir}/ckpt/best``
    or ``latest``) on ``device`` (the card unless the caller asks for the
    CPU). ``attrs_table`` is the item catalog the run trained against:
    checkpoints hold parameters, not data."""
    from carca_tpu_torch.train.checkpoint import CheckpointKeeper

    if which not in ("best", "latest"):
        raise ValueError(f"which is 'best' or 'latest', got {which!r}")
    cfg = config_from_run_dir(run_dir)
    model = CARCA(cfg.model, device=device)
    keeper = CheckpointKeeper(os.path.join(run_dir, "ckpt"))
    if which == "best":
        found = keeper.restore_best(model)
    else:
        found = keeper.restore_latest_model(model)
    if found is None:
        raise FileNotFoundError(f"no {which!r} checkpoint under {run_dir}/ckpt")
    return Recommender(model, attrs_table, **kwargs)
