"""Each serving call as one device dispatch: a CUDA graph per (bucket, k) of
``Recommender.recommend`` and per (bucket, n) of ``score_candidates``, the
counterpart of the JAX package's per-bucket jitted executables
(``carca_tpu/serve/recommender.py``: ``_compiled``, ``_score_compiled``,
``warmup``).

``GraphedServe`` wraps one Recommender's eager bodies on one card. Per key:

* the first call runs the eager body on a side stream (the warm-up: kernel
  builds and cuBLAS's and the allocator's lazy set-up happen there), then
  captures the body into a graph and replays it;
* every later call is one ``CUDAGraph.replay()`` and one wait.

A call reads its request from one static input region: p_x int32 [bb, L],
p_c float32 [bb, L, n_ctx], rc float32 [bb, n_ctx] (and the candidates
int64 [bb, n] of ``score_candidates``), sections of one byte buffer on the
card, each where a fresh tensor would start (``utils/staging.py``'s
``Region``), staged through a pinned host twin. It writes its answer to a static output region (ids
int64 [bb, k] and scores float32 [bb, k]; or scores [bb, n]) with a pinned
twin. The graph holds both copies: the inputs' H2D before the body, the
outputs' D2H after it. So a request is its host staging, one replay, one
wait and a read of pinned memory. That is sound because a call waits for
its replay before it returns: no call writes the pinned inputs while a
replay still reads them.

All of one Recommender's graphs share one memory pool
(``torch.cuda.graph_pool_handle``): the replays run one at a time on one
stream, and what a graph keeps between calls (its regions) lies outside
the pool. The graphs are keyed by the data pointers and shapes of all that
a replay reads in place: the model's parameters and buffers, the attrs
table, the index (``catalog_emb``, or a ``QuantizedIndex``'s ``qvals`` and
``scales``) and ``row_ids``. When any of them changes, every graph is
dropped and the next call captures anew.

A capture runs the Python once and launches nothing: the kernels' launch
counters (``ops/launches.py``) are put back after it and advanced at each
replay by what it counted. A capture that fails (a host sync in the body)
raises; there is no eager retry.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from carca_tpu_torch.ops import launches
from carca_tpu_torch.ops.retrieval_topk import QuantizedIndex
from carca_tpu_torch.utils import staging
from carca_tpu_torch.utils.staging import ALIGN, Region  # noqa: F401  (re-exported)

REQUEST = ("p_x", "p_c", "rc", "cand")  # a request's arrays, in the Recommender's order


def request_sections(bb: int, seq_len: int, n_ctx: int, n_cand: Optional[int] = None) -> list:
    """The input region's sections of a bucket-``bb`` request (with
    ``n_cand`` candidates per row for ``score_candidates``)."""
    out = [("p_x", torch.int32, (bb, seq_len)), ("p_c", torch.float32, (bb, seq_len, n_ctx)),
           ("rc", torch.float32, (bb, n_ctx))]
    return out + ([("cand", torch.int64, (bb, n_cand))] if n_cand is not None else [])


def stage(region: Region, arrays: Sequence[np.ndarray]) -> None:
    """Write a padded request (``REQUEST``'s numpy arrays) into the region's
    host twin."""
    for name, a in zip(REQUEST, arrays):
        region.np[name][...] = a


class _Entry:
    """One graph: its regions, the graph and the launches it makes."""

    def __init__(self, inputs: Region, outputs: Region):
        self.inputs, self.outputs = inputs, outputs
        self.graph = None
        self.launched = launches.Launches()


class GraphedServe:
    """One Recommender's serving calls as CUDA graph replays (see the
    module's docstring). ``rec._recommend`` and ``rec._score`` are the
    eager bodies; the Recommender decides which requests come here. It
    holds the Recommender weakly: a Recommender that goes frees its graphs
    and their pool at once."""

    def __init__(self, rec):
        self.rec = weakref.proxy(rec)
        self.device = rec.device
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None
        self.key = None
        self.entries: Dict[tuple, _Entry] = {}
        self.captures = 0
        self.replays = 0

    def recommend(self, arrays: Sequence, b: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [b, k], scores [b, k]) of a request padded to its bucket
        (p_x, p_c, rc), as ``Recommender.recommend_padded``."""
        out = self._call("recommend", arrays, k)
        return out["ids"][:b].copy(), out["scores"][:b].copy()

    def score(self, arrays: Sequence, b: int) -> np.ndarray:
        """Decoder scores [b, n] of a request padded to its bucket (p_x, p_c,
        rc, candidates [bb, n]), as ``Recommender.score_candidates``."""
        return self._call("score", arrays, arrays[3].shape[1])["scores"][:b].copy()

    def _call(self, kind: str, arrays: Sequence, size: int) -> Dict[str, np.ndarray]:
        key = self._tensors_key()
        if key != self.key:
            self.entries.clear()  # frees the graphs of replaced tensors, and then their pool
            self.pool, self.key = None, key
        bb = arrays[0].shape[0]
        entry = self.entries.get((kind, bb, size)) or self._entry(kind, bb, size)
        stage(entry.inputs, arrays)
        if entry.graph is None:
            self._capture(entry, kind, size)
            self.entries[kind, bb, size] = entry
        entry.graph.replay()
        self.replays += 1
        launches.add(entry.launched)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return entry.outputs.np

    def _tensors_key(self) -> tuple:
        rec = self.rec
        e = rec.catalog_emb
        tensors = [*rec.model.parameters(), *rec.model.buffers(), rec.attrs,
                   *(e if isinstance(e, QuantizedIndex) else [e])]
        if rec.row_ids is not None:
            tensors.append(rec.row_ids)
        return (rec.shortlist, rec.exclude_history,
                tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors))

    def _entry(self, kind: str, bb: int, size: int) -> _Entry:
        cfg = self.rec.cfg
        ins = request_sections(bb, cfg.seq_len, cfg.n_ctx, size if kind == "score" else None)
        outs = ([("ids", torch.int64, (bb, size))] if kind == "recommend" else [])
        outs.append(("scores", torch.float32, (bb, size)))
        return _Entry(Region(ins, self.device), Region(outs, self.device))

    def _body(self, entry: _Entry, kind: str, size: int) -> None:
        """The eager call on the regions: copy the request in, run the
        Recommender's body on the device views, copy the answer out."""
        rec, d, out = self.rec, entry.inputs.d, entry.outputs.d
        entry.inputs.dev.copy_(entry.inputs.host, non_blocking=True)
        with torch.inference_mode():
            if kind == "recommend":
                v, ids = rec._recommend(d["p_x"], d["p_c"], d["rc"], size)
                out["ids"].copy_(ids)
            else:
                v = rec._score(d["p_x"], d["p_c"], d["rc"], d["cand"])
            out["scores"].copy_(v)
        entry.outputs.host.copy_(entry.outputs.dev, non_blocking=True)

    def _capture(self, entry: _Entry, kind: str, size: int) -> None:
        body = functools.partial(self._body, entry, kind, size)
        self._warm_up(body)  # the eager call: its launches count as such
        before = launches.snapshot()
        try:
            graph = self._record(body)
            launched = launches.since(before)
        finally:
            launches.restore(before)  # the capture launched nothing
        entry.graph, entry.launched = graph, launched
        self.captures += 1

    def _warm_up(self, body) -> None:
        """Run ``body`` once on the side stream, outside any capture."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        staging.side_stream_call(self.stream, body)

    def _record(self, body) -> torch.cuda.CUDAGraph:
        """``body`` captured on the side stream into this Recommender's pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return staging.capture(body, self.stream, self.pool)[0]

    def pool_bytes(self) -> int:
        """Device bytes reserved by this Recommender's graph pool."""
        return staging.pool_bytes(self.pool)
