"""Catalog scoring + top-k (counterpart of
``carca_tpu/ops/retrieval_topk.py``).

``catalog_topk`` ranks an f32, bf16 or int8 (``QuantizedIndex``) index by
one of two methods, each built on a hand-written kernel for CUDA tensors
and on that kernel's plain version for CPU tensors:

* ``"stream"``: kernel K3 (``csrc/catalog_topk.cu``), which replaces the
  TPU's streaming ``_kernel``; the [B, R] score matrix never reaches device
  memory. Plain version: ``catalog_topk_plain``.
* ``"tournament"``: kernel K4 (``csrc/groupmax.cu``, wrapper ``groupmax``)
  computes the maximum score of every 128-row group, replacing both
  ``_groupmax_kernel`` (layout 0, group-major [G, B]) and
  ``_groupmax_bq_kernel`` (layout 1, query-major [B, G]); plain version
  ``groupmax_plain``. Stage 2 keeps the k + 8 best groups (a stable sort:
  ties to the lowest group) and stage 3 rescores their rows in
  memory-bounded slices: plain tensor work, as in the JAX package. From
  ``_RECURSIVE_MIN_GROUPS`` groups stage 2 runs two levels over 128-group
  super-groups (layout 1).
* ``"auto"``: the tournament from ``_TOURNAMENT_MIN_ROWS`` rows on for
  k < 48 at a batch of ``_TOURNAMENT_MIN_BATCH`` or more, from
  ``_TOURNAMENT_MIN_ROWS_BIG_K`` rows otherwise; else the stream.

One arithmetic scores everywhere (``ordered_scores`` here,
``csrc/scoring.cuh`` in the kernels): against a bf16 or int8 index the
query is rounded to bf16 first (the JAX package's ``q.astype(cd)``); the
products are summed over d in index order, each product and each sum
rounded on its own; an int8 row's scale multiplies the sum, after it. The
kernels and the plain versions therefore agree bit for bit: K3's ids equal
the plain sort's even on near-ties, and K4's group maxima equal stage 3's
scores, which makes the tournament's containment argument exact, so
stream and tournament return the same ids and values.

Order: values descending, ties to the lowest id (``lax.top_k``'s order);
rows ≥ ``n_items`` and the pad id 0 score −inf; a −inf slot returns id 0.
The plain versions sort stably, never with ``torch.topk``, whose tie order
is unspecified.

Against the JAX package: its f32 paths and its tournament return the same
true f32 scores, to summation order. Its bf16/int8 stream packs a 12-bit
lane id into the low bits of every score's key, so its values are ≤ the
true scores and within 2⁻¹¹ of them relative, and its order among such
near-ties is unspecified (``carca_tpu/ops/retrieval_topk.py:156-159``).
The port's stream keeps full 64-bit (score, row) keys for every index
type: its values are the true f32 scores and its ids exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from carca_tpu_torch.ops import _build

NEG_INF = float("-inf")
MAX_K = 16_384  # the largest chunk whose keys a K3 block sorts in shared memory
GROUP = 128  # rows per tournament group
BIG_K = 48  # from this k on, "auto" takes the tournament from _TOURNAMENT_MIN_ROWS_BIG_K rows
# Stream/tournament crossover measured on the H100 (PERF.md, "crossover";
# carca_tpu_torch/bench_retrieval.py --sweep over B = 1/8/64/256). The
# stream's time grows with B x rows; the tournament's stage 3 with B x k,
# and at small B it is ~1-2 ms of launches. k < 48: from 1M rows the
# tournament is 4-10x faster at B >= 64, ties at B = 8, and at B = 1 is
# slower up to 2M rows. k >= 48: from 5M rows it wins at every B; at 2M
# only over an int8 index.
_TOURNAMENT_MIN_ROWS = 1_000_000
_TOURNAMENT_MIN_ROWS_BIG_K = 5_000_000
_TOURNAMENT_MIN_BATCH = 8
# Two-level stage 2 from this many groups on; off: at 10M rows it did not
# beat the flat stage 2 on the H100 (PERF.md).
_RECURSIVE_MIN_GROUPS = 1 << 62
_RERANK_SLICE_BYTES = 128 << 20  # gathered index rows per stage-3 slice
_SCORE_CHUNK = 1 << 26  # plain scores per row chunk (256 MB of float32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # carca::IndexType
INDEX_KINDS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


class QuantizedIndex(NamedTuple):
    """Symmetric per-row int8 index: row r is ``qvals[r] * scales[0, r]``.
    Build it with ``quantize_index`` after ``catalog_in_decoder_space``."""

    qvals: torch.Tensor   # [R, d] int8
    scales: torch.Tensor  # [1, R] float32

    @property
    def rows(self) -> int:
        return int(self.qvals.shape[0])


Index = Union[torch.Tensor, QuantizedIndex]


def quantize_index(e: torch.Tensor) -> QuantizedIndex:
    """[R, d] float → per-row symmetric int8 (max-abs scaling); an all-zero
    row gets scale 0 and scores exactly 0."""
    e = e.to(torch.float32)
    s = e.abs().amax(dim=1) / 127.0
    q = torch.where(s[:, None] > 0, torch.round(e / s.clamp_min(1e-30)[:, None]),
                    torch.zeros((), device=e.device))
    return QuantizedIndex(q.clamp(-127, 127).to(torch.int8), s[None, :])


def dequantize_index(qi: QuantizedIndex) -> torch.Tensor:
    """Exact float reconstruction of the quantized rows."""
    return qi.qvals.to(torch.float32) * qi.scales[0][:, None]


def _unpack(index: Index) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(rows [R, d], scales [1, R] or None), checked for a type the kernels
    take."""
    e, scales = (index.qvals, index.scales) if isinstance(index, QuantizedIndex) else (index, None)
    if e.dtype not in _DTYPE_CODE:
        raise TypeError(f"the index is float32, bfloat16 or a QuantizedIndex, got {e.dtype}")
    if (e.dtype == torch.int8) != (scales is not None):
        raise TypeError("an int8 index comes as a QuantizedIndex (int8 rows and their scales)")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (1, e.shape[0])):
        raise ValueError(f"int8 scales must be float32 [1, {e.shape[0]}], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    return e, scales


def query_operand(q: torch.Tensor, index_dtype: torch.dtype) -> torch.Tensor:
    """The query as the scoring operand against an index of ``index_dtype``:
    float32 against f32, rounded to bf16 (nearest even) against bf16 or
    int8, as the JAX package's kernels cast it."""
    q = q.to(torch.float32)
    if index_dtype == torch.float32:
        return q
    return q.to(torch.bfloat16).to(torch.float32)


def _ordered_dot(qo: torch.Tensor, rows_t: torch.Tensor) -> torch.Tensor:
    """Σ_j qo[:, j] · rows_t[j] in index order, each product and each sum
    rounded on its own. ``qo`` [B, d] float32; ``rows_t`` float32 [d, N]
    (rows shared by every query) or [d, B, N] (rows per query)."""
    s = torch.zeros(qo.shape[0], rows_t.shape[-1], dtype=torch.float32, device=qo.device)
    for j in range(qo.shape[1]):
        s.add_(qo[:, j, None] * rows_t[j])
    return s


def _score_chunks(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor]):
    """Yields (first row, [B, n] scores) over row chunks of a multiple of
    GROUP rows, each chunk's scores at most _SCORE_CHUNK floats."""
    qo = query_operand(q, e.dtype)
    step = max(GROUP, _SCORE_CHUNK // max(qo.shape[0], 1) // GROUP * GROUP)
    for r0 in range(0, e.shape[0], step):
        rows_t = e[r0:r0 + step].to(torch.float32).t().contiguous()  # [d, n]
        s = _ordered_dot(qo, rows_t)
        if scales is not None:
            s.mul_(scales[0, r0:r0 + step])
        yield r0, s


def ordered_scores(q: torch.Tensor, index: Index) -> torch.Tensor:
    """[B, R] float32 scores of queries [B, d] against ``index`` with the
    kernels' arithmetic exactly (module docstring)."""
    e, scales = _unpack(index)
    out = torch.empty(q.shape[0], e.shape[0], dtype=torch.float32, device=q.device)
    for r0, s in _score_chunks(q, e, scales):
        out[:, r0:r0 + s.shape[1]] = s
    return out


def _invalid(rows: torch.Tensor, lim0: int, mask_row0: bool) -> torch.Tensor:
    """Local rows that score −inf: ≥ lim0, and row 0 when it is the pad."""
    return (rows >= lim0) | ((rows == 0) & mask_row0)


def _window(r: int, n_items: Optional[int], id_offset: int) -> Tuple[int, bool]:
    """(lim0, mask_row0): the valid local rows are [0, lim0), and local row
    0 is the pad when the index starts at global id 0."""
    n_items = n_items if n_items is not None else id_offset + r
    return max(0, min(n_items - id_offset, r)), id_offset == 0


def _stable_desc(v: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the n largest along dim 1, ties to the lowest position."""
    return torch.sort(v, dim=1, descending=True, stable=True).indices[:, :n]


def _top_k(s: torch.Tensor, ids: torch.Tensor, k: int, id_offset: int):
    """The first k of a stable descending sort of s [B, N] (−inf-padded to
    k), with their ids [B, N] (+ id_offset; 0 in a −inf slot)."""
    if k > s.shape[1]:
        s = torch.cat([s, s.new_full((s.shape[0], k - s.shape[1]), NEG_INF)], dim=1)
        ids = torch.cat([ids, ids.new_zeros(ids.shape[0], k - ids.shape[1])], dim=1)
    sel = _stable_desc(s, k)
    v = torch.gather(s, 1, sel)
    return v, torch.where(v > NEG_INF, torch.gather(ids, 1, sel) + id_offset,
                          torch.zeros_like(sel))


def catalog_topk_plain(
    q: torch.Tensor,
    catalog_emb: Index,
    k: int,
    *,
    n_items: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``catalog_topk`` (either method): score every
    row, mask, and take the first k of a stable descending sort."""
    e, _ = _unpack(catalog_emb)
    r = e.shape[0]
    lim0, mask_row0 = _window(r, n_items, id_offset)
    s = ordered_scores(q, catalog_emb)
    rows = torch.arange(r, device=s.device)
    s = s.masked_fill(_invalid(rows, lim0, mask_row0)[None, :], NEG_INF)
    return _top_k(s, rows.expand(s.shape[0], r), k, id_offset)


def groupmax_plain(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                   lim0: int, mask_row0: bool, layout: int) -> torch.Tensor:
    """The plain version of ``groupmax``: [G, B] (layout 0) or [B, G']
    (layout 1, G' = G rounded up to a multiple of 128) maxima of the masked
    scores over each 128-row group, G = ⌈R / 128⌉; groups past the index
    are −inf."""
    if layout not in (0, 1):
        raise ValueError(f"layout is 0 ([G, B]) or 1 ([B, G]), got {layout}")
    b, r = q.shape[0], e.shape[0]
    g = -(-r // GROUP)
    n_groups = g if layout == 0 else -(-g // GROUP) * GROUP
    out = torch.full((b, n_groups), NEG_INF, dtype=torch.float32, device=q.device)
    for r0, s in _score_chunks(q, e, scales):
        n = s.shape[1]
        rows = torch.arange(r0, r0 + n, device=s.device)
        s = s.masked_fill(_invalid(rows, lim0, mask_row0)[None, :], NEG_INF)
        pad = -n % GROUP
        if pad:
            s = torch.cat([s, s.new_full((b, pad), NEG_INF)], dim=1)
        out[:, r0 // GROUP:(r0 + n + pad) // GROUP] = s.view(b, -1, GROUP).amax(dim=2)
    return out.t().contiguous() if layout == 0 else out


def _cuda_operands(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                   what: str) -> None:
    """Raise unless (q, e, scales) are what the kernels take."""
    if e.device != q.device or (scales is not None and scales.device != q.device):
        raise ValueError(f"{what}: index on {e.device}, queries on {q.device}")
    if q.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 queries, got {q.dtype}")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"{what}: queries {tuple(q.shape)} and index {tuple(e.shape)} "
                         f"must be [B, d] and [R, d]")
    if not (q.is_contiguous() and e.is_contiguous()
            and (scales is None or scales.is_contiguous())):
        raise ValueError(f"{what} takes contiguous queries and index")


def groupmax(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
             lim0: int, mask_row0: bool, layout: int) -> torch.Tensor:
    """Stage 1 of the tournament: kernel K4 on CUDA tensors, the plain
    version on CPU tensors. Same contract as ``groupmax_plain``."""
    if layout not in (0, 1):
        raise ValueError(f"layout is 0 ([G, B]) or 1 ([B, G]), got {layout}")
    if q.device.type == "cpu":
        return groupmax_plain(q, e, scales, lim0, mask_row0, layout)
    if q.device.type != "cuda":
        raise ValueError(f"groupmax runs on cpu or cuda tensors, got {q.device}")
    _cuda_operands(q, e, scales, "groupmax")
    b, d = q.shape
    r = e.shape[0]
    g = -(-r // GROUP)
    n_groups = g if layout == 0 else -(-g // GROUP) * GROUP
    out = torch.empty((n_groups, b) if layout == 0 else (b, n_groups), dtype=torch.float32,
                      device=q.device)
    if b == 0 or r == 0:
        return out.fill_(NEG_INF)
    lib = _build.library()
    smem = lib.carca_groupmax_smem_bytes(b, d)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"d={d} needs {smem} bytes of shared memory per block; "
                         f"the kernel holds at most {_build.SMEM_LIMIT}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.carca_groupmax(
            q.data_ptr(), e.data_ptr(), None if scales is None else scales.data_ptr(),
            out.data_ptr(), b, r, d, max(0, min(lim0, r)), int(mask_row0), n_groups, layout,
            _DTYPE_CODE[e.dtype], stream)
    _build.check(err, "groupmax")
    groupmax.launches[layout] += 1
    return out


# kernel launches by layout, for checks that a path ran K4
groupmax.launches = {0: 0, 1: 0}


def _tournament_topk(q, e, scales, k: int, lim0: int, mask_row0: bool, id_offset: int):
    """Top-k by group maxima (stage 1, ``groupmax``), the k + 8 best groups
    (stage 2) and an exact rescoring of their rows (stage 3). The union of
    the k best groups holds the true top-k: an element of it in an unpicked
    group would follow k group maxima in (value, lowest id) order. K4 and
    stage 3 score bit-identically, so the containment is exact; the 8 extra
    groups are the JAX package's margin for its two summation orders, kept
    so that both packages rerank the same groups."""
    b, d = q.shape
    r = e.shape[0]
    dev = q.device
    if b == 0 or r == 0:
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros(b, k, dtype=torch.int64, device=dev))
    offs = torch.arange(GROUP, device=dev)
    if -(-r // GROUP) >= _RECURSIVE_MIN_GROUPS:
        gmat = groupmax(q, e, scales, lim0, mask_row0, layout=1)  # [B, G'], query-major
        n_groups = gmat.shape[1]
        n2 = n_groups // GROUP
        # level 2: super-group maxima are maxima of the same level-1 values,
        # so the containment argument holds at each level as it stands
        gi2 = _stable_desc(gmat.view(b, n2, GROUP).amax(dim=2), min(k + 8, n2))
        cand = (gi2.sort(dim=1).values[:, :, None] * GROUP + offs).reshape(b, -1)
        sel = _stable_desc(torch.gather(gmat, 1, cand), min(k + 8, n_groups))
        gi = torch.gather(cand, 1, sel).sort(dim=1).values
    else:
        gm = groupmax(q, e, scales, lim0, mask_row0, layout=0)  # [G, B], group-major
        gi = _stable_desc(gm.t(), min(k + 8, gm.shape[0])).sort(dim=1).values
    # winner groups ascending: candidates run in global row order, so the
    # stable sort below breaks ties to the lowest id, as the stream does
    lids = (gi[:, :, None] * GROUP + offs).reshape(b, -1)  # [B, kg * 128]
    qo = query_operand(q, e.dtype)
    per_group = b * GROUP * d * e.element_size()
    step = max(1, _RERANK_SLICE_BYTES // per_group) * GROUP
    scores = []
    for c0 in range(0, lids.shape[1], step):
        rows = lids[:, c0:c0 + step].clamp(max=r - 1)
        rows_t = torch.empty((d, *rows.shape), dtype=torch.float32, device=dev)
        rows_t.copy_(e[rows].permute(2, 0, 1))  # [d, B, n]
        s = _ordered_dot(qo, rows_t)
        if scales is not None:
            s.mul_(scales[0][rows])
        scores.append(s)
    s2 = torch.cat(scores, dim=1).masked_fill(_invalid(lids, lim0, mask_row0), NEG_INF)
    return _top_k(s2, lids, k, id_offset)


def _plan(k: int, b: int) -> Tuple[int, int]:
    """(chunk rows C, queries per block QB) of K3: C is the power of two ≥
    max(k, 1024); QB·C keys fill at most 64 KB of shared memory, and a
    batch smaller than that sorts no empty query rows."""
    c = max(1024, 1 << (k - 1).bit_length())
    return c, max(1, min(8192 // c, b))


def _stream_kernel(q, e, scales, k: int, lim0: int, mask_row0: bool, id_offset: int):
    """K3 on CUDA tensors."""
    _cuda_operands(q, e, scales, "catalog_topk")
    b, d = q.shape
    r = e.shape[0]
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's largest chunk ({MAX_K})")
    if b > 65_535:
        raise ValueError(f"query batch {b} exceeds the kernel's grid; split it")
    c, qb = _plan(k, b)
    lib = _build.library()
    smem = lib.carca_catalog_topk_smem_bytes(c, qb, d)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"d={d} needs {smem} bytes of shared memory per block; "
                         f"the kernel holds at most {_build.SMEM_LIMIT}")
    vals = torch.empty(b, k, dtype=torch.float32, device=q.device)
    ids = torch.empty(b, k, dtype=torch.int64, device=q.device)
    if b == 0 or r == 0:
        return vals.fill_(NEG_INF), ids.zero_()
    n_chunks = -(-r // c)
    buf0 = torch.empty(b * n_chunks * k, dtype=torch.int64, device=q.device)
    buf1 = torch.empty(max(1, b * (-(-n_chunks // 2)) * k), dtype=torch.int64,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.carca_catalog_topk(
            q.data_ptr(), e.data_ptr(), None if scales is None else scales.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), b, r, d, k,
            c, qb, lim0, int(mask_row0), int(id_offset), _DTYPE_CODE[e.dtype], stream)
    _build.check(err, "catalog_topk")
    catalog_topk.launches[INDEX_KINDS[e.dtype]] += 1
    return vals, ids


def resolve_method(method: str, rows: int, k: int, batch: int) -> str:
    """"auto" → "tournament" from the crossover measured for (k, batch)
    on, else "stream"; the other methods as they are."""
    if method not in ("auto", "stream", "tournament"):
        raise ValueError(f"method must be auto|stream|tournament, got {method!r}")
    if method != "auto":
        return method
    fast = k < BIG_K and batch >= _TOURNAMENT_MIN_BATCH
    big = rows >= (_TOURNAMENT_MIN_ROWS if fast else _TOURNAMENT_MIN_ROWS_BIG_K)
    return "tournament" if big and rows >= 2 * GROUP else "stream"


def catalog_topk(
    q: torch.Tensor,
    catalog_emb: Index,
    k: int,
    *,
    n_items: Optional[int] = None,
    id_offset: int = 0,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] float32, global ids [B, k] int64) = top-k of
    q · catalog_embᵀ. ``catalog_emb`` [R, d] (f32, bf16, or a
    ``QuantizedIndex``) holds the rows ``id_offset .. id_offset + R``; rows
    whose global id is 0 (pad) or ≥ ``n_items`` are excluded. ``method``:
    "stream" (K3), "tournament" (K4 + exact rerank) or "auto" (module
    docstring). CPU tensors take the plain versions; CUDA tensors launch the
    kernels or raise."""
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    e, scales = _unpack(catalog_emb)
    method = resolve_method(method, e.shape[0], k, q.shape[0])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"catalog_topk runs on cpu or cuda tensors, got {q.device}")
    lim0, mask_row0 = _window(e.shape[0], n_items, id_offset)
    if method == "tournament":
        return _tournament_topk(q, e, scales, k, lim0, mask_row0, id_offset)
    if q.device.type == "cpu":
        return catalog_topk_plain(q, catalog_emb, k, n_items=n_items, id_offset=id_offset)
    return _stream_kernel(q, e, scales, k, lim0, mask_row0, id_offset)


# kernel launches by index type, for checks that a path ran K3
catalog_topk.launches = {kind: 0 for kind in INDEX_KINDS.values()}
