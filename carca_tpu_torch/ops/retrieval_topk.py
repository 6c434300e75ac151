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
  ``groupmax_plain``. Stage 2 keeps the k + 8 best groups (ties to the
  lowest group) and stage 3 rescores their rows with the rerank kernel
  (``tournament_rerank``, ``csrc/groupmax.cu``; plain version
  ``tournament_rerank_plain``); the select kernel (``select_topk``,
  ``csrc/select_topk.cu``, lax.top_k's counterpart; plain version
  ``select_topk_plain``) takes both stage 2's groups and the final k. From
  ``_RECURSIVE_MIN_GROUPS`` groups stage 2 runs two levels over 128-group
  super-groups (layout 1).
* ``"auto"``: for k < ``BIG_K`` the tournament from ``_TOURNAMENT_MIN_ROWS``
  rows at a batch of ``_TOURNAMENT_MIN_BATCH`` or more, for larger k from
  ``_TOURNAMENT_MIN_ROWS_BIG_K`` rows; else the stream. On the card the
  stream takes k up to ``MAX_K`` and the tournament up to
  ``TOURNAMENT_MAX_K`` (= MAX_K − 8); "auto" gives a larger k the stream.

Scores. The kernels K3, K4 and the rerank score with one tensor-core
arithmetic (``csrc/scoring.cuh``): against a bf16 or int8 index the query is
rounded to bf16 first (the JAX package's ``q.astype(cd)``) and the products
run as bf16 ``mma.sync`` (K4: warpgroup ``wgmma`` products that a card test
holds bit-equal to it; ``groupmax_branch``); against an f32 index as
3xTF32; an int8 row's scale multiplies the finished sum. A score depends only on the query and
the row, so the three kernels agree bit for bit: K4's group maxima equal
the rerank's scores, which makes the tournament's containment argument
exact, and stream and tournament return the same ids and values on the
card. The plain versions (``ordered_scores``, ``_ordered_dot``) add the same
products in index order, each sum rounded, so on the CPU the stream and the
tournament agree exactly as well; the kernels differ from them only by the
summation order: |kernel − plain| ≤ 1e-5 · Σⱼ|q_j e_rj| (× the int8 scale),
and ids differ only where two candidates' plain scores lie within that
bound at the k-th place (``SCORE_ORDER_TOL``).

Order: ``lax.top_k``'s: values descending in IEEE total order (−0.0 below
+0.0; ``order_key``), ties to the lowest id; rows ≥ ``n_items`` and the pad
id 0 score −inf; a −inf slot returns id 0. The kernels order by 64-bit
keys (``csrc/select.cuh``); the plain versions sort stably by the same
order (``stable_desc``), never with ``torch.topk``, whose tie order is
unspecified.

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
MAX_K = 16_384  # the largest k whose running list and final sort fit K3's shared memory
# the tournament's largest k on the card: its stage 2 selects k + 8 groups
# with the select kernel, which takes at most MAX_K
TOURNAMENT_MAX_K = MAX_K - 8
GROUP = 128  # rows per tournament group
CHUNK = 128  # the kernels score rows wider than this in chunks of it (csrc/scoring.cuh)
# The kernels against the plain versions: two summation orders of the same
# d products, |kernel - plain| <= SCORE_ORDER_TOL * sum_j |q_j e_rj| (x the
# int8 scale); see csrc/scoring.cuh.
SCORE_ORDER_TOL = 1e-5
BIG_K = 48  # from this k on, "auto" reads the row count alone
# Stream/tournament crossover measured on the H100 after K3's redesign
# (PERF.md, Findings; carca_tpu_torch/bench_retrieval.py --sweep over B =
# 1/8/64/256, 100k-10M rows, f32/int8 and bf16 at 10M, k = 10, 60 and 562).
# k = 10: the stream wins at every B below 1M rows and at B <= 8 up to 10M,
# the tournament from 1M rows at B = 256 and from 2-5M at B = 64 (over a
# bf16 index the stream still wins at 10M). k >= 48: the tournament from
# 1M rows, but at k = 60 the stream still wins at B <= 8 up to 10M rows and
# at B = 64 up to 2M (not routed: the 5M-row shards of a sharded service
# keep the tournament).
_TOURNAMENT_MIN_ROWS = 1_000_000
_TOURNAMENT_MIN_ROWS_BIG_K = 1_000_000
_TOURNAMENT_MIN_BATCH = 64
# Two-level stage 2 from this many groups on; off: at 10M rows it saved 4-8 %
# at B = 256 and cost 5-11 % at B <= 8 on the H100 (PERF.md).
_RECURSIVE_MIN_GROUPS = 1 << 62
_RERANK_SLICE_BYTES = 128 << 20  # gathered index rows per slice of the plain rerank
# K3's plan (csrc/catalog_topk.cu, stream_plan): a select block of up to 8
# consumer warps (query groups of up to 8 queries) and two producer warps;
# each warp's lists of k + slack keys a query; a ring of 2-16 slots; row
# splits of a multiple of 128 rows, one wave (four from _K3_BIG_K on) of the
# blocks the H100's 132 SMs hold.
_K3_TILE = 64  # rows of a ring slot
_K3_MAX_WARPS = 8
_K3_MAX_SLOTS = 16
_K3_RING_MAX = 32 << 10  # ring bytes, at most (twice that where an SM holds one block)
_K3_SMS = 132
_K3_MAX_BLOCKS = 4 * _K3_SMS  # select blocks of a launch, at most (beyond a query block's first)
_K3_SM_SMEM = 228 << 10  # shared memory of an SM; each block also takes 1 KB
_K3_SMEM_TARGET = 227 << 10  # per select block
_K3_WAVES = 1
_K3_BIG_K = 256  # from this k on (lists of ~10 KB a query, few queries a block), ...
_K3_WAVES_BIG_K = 4  # ... more waves of shorter splits, and ...
_K3_BIG_K_GROUPS = 4  # ... at most this many query groups (more queries a warp)
_K3_MIN_SLACK = 64  # a tile's keys per query
_K3_MAX_SLACK = 2048
_K3_SLACK_K = 2  # list slots beyond a tile's keys: this many times k, as shared memory allows
_K3_SPLIT_K = 4  # a split holds at least this many times k rows (and 1024) ...
_K3_IDLE_SPLIT_ROWS = 256  # ... or this many where that would leave half the card idle
_K3_FINAL_KEYS = 32_768  # keys a query's lists hand the final pass, at most (k ≤ 4,096)
_K3_BUSY_WARPS = 2 * _K3_SMS  # fewer consumer warps than this: a warp takes fewer queries
# The select kernel's plan (select_plan; csrc/select_topk.cu): blocks of
# 1-8 queries over one split of their row, a query group's splits one
# thread-block cluster of at most 8, one block an H100 SM; a ring of up to
# 24 slots of 16 KB (4,096 values) a block
_SELECT_MAX_SPLITS = 8  # a portable cluster
# clusters of 1, 2, 4 and 8 blocks (one block an SM) that an H100 holds at
# once (cudaOccupancyMaxActiveClusters; PERF.md §6): more query groups
# than these run in a second wave
_SELECT_RESIDENT_CLUSTERS = {1: _K3_SMS, 2: 66, 4: 30, 8: 15}
_SELECT_SPLIT_MIN = 2_048  # values a split holds, at least, ...
_SELECT_SPLIT_K = 4  # ... and this many times k
_SELECT_SPLIT_ROUND = 256  # a split holds a multiple of this many values (a tensor copy)
_SELECT_SLOT_BYTES = 16_384
_SELECT_MAX_SLOTS = 24  # as many as shared memory holds: a trimming warp holds the ring back
_SELECT_MIN_SLOTS = 4  # fewer queries a block before fewer slots than this (but 2 at 1 query)
_SELECT_CTL_BYTES = 1_280  # a query's control block
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


def _scores_of_rows(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                    rows: torch.Tensor) -> torch.Tensor:
    """[B, n] plain scores of each query q[b] against its own local rows
    rows[b] (clamped into the index), in memory-bounded slices."""
    b, d = q.shape
    qo = query_operand(q, e.dtype)
    per_row = max(1, b * d * e.element_size())
    step = max(GROUP, _RERANK_SLICE_BYTES // per_row // GROUP * GROUP)
    out = [q.new_zeros(b, 0)]
    for c0 in range(0, rows.shape[1], step):
        r = rows[:, c0:c0 + step].clamp(0, e.shape[0] - 1)
        rows_t = torch.empty((d, *r.shape), dtype=torch.float32, device=q.device)
        rows_t.copy_(e[r].permute(2, 0, 1))  # [d, B, n]
        s = _ordered_dot(qo, rows_t)
        if scales is not None:
            s.mul_(scales[0][r])
        out.append(s)
    return torch.cat(out, dim=1)


def ordered_scores_at(q: torch.Tensor, index: Index, rows: torch.Tensor) -> torch.Tensor:
    """``ordered_scores`` at local rows [B, n] only: [B, n] float32."""
    e, scales = _unpack(index)
    return _scores_of_rows(q, e, scales, rows)


def score_magnitude_at(q: torch.Tensor, index: Index, rows: torch.Tensor) -> torch.Tensor:
    """Σⱼ |q_j · e_rj| (× the int8 scale) at local rows [B, n]: what the
    summation-order tolerance SCORE_ORDER_TOL scales."""
    e, scales = _unpack(index)
    return _scores_of_rows(q.abs(), e.abs(), scales, rows)


def compare_within_order_tol(v: torch.Tensor, i: torch.Tensor, pv: torch.Tensor,
                             pi: torch.Tensor, q: torch.Tensor, index: Index,
                             id_offset: int = 0) -> Tuple[float, int]:
    """Hold a kernel's top-k (v, i) to the plain version's (pv, pi) for the
    same queries: −inf slots alike; every value within SCORE_ORDER_TOL · M_b
    of the plain value in its slot, M_b the largest Σⱼ|q_j e_rj| over query
    b's returned rows of either side; and where ids differ, the kernel's row
    scores (plain arithmetic) within twice that of the plain value in its
    slot: a near-tie at the k-th place or inside the list. Returns (max
    |v − pv| over finite slots, slots whose ids differ); raises ValueError
    otherwise."""
    fin = torch.isfinite(pv)
    if not torch.equal(torch.isfinite(v), fin):
        raise ValueError("the kernel's -inf slots differ from the plain version's")
    rows_k, rows_p = (i - id_offset).clamp(min=0), (pi - id_offset).clamp(min=0)
    mag = torch.maximum(score_magnitude_at(q, index, rows_k), score_magnitude_at(q, index, rows_p))
    bound = SCORE_ORDER_TOL * torch.where(fin, mag, 0).double().amax(dim=1, keepdim=True)
    bound = bound.expand_as(mag)
    err = torch.where(fin, (v.double() - pv.double()).abs(), 0)
    if bool((err > bound).any()):
        raise ValueError(f"values beyond the summation-order bound: max |err| "
                         f"{err.max().item():.3g}, bound {bound.max().item():.3g}")
    diff = (i != pi) & fin
    if bool(diff.any()):
        gap = (ordered_scores_at(q, index, rows_k).double() - pv.double()).abs()
        if bool((gap[diff] > 2 * bound[diff]).any()):
            raise ValueError(f"{int(diff.sum())} ids differ from the plain version and "
                             f"are not near-ties (plain score gap {gap[diff].max().item():.3g})")
    return (err.max().item() if err.numel() else 0.0), int(diff.sum())


def _invalid(rows: torch.Tensor, lim0: int, mask_row0: bool) -> torch.Tensor:
    """Local rows that score −inf: ≥ lim0, and row 0 when it is the pad."""
    return (rows >= lim0) | ((rows == 0) & mask_row0)


def _window(r: int, n_items: Optional[int], id_offset: int) -> Tuple[int, bool]:
    """(lim0, mask_row0): the valid local rows are [0, lim0), and local row
    0 is the pad when the index starts at global id 0."""
    n_items = n_items if n_items is not None else id_offset + r
    return max(0, min(n_items - id_offset, r)), id_offset == 0


def order_key(v: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is lax.top_k's order of the float32
    values v: IEEE total order, −0.0 below +0.0 (the float's bits with the
    low 31 flipped where the sign is set, the JAX package's ``_float_key``;
    the kernels' 64-bit keys, ``csrc/select.cuh``, hold it in their high
    word). Any float dtype is widened to float32 first, exactly."""
    b = v.to(torch.float32).view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def stable_desc(v: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the n largest along the last axis in lax.top_k's order:
    by ``order_key``, ties to the lowest position. The one plain selection
    of the port (``_top_k``, ``select_topk_plain`` and
    ``parallel.retrieval.stable_topk`` take it)."""
    return torch.sort(order_key(v), dim=-1, descending=True, stable=True).indices[..., :n]


def _top_k(s: torch.Tensor, ids: torch.Tensor, k: int, id_offset: int):
    """The first k of s [B, N] in lax.top_k's order (−inf-padded to k), with
    their ids [B, N] (+ id_offset; 0 in a −inf slot)."""
    if k > s.shape[1]:
        s = torch.cat([s, s.new_full((s.shape[0], k - s.shape[1]), NEG_INF)], dim=1)
        ids = torch.cat([ids, ids.new_zeros(ids.shape[0], k - ids.shape[1])], dim=1)
    sel = stable_desc(s, k)
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


def _launch(what: str, device: torch.device, smem: int, fn, *args) -> None:
    """Call a C entry point on the device's current stream, after checking
    its shared memory, and raise on a CUDA error."""
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{what} needs {smem} bytes of shared memory per block; "
                         f"a block holds at most {_build.SMEM_LIMIT}")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, what)


# K4's kernels by the C rule's code (csrc/groupmax.cu, carca_groupmax_branch)
GROUPMAX_BRANCHES = ("mma", "wgmma", "wide")


def groupmax_branch(dtype: torch.dtype, d: int) -> str:
    """The kernel K4 runs over an index of this dtype and width (the rule of
    ``csrc/groupmax.cu::groupmax_branch``, which a card test and
    chip_smoke hold equal to this one): "wgmma" (``groupmax_wg_kernel``,
    warpgroup products fed by a producer warp) for bf16 and int8 rows of up
    to 128 columns, "mma" (``groupmax_kernel``, 3xTF32 on ``mma.sync``) for
    f32 rows of up to 128 columns, "wide" (``groupmax_wide_kernel``, 128-column
    chunks) past 128 columns."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"K4 takes float32, bfloat16 or int8 rows, got {dtype}")
    if d > CHUNK:
        return "wide"
    return "mma" if dtype == torch.float32 else "wgmma"


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
    code = _DTYPE_CODE[e.dtype]
    _launch("groupmax", q.device, lib.carca_groupmax_smem_bytes(d, code), lib.carca_groupmax,
            q.data_ptr(), e.data_ptr(), None if scales is None else scales.data_ptr(),
            out.data_ptr(), b, r, d, max(0, min(lim0, r)), int(mask_row0), n_groups, layout,
            code)
    groupmax.launches[layout] += 1
    return out


# kernel launches by layout, for checks that a path ran K4
groupmax.launches = {0: 0, 1: 0}


def _winner_rows(gi: torch.Tensor) -> torch.Tensor:
    """[B, kg] group ids → their [B, kg · 128] local rows."""
    return (gi[:, :, None] * GROUP + torch.arange(GROUP, device=gi.device)).reshape(
        gi.shape[0], -1)


def tournament_rerank_plain(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                            gi: torch.Tensor, lim0: int, mask_row0: bool) -> torch.Tensor:
    """The plain version of ``tournament_rerank``: the rows of each query's
    winner groups gathered in memory-bounded slices and scored in index
    order (``_ordered_dot``), then masked."""
    lids = _winner_rows(gi)
    return _scores_of_rows(q, e, scales, lids).masked_fill(
        _invalid(lids, lim0, mask_row0), NEG_INF)


def _rerank_operands(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                     gi: torch.Tensor) -> None:
    """Raise unless (q, e, scales, gi) are what the rerank kernel takes."""
    _cuda_operands(q, e, scales, "tournament_rerank")
    if gi.device != q.device or gi.dtype != torch.int64:
        raise TypeError(f"tournament_rerank takes int64 group ids on {q.device}, got "
                        f"{gi.dtype} on {gi.device}")
    if gi.dim() != 2 or gi.shape[0] != q.shape[0] or not gi.is_contiguous():
        raise ValueError(f"tournament_rerank takes contiguous group ids [{q.shape[0]}, kg], "
                         f"got {tuple(gi.shape)}")


def tournament_rerank(q: torch.Tensor, e: torch.Tensor, scales: Optional[torch.Tensor],
                      gi: torch.Tensor, lim0: int, mask_row0: bool) -> torch.Tensor:
    """Stage 3 of the tournament: [B, kg · 128] float32 scores of the rows
    of each query's kg winner groups gi [B, kg] (int64, ascending), rows
    ≥ lim0 and the pad row 0 (when ``mask_row0``) −inf. The rerank kernel
    (``csrc/groupmax.cu``, K4's scoring routine) on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return tournament_rerank_plain(q, e, scales, gi, lim0, mask_row0)
    if q.device.type != "cuda":
        raise ValueError(f"tournament_rerank runs on cpu or cuda tensors, got {q.device}")
    _rerank_operands(q, e, scales, gi)
    b, d = q.shape
    r, kg = e.shape[0], gi.shape[1]
    out = torch.empty(b, kg * GROUP, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    code = _DTYPE_CODE[e.dtype]
    _launch("tournament_rerank", q.device, lib.carca_tournament_rerank_smem_bytes(d, code),
            lib.carca_tournament_rerank, q.data_ptr(), e.data_ptr(),
            None if scales is None else scales.data_ptr(), gi.data_ptr(), out.data_ptr(), b, r,
            d, kg, max(0, min(lim0, r)), int(mask_row0), code)
    tournament_rerank.launches += 1
    return out


# kernel launches, for checks that a path ran the rerank kernel
tournament_rerank.launches = 0


def select_topk_plain(v: torch.Tensor, k: int, *, positions_sorted: bool = False,
                      gi: Optional[torch.Tensor] = None, id_offset: int = 0):
    """The plain version of ``select_topk``: a stable sort by ``order_key``
    (``stable_desc``), the same contract."""
    if positions_sorted:
        if k > v.shape[1]:
            raise ValueError(f"select_topk: positions of k={k} of {v.shape[1]} values")
        return stable_desc(v, k).sort(dim=1).values
    b, n = v.shape
    ids = (_winner_rows(gi) if gi is not None
           else torch.arange(n, device=v.device).expand(b, n))
    return _top_k(v, ids, k, id_offset)


class SelectPlan(NamedTuple):
    """The select kernel's launch: ``queries`` rows a block (1, 2, 4 or 8),
    ``splits`` blocks a query group (one thread-block cluster, at most 8)
    of ``per_split`` values each, and ``slots`` ring slots of 16 KB a
    block."""

    queries: int
    splits: int
    per_split: int
    slots: int


def _select_smem(k: int, queries: int, slots: int) -> int:
    """Shared memory of a select block (``csrc/select_topk.cu``,
    smem_bytes, the same formula): alignment, the ring, each query's list
    of max(k + slack, kpad) keys and its control block, the mbarriers."""
    kpad = 1 << max(0, k - 1).bit_length()
    slack = max(1024, 2 * 256 * (16 // queries))  # two slots of the query's warps' keys
    cap = max(k + slack, kpad)
    return 1024 + slots * _SELECT_SLOT_BYTES + queries * (cap * 8 + _SELECT_CTL_BYTES) + 16 * slots


def select_plan(b: int, n: int, k: int, column: bool = False) -> SelectPlan:
    """The select kernel's launch for B rows of N values (``column``: read
    column-major, K4's [G, B] as [B, G], in boxes of 8 or 4 queries, a
    whole or half 32-byte sector a row). Each of a block's 16 consumer
    warps reads queries / 16 of every value of its split, so a launch takes about
    waves x queries / splits of a block's time at one query and one split:
    of the queries a block whose lists and _SELECT_MIN_SLOTS ring slots fit
    (2 slots at one query), the one that makes this least (ties to more
    queries). Splits a query group: 8, 4 or 2 where the card holds every
    group's cluster at once (_SELECT_RESIDENT_CLUSTERS), else 1; each split
    at least _SELECT_SPLIT_MIN values and _SELECT_SPLIT_K · k (a split
    keeps k of its values), and the splits' k largest within the block's
    ring, where the merge gathers them."""
    min_split = max(_SELECT_SPLIT_MIN, _SELECT_SPLIT_K * k)
    best = None
    for queries in (8, 4) if column else (8, 4, 2, 1):
        room = _build.SMEM_LIMIT - _select_smem(k, queries, 0)
        slots = min(_SELECT_MAX_SLOTS, room // (_SELECT_SLOT_BYTES + 16))
        if slots < (_SELECT_MIN_SLOTS if queries > 1 else 2):
            continue
        groups = -(-max(b, 1) // queries)
        most = min(_SELECT_MAX_SPLITS, n // min_split, slots * _SELECT_SLOT_BYTES // 8 // k)
        splits = next((c for c in (8, 4, 2)
                       if c <= most and groups <= _SELECT_RESIDENT_CLUSTERS[c]), 1)
        cost = -(-groups // _SELECT_RESIDENT_CLUSTERS[splits]) * queries / splits
        if best is None or cost < best[0]:
            best = cost, queries, splits, slots
    if best is None:  # a large k: one query a block (column-major reads take plain loads)
        slots = min(_SELECT_MAX_SLOTS,
                    (_build.SMEM_LIMIT - _select_smem(k, 1, 0)) // (_SELECT_SLOT_BYTES + 16))
        best = 0, 1, 1, slots
    _, queries, splits, slots = best
    per_split = -(-n // splits)
    per_split = -(-per_split // _SELECT_SPLIT_ROUND) * _SELECT_SPLIT_ROUND
    return SelectPlan(queries, -(-n // per_split), per_split, slots)


def _select_operands(v: torch.Tensor, k: int, positions_sorted: bool,
                     gi: Optional[torch.Tensor]) -> None:
    """Raise unless (v, k, gi) are what the select kernel takes."""
    if v.dtype != torch.float32 or v.dim() != 2:
        raise TypeError(f"select_topk takes float32 [B, N] values, got {v.dtype} "
                        f"{tuple(v.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"select_topk: k={k} outside the kernel's 1..{MAX_K}")
    if v.shape[1] >= 1 << 31 or min(v.stride()) < 0:
        raise ValueError(f"select_topk: {v.shape[1]} values a row, strides {v.stride()}")
    if positions_sorted:
        if gi is not None:
            raise ValueError("select_topk: the position mode takes no group ids")
        if k > v.shape[1]:
            raise ValueError(f"select_topk: positions of k={k} of {v.shape[1]} values")
    if gi is not None:
        if gi.device != v.device or gi.dtype != torch.int64:
            raise TypeError(f"select_topk takes int64 group ids on {v.device}, got "
                            f"{gi.dtype} on {gi.device}")
        if (gi.dim() != 2 or gi.shape[0] != v.shape[0] or gi.shape[1] * GROUP != v.shape[1]
                or not gi.is_contiguous()):
            raise ValueError(f"select_topk takes contiguous group ids [{v.shape[0]}, "
                             f"{v.shape[1]} / {GROUP}], got {tuple(gi.shape)}")


def select_topk(v: torch.Tensor, k: int, *, positions_sorted: bool = False,
                gi: Optional[torch.Tensor] = None, id_offset: int = 0):
    """The k largest of each row of v [B, N] (float32, any strides) in
    lax.top_k's order (``order_key``: −0.0 below +0.0, ties to the lowest
    position): the select kernel (``csrc/select_topk.cu``) on CUDA tensors,
    ``select_topk_plain`` on CPU tensors.

    ``positions_sorted``: int64 positions [B, k], ascending (k ≤ N).
    Otherwise (values [B, k], ids [B, k] int64): values descending; position
    p's id is gi[b, p // 128] · 128 + p % 128 + id_offset with ``gi`` [B,
    N / 128] int64 (the tournament's winner groups), else p + id_offset; a
    −inf value gets id 0, and k > N pads with (−inf, 0)."""
    if v.device.type == "cpu":
        return select_topk_plain(v, k, positions_sorted=positions_sorted, gi=gi,
                                 id_offset=id_offset)
    if v.device.type != "cuda":
        raise ValueError(f"select_topk runs on cpu or cuda tensors, got {v.device}")
    _select_operands(v, k, positions_sorted, gi)
    b, n = v.shape
    ids = torch.empty(b, k, dtype=torch.int64, device=v.device)
    vals = None if positions_sorted else torch.empty(b, k, dtype=torch.float32, device=v.device)
    if b == 0 or n == 0:
        return ids if positions_sorted else (vals.fill_(NEG_INF), ids.zero_())
    plan = select_plan(b, n, k, column=n > 1 and v.stride(1) != 1)
    lib = _build.library()
    _launch("select_topk", v.device, lib.carca_select_topk_smem_bytes(k, plan.queries, plan.slots),
            lib.carca_select_topk, v.data_ptr(), v.stride(0), v.stride(1), b, n, k,
            plan.queries, plan.splits, plan.per_split, plan.slots, int(positions_sorted),
            None if gi is None else gi.data_ptr(), 0 if gi is None else gi.shape[1],
            int(id_offset), None if vals is None else vals.data_ptr(), ids.data_ptr())
    select_topk.launches["positions" if positions_sorted else "values"] += 1
    return ids if positions_sorted else (vals, ids)


# kernel launches by mode (stage 2's positions, the final k's values), for
# checks that a path ran the select kernel
select_topk.launches = {"positions": 0, "values": 0}


def _tournament_topk(q, e, scales, k: int, lim0: int, mask_row0: bool, id_offset: int):
    """Top-k by group maxima (stage 1, ``groupmax``), the k + 8 best groups
    (stage 2, ``select_topk`` by position) and an exact rescoring of their
    rows (stage 3, ``tournament_rerank``), then the final k (``select_topk``
    by value, ids from the winner groups). The union of the k best groups holds the true
    top-k: an element of it in an unpicked group would follow k group
    maxima in (value, lowest id) order. K4 and the rerank score
    bit-identically (one routine on the card, one order on the CPU), so the
    containment is exact; the 8 extra groups are the JAX package's margin
    for its two summation orders, kept so that both packages rerank the same
    groups."""
    b, d = q.shape
    r = e.shape[0]
    dev = q.device
    if dev.type == "cuda" and k > TOURNAMENT_MAX_K:
        raise ValueError(f"the tournament takes k <= {TOURNAMENT_MAX_K} on the card (stage 2 "
                         f"selects k + 8 groups, the select kernel at most {MAX_K}), got k={k}")
    if b == 0 or r == 0:
        return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros(b, k, dtype=torch.int64, device=dev))
    if -(-r // GROUP) >= _RECURSIVE_MIN_GROUPS:
        gmat = groupmax(q, e, scales, lim0, mask_row0, layout=1)  # [B, G'], query-major
        n_groups = gmat.shape[1]
        n2 = n_groups // GROUP
        # level 2: super-group maxima are maxima of the same level-1 values,
        # so the containment argument holds at each level as it stands
        gi2 = select_topk(gmat.view(b, n2, GROUP).amax(dim=2), min(k + 8, n2),
                          positions_sorted=True)
        cand = (gi2[:, :, None] * GROUP + torch.arange(GROUP, device=dev)).reshape(b, -1)
        sel = select_topk(torch.gather(gmat, 1, cand), min(k + 8, n_groups),
                          positions_sorted=True)
        gi = torch.gather(cand, 1, sel)  # ascending: cand ascends, and so does sel
    else:
        gm = groupmax(q, e, scales, lim0, mask_row0, layout=0)  # [G, B], group-major
        gi = select_topk(gm.t(), min(k + 8, gm.shape[0]), positions_sorted=True)
    # winner groups ascending: candidates run in global row order, so ties
    # in the final selection go to the lowest id, as in the stream
    s2 = tournament_rerank(q, e, scales, gi, lim0, mask_row0)
    return select_topk(s2, k, gi=gi, id_offset=id_offset)


class StreamPlan(NamedTuple):
    """K3's launch plan: query groups (a select block's consumer warps),
    queries per group (``per_warp``, the real columns of a warp's n8 tile),
    list slots beyond k, ring slots, row splits, rows per split (a multiple
    of 128), and the scratch's bytes (B · splits · k · 8)."""

    groups: int
    per_warp: int
    slack: int
    slots: int
    splits: int
    rows_per_split: int
    scratch_bytes: int

    @property
    def qb(self) -> int:
        """Queries per select block."""
        return self.groups * self.per_warp


def _k3_slot_bytes(d: int, itemsize: int) -> int:
    """A ring slot of K3's select block: 64 rows at their shared-memory
    stride (csrc/scoring.cuh, row_stride_bytes) and their scales."""
    kd = 64 if d <= 64 else CHUNK
    return _K3_TILE * (kd * itemsize + (16 if itemsize == 1 else 32) + 4)


def _k3_select_smem(k: int, warps: int, per_warp: int, slack: int, slots: int, d: int,
                    itemsize: int) -> int:
    """Shared memory of K3's select block (csrc/catalog_topk.cu,
    select_bytes: two mbarriers and a slot per ring slot, each consumer
    warp's lists and histogram)."""
    return (slots * (16 + _k3_slot_bytes(d, itemsize)) + 8 * warps * per_warp * (k + slack)
            + 4 * 256 * warps)


def _k3_blocks_per_sm(smem: int, warps: int) -> int:
    """Select blocks an SM holds: by shared memory (each block also takes 1
    KB) and by threads (the warps and two producers)."""
    return max(1, min(_K3_SM_SMEM // (smem + 1024), 2048 // (32 * (warps + 2))))


def _k3_plan(k: int, b: int, r: int, d: int, itemsize: int, per_warp: int) -> StreamPlan:
    """stream_plan's block and splits for at most ``per_warp`` queries a
    warp."""
    max_groups = _K3_MAX_WARPS if k < _K3_BIG_K else _K3_BIG_K_GROUPS
    groups = min(max_groups, -(-b // per_warp))
    slot = _k3_slot_bytes(d, itemsize)
    floor = _K3_MIN_SLACK + max(_K3_MIN_SLACK, -(-k // 32) * 32)
    slack = min(_K3_MAX_SLACK,
                _K3_MIN_SLACK + max(_K3_MIN_SLACK, -(-_K3_SLACK_K * k // 32) * 32))
    while (_k3_select_smem(k, groups, per_warp, slack, 2, d, itemsize) > _K3_SMEM_TARGET
           and (slack, per_warp, groups) != (_K3_MIN_SLACK, 1, 1)):
        if slack > floor:
            slack = max(floor, slack // 2 // 32 * 32)
        elif per_warp > 1:
            per_warp = -(-per_warp // 2)
            groups = min(max_groups, -(-b // per_warp))
        elif groups > 1:
            groups = -(-groups // 2)
        else:
            slack = max(_K3_MIN_SLACK, slack // 2 // 32 * 32)
    lists = _k3_select_smem(k, groups, per_warp, slack, 0, d, itemsize)
    for ring in (_K3_RING_MAX, 2 * _K3_RING_MAX):  # the deeper ring where an SM holds one block
        slots = max(2, min(_K3_MAX_SLOTS, min(_K3_SMEM_TARGET - lists, ring) // (16 + slot)))
        per_sm = _k3_blocks_per_sm(lists + slots * (16 + slot), groups)
        if per_sm > 1:
            break
    qblocks = -(-b // (groups * per_warp))
    waves = _K3_WAVES if k < _K3_BIG_K else _K3_WAVES_BIG_K
    want = max(1, -(-min(_K3_SMS * per_sm * waves, _K3_MAX_BLOCKS) // qblocks))
    min_rows = max(1024, _K3_SPLIT_K * k)
    if qblocks * -(-r // min_rows) < _K3_SMS // 2:  # too few blocks to fill half the card
        min_rows = _K3_IDLE_SPLIT_ROWS
    rows = max(-(-r // want), min_rows, 1)
    if 8 * k <= _K3_FINAL_KEYS:  # the final pass merges splits · k keys a query
        for keys in (_K3_FINAL_KEYS, 2 * _K3_FINAL_KEYS):  # twice where the card would idle
            capped = max(rows, -(-r // max(1, keys // k)))
            if qblocks * -(-r // capped) >= _K3_SMS:
                break
        rows = capped
    rows = -(-rows // 128) * 128
    splits = max(1, -(-r // rows))
    return StreamPlan(groups, per_warp, slack, slots, splits, rows, b * splits * k * 8)


def stream_plan(k: int, b: int, r: int, d: int, itemsize: int) -> StreamPlan:
    """K3's block shape, list slack, ring and row splits.

    A block takes up to 8 queries a warp (its n8 tile) and up to 8 query
    groups: 8 groups of 8 at B ≥ 64 for k < _K3_BIG_K (the index is read
    once per 64 queries), at most _K3_BIG_K_GROUPS groups from _K3_BIG_K on
    (more queries a warp, fewer warps widening the same rows). Each warp's
    lists take k + slack keys a query, the slack 64 + _K3_SLACK_K · k (at
    most _K3_MAX_SLACK: every 'slack' keys past the threshold cost a radix
    select). Where the lists and a ring of two slots do not fit
    _K3_SMEM_TARGET, the slack shrinks to 64 + k, then a warp takes fewer
    queries, then there are fewer groups. The ring takes what is left, up
    to _K3_MAX_SLOTS slots and _K3_RING_MAX bytes, or twice that where an SM
    holds only one block anyway. Then as many row splits as fill _K3_WAVES
    waves of the blocks an SM holds (_K3_WAVES_BIG_K from _K3_BIG_K on; at
    most _K3_MAX_BLOCKS blocks), each split at least max(1024, _K3_SPLIT_K
    · k) rows (_K3_IDLE_SPLIT_ROWS where that would leave half the card
    idle), and, for k ≤ _K3_FINAL_KEYS / 8, few enough that a query's lists
    hand the final pass at most _K3_FINAL_KEYS keys (twice that where fewer
    blocks than the card's SMs would be left). Where that gives fewer
    consumer warps than _K3_BUSY_WARPS (few queries, few rows against k), a
    warp takes half the queries, and again, down to one: more warps share a
    block's rows, then more query blocks read them. The scratch is B ·
    splits · k · 8 bytes with the splits bounded by the blocks: it does not
    grow with R."""
    plan = _k3_plan(k, b, r, d, itemsize, max(1, min(8, b)))
    while plan.per_warp > 1 and -(-b // plan.qb) * plan.splits * plan.groups < _K3_BUSY_WARPS:
        plan = _k3_plan(k, b, r, d, itemsize, plan.per_warp // 2)
    return plan


def _stream_kernel(q, e, scales, k: int, lim0: int, mask_row0: bool, id_offset: int):
    """K3 on CUDA tensors."""
    _cuda_operands(q, e, scales, "catalog_topk")
    b, d = q.shape
    r = e.shape[0]
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's largest list ({MAX_K})")
    vals = torch.empty(b, k, dtype=torch.float32, device=q.device)
    ids = torch.empty(b, k, dtype=torch.int64, device=q.device)
    if b == 0 or r == 0:
        return vals.fill_(NEG_INF), ids.zero_()
    plan = stream_plan(k, b, r, d, e.element_size())
    scratch = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64, device=q.device)
    lib = _build.library()
    code = _DTYPE_CODE[e.dtype]
    _launch("catalog_topk", q.device,
            lib.carca_catalog_topk_smem_bytes(k, plan.groups, plan.per_warp, plan.slack, plan.slots,
                                              d, code),
            lib.carca_catalog_topk, q.data_ptr(), e.data_ptr(),
            None if scales is None else scales.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            scratch.data_ptr(), b, r, d, k, plan.groups, plan.per_warp, plan.slack,
            plan.slots, plan.splits, plan.rows_per_split, lim0, int(mask_row0), int(id_offset),
            code)
    catalog_topk.launches[INDEX_KINDS[e.dtype]] += 1
    return vals, ids


def resolve_method(method: str, rows: int, k: int, batch: int) -> str:
    """"auto" → "tournament" where the crossover measured for (rows, k,
    batch) says so and k ≤ TOURNAMENT_MAX_K, else "stream"; the other
    methods as they are."""
    if method not in ("auto", "stream", "tournament"):
        raise ValueError(f"method must be auto|stream|tournament, got {method!r}")
    if method != "auto":
        return method
    if k < BIG_K:
        big = batch >= _TOURNAMENT_MIN_BATCH and rows >= _TOURNAMENT_MIN_ROWS
    else:
        big = rows >= _TOURNAMENT_MIN_ROWS_BIG_K
    return "tournament" if big and rows >= 2 * GROUP and k <= TOURNAMENT_MAX_K else "stream"


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
