"""Catalog scoring + top-k (counterpart of
``carca_tpu/ops/retrieval_topk.py``).

``catalog_topk`` is the wrapper for kernel K3 (``csrc/catalog_topk.cu``),
which replaces the TPU's streaming ``_kernel`` for an f32 index: the
[B, R] score matrix never reaches device memory. Its plain version is
``catalog_topk_plain``.

Both give the same answer, id for id: values descending, ties to the
lowest id (``lax.top_k``'s order), rows ≥ ``n_items`` and the pad id 0
at −inf, and an id of 0 in any −inf slot. Scores are summed over d in
index order with each product and sum rounded on its own, in the kernel
and in ``ordered_scores`` alike, so the two agree bit for bit and the ids
agree even on near-ties. The plain version sorts with a stable sort, never
``torch.topk``, whose tie order is unspecified.

``catalog_topk`` takes an f32 index. On CPU tensors it runs the plain
version; on CUDA tensors it launches K3. On either device the tournament
method and a bf16/int8 index raise ``NotImplementedError`` until their
kernels are ported (ROADMAP queue B, B3 variants and B4); the plain
``quantize_index``/``dequantize_index`` are here for that int8 kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from carca_tpu_torch.ops import _build

NEG_INF = float("-inf")
MAX_K = 16_384  # the largest chunk whose keys a block sorts in shared memory


class QuantizedIndex(NamedTuple):
    """Symmetric per-row int8 index: row r is ``qvals[r] * scales[0, r]``.
    Build it with ``quantize_index`` after ``catalog_in_decoder_space``."""

    qvals: torch.Tensor   # [R, d] int8
    scales: torch.Tensor  # [1, R] float32

    @property
    def rows(self) -> int:
        return int(self.qvals.shape[0])


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


def ordered_scores(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """[B, R] float32 scores q·eᵀ, summed over d in index order with each
    product and each sum rounded separately — K3's arithmetic exactly."""
    et = e.to(torch.float32).t().contiguous()  # [d, R]
    q = q.to(torch.float32)
    s = torch.zeros(q.shape[0], et.shape[1], dtype=torch.float32, device=q.device)
    for j in range(q.shape[1]):
        s.add_(q[:, j, None] * et[j][None, :])
    return s


def catalog_topk_plain(
    q: torch.Tensor,
    catalog_emb: torch.Tensor,
    k: int,
    *,
    n_items: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``catalog_topk`` for an f32 index: score every
    row, mask, and take the first k of a stable descending sort."""
    r = catalog_emb.shape[0]
    n_items = n_items if n_items is not None else id_offset + r
    s = ordered_scores(q, catalog_emb)
    rows = torch.arange(r, device=s.device)
    lim0 = min(n_items - id_offset, r)
    bad = (rows >= lim0) | ((rows == 0) & (id_offset == 0))
    s = s.masked_fill(bad[None, :], NEG_INF)
    if k > r:
        s = torch.cat([s, s.new_full((s.shape[0], k - r), NEG_INF)], dim=1)
    v, cols = torch.sort(s, dim=1, descending=True, stable=True)
    v, cols = v[:, :k], cols[:, :k]
    return v, torch.where(v > NEG_INF, cols + id_offset, torch.zeros_like(cols))


def _plan(k: int, b: int) -> Tuple[int, int]:
    """(chunk rows C, queries per block QB): C is the power of two ≥
    max(k, 1024); QB·C keys fill at most 64 KB of shared memory, and a
    batch smaller than that sorts no empty query rows."""
    c = max(1024, 1 << (k - 1).bit_length())
    return c, max(1, min(8192 // c, b))


def catalog_topk(
    q: torch.Tensor,
    catalog_emb: torch.Tensor,
    k: int,
    *,
    n_items: Optional[int] = None,
    id_offset: int = 0,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] float32, global ids [B, k] int64) = top-k of
    q · catalog_embᵀ. ``catalog_emb`` [R, d] holds the rows ``id_offset ..
    id_offset + R``; rows whose global id is 0 (pad) or ≥ ``n_items`` are
    excluded. ``method``: "stream" (K3); "auto" resolves to "stream" until
    the stream/tournament crossover is measured on the H100;
    "tournament" has no kernel yet."""
    if method not in ("auto", "stream", "tournament"):
        raise ValueError(f"method must be auto|stream|tournament, got {method!r}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if method == "tournament":
        raise NotImplementedError(
            "the tournament top-k kernel is not ported yet (ROADMAP queue B, "
            "B4: the >=1M-row serving slice); use method='stream'")
    if isinstance(catalog_emb, QuantizedIndex) or catalog_emb.dtype != torch.float32:
        raise NotImplementedError(
            "the stream top-k kernel takes an f32 index; its bf16/int8 "
            "variants come with the >=1M-row serving slice (ROADMAP queue B, B3)")
    if q.device.type == "cpu":
        return catalog_topk_plain(q, catalog_emb, k, n_items=n_items,
                                  id_offset=id_offset)
    if q.device.type != "cuda":
        raise ValueError(f"catalog_topk runs on cpu or cuda tensors, got {q.device}")
    e = catalog_emb
    if e.device != q.device:
        raise ValueError(f"index on {e.device}, queries on {q.device}")
    if q.dtype != torch.float32:
        raise TypeError(f"the top-k kernel takes float32 queries, got {q.dtype}")
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"queries {tuple(q.shape)} and index {tuple(e.shape)} "
                         f"must be [B, d] and [R, d]")
    if not (q.is_contiguous() and e.is_contiguous()):
        raise ValueError("the top-k kernel takes contiguous queries and index")
    b, d = q.shape
    r = e.shape[0]
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's largest chunk ({MAX_K})")
    if b > 65_535:
        raise ValueError(f"query batch {b} exceeds the kernel's grid; split it")
    n_items = n_items if n_items is not None else id_offset + r
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
    lim0 = max(0, min(n_items - id_offset, r))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.carca_catalog_topk(
            q.data_ptr(), e.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            buf0.data_ptr(), buf1.data_ptr(), b, r, d, k, c, qb, lim0,
            int(id_offset == 0), int(id_offset), stream)
    _build.check(err, "catalog_topk")
    catalog_topk.launches += 1
    return vals, ids


catalog_topk.launches = 0  # kernel launches, for checks that the path ran K3
