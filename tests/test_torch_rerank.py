"""The tournament's rerank and K3's plan on the CPU.

* ``tournament_rerank_plain`` (the plain version of the rerank kernel)
  against the JAX package's stage 3 (the ``score_slice`` einsum of
  ``carca_tpu/ops/retrieval_topk.py::_tournament_topk``) at f32, bf16 and
  int8, numbers passed through numpy: within SCORE_ORDER_TOL of
  sum_j |q_j e_rj| (two summation orders of the same products), -inf rows
  alike.
* ``tournament_rerank``'s checks of device, type, shape and contiguity,
  and its CPU path (the plain version).
* ``stream_plan``: K3's block shape (query groups, queries a warp), list
  slack, ring slots, row splits and scratch at 100k and 10M rows, B =
  1/33/256, k = 10/562, and the plan at the retrieval monitor's shape; the
  shared memory fits a block, the scratch does not grow with R and stays
  under 0.5 GB.
* ``compare_within_order_tol``: what the card checks accept (near-ties)
  and refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carca_tpu.ops.retrieval_topk as jrt
import carca_tpu_torch.ops.retrieval_topk as rt
from carca_tpu_torch.ops.retrieval_topk import (GROUP, SCORE_ORDER_TOL, QuantizedIndex,
                                                compare_within_order_tol, ordered_scores,
                                                ordered_scores_at, score_magnitude_at,
                                                stream_plan, tournament_rerank,
                                                tournament_rerank_plain)

torch.set_num_threads(1)


def data(seed, b, r, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


def indexes(e, kind):
    """(JAX rows, JAX scales or None, port rows, port scales or None)."""
    if kind == "f32":
        return jnp.asarray(e), None, torch.from_numpy(e), None
    if kind == "bf16":
        return (jnp.asarray(e).astype(jnp.bfloat16), None,
                torch.from_numpy(e).to(torch.bfloat16), None)
    qi = jrt.quantize_index(jnp.asarray(e))
    return (qi.qvals, qi.scales, torch.from_numpy(np.array(qi.qvals)),
            torch.from_numpy(np.array(qi.scales)))


def jax_stage3(q, rows, scales, gi, lim0, mask_row0):
    """The JAX package's stage 3 on winner groups gi [B, kg]: its einsum
    (HIGHEST at f32, bf16 operands otherwise), the int8 scale after it, the
    same mask."""
    b, d = q.shape
    n_groups = -(-rows.shape[0] // GROUP)
    pad = n_groups * GROUP - rows.shape[0]
    cat = jnp.pad(rows, ((0, pad), (0, 0))).reshape(n_groups, GROUP, d)
    cd = jnp.bfloat16 if cat.dtype == jnp.int8 else cat.dtype
    s = jnp.einsum("bd,bkgd->bkg", jnp.asarray(q).astype(cd), cat[gi].astype(cd),
                   preferred_element_type=jnp.float32,
                   precision=(jax.lax.Precision.HIGHEST if cd == jnp.float32 else None))
    if scales is not None:
        scl = jnp.pad(scales[0], (0, pad)).reshape(n_groups, GROUP)
        s = s * scl[gi]
    lids = gi[:, :, None] * GROUP + jnp.arange(GROUP)
    bad = (lids >= lim0) | ((lids == 0) & mask_row0)
    return np.asarray(jnp.where(bad, -jnp.inf, s).reshape(b, -1))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("r,lim0,mask_row0", [(1000, 1000, True), (777, 700, False)])
def test_rerank_plain_matches_jax_stage3(kind, r, lim0, mask_row0):
    q, e = data(r, 5, r, 16)
    q[1] = 0.0  # a zero query
    jrows, jscales, rows, scales = indexes(e, kind)
    rng = np.random.default_rng(1)
    n_groups = -(-r // GROUP)
    gi = np.sort(np.stack([rng.choice(n_groups, 4, replace=False) for _ in range(5)]), axis=1)
    want = jax_stage3(q, jrows, jscales, jnp.asarray(gi), lim0, mask_row0)
    got = tournament_rerank_plain(torch.from_numpy(q), rows, scales, torch.from_numpy(gi),
                                  lim0, mask_row0).numpy()
    assert got.shape == (5, 4 * GROUP)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    mag = tournament_rerank_plain(torch.from_numpy(np.abs(q)), rows.abs(), scales,
                                  torch.from_numpy(gi), r, False).numpy()
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= SCORE_ORDER_TOL * mag[fin] + 1e-30).all()
    assert (got[1][np.isfinite(got[1])] == 0).all()


def test_rerank_on_cpu_is_the_plain_version_and_equals_ordered_scores():
    """On CPU tensors the wrapper runs the plain version, whose scores are
    ordered_scores' at the winner rows exactly (one arithmetic on the
    CPU): the tournament's containment argument holds there bit for bit."""
    q, e = (torch.from_numpy(a) for a in data(3, 4, 600, 8))
    gi = torch.tensor([[0, 2], [1, 4], [3, 4], [0, 1]])
    got = tournament_rerank(q, e, None, gi, 550, True)
    want = ordered_scores(q, e)
    want[:, 550:] = float("-inf")
    want[:, 0] = float("-inf")
    want = torch.cat([want, want.new_full((4, 640 - 600), float("-inf"))], dim=1)
    rows = (gi[:, :, None] * GROUP + torch.arange(GROUP)).reshape(4, -1)
    assert torch.equal(got, torch.gather(want, 1, rows))
    at = rows.clamp(max=599)
    assert torch.equal(ordered_scores_at(q, e, at), torch.gather(ordered_scores(q, e), 1, at))


@pytest.mark.parametrize("case", ["ids int32", "ids on another shape", "ids not contiguous",
                                  "queries float64", "index not contiguous",
                                  "query and index widths differ", "int8 without scales"])
def test_rerank_wrapper_raises_on_what_it_does_not_take(case):
    """The checks the wrapper makes before launching the kernel (run here on
    CPU tensors, as on the card)."""
    q = torch.zeros(3, 8)
    e = torch.zeros(300, 8)
    gi = torch.zeros(3, 2, dtype=torch.int64)
    scales = None
    if case == "ids int32":
        gi = gi.int()
    elif case == "ids on another shape":
        gi = torch.zeros(2, 2, dtype=torch.int64)
    elif case == "ids not contiguous":
        gi = torch.zeros(2, 3, dtype=torch.int64).t()
    elif case == "queries float64":
        q = q.double()
    elif case == "index not contiguous":
        e = torch.zeros(8, 300).t()
    elif case == "query and index widths differ":
        q = torch.zeros(3, 200)
    else:
        e = e.to(torch.int8)
    with pytest.raises((TypeError, ValueError)):
        if case == "int8 without scales":
            rt._unpack(e)
        rt._rerank_operands(q, e, scales, gi)


@pytest.mark.parametrize("d", [130, 256, 300])
def test_rerank_wrapper_takes_rows_wider_than_128(d):
    """Rows of any width pass the checks (the kernels walk 128-column
    chunks); the wrapper's plain version scores them in index order."""
    q, e = (torch.from_numpy(a) for a in data(d, 3, 400, d))
    gi = torch.tensor([[0, 2], [1, 3], [0, 1]])
    rt._rerank_operands(q, e, None, gi)
    got = tournament_rerank(q, e, None, gi, 400, True)
    want = torch.cat([ordered_scores(q, e), q.new_full((3, 112), float("-inf"))], dim=1)
    want[:, 0] = float("-inf")
    rows = (gi[:, :, None] * GROUP + torch.arange(GROUP)).reshape(3, -1)
    assert torch.equal(got, torch.gather(want, 1, rows))


def test_rerank_wrapper_refuses_other_devices():
    q = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tournament_rerank(q, torch.zeros(8, 4, device="meta"), None,
                          torch.zeros(2, 1, dtype=torch.int64, device="meta"), 8, True)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("b", [1, 33, 256])
@pytest.mark.parametrize("k", [10, 562])
@pytest.mark.parametrize("r", [100_000, 10_000_000])
def test_stream_plan_is_bounded(itemsize, b, k, r):
    p = stream_plan(k, b, r, 64, itemsize)
    assert 1 <= p.per_warp <= min(8, b) and 1 <= p.groups <= 8
    assert (p.groups - 1) * p.per_warp < b  # no empty query group
    assert p.slack >= 64 and p.slots >= 2
    assert p.rows_per_split % 128 == 0 and p.splits * p.rows_per_split >= r
    assert (p.splits - 1) * p.rows_per_split < r  # no empty split
    # at least 1024 rows and _K3_SPLIT_K k, or 256 where that left half the card idle
    idle = -(-b // p.qb) * -(-r // max(1024, rt._K3_SPLIT_K * k)) < rt._K3_SMS // 2
    assert p.rows_per_split >= (256 if idle else max(1024, rt._K3_SPLIT_K * k))
    assert p.scratch_bytes == b * p.splits * k * 8
    assert p.scratch_bytes <= (b + 4 * rt._K3_SMS * p.qb) * k * 8 <= 512 << 20
    smem = rt._k3_select_smem(k, p.groups, p.per_warp, p.slack, p.slots, 64, itemsize)
    assert smem <= rt._K3_SMEM_TARGET <= 232_448
    # ten times the rows: the same scratch, or at most what fills the card
    assert stream_plan(k, b, 10 * r, 64, itemsize).scratch_bytes <= max(
        p.scratch_bytes, (b + 4 * rt._K3_SMS * p.qb) * k * 8)


def test_stream_plan_at_the_serving_shapes():
    """10M rows, B = 256, k = 562 (the 10M slice's stage 1 by the stream):
    tens of MB of scratch (the splits of four waves of 132 blocks), where
    the merge tree took ~17 GB; MAX_K fits one query per warp and one warp
    per block."""
    p = stream_plan(562, 256, 10_000_000, 64, 1)
    qblocks = -(-256 // p.qb)
    smem = rt._k3_select_smem(562, p.groups, p.per_warp, p.slack, p.slots, 64, 1)
    waves = -(-rt._K3_SMS * rt._k3_blocks_per_sm(smem, p.groups) * rt._K3_WAVES_BIG_K // qblocks)
    assert p.scratch_bytes == 256 * 562 * 8 * p.splits <= 256 * 562 * 8 * waves
    assert p.scratch_bytes <= (256 + 4 * rt._K3_SMS * p.qb) * 562 * 8
    assert p.qb >= 8
    for itemsize in (1, 2, 4):
        big = stream_plan(rt.MAX_K, 1, 10_000_000, 64, itemsize)
        assert big.qb == 1 and big.groups == 1
        assert rt._k3_select_smem(rt.MAX_K, 1, 1, big.slack, big.slots, 64, itemsize) <= 232_448
        wide = stream_plan(rt.MAX_K, 3, 40_000, 256, itemsize)  # rows in 128-column chunks
        assert rt._k3_select_smem(rt.MAX_K, wide.groups, wide.per_warp, wide.slack, wide.slots,
                                  256, itemsize) <= 232_448


@pytest.mark.parametrize("itemsize,slots", [(2, 6), (1, 12)])
def test_stream_plan_at_the_retrieval_monitor_shape(itemsize, slots):
    """The 10M fit's retrieval monitor and final eval: [256, 64] queries
    over 468,273 seen rows (bf16, int8), k = 60. Eight groups of eight
    queries a block (the index read 4 times, where the old plan read it 64
    times at bf16), lists of k + 192 keys, the ring what shared memory
    leaves, one wave of 33 splits: 132 blocks."""
    p = stream_plan(60, 256, 468_273, 64, itemsize)
    assert p == rt.StreamPlan(groups=8, per_warp=8, slack=192, slots=slots, splits=33,
                              rows_per_split=14_208, scratch_bytes=256 * 33 * 60 * 8)
    assert -(-256 // p.qb) * p.splits == 132
    assert rt._k3_select_smem(60, p.groups, p.per_warp, p.slack, p.slots, 64,
                              itemsize) <= 232_448


def test_compare_within_order_tol_accepts_near_ties_and_refuses_the_rest():
    q, e = (torch.from_numpy(a) for a in data(5, 2, 300, 8))
    e[20] = e[10] * (1 + 1e-7)  # a near-tie of rows 10 and 20
    pv, pi = rt.catalog_topk_plain(q, e, 5)
    assert compare_within_order_tol(pv, pi, pv, pi, q, e) == (0.0, 0)
    s = ordered_scores(q, e)
    # swap the near-tie into the plain answer's place, if it is there
    v, i = pv.clone(), pi.clone()
    for row in range(2):
        for j in range(5):
            if int(pi[row, j]) in (10, 20):
                i[row, j] = 30 - int(pi[row, j])
                v[row, j] = s[row, i[row, j]]
    compare_within_order_tol(v, i, pv, pi, q, e)
    far = pi.clone()
    far[0, 0] = int(torch.argsort(s[0])[0])  # the lowest score: not a near-tie
    with pytest.raises(ValueError, match="not near-ties"):
        compare_within_order_tol(pv, far, pv, pi, q, e)
    with pytest.raises(ValueError, match="bound"):
        compare_within_order_tol(pv + 1e-2, pi, pv, pi, q, e)
    with pytest.raises(ValueError, match="-inf"):
        compare_within_order_tol(torch.full_like(pv, float("-inf")), pi, pv, pi, q, e)


def test_score_magnitude_is_the_sum_of_absolute_products():
    q, e = data(6, 3, 50, 16)
    qi = rt.quantize_index(torch.from_numpy(e))
    rows = torch.tensor([[0, 5, 49], [1, 1, 2], [7, 8, 9]])
    got = score_magnitude_at(torch.from_numpy(q), qi, rows).double().numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).double().abs().numpy()
    mag = qb @ np.abs(qi.qvals.double().numpy().T) * qi.scales.double().numpy()
    np.testing.assert_allclose(got, np.take_along_axis(mag, rows.numpy(), 1), rtol=1e-6)
    assert isinstance(qi, QuantizedIndex)
