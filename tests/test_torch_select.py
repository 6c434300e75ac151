"""The port's plain selection (``retrieval_topk.select_topk_plain``, the one
plain order behind ``stable_desc``, ``_top_k`` and
``parallel.retrieval.stable_topk``) against ``jax.lax.top_k``, which the
JAX package's tournament calls for its stage 2 and its final top-k
(``carca_tpu/ops/retrieval_topk.py:444,453,481,520``).

Exact: values bit for bit (the sign of zero included) and positions, on
numpy inputs from a seed. ``lax.top_k`` orders floats totally (+0.0 above
−0.0) and ties to the lowest position. The select kernel
(``csrc/select_topk.cu``) is held to this plain version on the card
(``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carca_tpu.ops.retrieval_topk as jrt
from carca_tpu_torch.ops import retrieval_topk as rt
from carca_tpu_torch.ops import _build, launches
from carca_tpu_torch.ops.retrieval_topk import (GROUP, MAX_K, TOURNAMENT_MAX_K, catalog_topk,
                                                ordered_scores, resolve_method, select_plan,
                                                select_topk, select_topk_plain)
from carca_tpu_torch.parallel.retrieval import stable_topk

torch.set_num_threads(1)

N = 300


def rows(kind: str, b: int = 5, n: int = N, seed: int = 0) -> np.ndarray:
    """[b, n] float32 rows of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "signed_zeros":  # mostly ±0.0, some ±1, a few 2 and -inf
        x = rng.choice(np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, 2.0, -np.inf], np.float32),
                       (b, n))
    elif kind == "all_equal":
        x = np.full((b, n), 0.5, np.float32)
        x[1] = -0.0
        x[2] = -np.inf
    elif kind == "half_neg_inf":
        x = rng.standard_normal((b, n)).astype(np.float32)
        x[:, ::2] = -np.inf
    else:  # distinct values with repeats
        x = rng.standard_normal((b, n)).astype(np.float32)
        x[:, 10:40] = x[:, 7:8]
    return x.astype(np.float32)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def jax_top_k(x: np.ndarray, k: int):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


KINDS = ["signed_zeros", "all_equal", "half_neg_inf", "normal"]


def test_the_signed_zero_row_orders_as_lax_top_k():
    x = np.array([[0.0, -0.0, 0.0, -0.0, -np.inf, 1.0, -np.inf]], np.float32)
    _, want = jax_top_k(x, 7)
    np.testing.assert_array_equal(want, [[5, 0, 2, 1, 3, 4, 6]])
    v, ids = select_topk_plain(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(rt.stable_desc(torch.from_numpy(x), 7).numpy(), want)
    np.testing.assert_array_equal(bits(v.numpy()), bits(x[0, want[0]])[None])
    np.testing.assert_array_equal(ids.numpy(), [[5, 0, 2, 1, 3, 0, 0]])  # -inf slots: id 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 7, 150, N])
def test_select_plain_equals_lax_top_k(kind, k):
    """Value mode: values bit for bit, ids the positions (0 where −inf)."""
    x = rows(kind, seed=k)
    jv, ji = jax_top_k(x, k)
    v, ids = select_topk_plain(torch.from_numpy(x), k, id_offset=3)
    np.testing.assert_array_equal(bits(v.numpy()), bits(jv))
    np.testing.assert_array_equal(ids.numpy(), np.where(jv > -np.inf, ji + 3, 0))


@pytest.mark.parametrize("kind", KINDS)
def test_select_plain_pads_past_the_row(kind):
    """k > N: lax.top_k's N, then (−inf, id 0) slots, as ``_top_k`` pads."""
    x = rows(kind, b=3, n=40, seed=5)
    jv, ji = jax_top_k(x, 40)
    v, ids = select_topk_plain(torch.from_numpy(x), 45)
    np.testing.assert_array_equal(bits(v[:, :40].numpy()), bits(jv))
    np.testing.assert_array_equal(ids[:, :40].numpy(), np.where(jv > -np.inf, ji, 0))
    assert np.isneginf(v[:, 40:].numpy()).all() and (ids[:, 40:] == 0).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 68, N])
def test_select_plain_positions_equal_the_sorted_lax_top_k(kind, k):
    """Position mode (stage 2's): jnp.sort(lax.top_k(x, k)[1])."""
    x = rows(kind, seed=k + 1)
    want = np.asarray(jnp.sort(jax.lax.top_k(jnp.asarray(x), k)[1], axis=1))
    got = select_topk_plain(torch.from_numpy(x), k, positions_sorted=True)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_select_plain_ids_from_winner_groups_equal_the_jax_tournament(kind):
    """Value mode with the winner groups: the JAX tournament's last lines
    (carca_tpu/ops/retrieval_topk.py:516-523) on the same scores."""
    rng = np.random.default_rng(9)
    b, kg, k, off = 4, 3, 50, 1000
    gi = np.sort(np.stack([rng.choice(20, kg, replace=False) for _ in range(b)]), axis=1)
    s = rows(kind, b=b, n=kg * GROUP, seed=2)
    lids = (gi[:, :, None] * GROUP + np.arange(GROUP)).reshape(b, -1)
    jv, sel = jax_top_k(s, k)
    want = np.where(jv > -np.inf, np.take_along_axis(lids, sel, axis=1) + off, 0)
    v, ids = select_topk_plain(torch.from_numpy(s), k, gi=torch.from_numpy(gi), id_offset=off)
    np.testing.assert_array_equal(bits(v.numpy()), bits(jv))
    np.testing.assert_array_equal(ids.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_stable_topk_is_the_same_order(kind):
    """The recommender's rerank, ``filter_excluded`` and the shard merge
    select with ``stable_topk``: lax.top_k's values and positions."""
    x = rows(kind, seed=3)
    jv, ji = jax_top_k(x, 60)
    v, pos = stable_topk(torch.from_numpy(x), 60)
    np.testing.assert_array_equal(bits(v.numpy()), bits(jv))
    np.testing.assert_array_equal(pos.numpy(), ji)


def test_select_topk_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(rows("signed_zeros", seed=4))
    before = dict(select_topk.launches)
    for kw in ({}, dict(positions_sorted=True), dict(id_offset=7)):
        got, want = select_topk(x.t().contiguous().t(), 20, **kw), select_topk_plain(x, 20, **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               w.view(torch.int32) if w.is_floating_point() else w)
    assert select_topk.launches == before
    with pytest.raises(ValueError, match="positions of k=301"):
        select_topk(x, N + 1, positions_sorted=True)


SELECT_PLAN_CASES = [(1, 78_126, 570), (8, 78_126, 570), (64, 78_126, 570), (256, 78_126, 570),
                     (256, 72_960, 562), (256, 78_126, 68), (256, 8_704, 60), (1, 1, 1),
                     (257, 127, 132), (3, 1_000_000, MAX_K)]


@pytest.mark.parametrize("column", [False, True])
@pytest.mark.parametrize("b,n,k", SELECT_PLAN_CASES)
def test_select_plan_covers_every_value_once(b, n, k, column):
    """Every value in exactly one split, no split empty, each split at
    least the plan's least (or the whole row); 1, 2, 4 or 8 queries a
    block, 4 or 8 over a column-major read (a tensor copy's box of half or
    a whole 32-byte sector a row); the block's lists and ring fit its
    shared memory."""
    p = select_plan(b, n, k, column)
    assert p.splits >= 1 and p.splits * p.per_split >= n > (p.splits - 1) * p.per_split
    want = max(rt._SELECT_SPLIT_MIN, rt._SELECT_SPLIT_K * k)  # a split's values, at least
    assert p.per_split >= min(n, want)
    assert p.queries in (1, 2, 4, 8) and 2 <= p.slots <= rt._SELECT_MAX_SLOTS
    if column and k <= 1_024:
        assert p.queries in (4, 8)
    assert rt._select_smem(k, p.queries, p.slots) <= _build.SMEM_LIMIT
    if p.splits > 1:  # the merge gathers the splits' k largest into the ring
        assert p.splits * k <= p.slots * rt._SELECT_SLOT_BYTES // 8


@pytest.mark.parametrize("b,n,k", SELECT_PLAN_CASES + [(1, 10_000_000, 1), (1, 2_000_000_000, 10),
                                                       (8, 78_126, 570), (2, 50_000, 16)])
@pytest.mark.parametrize("column", [False, True])
def test_select_plan_clusters_never_exceed_8_blocks(b, n, k, column):
    """A query group's splits are one thread-block cluster: at most 8
    blocks, the portable size, however long the row; a long row at B = 1
    gets 8 longer splits, not more of them, and the launch stays about
    one block an SM (query groups x splits <= 132 where B allows)."""
    p = select_plan(b, n, k, column)
    assert 1 <= p.splits <= 8
    groups = -(-b // p.queries)
    assert p.splits == 1 or groups <= rt._SELECT_RESIDENT_CLUSTERS[p.splits]  # one wave
    if b == 1 and n >= 8 * max(rt._SELECT_SPLIT_MIN, rt._SELECT_SPLIT_K * k):
        assert p.splits == 8 and p.per_split >= n // 8


@pytest.mark.parametrize("recursive", [False, True])
def test_tournament_zero_scores_match_jax_and_the_stream(monkeypatch, recursive):
    """Negative integer queries against rows of which a third are all
    zero: the products are −0.0, but the ordered sum starts at +0.0, so every zero
    score is +0.0 (no −0.0 reaches a selection from scoring) and ties to
    the lowest id, as in lax.top_k; the tournament equals the JAX package's
    and the port's stream."""
    if recursive:
        monkeypatch.setattr(jrt, "_RECURSIVE_MIN_GROUPS", 1)
        monkeypatch.setattr(rt, "_RECURSIVE_MIN_GROUPS", 1)
    rng = np.random.default_rng(17)
    q = -rng.integers(1, 4, (4, 8)).astype(np.float32)  # integers: sums exact on both sides
    e = rng.integers(1, 4, (900, 8)).astype(np.float32)
    e[::3] = 0.0
    e[1::3] *= -1  # positive scores; the rest negative
    s = ordered_scores(torch.from_numpy(q), torch.from_numpy(e))
    assert bool((s[:, ::3] == 0).all()) and not bool(torch.signbit(s[:, ::3]).any())
    k = 400  # past the 300 positive scores: into the zero ties
    jv, ji = jrt.catalog_topk(jnp.asarray(q), jnp.asarray(e), k, method="tournament")
    tv, ti = catalog_topk(torch.from_numpy(q), torch.from_numpy(e), k, method="tournament")
    sv, si = catalog_topk(torch.from_numpy(q), torch.from_numpy(e), k, method="stream")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), si.numpy())
    np.testing.assert_array_equal(bits(tv.numpy()), bits(sv.numpy()))
    np.testing.assert_array_equal(ti[:, 300:].numpy(),
                                  np.broadcast_to(np.arange(3, 303, 3), (4, 100)))


def test_select_launches_counted_by_mode():
    """The select kernel's counter keeps stage 2's position mode and the
    final k's value mode apart through snapshot, add, since and report."""
    saved = launches.snapshot()
    try:
        launches.reset()
        assert select_topk.launches == {"positions": 0, "values": 0}
        launches.add(launches.Launches(select_topk={"positions": 3, "values": 2}))
        now = launches.snapshot()
        launches.add(launches.Launches(select_topk={"values": 1}))
        assert launches.since(now).select_topk == {"positions": 0, "values": 1}
        report = launches.report()
        assert (report["select_topk_positions"], report["select_topk_values"]) == (3, 3)
        assert "select_topk" not in report
    finally:
        launches.restore(saved)


@pytest.mark.parametrize("k", [TOURNAMENT_MAX_K - 1, TOURNAMENT_MAX_K, TOURNAMENT_MAX_K + 1,
                               MAX_K])
def test_auto_keeps_k_the_tournament_takes_on_the_card(k):
    """Over 10M rows "auto" picks the tournament up to TOURNAMENT_MAX_K =
    MAX_K - 8 (its stage 2 selects k + 8 groups, the select kernel at most
    MAX_K) and the stream, which takes k up to MAX_K, past it."""
    assert TOURNAMENT_MAX_K == MAX_K - 8
    want = "tournament" if k <= TOURNAMENT_MAX_K else "stream"
    assert resolve_method("auto", 10_000_000, k, 256) == want
