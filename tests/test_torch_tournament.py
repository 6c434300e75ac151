"""The port's tournament top-k and its bf16/int8 indexes (plain versions, on
CPU tensors) against the JAX package's Pallas kernels in interpret mode.

* Tournament (flat, and recursive with both packages'
  ``_RECURSIVE_MIN_GROUPS`` forced to 1) against JAX's
  ``catalog_topk(method="tournament", chunk=256)`` at f32, bf16 and int8:
  ids equal, values within rtol 1e-5 / atol 1e-6 (``tests/test_retrieval.py``'s
  own tolerance; both score true f32 values, summed in other orders).
* Exact ties across group boundaries, ``id_offset``/``n_items``, k beyond
  the valid rows; the tournament equal to the stream, ids and values.
* The bf16/int8 stream against JAX's packed stream, under its 2⁻¹¹
  contract: JAX's values are ≤ the port's true scores and within 2⁻¹¹ of
  them relative; ids differ only between scores within that window.
* ``Recommender(quantize=True | "auto")``, ``topk_given_queries`` over a
  ``QuantizedIndex``, ``embed_catalog(out_dtype=)``, ``queries`` and the
  single-device ``full_catalog_topk`` against the JAX package.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import carca_tpu.ops.retrieval_topk as jrt
import carca_tpu_torch.ops.retrieval_topk as rt
from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.models.carca import carca_init
from carca_tpu.serve.recommender import Recommender as JaxRecommender
from carca_tpu_torch.bridge import load_into, model_config_from_jax
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops.retrieval_topk import (GROUP, QuantizedIndex, catalog_topk,
                                                groupmax_branch, groupmax_plain,
                                                ordered_scores)
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
PACK_REL = 2.0 ** -11  # the JAX packed stream's value truncation, relative


def indexes(e: np.ndarray, kind: str):
    """(JAX index, port index) holding the same values: bf16 rounded once
    (nearest even on both sides), int8 quantized by the JAX package."""
    if kind == "f32":
        return jnp.asarray(e), torch.from_numpy(e)
    if kind == "bf16":
        return jnp.asarray(e).astype(jnp.bfloat16), torch.from_numpy(e).to(torch.bfloat16)
    qi = jrt.quantize_index(jnp.asarray(e))
    return qi, QuantizedIndex(torch.from_numpy(np.array(qi.qvals)),
                              torch.from_numpy(np.array(qi.scales)))


def data(seed, b, r, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((r, d)).astype(np.float32))


def both(q, e, k, kind, method="tournament", **kw):
    je, te = indexes(e, kind)
    jv, ji = jrt.catalog_topk(jnp.asarray(q), je, k, chunk=256, method=method, **kw)
    tv, ti = catalog_topk(torch.from_numpy(q), te, k, method=method, **kw)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


CASES = [  # (r, b, d, k, id_offset, n_items)
    (1000, 8, 16, 10, 0, None), (517, 4, 32, 7, 0, None), (777, 8, 16, 5, 777, 1554),
    (3000, 4, 16, 12, 0, 2500), (300, 3, 8, 290, 0, 250)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"r{c[0]}_k{c[3]}_off{c[4]}")
def test_tournament_matches_jax(kind, case):
    r, b, d, k, off, n_items = case
    q, e = data(r + k, b, r, d)
    q[1] = 0.0  # a zero query (batch padding): every score 0, the lowest ids
    jv, ji, tv, ti = both(q, e, k, kind, n_items=n_items or off + r, id_offset=off)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    # the tournament returns the port's stream answer exactly
    sv, si = catalog_topk(torch.from_numpy(q), indexes(e, kind)[1], k, method="stream",
                          n_items=n_items or off + r, id_offset=off)
    np.testing.assert_array_equal(ti, si.numpy())
    np.testing.assert_array_equal(tv, sv.numpy())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4], (33000, 4, 8, 9, 0, None)],
                         ids=lambda c: f"r{c[0]}_k{c[3]}")
def test_recursive_tournament_matches_jax(monkeypatch, kind, case):
    monkeypatch.setattr(jrt, "_RECURSIVE_MIN_GROUPS", 1)
    monkeypatch.setattr(rt, "_RECURSIVE_MIN_GROUPS", 1)
    r, b, d, k, off, n_items = case
    q, e = data(r + 2 * k, b, r, d)
    jv, ji, tv, ti = both(q, e, k, kind, n_items=n_items or off + r, id_offset=off)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("recursive", [False, True])
def test_tournament_exact_under_ties_across_groups(monkeypatch, recursive):
    """Integer scores, exact in f32 on both sides, many of them equal and
    straddling group boundaries: lax.top_k's first-occurrence order."""
    if recursive:
        monkeypatch.setattr(jrt, "_RECURSIVE_MIN_GROUPS", 1)
        monkeypatch.setattr(rt, "_RECURSIVE_MIN_GROUPS", 1)
    rng = np.random.default_rng(11)
    e = rng.integers(0, 3, (1500, 4)).astype(np.float32)
    e[GROUP - 10:GROUP + 10] = e[3]  # duplicates across the first boundary
    q = rng.integers(0, 3, (6, 4)).astype(np.float32)
    jv, ji, tv, ti = both(q, e, 40, "f32")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    s = q @ e.T
    s[:, 0] = -np.inf
    for row in range(6):
        np.testing.assert_array_equal(ti[row], np.argsort(-s[row], kind="stable")[:40])


def test_k_beyond_valid_rows_gives_neg_inf_slots():
    q, e = data(5, 3, 200, 8)
    jv, ji, tv, ti = both(q, e, 180, "int8", n_items=150)  # 149 valid rows
    np.testing.assert_array_equal(ti, ji)
    assert np.isneginf(tv[:, 149:]).all() and (ti[:, 149:] == 0).all()
    assert np.isfinite(tv[:, :149]).all()


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_groupmax_plain_is_the_max_of_ordered_scores(kind, layout):
    """Stage 1's plain version: the masked scores' maximum per 128-row
    group; layout 1 is layout 0 transposed and −inf-padded to a multiple of
    128 groups."""
    q, e = data(6, 5, 700, 16)
    te = indexes(e, kind)[1]
    rows, scales = (te.qvals, te.scales) if kind == "int8" else (te, None)
    s = ordered_scores(torch.from_numpy(q), te).numpy()
    s[:, 600:] = -np.inf  # lim0 = 600
    s[:, 0] = -np.inf
    s = np.pad(s, ((0, 0), (0, 768 - 700)), constant_values=-np.inf)
    want = s.reshape(5, 6, GROUP).max(axis=2)
    got = groupmax_plain(torch.from_numpy(q), rows, scales, 600, True, layout).numpy()
    if layout == 0:
        np.testing.assert_array_equal(got, want.T)
    else:
        assert got.shape == (5, GROUP)
        np.testing.assert_array_equal(got[:, :6], want)
        assert np.isneginf(got[:, 6:]).all()


def jax_stage1(q: np.ndarray, index, lim0: int, mask_row0: bool, layout: int) -> np.ndarray:
    """The JAX package's stage 1 as its ``_tournament_topk`` calls it, in
    interpret mode: B4 (``_groupmax_kernel``, layout 0, [G, B]) or B5
    (``_groupmax_bq_kernel``, layout 1, [B, G'], G' a multiple of 128), over
    chunks of 8 groups (B5: 8 programs share each 128-group output block),
    the index zero-padded to whole chunks, a batch below 8 padded to 8."""
    rows, scales = (index.qvals, index.scales) if isinstance(index, jrt.QuantizedIndex) \
        else (index, None)
    b_req, d = q.shape
    r = rows.shape[0]
    qj = jnp.pad(jnp.asarray(q), ((0, max(0, 8 - b_req)), (0, 0)))
    b = qj.shape[0]
    c = 8 * GROUP
    rp = -(-r // (GROUP * GROUP if layout else c)) * (GROUP * GROUP if layout else c)
    rows = jnp.pad(rows, ((0, rp - r), (0, 0)))
    lim = jnp.asarray([lim0, int(mask_row0)], jnp.int32)
    specs = [pl.BlockSpec(memory_space=pltpu.SMEM),
             pl.BlockSpec((b, d), lambda j: (0, 0), memory_space=pltpu.VMEM),
             pl.BlockSpec((c, d), lambda j: (j, 0), memory_space=pltpu.VMEM)]
    args = [lim, qj, rows]
    n_groups = rp // GROUP
    if layout == 1:
        if scales is not None:
            specs.append(pl.BlockSpec((1, c), lambda j: (0, j), memory_space=pltpu.VMEM))
            args.append(jnp.pad(scales, ((0, 0), (0, rp - r))))
        out = pl.pallas_call(
            functools.partial(jrt._groupmax_bq_kernel, c, GROUP, GROUP // 8), grid=(rp // c,),
            in_specs=specs,
            out_specs=pl.BlockSpec((b, 128), lambda j: (0, j // (GROUP // 8)),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((b, n_groups), jnp.float32), interpret=True)(*args)
        return np.asarray(out)[:b_req]
    if scales is not None:
        specs.append(pl.BlockSpec((c, 1), lambda j: (j, 0), memory_space=pltpu.VMEM))
        args.append(jnp.pad(scales, ((0, 0), (0, rp - r))).reshape(-1, 1))
    out = pl.pallas_call(
        functools.partial(jrt._groupmax_kernel, c, GROUP), grid=(rp // c,), in_specs=specs,
        out_specs=pl.BlockSpec((c // GROUP, b), lambda j: (j, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_groups, b), jnp.float32), interpret=True)(*args)
    return np.asarray(out)[:, :b_req]


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,r,d,lim0,mask_row0", [
    (1, 63, 16, 63, True), (8, 65, 16, 60, True), (64, 127, 16, 127, False),
    (65, 129, 32, 129, True), (129, 255, 16, 200, True), (257, 257, 8, 257, False),
    (33, 1_025, 128, 1_000, True)])
def test_groupmax_plain_matches_jax_stage1(kind, layout, b, r, d, lim0, mask_row0):
    """K4's plain version against the JAX package's B4 and B5 (interpret
    mode) at the warpgroup kernel's edges: batches around its products and
    query sets (8 to 257), rows one either side of its 64-row tiles and
    128-row slots, lim0 inside a tile, 128 columns: the same -inf groups,
    maxima within rtol 1e-5 / atol 1e-6 (two summation orders). Groups past
    the index are -inf in both."""
    q, e = data(b * 7 + r, b, r, d)
    q[0] = 0.0
    e[40:70] = e[1]  # ties across a tile boundary
    je, te = indexes(e, kind)
    rows, scales = (te.qvals, te.scales) if kind == "int8" else (te, None)
    got = groupmax_plain(torch.from_numpy(q), rows, scales, lim0, mask_row0, layout).numpy()
    want = jax_stage1(q, je, lim0, mask_row0, layout)
    g = -(-r // GROUP)
    if layout == 0:
        assert got.shape == (g, b)
        assert np.isneginf(want[g:]).all()
        want = want[:g]
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.int8, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.int8, 1, "wgmma"), (torch.int8, 100, "wgmma"), (torch.bfloat16, 50, "wgmma"),
    (torch.float32, 64, "mma"), (torch.float32, 128, "mma"), (torch.float32, 1, "mma"),
    (torch.bfloat16, 129, "wide"), (torch.int8, 256, "wide"), (torch.float32, 256, "wide")])
def test_groupmax_branch_routes_by_type_and_width(dtype, d, want):
    """The rule for which K4 kernel runs (csrc/groupmax.cu keeps the same
    rule beside the launch; a card test holds the two equal): warpgroup
    products for bf16 and int8 rows of up to 128 columns, 3xTF32 on
    mma.sync for f32 rows, 128-column chunks past 128 columns."""
    assert groupmax_branch(dtype, d) == want


def test_groupmax_branch_raises_on_other_types():
    with pytest.raises(TypeError):
        groupmax_branch(torch.float16, 64)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_ordered_scores_round_the_query_to_bf16(kind):
    """Against a bf16 or int8 index the query operand is bf16, the products
    exact, and an int8 row's scale multiplies the finished sum — JAX's
    dot(bf16(q), bf16(rows)) in f32, times the scale."""
    q, e = data(7, 4, 300, 32)
    je, te = indexes(e, kind)
    rows = je.qvals if kind == "int8" else je
    want = jnp.einsum("bd,rd->br", jnp.asarray(q).astype(jnp.bfloat16),
                      rows.astype(jnp.bfloat16), preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if kind == "int8":
        want = want * je.scales[0][None, :]
    got = ordered_scores(torch.from_numpy(q), te).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("k", [5, 40])
def test_stream_meets_the_packed_contract_of_jax(kind, k):
    q, e = data(8 + k, 6, 2000, 16)
    q[2] = 0.0
    jv, ji, tv, ti = both(q, e, k, kind, method="stream")
    true = ordered_scores(torch.from_numpy(q), indexes(e, kind)[1]).numpy()
    slack = ATOL + RTOL * np.abs(tv)  # summation order
    assert (jv <= tv + slack).all()
    assert (tv - jv <= PACK_REL * np.abs(tv) + slack).all()
    for row in range(q.shape[0]):
        diff = ti[row] != ji[row]
        gap = np.abs(true[row, ti[row][diff]] - true[row, ji[row][diff]])
        assert (gap <= PACK_REL * np.abs(tv[row][diff]) + slack[row][diff]).all()
        # the port's own ids are the exact order of its true scores
        order = np.argsort(-np.where(np.arange(2000) == 0, -np.inf, true[row]),
                           kind="stable")[:k]
        np.testing.assert_array_equal(ti[row], order)


def test_auto_routes_on_rows_and_k():
    rows, rows_big_k, batch = (rt._TOURNAMENT_MIN_ROWS, rt._TOURNAMENT_MIN_ROWS_BIG_K,
                               rt._TOURNAMENT_MIN_BATCH)
    assert rows <= rows_big_k and batch > 1
    assert rt.resolve_method("auto", rows - 1, 10, batch) == "stream"
    assert rt.resolve_method("auto", rows, 10, batch) == "tournament"
    assert rt.resolve_method("auto", rows, 10, 256) == "tournament"
    # a small batch at a small k keeps the stream at any row count
    assert rt.resolve_method("auto", rows, 10, batch - 1) == "stream"
    assert rt.resolve_method("auto", 10 ** 9, 10, 1) == "stream"
    # a large k reads the rows alone: a small batch takes the tournament too
    assert rt.resolve_method("auto", rows_big_k, rt.BIG_K - 1, batch - 1) == "stream"
    assert rt.resolve_method("auto", rows_big_k - 1, rt.BIG_K, 256) == "stream"
    assert rt.resolve_method("auto", rows_big_k, rt.BIG_K, 256) == "tournament"
    assert rt.resolve_method("auto", rows_big_k, 562, 1) == "tournament"
    assert rt.resolve_method("auto", 2 * GROUP - 1, 10 ** 6, 256) == "stream"
    assert rt.resolve_method("stream", 10 ** 9, 10, 256) == "stream"
    with pytest.raises(ValueError, match="method"):
        rt.resolve_method("heap", 10, 1, 1)


@pytest.mark.parametrize("rows,k,batch,want", [
    (100_000, 10, 256, "stream"), (100_000, 10, 64, "stream"),
    (100_000, 562, 256, "stream"), (1_000_000, 562, 1, "tournament"),
    (10_000_000, 10, 8, "stream"), (10_000_000, 10, 1, "stream"),
    (10_000_000, 562, 256, "tournament"), (19_157, 562, 256, "stream"),
    (1_000_000, 10, 256, "tournament"), (100_000, 60, 256, "stream")])
def test_auto_at_the_measured_crossover(rows, k, batch, want):
    """The H100 sweep's winners after K3's redesign (PERF.md, Findings) at the
    cells "auto" routes: the 100k and 10M serving slices, the bench, small
    batches, and k = 60 (the retrieval monitor's) below 1M rows."""
    assert rt.resolve_method("auto", rows, k, batch) == want


# --------------------------------------------------------------------------
# serving and retrieval over an int8 index
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cat = synthetic_catalog(n_users=40, n_real_items=111, seed=11)
    jcfg = JaxModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16,
                          g=32, seq_len=8, target_len=10, n_blocks=1, n_heads=2,
                          dropout=0.0, embedding="all", decoder="ca")
    params = carca_init(jax.random.PRNGKey(2), jcfg)
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu"),
                      jax.tree.map(np.asarray, params)).eval()
    return cat, jcfg, params, model


HISTS = [[3, 9, 4], [17, 2], [1], [30, 8, 21, 5]]


@pytest.mark.parametrize("quantize", [True, "auto"])
def test_quantized_recommender_matches_jax(small, monkeypatch, quantize):
    """``quantize=True`` and "auto" (its threshold lowered below this
    catalog, as the JAX package's ≥ 1M rows cannot be lowered from outside)
    build an int8 index and recommend as the JAX package's int8
    Recommender does."""
    from carca_tpu_torch.serve import recommender as trec

    cat, jcfg, params, model = small
    monkeypatch.setattr(trec, "QUANTIZE_AUTO_MIN_ROWS", 100)
    kw = dict(shortlist=64, batch_buckets=(4,))
    jrec = JaxRecommender(params, jcfg, np.asarray(cat.attrs), quantize=True, **kw)
    rec = trec.Recommender(model, cat.attrs, quantize=quantize, **kw)
    assert isinstance(rec.catalog_emb, QuantizedIndex)
    assert rec.catalog_emb.qvals.dtype == torch.int8
    want_ids, want_s = jrec.recommend(HISTS, k=5)
    got_ids, got_s = rec.recommend(HISTS, k=5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=2e-5, atol=2e-5)
    # the exact rerank makes the int8 shortlist answer as the float index does
    f_ids, f_s = trec.Recommender(model, cat.attrs, **kw).recommend(HISTS, k=5)
    np.testing.assert_array_equal(got_ids, f_ids)
    np.testing.assert_allclose(got_s, f_s, rtol=1e-4, atol=1e-4)


def test_quantize_flag_is_strict(small):
    from carca_tpu_torch.serve.recommender import Recommender

    cat, _, _, model = small
    rec = Recommender(model, cat.attrs, quantize="auto", batch_buckets=(4,))
    assert rec.catalog_emb.dtype == torch.float32  # 112 rows: below the threshold
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="quantize"):
            Recommender(model, cat.attrs, quantize=bad)


@pytest.fixture(scope="module")
def dot_pair():
    cat = synthetic_catalog(n_users=40, n_real_items=400, seed=4)
    jcfg = JaxModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16,
                          g=32, seq_len=8, target_len=10, n_blocks=2, n_heads=2,
                          dropout=0.0, embedding="all", decoder="dot")
    params = carca_init(jax.random.PRNGKey(3), jcfg)
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu"),
                      jax.tree.map(np.asarray, params)).eval()
    rng = np.random.default_rng(0)
    p_x = rng.integers(0, cat.n_items, (8, 8)).astype(np.int32)
    p_c = rng.standard_normal((8, 8, cat.n_ctx)).astype(np.float32)
    return cat, jcfg, params, model, p_x, p_c


def test_queries_and_bf16_catalog_match_jax(dot_pair):
    from carca_tpu.parallel.retrieval import embed_catalog as jax_embed_catalog
    from carca_tpu.parallel.retrieval import queries as jax_queries
    from carca_tpu_torch.parallel.retrieval import embed_catalog, queries

    cat, jcfg, params, model, p_x, p_c = dot_pair
    attrs = torch.from_numpy(np.asarray(cat.attrs, np.float32))
    with torch.no_grad():
        q = queries(model, (torch.from_numpy(p_x), None, torch.from_numpy(p_c)), attrs)
        e16 = embed_catalog(model, attrs, out_dtype=torch.bfloat16)
    want_q = jax_queries(params, jcfg, (jnp.asarray(p_x), None, jnp.asarray(p_c)),
                         jnp.asarray(cat.attrs))
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), rtol=2e-5, atol=2e-5)
    want_e = jax_embed_catalog(params, jcfg, jnp.asarray(cat.attrs), out_dtype=jnp.bfloat16)
    assert e16.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) for f32 values that straddle a rounding point
    np.testing.assert_allclose(e16.float().numpy(), np.asarray(want_e, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("method", ["stream", "tournament"])
def test_full_catalog_topk_over_an_int8_index_matches_jax(dot_pair, method):
    """``full_catalog_topk`` on one device with an int8 ``catalog_emb`` and
    exclusions, against the JAX package's (JAX's stream packs its values;
    the tournament is compared on both sides)."""
    from carca_tpu.parallel.retrieval import embed_catalog as jax_embed_catalog
    from carca_tpu.parallel.retrieval import full_catalog_topk as jax_full_catalog_topk
    from carca_tpu_torch.parallel.retrieval import (embed_catalog, full_catalog_topk,
                                                    topk_given_queries)

    cat, jcfg, params, model, p_x, p_c = dot_pair
    attrs = torch.from_numpy(np.asarray(cat.attrs, np.float32))
    jqi = jrt.quantize_index(jax_embed_catalog(params, jcfg, jnp.asarray(cat.attrs)))
    qi = QuantizedIndex(torch.from_numpy(np.array(jqi.qvals)),
                        torch.from_numpy(np.array(jqi.scales)))
    profile = (torch.from_numpy(p_x), None, torch.from_numpy(p_c))
    with torch.no_grad():
        got_v, got_i = full_catalog_topk(model, profile, attrs, 7, catalog_emb=qi,
                                         exclude=profile[0], method="tournament")
        other_v, other_i = full_catalog_topk(model, profile, attrs, 7, catalog_emb=qi,
                                             exclude=profile[0], method=method)
        fv, fi = full_catalog_topk(model, profile, attrs, 7, exclude=profile[0])
        with pytest.raises(ValueError, match="decoder-space"):
            topk_given_queries(fv, qi, model.cfg, 3)
    np.testing.assert_array_equal(got_i.numpy(), other_i.numpy())
    np.testing.assert_array_equal(got_v.numpy(), other_v.numpy())
    jv, ji = jax_full_catalog_topk(params, jcfg, (jnp.asarray(p_x), None, jnp.asarray(p_c)),
                                   jnp.asarray(cat.attrs), 7, catalog_emb=jqi,
                                   exclude=jnp.asarray(p_x), method="tournament")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)
    for row in range(8):
        assert not set(got_i[row].tolist()) & set(p_x[row][p_x[row] > 0].tolist())
    # the float index (embedded here) agrees with JAX's float path
    jfv, jfi = jax_full_catalog_topk(params, jcfg, (jnp.asarray(p_x), None, jnp.asarray(p_c)),
                                     jnp.asarray(cat.attrs), 7, exclude=jnp.asarray(p_x))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(jfi))
    np.testing.assert_allclose(fv.numpy(), np.asarray(jfv), rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        e = embed_catalog(model, attrs)
    assert e.dtype == torch.float32 and e.shape == (cat.n_items, 16)
