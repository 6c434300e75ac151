"""The port's serving path against the JAX package's: the two-stage
``Recommender`` on the same weights (full and seen index; ``ca``, ``dot``
and ``wdot``), ``pad_histories``, the JSON-lines request loop, and the
synthetic catalog generator.

Ids must be equal; scores within 2e-5 (f32 summation order, as
``tests/test_serve.py``). The JAX Recommender runs its stage-1 Pallas
kernel in interpret mode, as its own tests do.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.models.carca import carca_init
from carca_tpu.serve.recommender import Recommender as JaxRecommender
from carca_tpu_torch.bridge import load_into, model_config_from_jax
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.serve.recommender import Recommender, pad_histories
from carca_tpu_torch.serve.service import HostCSR, serve_lines

torch.set_num_threads(1)

N_ITEMS = 97
TOL = 2e-5


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=N_ITEMS - 1, seed=3)


def histories_of(cat, users):
    return [cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist() for u in users]


def ctxs_of(cat, users):
    return [cat.ctx_vals[cat.offsets[u]:cat.offsets[u + 1]] for u in users]


def build_pair(cat, decoder, seed=1, **rec_kw):
    jcfg = JaxModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                          d=16, g=32, seq_len=8, target_len=10, n_blocks=2,
                          n_heads=2, dropout=0.0, embedding="all", decoder=decoder,
                          l2_norm=decoder == "wdot")
    params = carca_init(jax.random.PRNGKey(seed), jcfg)
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(jcfg))),
                      jax.tree.map(np.asarray, params))
    return (JaxRecommender(params, jcfg, cat.attrs, **rec_kw),
            Recommender(model, cat.attrs, **rec_kw))


@pytest.mark.parametrize("index", ["full", "seen"])
@pytest.mark.parametrize("decoder", ["ca", "dot", "wdot"])
def test_recommender_matches_jax(cat, decoder, index):
    index_ids = np.unique(cat.items) if index == "seen" else None
    jrec, rec = build_pair(cat, decoder, shortlist=24, batch_buckets=(1, 8),
                           index_ids=index_ids)
    users = list(range(5))
    hists, ctxs = histories_of(cat, users), ctxs_of(cat, users)
    rc = np.random.default_rng(0).standard_normal(cat.n_ctx).astype(np.float32)
    for kw in (dict(k=6), dict(k=4, ctxs=ctxs, request_ctx=rc)):
        want_ids, want_s = jrec.recommend(hists, **kw)
        got_ids, got_s = rec.recommend(hists, **kw)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_s, want_s, rtol=TOL, atol=TOL)
    # the size-1 bucket answers the same as row 0 of the batch
    ids1, _ = rec.recommend(hists[:1], k=6)
    np.testing.assert_array_equal(ids1[0], rec.recommend(hists, k=6)[0][0])


def test_score_candidates_matches_recommend(cat):
    jrec, rec = build_pair(cat, "ca", seed=2, shortlist=32, batch_buckets=(8,))
    hists = histories_of(cat, [0, 1, 2])
    ids, scores = rec.recommend(hists, k=5)
    np.testing.assert_allclose(rec.score_candidates(hists, ids), scores,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rec.score_candidates(hists, ids),
                               jrec.score_candidates(hists, ids), rtol=TOL, atol=TOL)


def test_small_catalog_neg_inf_slots_and_k_validation(cat):
    jrec, rec = build_pair(cat, "dot", seed=3, batch_buckets=(1,))
    hist = histories_of(cat, [0])[0]
    k = N_ITEMS - 2  # beyond the valid, non-excluded items → -inf tail
    got_ids, got_s = rec.recommend([hist], k=k)
    want_ids, want_s = jrec.recommend([hist], k=k)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=TOL, atol=TOL)
    assert not np.isfinite(got_s[0][-1])
    with pytest.raises(ValueError, match="exceeds the stage-1 index"):
        rec.recommend([hist], k=N_ITEMS + 5)


def test_pad_histories_right_aligned():
    p_x, p_c = pad_histories([[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9]],
                             seq_len=4, n_ctx=2)
    np.testing.assert_array_equal(p_x[0], [0, 5, 6, 7])
    np.testing.assert_array_equal(p_x[1], [6, 7, 8, 9])  # last seq_len kept
    assert p_c.shape == (2, 4, 2) and (p_c == 0).all()
    ctxs = [np.ones((3, 2)), np.full((9, 2), 2.0)]
    _, p_c = pad_histories([[5, 6, 7], list(range(1, 10))], 4, ctxs, 2)
    assert (p_c[0, 1:] == 1.0).all() and (p_c[0, 0] == 0).all()
    assert (p_c[1] == 2.0).all()
    p_x, _ = pad_histories([[]], 3)
    assert (p_x == 0).all()


def test_service_request_shapes(cat):
    jrec, rec = build_pair(cat, "ca", seed=4, shortlist=20, batch_buckets=(1,))
    host = HostCSR(cat)
    hist = histories_of(cat, [2])[0]
    lines = [
        json.dumps({"history": [3, 4, 5], "k": 4, "id": "a"}),
        json.dumps({"user": 1, "id": "b"}),
        json.dumps({"history": hist, "ctx": ctxs_of(cat, [2])[0].tolist(),
                    "request_ctx": [0.5] * cat.n_ctx, "id": 3}),
        "",
        "{not json",
        json.dumps({"user": 10_000, "id": "c"}),
        json.dumps({"history": [3], "k": 500}),  # capped at max_k
    ]
    out = list(serve_lines(rec, host, lines, k=3, max_k=6))
    assert len(out) == 6
    assert len(out[0]["items"]) == 4 and out[0]["id"] == "a"
    assert len(out[1]["items"]) == 3 and out[1]["id"] == "b"
    assert out[2]["id"] == 3 and len(out[2]["items"]) == 3
    assert "error" in out[3] and "id" not in out[3]
    assert "error" in out[4] and out[4]["id"] == "c"
    assert len(out[5]["items"]) == 6
    want_ids, want_s = jrec.recommend(
        [hist], k=3, ctxs=ctxs_of(cat, [2]),
        request_ctx=np.full(cat.n_ctx, 0.5, np.float32))
    assert out[2]["items"] == want_ids[0].tolist()
    np.testing.assert_allclose(out[2]["scores"], want_s[0], atol=TOL)
    for line in out:
        json.dumps(line, allow_nan=False)  # never -Infinity


def test_embed_catalog_matches_jax_and_chunks(cat):
    from carca_tpu.parallel.retrieval import embed_catalog as jax_embed_catalog
    from carca_tpu_torch.parallel.retrieval import embed_catalog

    jrec, rec = build_pair(cat, "dot", seed=5, batch_buckets=(1,))
    ids = np.array([0, 3, 9, 40, 96], np.int64)
    want = np.asarray(jax_embed_catalog(jrec.params, jrec.cfg, cat.attrs[ids],
                                        global_ids=ids.astype(np.int32)))
    rows = torch.from_numpy(cat.attrs[ids])
    with torch.no_grad():
        whole = embed_catalog(rec.model, rows, global_ids=torch.from_numpy(ids))
        chunked = embed_catalog(rec.model, rows, global_ids=torch.from_numpy(ids),
                                row_chunk=2)
    np.testing.assert_allclose(whole.numpy(), want, rtol=TOL, atol=TOL)
    # a GEMM over fewer rows may block its sums differently: f32 tolerance
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=TOL, atol=TOL)
    assert (whole[0] == 0).all()  # the pad id embeds to zero


def test_warmup_runs_every_bucket(cat):
    _, rec = build_pair(cat, "ca", seed=6, shortlist=16, batch_buckets=(2, 1))
    assert rec.batch_buckets == (1, 2)
    rec.warmup(k=3)
    ids, _ = rec.recommend(histories_of(cat, [0, 1, 2]), k=3)  # beyond every bucket
    assert ids.shape == (3, 3)


def test_run_bench_rows(cat):
    """One row per bucket. Throughput is users served over the whole timed
    window: at least half the calls take ≥ p50, so the window is at least
    iters/2 · p50 long."""
    from carca_tpu_torch.config import ModelConfig
    from carca_tpu_torch.serve.service import run_bench

    cfg = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                      d=16, g=32, seq_len=8, n_blocks=1, decoder="dot")
    rec = Recommender(CARCA(cfg, generator=torch.Generator().manual_seed(0)),
                      cat.attrs, batch_buckets=(1, 4))
    rows = run_bench(rec, HostCSR(cat), k=3, iters=4)
    assert [r["batch"] for r in rows] == [1, 4]
    for r in rows:
        assert 0 < r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
        assert 0 < r["throughput_users_per_sec"] <= 2 * r["batch"] / (r["p50_ms"] / 1e3)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_catalog_bit_identical_to_jax(seed):
    a = synthetic_catalog(n_users=50, n_real_items=200, seed=seed)
    b = jax_synthetic_catalog(n_users=50, n_real_items=200, seed=seed)
    for f in ("attrs", "user_ids", "items", "offsets", "ctx_vals"):
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.n_items, a.n_attrs, a.n_ctx, a.n_users) == (201, 12, 4, 50)
