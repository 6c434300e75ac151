"""Serving as one CUDA graph replay per (bucket, k) (``carca_tpu_torch/serve/
graph.py``) and the launch counters it keeps (``ops/launches.py``).

On the CPU (d = 16, L = 8, 97 items), where no graph runs, a stand-in
capture (``replayed``) records the body and runs it at each "replay", so
everything around the graph runs as on the card:

* (a) the body the graph captures — the eager call on the static regions'
  views — equals the JAX ``Recommender`` at buckets 1/8/64 for ``ca``,
  ``dot`` and ``wdot``, seen and full index, with and without a request
  context (``test_torch_serve.py``'s ``TOL``), and the port's eager call
  exactly; ``score_candidates`` the same;
* (b) a request packed into the input region reads back as the padded
  arrays at every bucket, with ``n_ctx = 0`` and oversized;
* (c) ``graph=True`` raises on a CPU model and with a mesh; ``graph=None``
  on the CPU runs eagerly;
* (d) the counter module's snapshot, restore, add and since cover all five
  counters, and a replay adds the captured launches once;
* (e) the graphs are keyed by (kind, bucket, k or n), and a replaced
  parameter, attrs table, index or row-id tensor drops them all.

On the card (``cuda`` marker, skipped here; run there with ``python -m
pytest --noconftest tests/test_torch_serve_graph.py -q -m cuda``): at
buckets 1/8/64/256 a replay equals the eager call (``graph=False``) bit
for bit, ids and scores, with equal kernel launches, over an f32 index
(stream) and a 1M-row int8 index at stage-1 k = 562 (tournament) and k =
10 (stream at buckets 1 and 8); ``score_candidates`` the same; two
requests replayed in turn each equal their eager answer; a replaced index
captures anew; a capture that meets a host sync raises, twice, and never
falls back.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from carca_tpu_torch.cli import launch_counts
from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops import launches
from carca_tpu_torch.ops.flash_attention import attention_bwd, fused_attention
from carca_tpu_torch.ops.retrieval_topk import catalog_topk, groupmax, tournament_rerank
from carca_tpu_torch.serve import graph as serve_graph
from carca_tpu_torch.serve.recommender import Recommender, pad_histories
from carca_tpu_torch.serve.service import HostCSR, run_bench

torch.set_num_threads(1)

N_ITEMS = 97
TOL = 2e-5
BUCKETS = (1, 8, 64)


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=N_ITEMS - 1, seed=3)


def requests(cat, b, seed):
    """b catalog users' (histories, ctxs), drawn with repetition."""
    users = np.random.default_rng(seed).integers(0, cat.n_users, size=b)
    return ([cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist() for u in users],
            [cat.ctx_vals[cat.offsets[u]:cat.offsets[u + 1]] for u in users])


def jax_pair(cat, decoder, seed=1, **rec_kw):
    """(the JAX Recommender, the port's model) over the same weights. JAX is
    imported here: the card's machine, which runs this file's card tests,
    has none."""
    import jax

    from carca_tpu.config import ModelConfig as JaxModelConfig
    from carca_tpu.models.carca import carca_init
    from carca_tpu.serve.recommender import Recommender as JaxRecommender
    from carca_tpu_torch.bridge import load_into, model_config_from_jax

    jcfg = JaxModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                          d=16, g=32, seq_len=8, target_len=10, n_blocks=2,
                          n_heads=2, dropout=0.0, embedding="all", decoder=decoder,
                          l2_norm=decoder == "wdot")
    params = carca_init(jax.random.PRNGKey(seed), jcfg)
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu"),
                      jax.tree.map(np.asarray, params))
    return JaxRecommender(params, jcfg, cat.attrs, **rec_kw), model


def small_model(cat, decoder="ca", n_ctx=None, device="cpu", d=16, seq_len=8, seed=0):
    cfg = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                      n_ctx=cat.n_ctx if n_ctx is None else n_ctx, d=d, g=32,
                      seq_len=seq_len, n_blocks=2, n_heads=2, decoder=decoder,
                      l2_norm=decoder == "wdot")
    return CARCA(cfg, generator=torch.Generator().manual_seed(seed), device=device)


class _Replays:
    """Stands in for a captured graph where the CPU has none: each replay
    runs the recorded body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def replayed(monkeypatch):
    """GraphedServe's warm-up and capture on the CPU: the warm-up runs the
    body, the capture records it."""
    monkeypatch.setattr(serve_graph.GraphedServe, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(serve_graph.GraphedServe, "_record", lambda self, body: _Replays(body))


def graphed(rec):
    """``rec`` served through a GraphedServe (with ``replayed``: on the CPU)."""
    rec._graphs = serve_graph.GraphedServe(rec)
    return rec._graphs


# --------------------------------------------------------------------------
# (a) the captured body against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["full", "seen"])
@pytest.mark.parametrize("decoder", ["ca", "dot", "wdot"])
def test_a_graph_body_matches_jax(cat, replayed, decoder, index):
    kw = dict(shortlist=24, batch_buckets=BUCKETS,
              index_ids=np.unique(cat.items) if index == "seen" else None)
    jrec, model = jax_pair(cat, decoder, **kw)
    rec, eager = Recommender(model, cat.attrs, **kw), Recommender(model, cat.attrs, **kw)
    gs = graphed(rec)
    rc = np.random.default_rng(0).standard_normal(cat.n_ctx).astype(np.float32)
    for b in (1, 5, 40):  # buckets 1, 8, 64
        hists, ctxs = requests(cat, b, seed=b)
        for call in (dict(k=6), dict(k=6, ctxs=ctxs, request_ctx=rc)):
            ids, scores = rec.recommend(hists, **call)
            want_ids, want_s = jrec.recommend(hists, **call)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_allclose(scores, want_s, rtol=TOL, atol=TOL)
            e_ids, e_s = eager.recommend(hists, **call)
            np.testing.assert_array_equal(ids, e_ids)
            np.testing.assert_array_equal(scores, e_s)
    assert (gs.captures, gs.replays) == (3, 6)


@pytest.mark.parametrize("decoder", ["ca", "dot", "wdot"])
def test_a_graph_score_candidates_matches_jax(cat, replayed, decoder):
    jrec, model = jax_pair(cat, decoder, seed=2, batch_buckets=BUCKETS)
    rec = Recommender(model, cat.attrs, batch_buckets=BUCKETS)
    eager = Recommender(model, cat.attrs, batch_buckets=BUCKETS, graph=False)
    gs = graphed(rec)
    rng = np.random.default_rng(7)
    rc = rng.standard_normal((3, cat.n_ctx)).astype(np.float32)
    for b, call in ((3, {}), (3, dict(request_ctx=rc)), (1, {})):
        hists, ctxs = requests(cat, b, seed=10 + b)
        cand = rng.integers(1, cat.n_items, size=(b, 7))
        got = rec.score_candidates(hists, cand, ctxs=ctxs, **call)
        np.testing.assert_allclose(got, jrec.score_candidates(hists, cand, ctxs=ctxs, **call),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got, eager.score_candidates(hists, cand, ctxs=ctxs, **call))
        assert got.shape == (b, 7)
    assert (gs.captures, gs.replays) == (2, 3)


# --------------------------------------------------------------------------
# (b) staging
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_ctx", [0, 3])
@pytest.mark.parametrize("b,bb", [(1, 1), (5, 8), (64, 64), (300, 300)])
def test_b_a_staged_request_reads_back_as_the_padded_arrays(cat, b, bb, n_ctx):
    """300 is beyond every bucket: served at its exact size (eagerly), its
    arrays stage all the same."""
    rec = Recommender(small_model(cat, "ca", n_ctx=n_ctx), cat.attrs,
                      batch_buckets=(1, 8, 64, 256), shortlist=24)
    rng = np.random.default_rng(b)
    hists = [rng.integers(1, N_ITEMS, size=rng.integers(0, 12)).tolist() for _ in range(b)]
    ctxs = [rng.standard_normal((len(h), n_ctx)).astype(np.float32) for h in hists]
    rc = rng.standard_normal((b, n_ctx)).astype(np.float32)
    cand = rng.integers(1, N_ITEMS, size=(b, 5))
    arrays = rec._padded(hists, ctxs, rc, cand)
    p_x, p_c = pad_histories(hists, 8, ctxs, n_ctx)
    want = [np.pad(p_x, ((0, bb - b), (0, 0))), np.pad(p_c, ((0, bb - b), (0, 0), (0, 0))),
            np.pad(rc, ((0, bb - b), (0, 0))), np.pad(cand, ((0, bb - b), (0, 0)))]
    region = serve_graph.Region(serve_graph.request_sections(bb, 8, n_ctx, 5), "cpu")
    assert region.host.numel() == region.dev.numel()
    serve_graph.stage(region, arrays)
    region.dev.copy_(region.host)
    for name, w in zip(serve_graph.REQUEST, want):
        got = region.d[name]
        assert got.shape == w.shape, name
        if got.numel():
            assert (got.data_ptr() - region.dev.data_ptr()) % serve_graph.ALIGN == 0, name
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert rec._graphed(bb) is False  # the CPU has no graphs


# --------------------------------------------------------------------------
# (c) routing
# --------------------------------------------------------------------------

def test_c_graph_true_raises_on_a_cpu_model_and_with_a_mesh(cat):
    model = small_model(cat)
    with pytest.raises(ValueError, match="needs a CUDA model"):
        Recommender(model, cat.attrs, graph=True)
    with pytest.raises(ValueError, match="over a mesh stays eager"):
        Recommender(model, cat.attrs, graph=True, mesh=object())


def test_c_graph_none_on_the_cpu_runs_eagerly(cat, monkeypatch):
    def no_capture(self, *a):
        raise AssertionError("a CPU Recommender captured")

    monkeypatch.setattr(serve_graph.GraphedServe, "_capture", no_capture)
    for graph in (None, False):
        rec = Recommender(small_model(cat, "dot"), cat.attrs, batch_buckets=(1, 4), graph=graph)
        assert rec._graphs is None and rec.mode == "eager"
        hists, _ = requests(cat, 3, seed=1)
        assert rec.recommend(hists, k=3)[0].shape == (3, 3)
        assert rec.score_candidates(hists, np.ones((3, 2), np.int64)).shape == (3, 2)
        rows = run_bench(rec, HostCSR(cat), k=3, iters=2)
        assert [r["step"] for r in rows] == ["eager", "eager"]


# --------------------------------------------------------------------------
# (d) the launch counters
# --------------------------------------------------------------------------

SOME = launches.Launches(3, Counter({(8, 8, 0): 2, (24, 8, None): 1}), 2,
                         Counter({(8, 8, 0): 2}), {"f32": 4, "int8": 1}, {0: 2}, 5)


@pytest.fixture
def counters():
    """The counters as they stand, put back after the test."""
    saved = launches.snapshot()
    yield saved
    launches.restore(saved)


def test_d_snapshot_restore_add_and_since_cover_all_five_counters(counters):
    launches.reset()
    assert launches.snapshot() == launches.Launches(
        0, Counter(), 0, Counter(), {"f32": 0, "bf16": 0, "int8": 0}, {0: 0, 1: 0}, 0)
    launches.add(SOME)
    now = launches.snapshot()
    assert (fused_attention.launches, attention_bwd.launches, tournament_rerank.launches) == \
        (3, 2, 5)
    assert fused_attention.launches_by_shape == SOME.attention_fwd_by_shape
    assert attention_bwd.launches_by_shape == SOME.attention_bwd_by_shape
    assert catalog_topk.launches == {"f32": 4, "bf16": 0, "int8": 1}
    assert groupmax.launches == {0: 2, 1: 0}
    launches.add(SOME)
    assert launches.since(now) == SOME
    launches.restore(now)
    assert launches.snapshot() == now
    # a shorter tuple counts 0 for the rest (the train graph's K1/K2 form)
    launches.add((1, Counter({(8, 8, 0): 1})))
    assert launches.since(now) == launches.Launches(1, Counter({(8, 8, 0): 1}))
    report = launch_counts(by_shape=True)
    assert report == launches.report(by_shape=True)
    assert (report["attention_fwd"], report["catalog_topk_int8"], report["groupmax_layout0"],
            report["tournament_rerank"]) == (4, 1, 2, 5)
    assert report["attention_fwd_by_shape"]["8x8 causal 0"] == 3


def test_d_a_replay_adds_the_captured_launches_once(cat, counters, monkeypatch):
    """The capture's own count is put back; each replay adds it once."""
    def record(self, body):
        launches.add(SOME)  # what the kernels' wrappers count while captured
        return _Replays(body)

    monkeypatch.setattr(serve_graph.GraphedServe, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(serve_graph.GraphedServe, "_record", record)
    rec = Recommender(small_model(cat, "dot"), cat.attrs, batch_buckets=(1, 8))
    gs = graphed(rec)
    start = launches.snapshot()
    hists, _ = requests(cat, 2, seed=3)
    for n in (1, 2, 3):
        rec.recommend(hists, k=4)
        want = launches.snapshot()
        launches.restore(start)
        for _ in range(n):
            launches.add(SOME)
        assert launches.snapshot() == want
    assert gs.entries["recommend", 8, 4].launched == SOME and gs.captures == 1


# --------------------------------------------------------------------------
# (e) the graph cache
# --------------------------------------------------------------------------

def test_e_one_graph_per_kind_bucket_and_k(cat, replayed):
    rec = Recommender(small_model(cat, "ca"), cat.attrs, batch_buckets=(1, 8), shortlist=20)
    gs = graphed(rec)
    h1, h3 = requests(cat, 1, seed=1)[0], requests(cat, 3, seed=2)[0]
    cand = np.arange(1, 13).reshape(3, 4)
    calls = [(lambda: rec.recommend(h1, k=5), 1), (lambda: rec.recommend(h1, k=5), 1),
             (lambda: rec.recommend(h1, k=6), 2), (lambda: rec.recommend(h3, k=5), 3),
             (lambda: rec.score_candidates(h3, cand), 4),
             (lambda: rec.score_candidates(h3, cand[:, :3]), 5),
             (lambda: rec.score_candidates(h3, cand), 5),
             (lambda: rec.recommend(requests(cat, 9, seed=4)[0], k=5), 5)]  # oversized: eager
    for call, captures in calls:
        call()
        assert gs.captures == captures
    assert set(gs.entries) == {("recommend", 1, 5), ("recommend", 1, 6), ("recommend", 8, 5),
                               ("score", 8, 4), ("score", 8, 3)}
    assert gs.replays == 7


def _replace(rec, what):
    if what == "parameter":
        p = next(rec.model.parameters())
        p.data = p.data.clone()
    elif what == "attrs":
        rec.attrs = rec.attrs.clone()
    elif what == "index":
        rec.catalog_emb = rec.catalog_emb.clone()
    elif what == "qvals":
        rec.catalog_emb = rec.catalog_emb._replace(qvals=rec.catalog_emb.qvals.clone())
    else:
        rec.row_ids = rec.row_ids.clone()


@pytest.mark.parametrize("what", ["parameter", "attrs", "index", "qvals", "row_ids"])
def test_e_a_replaced_tensor_drops_every_graph_and_captures_anew(cat, replayed, what):
    rec = Recommender(small_model(cat, "ca"), cat.attrs, batch_buckets=(1, 8), shortlist=20,
                      quantize=what == "qvals",
                      index_ids=np.unique(cat.items) if what == "row_ids" else None)
    gs = graphed(rec)
    hists, ctxs = requests(cat, 4, seed=5)
    before = rec.recommend(hists, k=5, ctxs=ctxs)
    rec.recommend(hists[:1], k=5, ctxs=ctxs[:1])
    assert gs.captures == 2 and len(gs.entries) == 2
    _replace(rec, what)
    after = rec.recommend(hists, k=5, ctxs=ctxs)
    assert gs.captures == 3 and list(gs.entries) == [("recommend", 8, 5)]
    for a, b in zip(before, after):  # the same values at new addresses
        np.testing.assert_array_equal(a, b)
    rec.recommend(hists, k=5, ctxs=ctxs)
    assert gs.captures == 3


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures the card's work")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_L = 8  # so that stage 1 at k = 10 takes the stream (k + L < 48) below 64 queries


@pytest.fixture(scope="module")
def cat_20k():
    return synthetic_catalog(n_users=600, n_real_items=19_999, seed=5)


@pytest.fixture(scope="module")
def cat_1m():
    return synthetic_catalog(n_users=600, n_real_items=999_999, seed=6)


def card_pair(cat, dev, decoder, **kw):
    """(graph, eager) Recommenders over one d = 64 model on the card."""
    model = small_model(cat, decoder, device=dev, d=64, seq_len=CARD_L, seed=1)
    kw = dict(batch_buckets=(1, 8, 64, 256), **kw)
    return Recommender(model, cat.attrs, **kw), Recommender(model, cat.attrs, graph=False, **kw)


def served_alike(rec, eager, calls) -> None:
    """Each call once through the graph (a key's first call warms up and
    captures), then again, and eagerly: bit-equal answers, equal launches."""
    for call in calls:
        call(rec)
        start = launches.snapshot()
        got = call(rec)
        mid = launches.snapshot()
        want = call(eager)
        assert launches.since(start, mid) == launches.since(mid)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32 stream", "int8 tournament", "int8 stream"])
def test_card_replays_equal_the_eager_calls(dev, cat_20k, cat_1m, case):
    if case == "f32 stream":
        rec, eager = card_pair(cat_20k, dev, "ca", shortlist=512)
        k, stage1 = 10, "catalog_topk_f32"
    elif case == "int8 tournament":  # stage-1 k = 554 + L = 562
        rec, eager = card_pair(cat_1m, dev, "ca", shortlist=562 - CARD_L, quantize=True)
        k, stage1 = 10, "tournament_rerank"
    else:
        rec, eager = card_pair(cat_1m, dev, "dot", quantize=True)
        k, stage1 = 10, "catalog_topk_int8"
    cat = cat_20k if case == "f32 stream" else cat_1m
    assert rec.mode == "graph" and eager.mode == "eager"
    rec.warmup(k=k)
    eager.warmup(k=k)
    for bb in (1, 8, 64, 256):
        hists, ctxs = requests(cat, bb, seed=bb)
        before = launches.report()
        served_alike(rec, eager, [lambda r: r.recommend(hists, k=k, ctxs=ctxs)])
        after = launches.report()
        if case != "int8 stream" or bb < 64:
            assert after[stage1] > before[stage1], (case, bb)
        assert after["attention_fwd"] > before["attention_fwd"]
    assert rec._graphs.captures == 4 and rec._graphs.replays == 12


@pytest.mark.cuda
def test_card_score_candidates_replay_equals_eager(dev, cat_20k):
    rec, eager = card_pair(cat_20k, dev, "ca")
    rng = np.random.default_rng(3)
    for bb in (1, 8, 64, 256):
        hists, ctxs = requests(cat_20k, bb, seed=bb + 1)
        cand = rng.integers(1, cat_20k.n_items, size=(bb, 101))
        served_alike(rec, eager, [lambda r: r.score_candidates(hists, cand, ctxs=ctxs)])
    assert rec._graphs.captures == 4 and rec._graphs.replays == 8


@pytest.mark.cuda
def test_card_two_requests_in_turn_each_equal_their_eager_answer(dev, cat_20k):
    rec, eager = card_pair(cat_20k, dev, "ca")
    (h1, c1), (h2, c2) = requests(cat_20k, 6, seed=1), requests(cat_20k, 7, seed=2)
    calls = [lambda r: r.recommend(h1, k=10, ctxs=c1), lambda r: r.recommend(h2, k=10, ctxs=c2)]
    served_alike(rec, eager, calls * 3)
    a, b = rec.recommend(h1, k=10, ctxs=c1), rec.recommend(h2, k=10, ctxs=c2)
    assert not np.array_equal(a[0][:6], b[0][:6])
    assert rec._graphs.captures == 1


@pytest.mark.cuda
def test_card_a_replaced_index_captures_anew(dev, cat_20k):
    rec, eager = card_pair(cat_20k, dev, "dot")
    hists, ctxs = requests(cat_20k, 8, seed=9)
    call = [lambda r: r.recommend(hists, k=10, ctxs=ctxs)]
    served_alike(rec, eager, call)
    new = torch.flip(rec.catalog_emb, dims=[1]).contiguous()
    rec.catalog_emb = eager.catalog_emb = new
    served_alike(rec, eager, call)
    assert rec._graphs.captures == 2 and len(rec._graphs.entries) == 1


@pytest.mark.cuda
def test_card_a_capture_that_syncs_raises_and_does_not_fall_back(dev, cat_20k, monkeypatch):
    rec, _ = card_pair(cat_20k, dev, "dot")
    body = Recommender._recommend

    def syncs(self, p_x, p_c, req_ctx, k):
        float(p_c.sum())  # a host sync: fine eagerly, refused in a capture
        return body(self, p_x, p_c, req_ctx, k)

    monkeypatch.setattr(Recommender, "_recommend", syncs)
    hists, _ = requests(cat_20k, 2, seed=4)
    start = launches.snapshot()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            rec.recommend(hists, k=10)
    assert rec._graphs.captures == 0 and rec._graphs.replays == 0 and not rec._graphs.entries
    torch.cuda.synchronize()
    # the warm-ups ran eagerly and counted; the failed captures put theirs back
    assert launches.since(start).attention_fwd == 2 * 2
