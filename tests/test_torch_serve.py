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
    model = load_into(CARCA(model_config_from_jax(dataclasses.asdict(jcfg)), device="cpu"),
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
    rec = Recommender(CARCA(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
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


# ---------------------------------------------------------------------------
# serving a run directory (train/loop.fit's args.json + ckpt/)
# ---------------------------------------------------------------------------

RUN_USERS, RUN_ITEMS = 200, 100
REC_KW = dict(shortlist=16, batch_buckets=(1, 8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port run and a JAX run of the smoke preset (2 epochs, CPU, host
    pipeline) over the same synthetic catalog; (root, catalog)."""
    from carca_tpu.config import DataConfig as JaxDataConfig
    from carca_tpu.config import preset as jax_preset
    from carca_tpu.train.loop import fit as jax_fit
    from carca_tpu_torch import cli

    root = tmp_path_factory.mktemp("runs")
    cli.main(["--synthetic", "true", "--preset", "smoke", "--epochs", "2", "--resume", "false",
              "--synthetic_users", str(RUN_USERS), "--synthetic_items", str(RUN_ITEMS),
              "--out_dir", str(root / "ours")], device="cpu")
    cat = synthetic_catalog(n_users=RUN_USERS, n_real_items=RUN_ITEMS, seed=0)
    jc = jax_preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    jax_fit(dataclasses.replace(
        jc, data=JaxDataConfig(synthetic=True, synthetic_users=RUN_USERS,
                               synthetic_items=RUN_ITEMS, use_native=False),
        train=dataclasses.replace(jc.train, epochs=2, out_dir=str(root / "jax"))), cat,
        log=False)
    return root, cat


def request_lines(cat):
    return [json.dumps({"user": 3, "id": "u3"}), json.dumps({"user": 150, "k": 5}),
            json.dumps({"history": histories_of(cat, [7])[0], "id": 7}),
            json.dumps({"history": [4, 9, 2], "ctx": [[0.1] * cat.n_ctx] * 3, "k": 2}),
            "{not json", json.dumps({"user": RUN_USERS, "id": "out of range"})]


def test_load_recommender_serves_the_run_weights(runs):
    from carca_tpu_torch.serve.recommender import config_from_run_dir, load_recommender

    root, cat = runs
    run = str(root / "ours")
    cfg = config_from_run_dir(run)
    assert cfg.model.d == 16 and cfg.data.synthetic_users == RUN_USERS and cfg.train.epochs == 2
    model = CARCA(cfg.model, device="cpu")
    model.load_state_dict(torch.load(root / "ours" / "ckpt" / "best" / "params.pt"))
    want = Recommender(model, cat.attrs, **REC_KW)
    hists = histories_of(cat, range(6))
    for which in ("best", "latest"):
        rec = load_recommender(run, cat.attrs, which=which, device="cpu", **REC_KW)
        assert rec.device.type == "cpu"
        if which == "best":
            for got, exp in zip(rec.recommend(hists, k=4), want.recommend(hists, k=4)):
                np.testing.assert_array_equal(got, exp)
    with pytest.raises(FileNotFoundError):
        load_recommender(str(root), cat.attrs, device="cpu")  # no args.json there
    with pytest.raises(ValueError, match="which"):
        load_recommender(run, cat.attrs, which="ema", device="cpu")


def test_service_main_answers_stdin_and_benches(runs):
    import io

    from carca_tpu_torch.serve import service
    from carca_tpu_torch.serve.recommender import load_recommender

    root, cat = runs
    run = str(root / "ours")
    lines = request_lines(cat)
    out = io.StringIO()
    service.main(["--run_dir", run, "--k", "4", "--shortlist", "16"], device="cpu",
                 stdin=io.StringIO("\n".join(lines) + "\n\n"), stdout=out)
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    rec = load_recommender(run, cat.attrs, device="cpu", shortlist=16,
                           index_ids=np.unique(cat.items))
    want = list(serve_lines(rec, HostCSR(cat), lines, k=4))
    assert got == want and len(got) == 6
    assert got[0]["id"] == "u3" and len(got[0]["items"]) == 4 and len(got[1]["items"]) == 5
    assert got[2]["id"] == 7 and len(got[3]["items"]) == 2
    assert "error" in got[4] and "error" in got[5] and got[5]["id"] == "out of range"
    out = io.StringIO()
    service.main(["--run_dir", run, "--bench", "--iters", "2", "--device", "cpu"], stdout=out)
    assert [json.loads(line)["batch"] for line in out.getvalue().splitlines()] == [1, 8, 64, 256]
    with pytest.raises(ValueError, match="world size of 2"):  # one process, two shards
        service.main(["--run_dir", run, "--index_shards", "2"], device="cpu")


def test_a_jax_run_served_by_the_port(runs, tmp_path):
    """A JAX fit's best/ (restored with orbax here) written into a port run
    directory through the bridge: the port's load_recommender returns the
    JAX package's ids (scores within 1e-5) for the same requests."""
    import shutil

    import jax

    from carca_tpu.serve.recommender import config_from_run_dir as jax_config_from_run_dir
    from carca_tpu.serve.recommender import load_recommender as jax_load_recommender
    from carca_tpu.train.checkpoint import CheckpointKeeper as JaxKeeper
    from carca_tpu.train.state import create_train_state as jax_create_train_state
    from carca_tpu.train.state import make_optimizer as jax_make_optimizer
    from carca_tpu_torch.serve.recommender import config_from_run_dir, load_recommender
    from carca_tpu_torch.train.checkpoint import CheckpointKeeper

    root, cat = runs
    jrun = str(root / "jax")
    jcfg = jax_config_from_run_dir(jrun)
    template = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train,
                                      jax_make_optimizer(jcfg.train))
    keeper = JaxKeeper(f"{jrun}/ckpt")
    try:
        epoch, state = keeper.restore_best(template)
        metrics = keeper.best_metrics()
    finally:
        keeper.close()
    shutil.copy(f"{jrun}/args.json", tmp_path / "args.json")
    cfg = config_from_run_dir(str(tmp_path))
    assert cfg.model == model_config_from_jax(dataclasses.asdict(jcfg.model))
    model = load_into(CARCA(cfg.model, device="cpu"), jax.tree.map(np.asarray, state.params))
    CheckpointKeeper(str(tmp_path / "ckpt")).save(epoch, model, metrics)
    ours = load_recommender(str(tmp_path), cat.attrs, device="cpu", **REC_KW)
    theirs = jax_load_recommender(jrun, cat.attrs, **REC_KW)
    hists, ctxs = histories_of(cat, range(9)), ctxs_of(cat, range(9))
    for kw in (dict(k=5), dict(k=3, ctxs=ctxs)):
        got_ids, got_s = ours.recommend(hists, **kw)
        want_ids, want_s = theirs.recommend(hists, **kw)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_service_regenerates_a_device_pipeline_run_catalog(tmp_path):
    """A synthetic10m-preset run at a tiny catalog (generated on the run's
    device, markov process): the service regenerates the same catalog from
    args.json and answers as an in-process Recommender over it."""
    import io

    from carca_tpu_torch import cli
    from carca_tpu_torch.data.loaders import host_catalog
    from carca_tpu_torch.serve import service
    from carca_tpu_torch.serve.recommender import config_from_run_dir, load_recommender

    run = str(tmp_path / "run")
    argv = ["--preset", "synthetic10m", "--synthetic_users", "120", "--synthetic_items", "150",
            "--synthetic_process", "markov", "--epochs", "1", "--batch_size", "32",
            "--resume", "false", "--out_dir", run]
    cli.main(argv, device="cpu")
    args = cli.build_parser().parse_args(argv)
    trained = cli.load_catalog(args, cli.config_from_args(args, 0, 0, 0).data, "cpu")
    served = service.load_catalog_for_run(service.build_parser().parse_args(["--run_dir", run]),
                                          config_from_run_dir(run), "cpu")
    assert isinstance(served.items, torch.Tensor)
    a, b = host_catalog(trained), host_catalog(served)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)
    lines = [json.dumps({"user": 3, "id": "u3"}), json.dumps({"user": 40, "k": 5}),
             json.dumps({"history": b.items[:4].tolist()})]
    out = io.StringIO()
    service.main(["--run_dir", run, "--k", "4"], device="cpu",
                 stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    rec = load_recommender(run, served.attrs, device="cpu", index_ids=np.unique(b.items))
    assert got == list(serve_lines(rec, HostCSR(served), lines, k=4))
    assert len(got) == 3 and len(got[1]["items"]) == 5 and "error" not in got[2]
