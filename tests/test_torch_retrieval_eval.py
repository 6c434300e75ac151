"""The port's full-catalog retrieval evaluation and KNN baseline against the
JAX package's, on the CPU (d = 16, L = 6, 120 real items, 150 users).

* ``retrieval_hr_ndcg``: HR equal to JAX's on the same ids, NDCG within
  1e-6 relative (the same float32 terms, summed in another order).
* ``evaluate_retrieval`` on bridged ``dot`` weights, seen/full index ×
  f32/int8: the seen index's row ids equal JAX's; HR and NDCG within
  1/n_users of JAX's (one user's hit may flip where two scores lie within
  float32 summation order at the k-th place; measured: HR equal, NDCG
  within 2e-9).
* ``eval_retrieval_every`` logs epochs [1, 2]; ``select_by=retrieval_hr``
  retains the first argmax of the logged curve; the ``ca`` decoder raises
  in ``evaluate_retrieval`` and is skipped with a note in ``fit``.
* ``knn_apply`` equal to JAX's up to 1e-6; ``evaluate_knn`` (the same
  numpy sampler and catalog) HR equal, NDCG and loss within 1e-6.
* The graphs of the evaluator (index build, batch metrics) and of the KNN
  step: ``graph=True`` raises on the CPU; with a stand-in capture (the
  capture records the call, a "replay" reruns it on the region's views)
  ``graph=None`` over three calls equals ``graph=False`` exactly and the
  JAX package within the tolerances above, with one capture per graph;
  ``index()`` builds into the same tensors on every call.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.config import Config as JaxConfig
from carca_tpu.config import DataConfig as JaxDataConfig
from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import TrainConfig as JaxTrainConfig
from carca_tpu.models.carca import carca_init
from carca_tpu.models.knn import knn_apply as jax_knn_apply
from carca_tpu.parallel import retrieval as jax_retrieval
from carca_tpu.train.loop import evaluate_knn as jax_evaluate_knn
from carca_tpu.train.loop import evaluate_retrieval as jax_evaluate_retrieval
from carca_tpu_torch.bridge import config_from_jax, load_into
from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.models.knn import knn_apply
from carca_tpu_torch.ops import launches
from carca_tpu_torch.ops.retrieval_topk import QuantizedIndex
from carca_tpu_torch.parallel.retrieval import retrieval_hr_ndcg
from carca_tpu_torch.train import graph as step_graph
from carca_tpu_torch.train import loop
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import (RetrievalEvaluator, evaluate_knn, evaluate_retrieval,
                                        fit)

torch.set_num_threads(1)

N_USERS, N_REAL = 150, 120


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL, seed=4)


def jax_config(cat, decoder="dot", **train):
    mc = JaxModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16, g=32,
                        seq_len=6, target_len=8, n_blocks=1, n_heads=2, dropout=0.1,
                        decoder=decoder, use_pallas=False)
    return JaxConfig(model=mc, data=JaxDataConfig(synthetic=True),
                     train=JaxTrainConfig(batch_size=32, seed=0, verbose=0, **train))


@pytest.mark.parametrize("k", [1, 5, 10])
def test_retrieval_hr_ndcg_matches_jax(k):
    rng = np.random.default_rng(k)
    ids = rng.integers(0, 30, size=(40, 12))
    pos = rng.integers(0, 30, size=40)
    ids[3] = -1  # a dead row
    ids[5, 2] = pos[5]  # a hit at rank 3
    got = retrieval_hr_ndcg(torch.as_tensor(ids), torch.as_tensor(pos), k)
    want = jax_retrieval.retrieval_hr_ndcg(jnp.asarray(ids), jnp.asarray(pos), k)
    (hr, ndcg), (jhr, jndcg) = got, want
    assert hr.dtype == ndcg.dtype == torch.float32 and hr.item() == float(jhr)
    assert abs(ndcg.item() - float(jndcg)) <= 1e-6 * abs(float(jndcg))


@pytest.fixture(scope="module")
def bridged(cat):
    jcfg = jax_config(cat)
    params = carca_init(jax.random.PRNGKey(5), jcfg.model)
    cfg = config_from_jax(jcfg)
    model = load_into(CARCA(cfg.model, device="cpu"), jax.tree.map(np.asarray, params))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("seen_only", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
def test_evaluate_retrieval_matches_jax(cat, bridged, monkeypatch, seen_only, quantized):
    jcfg, params, cfg, model = bridged
    seen = []
    real_embed = jax_retrieval.embed_catalog

    def spy(*args, **kw):  # the JAX evaluator's index rows
        seen.append(kw.get("global_ids"))
        return real_embed(*args, **kw)

    monkeypatch.setattr(jax_retrieval, "embed_catalog", spy)
    want = jax_evaluate_retrieval(jcfg, cat, params, mode="test", k=10, log=False,
                                  seen_only=seen_only, quantized=quantized)
    got = evaluate_retrieval(cfg, cat, model, mode="test", k=10, log=False,
                             seen_only=seen_only, quantized=quantized)
    ev = RetrievalEvaluator(cfg, cat, mode="test", k=10, seen_only=seen_only, device="cpu")
    if seen_only:
        np.testing.assert_array_equal(ev.row_ids.numpy(), np.asarray(seen[0]))
        assert 0 < len(ev.row_ids) - 1 < N_REAL
    else:
        assert ev.row_ids is None and seen[0] is None
    assert set(got) == set(want) == {"retrieval_test_hr", "retrieval_test_ndcg"}
    for key in want:
        assert abs(got[key] - want[key]) <= 1.0 / N_USERS, (key, got[key], want[key])
    assert got["retrieval_test_hr"] > 0.0


def port_cfg(cat, out_dir, **train):
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=16, g=32,
                     seq_len=6, target_len=8, n_blocks=1, n_heads=2, dropout=0.1, decoder="dot")
    return Config(model=mc, data=DataConfig(synthetic=True),
                  train=TrainConfig(batch_size=32, early_stop=5, out_dir=str(out_dir), seed=0,
                                    verbose=0, **train))


def retrieval_rows(run):
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    return {r["epoch"]: r["retrieval_val_hr"] for r in rows if "retrieval_val_hr" in r}


def test_eval_retrieval_every_monitors_during_fit(tmp_path, cat):
    _, final = fit(port_cfg(cat, tmp_path, epochs=2, eval_retrieval_every=1), cat,
                   device="cpu")
    assert 0.0 <= final["retrieval_val_hr"] <= 1.0 and 0.0 <= final["retrieval_val_ndcg"] <= 1.0
    assert sorted(retrieval_rows(tmp_path)) == [1, 2]
    ca = dataclasses.replace(port_cfg(cat, tmp_path / "ca", epochs=1, eval_retrieval_every=1),
                             model=dataclasses.replace(port_cfg(cat, "x").model, decoder="ca"))
    _, final_ca = fit(ca, cat, device="cpu", log=False)
    assert "retrieval_val_hr" not in final_ca
    with pytest.raises(ValueError, match="dot-family"):
        fit(dataclasses.replace(ca, train=dataclasses.replace(
            ca.train, select_by="retrieval_hr", out_dir=str(tmp_path / "ca2"))), cat,
            device="cpu", log=False)
    with pytest.raises(ValueError, match="dot/wdot"):
        evaluate_retrieval(ca, cat, CARCA(ca.model, device="cpu"), log=False)


def test_select_by_retrieval_retains_the_first_argmax(tmp_path, cat):
    fit(port_cfg(cat, tmp_path, epochs=3, eval_retrieval_every=1, select_by="retrieval_hr"),
        cat, device="cpu")
    curve = retrieval_rows(tmp_path)
    assert len(curve) == 3
    peak = max(sorted(curve), key=lambda e: (curve[e], -e))
    m = CheckpointKeeper(str(tmp_path / "ckpt"), select_by="retrieval_hr").best_metrics()
    assert m["select_by"] == "retrieval_hr" and m["epoch"] == peak
    assert m["select"] == curve[peak] == m["retrieval_val_hr"]
    with pytest.raises(ValueError, match="eval_retrieval_every"):
        fit(port_cfg(cat, tmp_path / "x", epochs=1, select_by="retrieval_hr"), cat,
            device="cpu", log=False)


def test_knn_apply_matches_jax(cat):
    rng = np.random.default_rng(0)
    p_x = rng.integers(0, cat.n_items, size=(5, 6))
    o_x = [rng.integers(0, cat.n_items, size=(5, 4)), rng.integers(0, cat.n_items, size=(5, 3))]
    got = knn_apply((torch.as_tensor(p_x), None, None),
                    [(torch.as_tensor(o), None, None) for o in o_x],
                    attrs_table=torch.as_tensor(cat.attrs))
    want = jax_knn_apply((jnp.asarray(p_x), None, None), [(jnp.asarray(o), None, None)
                                                           for o in o_x],
                         attrs_table=jnp.asarray(cat.attrs))
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_evaluate_knn_matches_jax(cat):
    jcfg = jax_config(cat, decoder="ca")
    want = jax_evaluate_knn(jcfg, cat, log=False)
    got = evaluate_knn(config_from_jax(jcfg), cat, log=False, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= (0.0 if key.endswith("_hr") else 1e-6), key


# --------------------------------------------------------------------------
# the evaluator's and the KNN step's graphs
# --------------------------------------------------------------------------

class _Rerun:
    """Stands in for a captured graph where the CPU has none: a replay
    reruns the recorded call and writes its results into the outputs the
    capture returned."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def replay(self):
        counted = launches.snapshot()  # the graph counts its launches itself
        with torch.inference_mode():
            for o, new in zip(self.outputs, self.fn()):
                o.copy_(new)
        launches.restore(counted)


@pytest.fixture
def stand_in(monkeypatch):
    """GraphedEval on the CPU: calls take the card's route, the warm-up runs
    the eager call, the capture records it."""
    monkeypatch.setattr(step_graph, "_cpu_call", lambda required, device: False)
    monkeypatch.setattr(step_graph.GraphedEval, "_warm_up", lambda self, device, fn: fn())
    monkeypatch.setattr(step_graph.GraphedEval, "_record",
                        lambda self, fn, generator: (lambda out: (_Rerun(fn, out), out))(fn()))


@pytest.mark.parametrize("what", ["evaluate_retrieval", "evaluate_knn"])
def test_graph_true_raises_on_the_cpu(cat, bridged, what):
    _, _, cfg, model = bridged
    with pytest.raises(ValueError, match="graph=True"):
        if what == "evaluate_retrieval":
            evaluate_retrieval(cfg, cat, model, k=10, log=False, graph=True)
        else:
            evaluate_knn(cfg, cat, log=False, device="cpu", graph=True)


@pytest.mark.parametrize("seen_only", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
def test_graphed_evaluator_equals_eager_and_jax(cat, bridged, stand_in, seen_only, quantized):
    jcfg, params, cfg, model = bridged
    want = jax_evaluate_retrieval(jcfg, cat, params, mode="test", k=10, log=False,
                                  seen_only=seen_only, quantized=quantized)
    kw = dict(mode="test", k=10, log=False, seen_only=seen_only, quantized=quantized,
              device="cpu")
    eager = RetrievalEvaluator(cfg, cat, graph=False, **kw)(model)
    ev = RetrievalEvaluator(cfg, cat, **kw)
    for _ in range(3):  # warm-up, capture + replay, replays
        got = ev(model)
        assert got == eager
    for key in want:
        assert abs(got[key] - want[key]) <= 1.0 / N_USERS, (key, got[key], want[key])
    assert (ev._build.captures, ev._build.replays) == (1, 2)
    n = len(ev.row_batches)
    assert (ev._metrics.captures, ev._metrics.replays) == (1, 3 * n - 1)
    assert evaluate_retrieval(cfg, cat, model, **{k: v for k, v in kw.items()
                                                  if k != "device"}) == eager


def test_graphed_knn_step_equals_eager_and_jax(cat, stand_in, monkeypatch):
    jcfg = jax_config(cat, decoder="ca")
    want = jax_evaluate_knn(jcfg, cat, log=False)
    steps = []
    real = loop.make_knn_eval_step
    monkeypatch.setattr(loop, "make_knn_eval_step",
                        lambda top_k, graph=None: steps.append(real(top_k, graph=graph))
                        or steps[-1])
    got = evaluate_knn(config_from_jax(jcfg), cat, log=False, device="cpu")
    eager = evaluate_knn(config_from_jax(jcfg), cat, log=False, device="cpu", graph=False)
    assert got == eager
    for key in want:
        assert abs(got[key] - want[key]) <= (0.0 if key.endswith("_hr") else 1e-6), key
    graphed = steps[0]
    assert graphed.mode == "graph" and steps[1].mode == "eager"
    assert graphed.captures >= 1 and graphed.replays > 0


@pytest.mark.parametrize("quantized", [False, True])
def test_the_index_is_built_into_the_same_tensors(cat, bridged, quantized):
    _, _, cfg, model = bridged
    model = CARCA(cfg.model, device="cpu")
    model.load_state_dict(bridged[3].state_dict())
    ev = RetrievalEvaluator(cfg, cat, k=10, log=False, quantized=quantized, device="cpu")
    first = ev.index(model)
    tensors = tuple(first) if quantized else (first,)
    ptrs = [t.data_ptr() for t in tensors]
    with torch.no_grad():  # the next epoch's weights, in place
        for p in model.parameters():
            p.mul_(0.5)
    again = ev.index(model)
    built = tuple(again) if quantized else (again,)
    assert all(a is b for a, b in zip(built, tensors))
    assert [t.data_ptr() for t in built] == ptrs
    fresh = RetrievalEvaluator(cfg, cat, k=10, log=False, quantized=quantized,
                               device="cpu").index(model)
    want = tuple(fresh) if quantized else (fresh,)
    assert all(torch.equal(a, b) for a, b in zip(built, want))
    assert isinstance(again, QuantizedIndex) == quantized
