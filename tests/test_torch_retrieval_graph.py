"""The full-catalog retrieval evaluator and the KNN eval step as CUDA graphs
(``train/loop.py``: ``RetrievalEvaluator``, ``make_knn_eval_step``, over
``train/graph.py``'s ``GraphedEval``), held to their eager twins on the card.

Every test here needs a CUDA card and skips elsewhere; run them there with
``python -m pytest --noconftest tests/test_torch_retrieval_graph.py -q``
(the CPU side, with a stand-in capture and the JAX package's parity, is
``tests/test_torch_retrieval_eval.py``). At d = 64, L = 8, batch 64 over
``synthetic_catalog(600 users, 120,000 items)``:

* the evaluator through its graphs (index build and batch metrics) against
  ``graph=False`` over three calls, the parameters changed in place between
  them: HR and NDCG bit-equal, the index tensors bit-equal, launches equal,
  over the seen index in f32 and in bf16 (K3) and the full int8 index at
  batch 64 (the tournament: K4 and the rerank); one capture per key;
* a parameter tensor replaced: the next calls warm up and capture anew, and
  still equal the eager evaluator;
* the KNN step's graph bit-equal to its eager call over host batches.
"""

import numpy as np
import pytest
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops import launches
from carca_tpu_torch.train.loop import RetrievalEvaluator, make_knn_eval_step

L, T, B = 8, 10, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph captures the card's work")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=600, n_real_items=120_000, seed=2)


def config(cat):
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=64, g=64,
                     seq_len=L, target_len=T, n_blocks=1, n_heads=2, dropout=0.0,
                     decoder="dot")
    return Config(model=mc, data=DataConfig(synthetic=True, eval_subsample=300),
                  train=TrainConfig(batch_size=B, seed=0, verbose=0))


# (index, seen_only, quantized, index dtype); the full int8 index of 120,001
# rows at batch 64 and k = 10 + L goes to the tournament
CASES = [("f32 seen", True, False, torch.float32), ("bf16 seen", True, False, torch.bfloat16),
         ("int8 full", False, True, torch.float32)]


def evaluators(cfg, cat, dev, seen_only, quantized, dtype):
    out = []
    for graph in (False, None):
        ev = RetrievalEvaluator(cfg, cat, mode="test", k=10, log=False, seen_only=seen_only,
                                quantized=quantized, device=dev, graph=graph)
        ev.emb_dtype = dtype  # bf16 rows, as the evaluator builds them from 4M items on
        out.append(ev)
    return out


def index_tensors(ev):
    return [t.clone() for t in ev._index]


def run(ev, model):
    before = launches.snapshot()
    got = ev(model)
    torch.cuda.synchronize()
    return got, launches.since(before), index_tensors(ev)


@pytest.mark.cuda
@pytest.mark.parametrize("case,seen_only,quantized,dtype", CASES, ids=[c[0] for c in CASES])
def test_card_evaluator_replays_equal_the_eager_calls(cat, dev, case, seen_only, quantized,
                                                      dtype):
    cfg = config(cat)
    model = CARCA(cfg.model, generator=torch.Generator().manual_seed(1), device=dev)
    eager, graphed = evaluators(cfg, cat, dev, seen_only, quantized, dtype)
    for call in range(3):
        if call:
            with torch.no_grad():  # the next epoch's weights, in place
                for p in model.parameters():
                    p.mul_(0.9).add_(0.01)
        want, want_n, want_index = run(eager, model)
        got, got_n, got_index = run(graphed, model)
        assert got == want, (case, call)
        assert got_n == want_n, (case, call, got_n, want_n)
        assert all(torch.equal(a, b) for a, b in zip(got_index, want_index)), (case, call)
    assert sum(want_n.catalog_topk.values()) + sum(want_n.groupmax.values()) > 0
    if quantized:
        assert want_n.groupmax and want_n.tournament_rerank > 0, want_n
    else:
        assert want_n.catalog_topk.get("bf16" if dtype == torch.bfloat16 else "f32", 0) > 0
    shapes = {tuple(rows.shape) for rows in graphed.row_batches}
    assert graphed._build.captures == 1 and len(graphed._build.entries) == 1
    assert graphed._metrics.captures == len(graphed._metrics.entries) == len(shapes)
    assert graphed._metrics.replays == 3 * len(graphed.row_batches) - len(shapes)


@pytest.mark.cuda
def test_card_a_replaced_parameter_captures_anew(cat, dev):
    cfg = config(cat)
    model = CARCA(cfg.model, generator=torch.Generator().manual_seed(3), device=dev)
    eager, graphed = evaluators(cfg, cat, dev, True, False, torch.float32)
    for _ in range(3):
        graphed(model)
    captures = (graphed._build.captures, graphed._metrics.captures)
    model.embed.items = torch.nn.Parameter(model.embed.items.detach() * 0.5)
    for _ in range(3):  # a new key: its warm-up, then its capture
        got = graphed(model)
    assert graphed._build.captures == captures[0] + 1
    assert graphed._metrics.captures > captures[1]
    assert got == eager(model)


@pytest.mark.cuda
def test_card_knn_replays_equal_the_eager_calls(cat, dev):
    builder = BatchBuilder(cat, L, T)
    attrs = torch.as_tensor(cat.attrs, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    users = builder.users("val")
    batches = []
    for i in range(4):
        b = builder.eval_batch(users[i * B:(i + 1) * B], rng, "val")
        b.pop("n_valid")
        batches.append(b)
    graphed, eager = make_knn_eval_step(10), make_knn_eval_step(10, graph=False)
    for b in batches:
        got, want = graphed(None, attrs, b), eager(None, attrs, b)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert (graphed.captures, graphed.replays) == (1, 3)
