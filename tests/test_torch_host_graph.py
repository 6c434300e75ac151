"""The host pipeline's train step and every eval step as one CUDA graph
replay (``carca_tpu_torch/train/graph.py``: ``GraphedStep`` at K = 1 over a
host batch or [B] user rows, ``GraphedEval``), the staging region they share
with serving (``carca_tpu_torch/utils/staging.py``) and the fit loop around
them.

On the CPU (d = 16, L = 8, ~100 items; the families' real batch shapes for
the regions), where no graph runs:

* (a) ``Region``'s sections for each family's train and eval batches start
  512-byte aligned, with the dtypes and shapes ``BatchBuilder`` gives, and
  a batch written through them reads back unchanged; the train call's
  sections add seeds, learning rates and row scalars;
* (b) ``graph=True`` raises on a CPU state and with a mesh for every
  builder that takes it, and ``graph=None`` on the CPU equals
  ``graph=False``;
* (c) ``on_step`` (the fit's EMA) inside a step equals the step followed
  by ``ema_update``; the step on the staged region's views equals the
  step on the host batch;
* (d) a re-seeded eval generator draws what a fresh ``eval_generator``
  draws, epoch by epoch, and ``evaluate_device`` over two epochs is
  unchanged by it;
* (e) ``GraphedEval`` with a stand-in capture (the capture records the
  call, a "replay" reruns it on the region's views): each replay equals
  the eager call, the outputs are cloned, a ``load_state_dict`` is read by
  the next replay, a replaced tensor warms up and captures anew, and a
  failed capture raises each time, with no eager retry;
* (f) ``fit(graph=None)`` equals ``fit(graph=False)``, host and device
  pipelines, with the EMA;
* (g) ``bench_scaling`` builds its size-1 step with ``graph=False``.

On the card (``cuda`` marker, skipped here; run there with ``python -m
pytest --noconftest tests/test_torch_host_graph.py -q -m cuda``): the graph
of each builder equals its eager call bit for bit over four calls at
dropout 0 and 0.5 with the EMA (losses, parameters, Adam's state, the
shadow, launches); the eval graphs over two re-seeded "epochs"; a replay
after ``restore_best`` reads the restored weights; a replaced tensor
captures anew; a failed capture raises with no eager retry.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from carca_tpu_torch import bench_scaling
from carca_tpu_torch.config import Config, DataConfig, TrainConfig, preset
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops import launches
from carca_tpu_torch.train import graph as step_graph
from carca_tpu_torch.train import loop
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import (ema_update, eval_generator, evaluate_device, fit,
                                        make_device_eval_step, make_device_train_step,
                                        make_eval_step, make_scanned_device_eval_step,
                                        make_scanned_device_train_step, make_train_step)
from carca_tpu_torch.train.state import create_train_state
from carca_tpu_torch.utils.staging import ALIGN, Region, sections_of
from carca_tpu_torch.validate_presets import FAMILIES, family_catalog, family_config

torch.set_num_threads(1)

L, T, B, K, D = 8, 10, 6, 3, 16
EMA = 0.9


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=100, seed=3)


def small(cat, dropout=0.0, device="cpu", **train):
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    mc = dataclasses.replace(cfg.model, d=D, g=32, seq_len=L, target_len=T, n_blocks=2,
                             n_heads=2, dropout=dropout, embedding="all", decoder="ca")
    tc = TrainConfig(batch_size=B, inner_steps=K, seed=5, lr_schedule="cosine",
                     lr_decay_steps=7, lr_decay_rate=0.1, l2_reg=1e-3, **train)
    return mc, tc, torch.as_tensor(cat.attrs, device=device)


def host_batches(cat, n, mode="train", seed=0):
    """``n`` host batches of B rows, numpy, without n_valid."""
    builder = BatchBuilder(cat, L, T)
    users = builder.users("train" if mode == "train" else mode)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = np.roll(users, -i * B)[:B]
        b = builder.train_batch(rows, rng) if mode == "train" else builder.eval_batch(rows, rng,
                                                                                      mode)
        b.pop("n_valid")
        out.append(b)
    return out


def user_rows(cat, n, k=None):
    users = DeviceDataset(cat, L, T, device="cpu").users("train")
    shape = (B,) if k is None else (k, B)
    size = int(np.prod(shape))
    return [torch.as_tensor(np.roll(users, -i * size)[:size].reshape(shape), dtype=torch.int64)
            for i in range(n)]


def params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


# --------------------------------------------------------------------------
# (a) the staging region
# --------------------------------------------------------------------------

# BatchBuilder's dtypes (data/dataset.py: train_batch, eval_batch)
BATCH_DTYPES = {"p_x": torch.int32, "p_c": torch.float32, "o_x": torch.int32,
                "o_c": torch.float32, "y_true": torch.float32}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_batches(request):
    name = request.param
    fam = FAMILIES[name]
    cfg = family_config(fam, 1, 1, "unused")
    mc, b = cfg.model, cfg.train.batch_size
    builder = BatchBuilder(family_catalog(fam), mc.seq_len, mc.target_len)
    out = {}
    for mode in ("train", "val"):
        users = builder.users(mode)[:b]
        rng = np.random.default_rng(0)
        batch = (builder.train_batch(users, rng) if mode == "train"
                 else builder.eval_batch(users, rng, mode))
        batch.pop("n_valid")
        out[mode] = batch
    return name, mc, b, out


@pytest.mark.parametrize("mode", ["train", "val"])
def test_a_region_holds_each_familys_batches(family_batches, mode):
    name, mc, b, batches = family_batches
    batch = batches[mode]
    c, width = mc.n_ctx, 2 * mc.seq_len if mode == "train" else mc.target_len + 1
    want = {"p_x": (b, mc.seq_len), "p_c": (b, mc.seq_len, c), "o_x": (b, width),
            "o_c": (b, width, c), "y_true": (b, width)}
    sections = sections_of(batch)
    assert [(n, dt, sh) for n, dt, sh in sections] == [
        (n, BATCH_DTYPES[n], want[n]) for n in ("p_x", "p_c", "o_x", "o_c", "y_true")], name
    inputs = step_graph._Inputs(sections, "cpu")
    for n, view in inputs.d.items():
        assert (view.data_ptr() - inputs.region.dev.data_ptr()) % ALIGN == 0, n
        assert view.is_contiguous()
    inputs.write(batch)
    for n, a in batch.items():
        np.testing.assert_array_equal(inputs.d[n].numpy(), a, err_msg=n)
        np.testing.assert_array_equal(inputs.region.np[n], a, err_msg=n)


def test_a_train_sections_add_seeds_lrs_and_row_scalars():
    rows = {"rows": torch.zeros(K, B, dtype=torch.int64)}
    secs = step_graph.train_sections(rows, K, 5)
    assert secs == [("rows", torch.int64, (K, B)), ("seeds", torch.int64, (5,)),
                    ("lrs", torch.float32, (K,)), ("scalars", torch.float32, (K, 3))]
    region = Region(step_graph.train_sections(rows, K, 0), "cpu")
    assert region.d["seeds"].shape == (0,)
    for n, view in region.d.items():
        assert (view.data_ptr() - region.dev.data_ptr()) % ALIGN == 0 or not view.numel(), n


# --------------------------------------------------------------------------
# (b) graph=True raises; graph=None on the CPU is the eager call
# --------------------------------------------------------------------------

def builders(mc, tc):
    """Each builder's graph form, by name: (build(graph, mesh), kind)."""
    return {
        "train": (lambda g, m=None: make_train_step(mc, tc, graph=g, mesh=m), "host train"),
        "device_train": (lambda g, m=None: make_device_train_step(mc, tc, graph=g, mesh=m),
                         "device train"),
        "scanned_train": (lambda g, m=None: make_scanned_device_train_step(
            mc, K, tc, graph=g, mesh=m), "scanned train"),
        "eval": (lambda g, m=None: make_eval_step(mc, tc.top_k, graph=g, mesh=m), "host eval"),
        "device_eval": (lambda g, m=None: make_device_eval_step(mc, tc.top_k, "val", graph=g,
                                                                mesh=m), "device eval"),
        "scanned_eval": (lambda g, m=None: make_scanned_device_eval_step(
            mc, tc.top_k, "val", K, graph=g, mesh=m), "scanned eval"),
    }


BUILDERS = ["train", "device_train", "scanned_train", "eval", "device_eval", "scanned_eval"]


def call(kind, step, state, attrs, cat, i=0, gen=None):
    """One call of a step of ``kind`` on the i-th inputs."""
    if kind == "host train":
        return step(state, attrs, host_batches(cat, i + 1)[i])
    if kind == "host eval":
        return step(state.model, attrs, host_batches(cat, i + 1, "val")[i])
    dd = DeviceDataset(cat, L, T, device="cpu")
    rows = user_rows(cat, i + 1, K if "scanned" in kind else None)[i]
    if "train" in kind:
        return step(state, attrs, dd.arrays, rows)
    return step(state.model, attrs, dd.arrays, rows, gen)


@pytest.mark.parametrize("name", BUILDERS)
def test_b_graph_true_raises_on_a_cpu_state_and_with_a_mesh(cat, name):
    mc, tc, attrs = small(cat)
    build, kind = builders(mc, tc)[name]
    with pytest.raises(ValueError, match="mesh stays the eager loop"):
        build(True, object())
    assert build(None, object()).mode == "eager" and build(False).mode == "eager"
    state = create_train_state(mc, tc, device="cpu")
    before = params(state.model)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        call(kind, build(True), state, attrs, cat, gen=torch.Generator().manual_seed(0))
    assert state.step == 0
    assert_params_equal(params(state.model), before)


@pytest.mark.parametrize("name", BUILDERS)
def test_b_graph_none_on_the_cpu_equals_graph_false(cat, name):
    mc, tc, attrs = small(cat, dropout=0.5)
    build, kind = builders(mc, tc)[name]
    runs = []
    for graph in (None, False):
        state = create_train_state(mc, tc, device="cpu")
        step = build(graph)
        assert (step.mode == "graph") == (graph is None)
        gen = torch.Generator().manual_seed(9)
        outs = [call(kind, step, state, attrs, cat, i, gen) for i in range(3)]
        if "train" in kind:
            outs = [o[1] for o in outs]
        runs.append((outs, params(state.model), state.step))
    (a, pa, sa), (b, pb, sb) = runs
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)
    assert_params_equal(pa, pb)
    assert sa == sb


# --------------------------------------------------------------------------
# (c) the EMA inside the step; the step on the region's views
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["host train", "device train"])
def test_c_on_step_ema_equals_the_step_then_ema_update(cat, kind):
    mc, tc, attrs = small(cat, dropout=0.5)
    runs = []
    for inside in (True, False):
        state = create_train_state(mc, tc, device="cpu")
        ema = CARCA(mc, device="cpu")
        ema.load_state_dict(state.model.state_dict())
        on = dict(on_step=lambda st, e=ema: ema_update(e, st.model, EMA)) if inside else {}
        step = (make_train_step(mc, tc, graph=False, **on) if kind == "host train"
                else make_device_train_step(mc, tc, graph=False, **on))
        losses = []
        for i in range(3):
            state, loss = call(kind, step, state, attrs, cat, i)
            if not inside:
                ema_update(ema, state.model, EMA)
            losses.append(loss)
        runs.append((torch.stack(losses), params(state.model), params(ema)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert_params_equal(runs[0][1], runs[1][1])
    assert_params_equal(runs[0][2], runs[1][2])
    assert not torch.equal(runs[0][2]["embed.items"], runs[0][1]["embed.items"])


def staged_call(step_eager, feed, state, attrs, *args):
    """The eager call on the views of a region the call's inputs were
    written into, as the capture hands them over."""
    f = feed(*args)
    inputs = step_graph._Inputs(sections_of(f.staged), "cpu")
    inputs.write(f.staged)
    return step_eager(state, attrs, *f.args(inputs.d))


@pytest.mark.parametrize("kind", ["host train", "device train", "host eval", "device eval"])
def test_c_the_step_on_the_region_views_equals_the_step_on_the_host_inputs(cat, kind):
    mc, tc, attrs = small(cat, dropout=0.5)
    dd = DeviceDataset(cat, L, T, device="cpu")
    feed = step_graph.host_feed if "host" in kind else step_graph.device_feed(None)
    outs = []
    for staged in (True, False):
        state = create_train_state(mc, tc, device="cpu")
        if kind == "host train":
            step, args = make_train_step(mc, tc, graph=False), (host_batches(cat, 1)[0],)
        elif kind == "device train":
            step, args = make_device_train_step(mc, tc, graph=False), (dd.arrays,
                                                                         user_rows(cat, 1)[0])
        elif kind == "host eval":
            step, args = make_eval_step(mc, tc.top_k, graph=False), (host_batches(cat, 1,
                                                                                  "val")[0],)
        else:
            step = make_device_eval_step(mc, tc.top_k, "val", graph=False)
            args = (dd.arrays, user_rows(cat, 1)[0], torch.Generator().manual_seed(4))
        first = state if "train" in kind else state.model
        out = (staged_call(step, feed, first, attrs, *args) if staged
               else step(first, attrs, *args))
        outs.append((out[1:] if "train" in kind else out, params(state.model)))
    for u, v in zip(outs[0][0], outs[1][0]):
        assert torch.equal(u, v)
    assert_params_equal(outs[0][1], outs[1][1])


# --------------------------------------------------------------------------
# (d) the re-seeded eval generator
# --------------------------------------------------------------------------

def test_d_a_reseeded_eval_generator_draws_a_fresh_ones_epoch_by_epoch():
    gen = None
    for salt in (1, 2, loop.TEST_SALT, 1):
        gen2 = eval_generator(7, salt, "cpu", gen)
        assert gen is None or gen2 is gen
        gen = gen2
        fresh = eval_generator(7, salt, "cpu")
        assert gen.initial_seed() == fresh.initial_seed()
        assert torch.equal(torch.randint(10**6, (50,), generator=gen),
                           torch.randint(10**6, (50,), generator=fresh))


def test_d_evaluate_device_over_two_epochs_is_unchanged_by_reseeding(cat):
    mc, tc, attrs = small(cat)
    dd = DeviceDataset(cat, L, T, device="cpu")
    model = CARCA(mc, generator=torch.Generator().manual_seed(1), device="cpu")
    users = dd.users("val")
    runs = {}
    for how in ("fresh", "reseeded"):
        step = make_device_eval_step(mc, tc.top_k, "val")
        scanned = make_scanned_device_eval_step(mc, tc.top_k, "val", K)
        gen, res = None, []
        for epoch in (1, 2):
            gen = eval_generator(tc.seed, epoch, "cpu", gen if how == "reseeded" else None)
            res.append(evaluate_device(step, model, attrs, dd.arrays, users, B, gen,
                                       scanned_step=scanned, inner_steps=K))
        runs[how] = res
    assert runs["fresh"] == runs["reseeded"]
    assert runs["fresh"][0] != runs["fresh"][1]  # the epochs draw other negatives


# --------------------------------------------------------------------------
# (e) GraphedEval around a stand-in capture
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


def _stand_in_record(self, fn, generator):
    saved = None if generator is None else generator.get_state()
    outputs = fn()
    if generator is not None:
        generator.set_state(saved)  # a capture draws nothing
    return _Rerun(fn, outputs), outputs


@pytest.fixture
def stand_in(monkeypatch):
    """GraphedEval on the CPU: calls take the card's route, the warm-up runs
    the eager call, the capture records it."""
    monkeypatch.setattr(step_graph, "_cpu_call", lambda required, device: False)
    monkeypatch.setattr(step_graph.GraphedEval, "_warm_up", lambda self, device, fn: fn())
    monkeypatch.setattr(step_graph.GraphedEval, "_record", _stand_in_record)


def test_e_eval_replays_equal_the_eager_calls_and_are_clones(cat, stand_in):
    mc, tc, attrs = small(cat)
    model = CARCA(mc, generator=torch.Generator().manual_seed(1), device="cpu")
    graphed, eager = make_eval_step(mc, tc.top_k), make_eval_step(mc, tc.top_k, graph=False)
    batches = host_batches(cat, 4, "val")
    got = [graphed(model, attrs, b) for b in batches]
    assert (graphed.captures, graphed.replays) == (1, 3)
    for g, b in zip(got, batches):
        want = eager(model, attrs, b)
        assert all(torch.equal(u, v) for u, v in zip(g, want))
    entry = next(iter(graphed.entries.values()))
    assert all(g is not o for g in got[-1] for o in entry.outputs)
    assert not torch.equal(got[2][2], got[3][2])  # the last replay left its own outputs


def test_e_device_eval_replays_over_two_reseeded_epochs(cat, stand_in):
    mc, tc, attrs = small(cat)
    dd = DeviceDataset(cat, L, T, device="cpu")
    model = CARCA(mc, generator=torch.Generator().manual_seed(1), device="cpu")
    users = dd.users("val")
    runs = {}
    for graph in (None, False):
        step = make_device_eval_step(mc, tc.top_k, "val", graph=graph)
        scanned = make_scanned_device_eval_step(mc, tc.top_k, "val", K, graph=graph)
        gen, res = None, []
        for epoch in (1, 2):
            gen = eval_generator(tc.seed, epoch, "cpu", gen)
            res.append(evaluate_device(step, model, attrs, dd.arrays, users, B, gen,
                                       scanned_step=scanned, inner_steps=K))
        runs[graph] = (res, step, scanned)
    assert runs[None][0] == runs[False][0]
    _, step, scanned = runs[None]
    assert step.captures == scanned.captures == 1
    assert step.replays > 0 and scanned.replays > 0


def test_e_a_load_state_dict_is_read_and_a_replaced_tensor_captures_anew(cat, stand_in,
                                                                        tmp_path):
    mc, tc, attrs = small(cat)
    model = CARCA(mc, generator=torch.Generator().manual_seed(1), device="cpu")
    other = CARCA(mc, generator=torch.Generator().manual_seed(2), device="cpu")
    step, eager = make_eval_step(mc, tc.top_k), make_eval_step(mc, tc.top_k, graph=False)
    batch = host_batches(cat, 1, "val")[0]
    for _ in range(3):
        step(model, attrs, batch)
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    keeper.save(1, other, {"ndcg": 1.0, "hr": 1.0, "epoch": 1})
    keeper.restore_best(model)  # in place: the same key
    got = step(model, attrs, batch)
    assert (step.captures, len(step.entries)) == (1, 1)
    assert all(torch.equal(u, v) for u, v in zip(got, eager(other, attrs, batch)))
    model.embed.items = torch.nn.Parameter(model.embed.items.detach().clone())
    for i in range(3):  # a new key: its warm-up, then a capture
        got = step(model, attrs, batch)
    assert (step.captures, len(step.entries)) == (2, 2)
    assert all(torch.equal(u, v) for u, v in zip(got, eager(other, attrs, batch)))


def test_e_a_failed_capture_raises_each_time_and_never_falls_back(cat, stand_in):
    mc, tc, attrs = small(cat)
    model = CARCA(mc, device="cpu")
    calls = []

    def eager(model, attrs_table, batch):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("operation not permitted when stream is capturing")
        return (torch.zeros(()),)

    step = step_graph.GraphedEval(eager, step_graph.host_feed)
    batch = host_batches(cat, 1, "val")[0]
    step(model, attrs, batch)  # the warm-up
    for n in (2, 3):
        with pytest.raises(RuntimeError, match="capturing"):
            step(model, attrs, batch)
        assert len(calls) == n  # one capture attempt, no eager retry
    assert (step.captures, step.replays) == (0, 0)


def test_e_a_replay_adds_the_captured_launches_once(cat, stand_in):
    mc, tc, attrs = small(cat)
    model = CARCA(mc, device="cpu")
    counted = launches.Launches(attention_fwd=3)

    def eager(model, attrs_table, batch):
        launches.add(counted)  # stands in for three K1 launches
        return (torch.ones(()),)

    step = step_graph.GraphedEval(eager, step_graph.host_feed)
    batch = host_batches(cat, 1, "val")[0]
    before = launches.snapshot()
    try:
        for n in (1, 2, 3, 4):
            step(model, attrs, batch)
            assert launches.since(before).attention_fwd == 3 * n
    finally:
        launches.restore(before)


# --------------------------------------------------------------------------
# (f) fit
# --------------------------------------------------------------------------

def fit_cfg(cat, out, device_pipeline):
    mc, tc, _ = small(cat, dropout=0.3)
    tc = dataclasses.replace(tc, epochs=2, early_stop=5, out_dir=str(out), ema_decay=EMA,
                             inner_steps=2 if device_pipeline else 1, verbose=0)
    return Config(mc, DataConfig(device_pipeline=device_pipeline, use_native=False), tc)


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_f_fit_graph_none_equals_graph_false(cat, tmp_path, pipeline):
    runs = {}
    for graph in (None, False):
        cfg = fit_cfg(cat, tmp_path / str(graph), pipeline == "device")
        state, final = fit(cfg, cat, device="cpu", graph=graph)
        with open(os.path.join(cfg.train.out_dir, "metrics.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        drop = ("examples_per_sec", "candidates_per_sec", "epoch_seconds")
        runs[graph] = ([{k: v for k, v in r.items() if k not in drop} for r in rows], final,
                       params(state.model), state.step)
    assert runs[None][0] == runs[False][0] and len(runs[None][0]) == 2
    assert runs[None][1] == runs[False][1]
    assert_params_equal(runs[None][2], runs[False][2])
    assert runs[None][3] == runs[False][3] > 0


# --------------------------------------------------------------------------
# (g) bench_scaling's size 1
# --------------------------------------------------------------------------

class Stop(Exception):
    """Raised by the recording step builder: run_one goes no further."""


def test_g_bench_scaling_builds_size_1_with_graph_false(monkeypatch):
    seen = {}

    def recording(mc, tc, *args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(loop, "make_train_step", recording)
    with pytest.raises(Stop):
        bench_scaling.run_one(1, types.SimpleNamespace(device="cpu", shard_embeddings=False,
                                                       per_chip_batch=8, steps=1))
    assert seen == {"graph": False}


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


def card_state(mc, tc, dev, base):
    state = create_train_state(mc, tc, dev, model=CARCA(mc, device=dev))
    state.model.load_state_dict(base.state_dict())
    ema = CARCA(mc, device=dev).eval()
    ema.load_state_dict(base.state_dict())
    return state, ema


def state_tensors(state, ema):
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam {i} {k}": v for k, v in st.items()})
    out.update({f"ema {n}": p.detach() for n, p in ema.named_parameters()})
    out["generator"] = state.generator.get_state()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["host train", "device train"])
def test_card_train_replays_equal_the_eager_calls(cat, dev, kind, dropout):
    mc, tc, attrs = small(cat, dropout=dropout, device=dev)
    dd = DeviceDataset(cat, L, T, device=dev)
    base = CARCA(mc, device=dev)
    inputs = host_batches(cat, 4) if kind == "host train" else user_rows(cat, 4)
    runs = {}
    for name, graph in (("eager", False), ("eager again", False), ("graph", None)):
        state, ema = card_state(mc, tc, dev, base)
        on = dict(on_step=lambda st, e=ema: ema_update(e, st.model, EMA),
                  watch=lambda e=ema: list(e.parameters()), graph=graph)
        step = (make_train_step(mc, tc, **on) if kind == "host train"
                else make_device_train_step(mc, tc, **on))
        before = launches.snapshot()
        losses = []
        for x in inputs:
            args = (x,) if kind == "host train" else (dd.arrays, x)
            state, loss = step(state, attrs, *args)
            losses.append(loss)
        torch.cuda.synchronize()
        runs[name] = (torch.stack(losses), state_tensors(state, ema), launches.since(before),
                      state.step, step)
    for name in ("eager again", "graph"):
        assert torch.equal(runs[name][0], runs["eager"][0]), name
        for t in runs["eager"][1]:
            assert torch.equal(runs[name][1][t].cpu(), runs["eager"][1][t].cpu()), (name, t)
        assert runs[name][2] == runs["eager"][2] and runs[name][3] == 4
    assert runs["eager"][2].attention_fwd > 0 and runs["eager"][2].attention_bwd > 0
    assert (runs["graph"][4].captures, runs["graph"][4].replays) == (1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["host eval", "device eval", "scanned eval"])
def test_card_eval_replays_equal_the_eager_calls_over_two_epochs(cat, dev, kind):
    mc, tc, attrs = small(cat, device=dev)
    dd = DeviceDataset(cat, L, T, device=dev)
    model = CARCA(mc, device=dev)
    runs = {}
    for graph in (False, None):
        if kind == "host eval":
            step = make_eval_step(mc, tc.top_k, graph=graph)
        elif kind == "device eval":
            step = make_device_eval_step(mc, tc.top_k, "val", graph=graph)
        else:
            step = make_scanned_device_eval_step(mc, tc.top_k, "val", K, graph=graph)
        gen, outs = None, []
        before = launches.snapshot()
        for epoch in (1, 2):
            gen = eval_generator(tc.seed, epoch, dev, gen)
            for i in range(3):
                if kind == "host eval":
                    outs.append(step(model, attrs, host_batches(cat, 3, "val", epoch)[i]))
                else:
                    rows = user_rows(cat, 3, K if kind == "scanned eval" else None)[i]
                    outs.append(step(model, attrs, dd.arrays, rows, gen))
        torch.cuda.synchronize()
        runs[graph] = (outs, launches.since(before), step)
    for a, b in zip(runs[False][0], runs[None][0]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert runs[None][1] == runs[False][1] and runs[False][1].attention_fwd > 0
    assert (runs[None][2].captures, runs[None][2].replays) == (1, 5)


@pytest.mark.cuda
def test_card_a_replay_reads_restore_best_and_a_replaced_tensor_captures_anew(cat, dev,
                                                                            tmp_path):
    mc, tc, attrs = small(cat, device=dev)
    model = CARCA(mc, generator=torch.Generator().manual_seed(1), device=dev)
    other = CARCA(mc, generator=torch.Generator().manual_seed(2), device=dev)
    step, eager = make_eval_step(mc, tc.top_k), make_eval_step(mc, tc.top_k, graph=False)
    batch = host_batches(cat, 1, "val")[0]
    for _ in range(3):
        step(model, attrs, batch)
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    keeper.save(1, other, {"ndcg": 1.0, "hr": 1.0, "epoch": 1})
    keeper.restore_best(model)
    got = step(model, attrs, batch)
    assert step.captures == 1
    assert all(torch.equal(u, v) for u, v in zip(got, eager(other, attrs, batch)))
    model.embed.items = torch.nn.Parameter(model.embed.items.detach().clone())
    for _ in range(3):
        got = step(model, attrs, batch)
    assert step.captures == 2
    assert all(torch.equal(u, v) for u, v in zip(got, eager(other, attrs, batch)))


@pytest.mark.cuda
def test_card_a_failed_capture_raises_and_does_not_fall_back(cat, dev):
    mc, tc, attrs = small(cat, device=dev)
    state = create_train_state(mc, tc, dev)
    step = make_train_step(mc, tc, on_step=lambda st: float(
        next(st.model.parameters()).detach().sum()))  # a host sync
    batches = host_batches(cat, 2)
    step(state, attrs, batches[0])  # the eager warm-up may read the host
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(state, attrs, batches[1])
    assert step.captures == 0 and state.step == 1
    model = CARCA(mc, device=dev)
    ev = step_graph.GraphedEval(lambda m, a, b: (torch.ones((), device=dev) * float(
        next(m.parameters()).detach().sum()),), step_graph.host_feed)
    batch = host_batches(cat, 1, "val")[0]
    ev(model, attrs, batch)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            ev(model, attrs, batch)
    assert ev.captures == 0
