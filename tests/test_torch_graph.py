"""The K-step train call as one CUDA graph (``carca_tpu_torch/train/graph.py``)
and what the capture changed around it: the attention kernels' seed slots,
Adam's tensor learning rate and the row-sparse Adam's device scalars.

On the CPU (d = 16, L = 8, ~100 items), where no graph runs:

* (a) a seed slot gives the int seed's keep mask, output and gradients;
  ``kernel_seed`` hands out the installed buffer's slots in call order
  under capture and raises with none installed or with its slots used up;
  one draw of n seeds is n eager draws;
* (b) the lr buffer of K steps across a cosine's and an exponential
  schedule's end equals ``schedule(step + k)`` in float32, and reaches
  Adam's lr tensor eagerly and from its slot under capture;
* (c) ``apply_rows_update`` with 0-dim tensor lr and corrections is
  bit-equal to the host floats, and matches the JAX package's within
  ``test_torch_sparse_adam.py``'s tolerances (table 1e-7, moments 1e-8);
* (d) a K-step call advances ``TrainState.step`` and the sparse count by
  K; a capture puts the host counters back and each replay adds the
  captured call's kernel launches once;
* (e) ``graph=True`` on a CPU state raises, and so does ``graph=True``
  with a mesh.

On the card (``cuda`` marker, skipped here; run there with ``python -m
pytest --noconftest tests/test_torch_graph.py -q -m cuda``): three calls
of the graph equal three eager calls bit for bit, dense and row-sparse, at
dropout 0 and 0.5 (the eager call first checked against itself); two
replays of a captured K1/K2 draw other bits, each the eager bits of its
seed; a replay after ``restore_latest`` captures anew; a capture that
fails raises, and so does a capture with dropout and no seed buffer.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from carca_tpu_torch.config import TrainConfig, preset
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.attention import masked_attention
from carca_tpu_torch.ops import flash_attention as fa
from carca_tpu_torch.ops.flash_attention import (attention_bwd, attention_grads_plain,
                                                 attention_keep_mask, fused_attention,
                                                 kernel_seed, seed_slots)
from carca_tpu_torch.train import graph as step_graph
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import _set_lr, make_scanned_device_train_step
from carca_tpu_torch.train.state import create_train_state, make_schedule

torch.set_num_threads(1)

L, B, K, H, D = 8, 6, 3, 2, 16


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=100, seed=3)


def small(cat, device="cpu", dropout=0.5, sparse=False, **train):
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    mc = dataclasses.replace(cfg.model, d=D, g=32, seq_len=L, target_len=10, n_blocks=2,
                             n_heads=H, dropout=dropout, embedding="all", decoder="ca")
    tc = TrainConfig(batch_size=B, inner_steps=K, seed=5, lr_schedule="cosine",
                     lr_decay_steps=7, lr_decay_rate=0.1, l2_reg=1e-3,
                     sparse_items_adam=True if sparse else "auto", **train)
    dd = DeviceDataset(cat, L, 10, device=device)
    attrs = torch.as_tensor(cat.attrs, device=device)
    users = dd.users("train")
    calls = [torch.as_tensor(np.stack([np.roll(users, -(c * K + i) * B)[:B] for i in range(K)]),
                             dtype=torch.int64) for c in range(4)]
    return mc, tc, dd, attrs, calls


def attn_inputs(b=3, lq=8, lk=6, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, D)).astype(np.float32) for n in (lq, lk, lk))
    qm = (rng.random((b, lq)) > 0.2).astype(np.float32)
    km = (rng.random((b, lk)) > 0.2).astype(np.float32)
    g = rng.standard_normal((b, lq, D)).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, qm, km, g)]


# --------------------------------------------------------------------------
# (a) seeds from slots
# --------------------------------------------------------------------------

def test_a_seed_slot_gives_the_int_seeds_mask_output_and_gradients(monkeypatch):
    q, k, v, qm, km, g = attn_inputs()
    seed = 2**40 + 12345
    slot = torch.tensor([7, seed, 9], dtype=torch.int64)[1]  # a 0-dim view, as the buffer's
    shape = (3, H, 8, 6)
    assert torch.equal(attention_keep_mask(slot, shape, 0.5), attention_keep_mask(seed, shape, 0.5))
    kw = dict(causal=-1, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=0.5)
    for a, b in zip(attention_bwd(q, k, v, qm, km, g, seed=slot, **kw),
                    attention_bwd(q, k, v, qm, km, g, seed=seed, **kw)):
        assert torch.equal(a, b)

    # the autograd.Function the card runs, its launches replaced by their
    # plain versions fed the Philox bits of the seed they were given
    def plain_launch(q, k, v, q_mask, k_mask, *, seed, dropout_rate, **o):
        keep = attention_keep_mask(seed, (q.shape[0], o["n_heads"], q.shape[1], k.shape[1]),
                                   dropout_rate)
        return masked_attention(q, k, v, q_mask, k_mask, dropout_rate=dropout_rate,
                                keep_mask=keep, **o)

    monkeypatch.setattr(fa, "_launch_fwd", plain_launch)
    outs = []
    for s in (slot, seed):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa._KernelAttention.apply(qq, kk, vv, qm, km,
                                        dict(kw, compute_dtype="float32", seed=s))
        out.backward(g)
        outs.append((out.detach(), qq.grad, kk.grad, vv.grad))
    keep = attention_keep_mask(seed, shape, 0.5)
    want = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, w in zip(outs[0][1:], want):
        assert torch.equal(a, w)


def test_a_kernel_seed_takes_slots_under_capture_and_raises_without(monkeypatch):
    gen = torch.Generator().manual_seed(11)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    eager = [kernel_seed(gen) for _ in range(5)]
    again = step_graph.draw_seeds(torch.Generator().manual_seed(11), 5)
    assert again.tolist() == eager and len(set(eager)) == 5

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="seed buffer"):
        kernel_seed(gen)
    buf = torch.zeros(2, dtype=torch.int64)
    drawn = kernel_seed.drawn
    with seed_slots(buf) as taken:
        slots = [kernel_seed(gen), kernel_seed(gen)]
        assert taken() == 2
        with pytest.raises(RuntimeError, match="more than the 2 seed slots"):
            kernel_seed(gen)
    assert [s.data_ptr() for s in slots] == [buf[0].data_ptr(), buf[1].data_ptr()]
    assert kernel_seed.drawn == drawn  # under capture nothing is drawn
    buf.copy_(step_graph.draw_seeds(torch.Generator().manual_seed(11), 2))
    assert [int(s) for s in slots] == eager[:2]  # the slots read what the caller wrote
    # two calls' seeds differ, so their keep bits differ
    shape = (2, H, 8, 8)
    nxt = step_graph.draw_seeds(gen, 2)
    assert not torch.equal(attention_keep_mask(int(nxt[0]), shape, 0.5),
                           attention_keep_mask(eager[0], shape, 0.5))
    with pytest.raises(RuntimeError, match="seed buffer"):
        kernel_seed(gen)  # uninstalled on leaving


# --------------------------------------------------------------------------
# (b) the learning rates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cosine", "exponential"])
def test_b_lr_buffer_is_the_schedule_in_float32_across_its_end(kind):
    tc = TrainConfig(lr=3e-3, lr_schedule=kind, lr_decay_steps=5, lr_decay_rate=0.2)
    sched = make_schedule(tc)
    for step in (0, 3, 4, 9):  # windows before, across and after the decay's end
        got = step_graph.step_lrs(sched, step, 4)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.float32([sched(step + k) for k in range(4)]))
    assert not step_graph.step_lrs(None, 3, 4).any()


def test_b_lr_reaches_a_tensor_lr_eagerly_and_from_its_slot_under_capture(cat):
    mc, tc, *_ = small(cat)
    state = create_train_state(mc, tc, device="cpu")
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    lr = torch.tensor(tc.lr, dtype=torch.float32)
    state.optimizer = torch.optim.Adam(params, lr=lr, foreach=False)
    state.step = 5
    _set_lr(state)
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == np.float32(state.schedule(5))
    lrs = torch.from_numpy(step_graph.step_lrs(state.schedule, 6, 3))
    step_graph._active.append(step_graph._Capture(lrs, torch.zeros(3, 3)))
    try:
        for k in range(3):
            _set_lr(state)
            assert lr.item() == lrs[k].item()
        with pytest.raises(RuntimeError, match="more than 3 learning rates"):
            _set_lr(state)
    finally:
        step_graph._active.clear()


# --------------------------------------------------------------------------
# (c) the row-sparse Adam's device scalars
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,count", [(0.0, 0), (1e-2, 3)])
def test_c_row_update_with_tensor_scalars_is_the_float_form_and_jaxs(weight_decay, count):
    import jax.numpy as jnp

    from carca_tpu.train import sparse_adam as jsa

    rng = np.random.default_rng(count)
    R, W, cap, lr = 50, 16, 24, 1e-3
    table = rng.standard_normal((R, W)).astype(np.float32)
    munu = np.concatenate([rng.standard_normal((R, W)), rng.random((R, W))], 1).astype(np.float32)
    touched = np.sort(rng.choice(np.arange(1, R), 15, replace=False))
    j_rows = np.concatenate([touched, np.full(cap - 15, R)])
    g = np.zeros((cap, W), np.float32)
    g[:15] = rng.standard_normal((15, W))
    rows = torch.as_tensor(np.where(j_rows < R, j_rows, 0))
    tc = TrainConfig(lr=lr, beta1=0.9, beta2=0.98)
    got = []
    for form in ("floats", "tensors"):
        t, state = torch.from_numpy(table.copy()), {"munu": torch.from_numpy(munu.copy()),
                                                    "count": count}
        kw = dict(lr=lr)
        if form == "tensors":
            v = [torch.tensor(x) for x in sparse_adam.step_scalars(tc, count)]
            kw = dict(lr=v[0], corrections=(v[1], v[2]))
        sparse_adam.apply_rows_update(t, state, rows, rows > 0, torch.from_numpy(g),
                                      torch.from_numpy(table[rows.numpy()]), b1=0.9, b2=0.98,
                                      weight_decay=weight_decay, **kw)
        assert state["count"] == count + 1
        got.append((t, state["munu"]))
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    j_table, j_state = jsa.apply_rows_update(
        jnp.asarray(table), {"munu": jnp.asarray(munu), "count": jnp.asarray(count, jnp.int32)},
        jnp.asarray(j_rows), jnp.asarray(g), jnp.asarray(table[np.minimum(j_rows, R - 1)]),
        lr=jnp.float32(lr), b1=0.9, b2=0.98, weight_decay=weight_decay)
    np.testing.assert_allclose(got[1][0].numpy(), np.asarray(j_table), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[1][1].numpy(), np.asarray(j_state["munu"]), rtol=0, atol=1e-8)


def test_c_step_scalars_are_lr_at_and_the_float32_corrections():
    tc = TrainConfig(lr=2e-3, beta1=0.8, beta2=0.95, lr_schedule="exponential",
                     lr_decay_steps=4, lr_decay_rate=0.5)
    for count in (0, 1, 6):
        got = sparse_adam.step_scalars(tc, count)
        c = np.float32(count + 1)
        want = np.float32([sparse_adam.lr_at(tc, count),
                           np.float32(1) - np.power(np.float32(0.8), c),
                           np.float32(1) - np.power(np.float32(0.95), c)])
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(step_graph.row_scalars(tc, 2, 3),
                                  np.stack([sparse_adam.step_scalars(tc, n) for n in (2, 3, 4)]))


# --------------------------------------------------------------------------
# (d) the host counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_d_a_k_step_call_advances_the_step_and_the_sparse_count_by_k(cat, sparse):
    mc, tc, dd, attrs, calls = small(cat, sparse=sparse)
    state = create_train_state(mc, tc, device="cpu", sparse_items=sparse)
    step = make_scanned_device_train_step(mc, K, tc, sparse_items=sparse)
    assert isinstance(step, step_graph.GraphedStep)  # graph=None: a graph on a card state
    for c in range(2):
        state, losses = step(state, attrs, dd.arrays, calls[c])
        assert losses.shape == (K,) and torch.isfinite(losses).all()
        assert state.step == (c + 1) * K
        if sparse:
            assert state.items_state["count"] == (c + 1) * K


class _NoGraph:
    """Stands in for a captured graph where the CPU has none."""

    def replay(self):
        pass


def test_d_replays_add_the_captured_launches_once_each(cat):
    """The bookkeeping of ``GraphedStep._replay``: each replay advances the
    step and the sparse count by K and the launch counters by what the
    capture counted, and only that."""
    mc, tc, dd, attrs, calls = small(cat, sparse=True)
    state = create_train_state(mc, tc, device="cpu", sparse_items=True)
    g = step_graph.GraphedStep(None, K, tc)
    g.graph, g.losses = _NoGraph(), torch.arange(K, dtype=torch.float32)
    g.launched = (2 * K, Counter({(8, 8, 0): 2 * K}), 2 * K, Counter({(8, 8, 0): 2 * K}))
    before = step_graph.launch_counts()
    try:
        for n in (1, 2):
            state, losses = g._replay(state)
            assert state.step == state.items_state["count"] == n * K
            now = step_graph.launch_counts()
            assert now[0] - before[0] == now[2] - before[2] == 2 * K * n
            assert (now[1] - before[1])[(8, 8, 0)] == (now[3] - before[3])[(8, 8, 0)] == 2 * K * n
            assert torch.equal(losses, g.losses) and losses is not g.losses
    finally:
        step_graph._set_launch_counts(before)


# --------------------------------------------------------------------------
# (e) no fallback
# --------------------------------------------------------------------------

def test_e_graph_true_raises_on_a_cpu_state_and_with_a_mesh(cat):
    mc, tc, dd, attrs, calls = small(cat)
    state = create_train_state(mc, tc, device="cpu")
    step = make_scanned_device_train_step(mc, K, tc, graph=True)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        step(state, attrs, dd.arrays, calls[0])
    assert state.step == 0
    with pytest.raises(ValueError, match="mesh stays the eager loop"):
        make_scanned_device_train_step(mc, K, tc, graph=True, mesh=object())
    eager = make_scanned_device_train_step(mc, K, tc, graph=False)
    assert eager.mode == "eager" and not isinstance(eager, step_graph.GraphedStep)


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


def state_tensors(state):
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"adam {i} {k}": v for k, v in st.items()})
    if state.items_state is not None:
        out["munu"] = state.items_state["munu"]
    out["generator"] = state.generator.get_state()
    return out


def run_calls(step, state, attrs, dd, calls):
    losses = []
    for rows in calls:
        state, lo = step(state, attrs, dd.arrays, rows)
        losses.append(lo)
    torch.cuda.synchronize()
    return torch.cat(losses)


def assert_same(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(ta[name].cpu(), tb[name].cpu()), name
    assert a.step == b.step
    if a.items_state is not None:
        assert a.items_state["count"] == b.items_state["count"]


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_card_replays_equal_the_eager_calls(cat, dev, sparse, dropout):
    mc, tc, dd, attrs, calls = small(cat, dev, dropout=dropout, sparse=sparse)
    runs = {}
    for name, graph in (("eager", False), ("eager again", False), ("graph", None)):
        state = create_train_state(mc, tc, dev, sparse_items=sparse)
        step = make_scanned_device_train_step(mc, K, tc, sparse_items=sparse, graph=graph)
        start = step_graph.launch_counts()
        losses = run_calls(step, state, attrs, dd, calls[:3])
        now = step_graph.launch_counts()
        runs[name] = (state, losses, now[0] - start[0], now[2] - start[2], step)
    eager, again, graph = runs["eager"], runs["eager again"], runs["graph"]
    assert torch.equal(eager[1], again[1])  # the eager call repeats itself
    assert_same(eager[0], again[0])
    assert torch.equal(graph[1], eager[1])
    assert_same(graph[0], eager[0])
    assert graph[2:4] == eager[2:4] and eager[2] > 0 and eager[3] > 0
    assert (graph[4].captures, graph[4].replays) == (1, 2)


@pytest.mark.cuda
def test_card_two_replays_draw_fresh_bits_each_the_eager_bits_of_its_seed(dev):
    q, k, v, qm, km, g = (t.to(dev) for t in attn_inputs(b=4, lq=50, lk=50))
    kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=0.5,
              compute_dtype="float32")
    fa._launch_fwd(q, k, v, qm, km, seed=1, **kw)  # builds the library before the capture
    attention_bwd(q, k, v, qm, km, g, seed=1, **kw)
    torch.cuda.synchronize()
    buf = torch.zeros(1, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    with seed_slots(buf), torch.cuda.graph(graph):
        slot = kernel_seed(None)
        out = fa._launch_fwd(q, k, v, qm, km, seed=slot, **kw)
        grads = attention_bwd(q, k, v, qm, km, g, seed=slot, **kw)
    seen = []
    for seed in (2**40 + 3, 977):
        buf.fill_(seed)
        graph.replay()
        torch.cuda.synchronize()
        want = fa._launch_fwd(q, k, v, qm, km, seed=seed, **kw)
        want_g = attention_bwd(q, k, v, qm, km, g, seed=seed, **kw)
        assert torch.equal(out, want)
        for a, b in zip(grads, want_g):
            assert torch.equal(a, b)
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[1])


@pytest.mark.cuda
def test_card_a_capture_with_dropout_and_no_seed_buffer_raises(dev):
    q, k, v, qm, km, _ = (t.to(dev) for t in attn_inputs())
    kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=0.5)
    seeds = torch.Generator().manual_seed(0)
    fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="seed buffer"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw)


@pytest.mark.cuda
def test_card_a_replay_after_restore_latest_captures_anew(cat, dev, tmp_path):
    mc, tc, dd, attrs, calls = small(cat, dev, dropout=0.0)
    runs = []
    for name, graph in (("eager", False), ("graph", None)):
        state = create_train_state(mc, tc, dev)
        step = make_scanned_device_train_step(mc, K, tc, graph=graph)
        keeper = CheckpointKeeper(str(tmp_path / name))
        run_calls(step, state, attrs, dd, calls[:2])
        keeper.save_latest(1, state)
        run_calls(step, state, attrs, dd, calls[2:3])
        keeper.restore_latest(state)
        losses = run_calls(step, state, attrs, dd, calls[2:4])
        runs.append((state, losses, step))
    assert torch.equal(runs[0][1], runs[1][1])
    assert_same(runs[0][0], runs[1][0])
    assert runs[1][2].captures == 2
    steps = [t for st in runs[1][0].optimizer.state.values() for t in [st["step"]]]
    assert all(t.is_cuda for t in steps)


@pytest.mark.cuda
def test_card_a_failed_capture_raises_and_does_not_fall_back(cat, dev):
    mc, tc, dd, attrs, calls = small(cat, dev, dropout=0.0)
    state = create_train_state(mc, tc, dev)
    step = make_scanned_device_train_step(
        mc, K, tc, graph=None, on_step=lambda st: float(next(st.model.parameters()).detach().sum()))
    step(state, attrs, dd.arrays, calls[0])  # the eager warm-up may read the host
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(state, attrs, dd.arrays, calls[1])
    assert step.captures == 0 and state.step == K
