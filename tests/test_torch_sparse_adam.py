"""The port's lazy row-sparse item Adam against the JAX package's, on the
CPU (d = 16, L = 8, 101 item ids).

Tolerances:
* touched rows, slots and the position map: equal (the port's fill slots
  hold row 0 where JAX's hold the out-of-range row count);
* ``apply_rows_update`` fed the same rows and gradients: table 1e-7 and
  moments 1e-8 absolute (the same elementwise float32 arithmetic; the bias
  corrections' pow may round differently), untouched rows bit-equal;
* ``_sparse_device_update`` from bridged weights on the same batch, dropout
  0: loss 1e-6; the item table and the moments 1e-6 absolute over 3 steps
  (measured ≤ 1e-7) and the other parameters 1e-6, except the key
  projections' biases: exact arithmetic gives them a zero gradient
  (softmax ignores a per-row shift), so both sides hold rounding noise
  there, which Adam's normalisation turns into steps of up to lr each;
  they are held to 2·lr per step;
* first-touch rows against the port's dense ``torch.optim.Adam`` on the
  same batch (l2 0): 1e-6 absolute (torch folds the bias corrections into
  the step size; the gradients reach the rows through another sum order);
* untouched rows, their moments and the pad row: bit-equal / exactly 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carca_tpu.config import Config as JaxConfig
from carca_tpu.config import DataConfig as JaxDataConfig
from carca_tpu.config import ModelConfig as JaxModelConfig
from carca_tpu.config import TrainConfig as JaxTrainConfig
from carca_tpu.train import sparse_adam as jsa
from carca_tpu.train.loop import _sparse_device_update as jax_sparse_update
from carca_tpu.train.state import create_train_state as jax_create_train_state
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu_torch.bridge import (config_from_jax, load_into, model_config_from_jax,
                                    params_from_jax, train_config_from_jax)
from carca_tpu_torch.config import Config, DataConfig, TrainConfig
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import (_sparse_device_update, apply_gradients, fit,
                                       make_train_step, train_loss, train_loss_terms)
from carca_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

L, B, LR = 8, 8, 1e-3
STEP_TOL = 1e-6


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=60, n_real_items=100, seed=3)


def jax_cfg(**kw):
    base = dict(n_items=101, n_attrs=12, n_ctx=4, d=16, g=32, seq_len=L, target_len=10,
                n_blocks=2, n_heads=2, dropout=0.0, decoder="dot", use_pallas=False)
    base.update(kw)
    return JaxModelConfig(**base)


def host_batches(cat, n, seed=0):
    """n train batches of B rows (the last one padding) of distinct users."""
    builder = BatchBuilder(cat, L, 10)
    users, rng = builder.users("train"), np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = builder.train_batch(np.concatenate([users[B * i:B * i + B - 1], [-1]]), rng)
        b.pop("n_valid")
        out.append(b)
    return out


def as_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def batch_ids(b):
    return np.unique(np.concatenate([b["p_x"].ravel(), b["o_x"].ravel()]))


def test_touched_rows_equal_jax(cat):
    b = host_batches(cat, 1)[0]
    cap = b["p_x"].size + b["o_x"].size
    j_rows, j_pos = jsa.touched_physical_rows({k: jnp.asarray(v) for k, v in b.items()}, 1,
                                              cat.n_items, cap)
    j_rows, j_pos = np.asarray(j_rows), np.asarray(j_pos)
    rows, valid, posmap = sparse_adam.touched_rows(as_torch(b), cat.n_items)
    assert rows.shape == (cap,) and valid.shape == (cap,)
    np.testing.assert_array_equal(valid.numpy(), j_rows < cat.n_items)
    np.testing.assert_array_equal(rows.numpy(), np.where(j_rows < cat.n_items, j_rows, 0))
    ids = batch_ids(b)
    np.testing.assert_array_equal(rows.numpy()[:len(ids)], ids)
    np.testing.assert_array_equal(posmap.numpy()[ids], j_pos[ids])


@pytest.mark.parametrize("weight_decay,count", [(0.0, 0), (1e-2, 3)])
def test_apply_rows_update_matches_jax(weight_decay, count):
    rng = np.random.default_rng(count)
    R, W, cap = 50, 16, 24
    table = rng.standard_normal((R, W)).astype(np.float32)
    munu = np.concatenate([rng.standard_normal((R, W)), rng.random((R, W))], 1).astype(np.float32)
    touched = np.sort(rng.choice(np.arange(1, R), 15, replace=False))
    j_rows = np.concatenate([touched, np.full(cap - 15, R)])
    g = np.zeros((cap, W), np.float32)
    g[:15] = rng.standard_normal((15, W))
    sub = table[np.minimum(j_rows, R - 1)]
    j_table, j_state = jsa.apply_rows_update(
        jnp.asarray(table), {"munu": jnp.asarray(munu), "count": jnp.asarray(count, jnp.int32)},
        jnp.asarray(j_rows), jnp.asarray(g), jnp.asarray(sub), lr=jnp.float32(LR), b1=0.9,
        b2=0.98, weight_decay=weight_decay)
    rows = torch.as_tensor(np.where(j_rows < R, j_rows, 0))
    t, state = torch.from_numpy(table.copy()), {"munu": torch.from_numpy(munu.copy()),
                                                "count": count}
    sparse_adam.apply_rows_update(t, state, rows, rows > 0, torch.from_numpy(g),
                                  torch.from_numpy(table[rows.numpy()]), lr=LR, b1=0.9, b2=0.98,
                                  weight_decay=weight_decay)
    assert state["count"] == int(j_state["count"]) == count + 1
    np.testing.assert_allclose(t.numpy(), np.asarray(j_table), rtol=0, atol=1e-7)
    np.testing.assert_allclose(state["munu"].numpy(), np.asarray(j_state["munu"]), rtol=0,
                               atol=1e-8)
    untouched = np.setdiff1d(np.arange(R), touched)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(state["munu"].numpy()[untouched], munu[untouched])


def check_params(model, jax_params, steps):
    want = params_from_jax(jax.tree.map(np.asarray, jax_params), model.cfg)
    for name, p in model.named_parameters():
        tol = 2 * LR * steps if name.endswith("attn.wk.b") else STEP_TOL
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=tol,
                                   err_msg=name)


def test_sparse_update_matches_jax_with_a_lazy_gap(cat):
    """One step, then two more, where some rows skip the middle step (the
    lazy gap: no moment decay for them) and others are touched for the
    first time in step 3."""
    jcfg = jax_cfg()
    jtc = JaxTrainConfig(batch_size=B, l2_reg=1e-3)
    tx = jax_make_optimizer(jtc)
    jstate = jax_create_train_state(jax.random.PRNGKey(1), jcfg, jtc, tx, sparse_items=True)
    attrs = np.asarray(cat.attrs)
    jstep = jax.jit(lambda st, b: jax_sparse_update(jcfg, jtc, tx, st, b, jax.random.PRNGKey(0),
                                                    st.rng, attrs))
    mc, tc = model_config_from_jax(dataclasses.asdict(jcfg)), train_config_from_jax(jtc)
    model = load_into(CARCA(mc, device="cpu"), jax.tree.map(np.asarray, jstate.params))
    state = create_train_state(mc, tc, "cpu", model=model, sparse_items=True)
    state.model.train()
    table0 = state.model.embed.items.detach().clone()
    batches = host_batches(cat, 3)
    gap = np.setdiff1d(np.intersect1d(batch_ids(batches[0]), batch_ids(batches[2])),
                       batch_ids(batches[1]))
    assert len(gap[gap > 0]) > 0
    touched = set()
    for i, b in enumerate(batches):
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        loss = _sparse_device_update(tc, state, as_torch(b), torch.from_numpy(attrs))
        assert abs(loss.item() - float(jloss)) <= 1e-6, i
        check_params(state.model, jstate.params, i + 1)
        np.testing.assert_allclose(state.items_state["munu"].numpy(),
                                   np.asarray(jstate.opt_state["items"]["munu"]), rtol=0,
                                   atol=STEP_TOL)
        assert state.items_state["count"] == int(jstate.opt_state["items"]["count"]) == i + 1
        touched |= set(batch_ids(b).tolist())
        never = np.setdiff1d(np.arange(cat.n_items), sorted(touched))
        assert torch.equal(state.model.embed.items[never], table0[never])
        assert not bool(state.items_state["munu"][never].any())
        assert not bool(state.model.embed.items[0].any()) and not bool(
            state.items_state["munu"][0].any())


def test_first_touch_rows_equal_the_dense_adam(cat):
    """From zero moments, one sparse step equals one dense torch.optim.Adam
    step on every touched row; untouched rows do not move in either."""
    mc = model_config_from_jax(dataclasses.asdict(jax_cfg()))
    tc = TrainConfig(batch_size=B)
    b = as_torch(host_batches(cat, 1, seed=4)[0])
    attrs = torch.from_numpy(np.asarray(cat.attrs))
    sparse = create_train_state(mc, tc, "cpu", sparse_items=True)
    dense = create_train_state(mc, tc, "cpu")
    dense.model.load_state_dict(sparse.model.state_dict())
    table0 = sparse.model.embed.items.detach().clone()
    for st in (sparse, dense):
        st.model.train()
    _sparse_device_update(tc, sparse, b, attrs)
    apply_gradients(dense, lambda: train_loss_terms(dense.model, b, attrs))
    ids = batch_ids({k: v.numpy() for k, v in b.items()})
    np.testing.assert_allclose(sparse.model.embed.items[ids].detach().numpy(),
                               dense.model.embed.items[ids].detach().numpy(), rtol=0,
                               atol=STEP_TOL)
    rest = np.setdiff1d(np.arange(mc.n_items), ids)
    assert torch.equal(sparse.model.embed.items[rest], table0[rest])
    assert torch.equal(dense.model.embed.items[rest], table0[rest])
    assert not bool(sparse.model.embed.items[0].any())


def smoke_cfg(cat, out_dir, **train):
    jc = jax_cfg(n_items=cat.n_items)
    return Config(model=model_config_from_jax(dataclasses.asdict(jc)),
                  data=DataConfig(device_pipeline=True),
                  train=TrainConfig(batch_size=16, inner_steps=2, out_dir=str(out_dir),
                                    **train))


def test_resume_with_the_row_state_is_exact(tmp_path, cat):
    """Two epochs straight equal one epoch, a stop, and a resumed second
    epoch: the weights, the moments and the row count, bit for bit."""
    straight, _ = fit(smoke_cfg(cat, tmp_path / "a", epochs=2, sparse_items_adam=True), cat,
                      device="cpu", log=False)
    fit(smoke_cfg(cat, tmp_path / "b", epochs=1, sparse_items_adam=True), cat, device="cpu",
        log=False)
    fit(smoke_cfg(cat, tmp_path / "b", epochs=2, sparse_items_adam=True), cat, device="cpu",
        log=False)
    resumed = create_train_state(straight.model.cfg, TrainConfig(), "cpu", sparse_items=True)
    assert CheckpointKeeper(str(tmp_path / "b" / "ckpt")).restore_latest(resumed) == 2
    last = create_train_state(straight.model.cfg, TrainConfig(), "cpu", sparse_items=True)
    CheckpointKeeper(str(tmp_path / "a" / "ckpt")).restore_latest(last)
    for (n, p), q in zip(last.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(last.items_state["munu"], resumed.items_state["munu"])
    assert last.items_state["count"] == resumed.items_state["count"] == resumed.step > 0


def test_resume_adopts_the_saved_structure(tmp_path, cat, capsys):
    """A sparse run resumed with sparse_items_adam=false (and a dense one
    with true) adopts the checkpoint's structure, with the JAX package's
    note, instead of failing."""
    for first, then in ((True, False), (False, True)):
        out = tmp_path / f"flip_{first}"
        fit(smoke_cfg(cat, out, epochs=1, sparse_items_adam=first), cat, device="cpu",
            log=False)
        state, m = fit(smoke_cfg(cat, out, epochs=2, sparse_items_adam=then), cat,
                       device="cpu")
        assert m["epochs_run"] == 2 and np.isfinite(m["val_loss"])
        assert (state.items_state is not None) == first
        note = "sparse" if first else "dense"
        assert (f"note: resumed checkpoint uses {note} item-table Adam; adopting it"
                in capsys.readouterr().out)


def test_host_pipeline_refuses_a_sparse_state(tmp_path, cat):
    """The host step has no row-sparse Adam: resuming a sparse latest/ with
    device_pipeline=false raises (the JAX package fails on the optimizer
    tree), and the host step refuses a sparse state, rather than leaving
    the item table untrained."""
    out = tmp_path / "run"
    fit(smoke_cfg(cat, out, epochs=1, sparse_items_adam=True), cat, device="cpu", log=False)
    host = smoke_cfg(cat, out, epochs=2)
    host = dataclasses.replace(host, data=DataConfig(device_pipeline=False))
    with pytest.raises(ValueError, match="item-table Adam"):
        fit(host, cat, device="cpu", log=False)
    state = create_train_state(host.model, host.train, "cpu", sparse_items=True)
    with pytest.raises(ValueError, match="device_pipeline=true"):
        make_train_step(host.model, host.train)(state, torch.as_tensor(cat.attrs), {})


@pytest.mark.parametrize("embedding,dp,flag", [
    ("all", True, True), ("id", True, "auto"), ("attrctx", True, True), ("all", False, True),
    ("mlpid", True, False)])
def test_resolve_and_its_refusals_match_jax(embedding, dp, flag):
    jcfg = JaxConfig(model=jax_cfg(n_items=1_000_001, embedding=embedding),
                     data=JaxDataConfig(device_pipeline=dp),
                     train=JaxTrainConfig(sparse_items_adam=flag))
    cfg = config_from_jax(jcfg)
    try:
        want = jsa.resolve(jcfg)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            sparse_adam.resolve(cfg)
        return
    assert sparse_adam.resolve(cfg) == want


def test_lr_at_is_the_schedule_at_the_row_count():
    from carca_tpu.train.state import make_schedule as jax_make_schedule

    jtc = JaxTrainConfig(lr=2e-3, lr_schedule="cosine", lr_decay_steps=10, lr_decay_rate=0.1)
    tc = train_config_from_jax(jtc)
    for count in (0, 3, 10, 15):
        assert abs(sparse_adam.lr_at(tc, count) - float(jax_make_schedule(jtc)(count))) <= 1e-9
        assert abs(sparse_adam.lr_at(tc, count)
                   - float(jsa.lr_at(jtc, jnp.asarray(count, jnp.int32)))) <= 1e-9
    assert sparse_adam.lr_at(TrainConfig(lr=5e-4), 7) == 5e-4


def test_bf16_attrs_give_the_f32_attrs_loss(cat):
    """Under bf16 compute the attrs catalog is stored bf16 (attrs_dtype):
    the first layer rounds attr values to bf16 either way, so the loss and
    every gradient are bit-equal to those with the f32 table."""
    from carca_tpu_torch.train.loop import attrs_dtype

    mc = model_config_from_jax(dataclasses.asdict(jax_cfg(compute_dtype="bfloat16")))
    assert attrs_dtype(mc) == torch.bfloat16
    assert attrs_dtype(dataclasses.replace(mc, compute_dtype="float32")) == torch.float32
    model = CARCA(mc, device="cpu").train()
    b = as_torch(host_batches(cat, 1, seed=5)[0])
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        model.zero_grad(set_to_none=True)
        loss = train_loss(model, b, torch.as_tensor(np.asarray(cat.attrs), dtype=dtype))
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(g, h) for g, h in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("n_blocks", [2, 3])
def test_block_updates_equal_the_whole_table_update(n_blocks):
    """The row update of each model rank's block (``lo=``) equals the
    whole-table update on its rows, bit for bit, for a batch that touches
    the first row of block 1 (global row ``lo``, a real item whose moments
    are not zero: a lazy gap), with fill slots and, for block 1, slots of
    other blocks; with three blocks the last one is untouched and stays
    so. Fill and out-of-block slots must not write stale moments over
    block 1's local row 0."""
    rng = np.random.default_rng(n_blocks)
    n, W, cap = 17, 8, 40
    R = n * n_blocks
    table = rng.standard_normal((R, W)).astype(np.float32)
    table[0] = 0.0
    munu = np.concatenate([rng.standard_normal((R, W)), rng.random((R, W))], 1).astype(np.float32)
    munu[0] = 0.0
    touched = np.unique(np.concatenate([[n, n + 3], rng.choice(np.arange(1, 2 * n), 9)]))
    rows = np.zeros(cap, np.int64)
    rows[:len(touched)] = touched
    valid = np.arange(cap) < len(touched)
    g = np.where(valid[:, None], rng.standard_normal((cap, W)), 0.0).astype(np.float32)
    kw = dict(lr=LR, b1=0.9, b2=0.98, weight_decay=1e-3)
    uphys, ok, g_rows = torch.from_numpy(rows), torch.from_numpy(valid), torch.from_numpy(g)
    whole = torch.from_numpy(table.copy())
    wstate = {"munu": torch.from_numpy(munu.copy()), "count": 4}
    sub = whole[uphys].clone()
    sparse_adam.apply_rows_update(whole, wstate, uphys, ok, g_rows, sub, **kw)
    for m in range(n_blocks):
        blk = slice(m * n, (m + 1) * n)
        block = torch.from_numpy(table[blk].copy())
        bstate = {"munu": torch.from_numpy(munu[blk].copy()), "count": 4}
        sparse_adam.apply_rows_update(block, bstate, uphys, ok, g_rows, sub, lo=m * n, **kw)
        assert bstate["count"] == wstate["count"] == 5
        assert torch.equal(block, whole[blk]), m
        assert torch.equal(bstate["munu"], wstate["munu"][blk]), m
    assert not torch.equal(wstate["munu"][n], torch.from_numpy(munu[n]))  # row lo moved
    rest = np.setdiff1d(np.arange(R), touched)
    np.testing.assert_array_equal(wstate["munu"].numpy()[rest], munu[rest])
    np.testing.assert_array_equal(whole.numpy()[rest], table[rest])
