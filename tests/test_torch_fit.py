"""The port's host pipeline, eval and fit loop against the JAX package's,
on the CPU at the ``smoke`` preset's size (d = 16, L = 10, 100 items, 200
users).

* Host batches: ``BatchBuilder`` and ``sample_negatives_batch`` give the
  JAX package's arrays exactly for one ``np.random.Generator`` state
  (JAX with ``use_native=False``); ``load_dataset`` the same ``Catalog``.
* Metrics: ``hr_ndcg_sums`` exact, NaN and tied scores included; the eval
  step on the same weights (through ``bridge``) and batch gives the same
  HR/NDCG sums and a loss within 1e-5.
* ``assemble_eval``: windows and positives equal to JAX's; its negatives
  (another PRNG) checked for what they must be.
* ``fit``, host pipeline, dropout 0, the same initial weights, 2 epochs:
  each epoch's train loss within 1e-4 relative of JAX's (Adam's float32
  rounding differs between the two, and grows over 14 steps), val and test
  HR/NDCG within 2 / n_users (one user's rank flipping), the same epochs,
  CSV and metrics.jsonl keys, and an args.json the JAX package reads.
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from carca_tpu.config import Config as JaxConfig
from carca_tpu.config import DataConfig as JaxDataConfig
from carca_tpu.config import preset as jax_preset
from carca_tpu.data.dataset import BatchBuilder as JaxBatchBuilder
from carca_tpu.data.device_pipeline import DeviceDataset as JaxDeviceDataset
from carca_tpu.data.device_pipeline import assemble_eval as jax_assemble_eval
from carca_tpu.data.loaders import load_dataset as jax_load_dataset
from carca_tpu.data.sampler import sample_negatives_batch as jax_sample_negatives_batch
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.data.synthetic import write_reference_format as jax_write_reference_format
from carca_tpu.models.carca import carca_init
from carca_tpu.serve.recommender import config_from_run_dir as jax_config_from_run_dir
from carca_tpu.train.loop import fit as jax_fit
from carca_tpu.train.loop import make_eval_step as jax_make_eval_step
from carca_tpu.train.metrics import hr_ndcg_sums as jax_hr_ndcg_sums
from carca_tpu.train.state import create_train_state as jax_create_train_state
from carca_tpu.train.state import make_optimizer as jax_make_optimizer
from carca_tpu_torch.bridge import (config_from_jax, data_config_from_jax, load_into,
                                    model_config_from_jax, train_config_from_jax)
from carca_tpu_torch.config import Config, TrainConfig, preset
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_eval
from carca_tpu_torch.data.loaders import load_dataset
from carca_tpu_torch.data.sampler import sample_negatives_batch
from carca_tpu_torch.data.synthetic import synthetic_catalog, write_reference_format
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.loop import fit, make_device_train_step, make_eval_step, to_device
from carca_tpu_torch.train.metrics import hr_ndcg_sums
from carca_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

N_USERS, N_REAL = 200, 100
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL, seed=0)


def jax_smoke(cat, out_dir, **train):
    """The JAX smoke preset at dropout 0 over ``cat``, host pipeline."""
    jc = jax_preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    return JaxConfig(model=dataclasses.replace(jc.model, dropout=0.0),
                     data=JaxDataConfig(use_native=False),
                     train=dataclasses.replace(jc.train, out_dir=out_dir, **train))


def same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["val", "test"])
def test_eval_batches_equal_the_jax_builder(cat, mode):
    L, T = 10, 20
    ours, theirs = BatchBuilder(cat, L, T), JaxBatchBuilder(cat, L, T, native=None)
    np.testing.assert_array_equal(ours.users(mode), theirs.users(mode))
    rows = np.concatenate([ours.users(mode)[:29], [-1, -1, -1]])
    same_batch(ours.eval_batch(rows, np.random.default_rng(4), mode),
               theirs.eval_batch(rows, np.random.default_rng(4), mode))


@pytest.mark.parametrize("seed", [0, 7])
def test_train_batches_equal_the_jax_builder(cat, seed):
    ours, theirs = BatchBuilder(cat, 10, 20), JaxBatchBuilder(cat, 10, 20, native=None)
    np.testing.assert_array_equal(ours.users("train"), theirs.users("train"))
    rows = np.concatenate([ours.users("train")[:30], [-1, -1]])
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the second call draws on from the same generators
        same_batch(ours.train_batch(rows, r1), theirs.train_batch(rows, r2))


def test_sample_negatives_batch_equals_jax(cat):
    sets = [cat.items[cat.offsets[u]:cat.offsets[u + 1]] for u in range(cat.n_users)]
    rows = np.array([0, 5, -1, 17, 199])
    counts = np.array([3, 0, 4, 20, 90])
    got = sample_negatives_batch(np.random.default_rng(2), sets, rows, counts, cat.n_items, 90)
    want = jax_sample_negatives_batch(np.random.default_rng(2), sets, rows, counts,
                                      cat.n_items, 90)
    np.testing.assert_array_equal(got, want)
    for b, u in enumerate(rows):  # distinct, outside the history, zero-padded
        n = counts[b] if u >= 0 else 0
        assert np.all(got[b, n:] == 0) and len(set(got[b, :n])) == n
        if n:
            assert not set(got[b, :n]) & set(sets[u].tolist())


def test_load_dataset_equals_jax(tmp_path, cat):
    write_reference_format(cat, str(tmp_path / "ours"))
    jax_write_reference_format(jax_synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL,
                                                     seed=0), str(tmp_path / "theirs"))
    for name in ("profiles.txt", "attrs.pkl", "ctx.pkl"):
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
    files = ("profiles.txt", "attrs.pkl", "ctx.pkl")
    ours = load_dataset(str(tmp_path / "ours"), *files)
    theirs = jax_load_dataset(str(tmp_path / "ours"), *files)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(theirs, f.name))
    assert ours.profile_sets() == theirs.profile_sets()


def test_write_then_load_gives_the_canonicalized_catalog(tmp_path, cat):
    """The reference format keys contexts by (user, item): loading the
    written files gives canonicalize_repeat_ctx's catalog, as in JAX."""
    from carca_tpu.data.synthetic import canonicalize_repeat_ctx as jax_canonicalize
    from carca_tpu_torch.data.synthetic import canonicalize_repeat_ctx

    write_reference_format(cat, str(tmp_path))
    back = load_dataset(str(tmp_path), "profiles.txt", "attrs.pkl", "ctx.pkl")
    want = canonicalize_repeat_ctx(cat)
    for f in dataclasses.fields(back):
        np.testing.assert_array_equal(getattr(back, f.name), getattr(want, f.name))
    np.testing.assert_array_equal(want.ctx_vals, jax_canonicalize(cat).ctx_vals)
    assert not np.array_equal(want.ctx_vals, cat.ctx_vals)  # the catalog repeats items


@pytest.mark.parametrize("k", [1, 3, 10])
def test_hr_ndcg_sums_exact_with_nan_and_ties(k):
    rng = np.random.default_rng(k)
    y_pred = rng.standard_normal((9, 12)).astype(np.float32)
    y_pred[1] = 0.5  # every score tied: the lowest index wins
    y_pred[2, :] = np.nan  # a diverged row ranks nothing
    y_pred[3, 0] = np.nan  # a NaN positive ranks last
    y_pred[4, [0, 5, 7]] = 2.0  # ties with the positive
    y_true = np.zeros((9, 12), np.float32)
    y_true[:, 0] = 1.0
    y_true[5, 3] = 1.0  # two positives
    row_mask = np.ones(9, np.float32)
    row_mask[8] = 0.0
    got = hr_ndcg_sums(torch.from_numpy(y_pred), torch.from_numpy(y_true), k,
                       torch.from_numpy(row_mask))
    want = jax_hr_ndcg_sums(y_pred, y_true, k, row_mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.item() == float(w)
    for b in range(9):  # row by row, no summation order at all
        got = hr_ndcg_sums(torch.from_numpy(y_pred[b:b + 1]), torch.from_numpy(y_true[b:b + 1]), k)
        want = jax_hr_ndcg_sums(y_pred[b:b + 1], y_true[b:b + 1], k)
        assert [g.item() for g in got] == [float(w) for w in want]


def test_eval_step_matches_jax(cat):
    jcfg = jax_smoke(cat, "unused")
    params = carca_init(jax.random.PRNGKey(3), jcfg.model)
    cfg = config_from_jax(jcfg)
    model = load_into(CARCA(cfg.model, device="cpu"), jax.tree.map(np.asarray, params))
    builder = BatchBuilder(cat, cfg.model.seq_len, cfg.model.target_len)
    rows = np.concatenate([builder.users("val")[:30], [-1, -1]])
    batch = builder.eval_batch(rows, np.random.default_rng(0), "val")
    batch.pop("n_valid")
    hr, ndcg, loss = make_eval_step(cfg.model, 10)(model, torch.from_numpy(cat.attrs),
                                                    to_device(batch, "cpu"))
    jhr, jndcg, jloss = jax_make_eval_step(jcfg.model, 10)(params, cat.attrs, batch)
    assert hr.item() == float(jhr) and abs(ndcg.item() - float(jndcg)) <= 1e-5
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert not model.training


@pytest.mark.parametrize("mode", ["val", "test"])
@pytest.mark.parametrize("full_history", [False, True])
def test_assemble_eval_windows_equal_jax(cat, mode, full_history):
    L, T = 10, 20
    dd = DeviceDataset(cat, L, T, device="cpu")
    jdd = JaxDeviceDataset(cat, L, T)
    rw = dd.hist_max if full_history else 0
    rows = np.concatenate([dd.users(mode)[:40], [-1, -1]])
    got = assemble_eval(dd.arrays, L, T, cat.n_items, mode, torch.as_tensor(rows),
                        torch.Generator().manual_seed(0), rw)
    want = jax_assemble_eval(jdd.arrays, L, T, cat.n_items, mode, jax.numpy.asarray(rows),
                             jax.random.PRNGKey(0), rw)
    for key in ("p_x", "p_c", "y_true", "n_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got["o_x"][:, 0].numpy(), np.asarray(want["o_x"])[:, 0])
    np.testing.assert_array_equal(got["o_c"][:, 0].numpy(), np.asarray(want["o_c"])[:, 0])
    negs, pos, live = got["o_x"][:, 1:].numpy(), got["o_x"][:, 0].numpy(), rows >= 0
    assert np.all(negs[~live] == 0) and np.all(got["o_c"][~live].numpy() == 0)
    for b in np.flatnonzero(live):
        u = rows[b]
        hist = set(cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist())
        assert len(set(negs[b])) == T and np.all(negs[b] >= 1) and pos[b] not in negs[b]
        if full_history:
            assert not set(negs[b]) & hist
        else:
            assert not set(negs[b]) & set(got["p_x"][b].tolist())


@pytest.fixture(scope="module")
def fitted(tmp_path_factory, cat):
    """A JAX fit and a port fit, host pipeline, dropout 0, 2 epochs, from the
    same initial weights."""
    root = tmp_path_factory.mktemp("fit")
    jcfg = jax_smoke(cat, str(root / "jax"), epochs=2)
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train,
                                    jax_make_optimizer(jcfg.train))
    init = jax.tree.map(np.asarray, jstate.params)  # fit donates the state
    jax_final = jax_fit(jcfg, cat, state=jstate, log=True)[1]
    cfg = config_from_jax(jcfg)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, out_dir=str(root / "ours")))
    model = load_into(CARCA(cfg.model, device="cpu"), init)
    state = create_train_state(cfg.model, cfg.train, model=model)
    final = fit(cfg, cat, state=state, device="cpu")[1]
    return root, jax_final, final


def metrics_rows(run):
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_fit_losses_match_jax(fitted):
    root, _, _ = fitted
    ours, theirs = metrics_rows(root / "ours"), metrics_rows(root / "jax")
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert abs(a["train_loss"] - b["train_loss"]) <= LOSS_RTOL * abs(b["train_loss"])
        assert abs(a["val_loss"] - b["val_loss"]) <= LOSS_RTOL * abs(b["val_loss"])


def test_fit_metrics_match_jax(fitted):
    _, theirs, ours = fitted
    assert set(ours) == set(theirs) and ours["epochs_run"] == theirs["epochs_run"] == 2
    n_val, n_test = N_USERS, N_USERS  # every user of the smoke catalog evaluates
    for key, n in (("val_hr", n_val), ("val_ndcg", n_val), ("test_hr", n_test),
                   ("test_ndcg", n_test)):
        assert abs(ours[key] - theirs[key]) <= 2.0 / n, key


def test_fit_run_directory_matches_jax(fitted):
    root, _, _ = fitted
    for run in ("ours", "jax"):
        assert os.path.exists(root / run / "args.json")
    csv = {run: glob.glob(str(root / run / "*.csv")) for run in ("ours", "jax")}
    assert len(csv["ours"]) == len(csv["jax"]) == 1
    splits = {}
    for run, (path,) in csv.items():
        with open(path) as fh:
            rows = [line.rstrip("\n").split(";") for line in fh]
        assert all(len(r) == 6 for r in rows)
        splits[run] = [r[1:3] for r in rows]
    assert splits["ours"] == splits["jax"] == [["1", "train"], ["1", "val"], ["2", "train"],
                                               ["2", "val"], ["2", "test"]]
    for name in ("best/params.pt", "best/metrics.json", "latest/state.pt"):
        assert os.path.exists(root / "ours" / "ckpt" / name)
    back = jax_config_from_run_dir(str(root / "ours"))  # the JAX package reads our args.json
    ours = json.loads((root / "ours" / "args.json").read_text())
    assert back.model.d == ours["d"] == 16 and back.train.epochs == 2
    assert back.model.n_items == ours["n_items"] and back.data.use_native is False


def test_device_pipeline_fit_lowers_the_loss(tmp_path, cat):
    cfg = preset("smoke", cat.n_items, cat.n_attrs, cat.n_ctx)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_pipeline=True),
        train=dataclasses.replace(cfg.train, epochs=4, early_stop=10, inner_steps=3,
                                  out_dir=str(tmp_path)))
    final = fit(cfg, cat, device="cpu")[1]
    rows = metrics_rows(tmp_path)
    assert rows[-1]["train_loss"] < rows[0]["train_loss"]
    assert final["epochs_run"] == 4 and 0.0 < final["test_hr"] <= 1.0


def jax_config_at(n_real_items, device_pipeline, **train):
    jc = jax_preset("smoke", n_real_items + 1, 12, 4)
    return JaxConfig(model=jc.model,
                     data=JaxDataConfig(device_pipeline=device_pipeline),
                     train=dataclasses.replace(jc.train, **train))


@pytest.fixture(scope="module")
def big_cat():
    """A catalog of 1,000,000 item ids (999,999 real) and 40 users: the
    size where "auto" turns the row-sparse Adam on."""
    return synthetic_catalog(n_users=40, n_real_items=999_999, seed=1)


def one_device_step(cfg, cat, sparse):
    """One device-pipeline train step of a fresh state built as ``sparse``
    says; the weights must move and the loss be finite."""
    mc = cfg.model
    state = create_train_state(mc, cfg.train, "cpu", sparse_items=sparse)
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device="cpu")
    before = state.model.embed.items.detach().clone()
    step = make_device_train_step(mc, cfg.train)
    state, loss = step(state, torch.as_tensor(cat.attrs), dd.arrays,
                       torch.as_tensor(dd.users("train")[:cfg.train.batch_size]))
    assert torch.isfinite(loss) and not torch.equal(before, state.model.embed.items)
    assert (state.items_state is not None) == sparse
    return state


@pytest.mark.parametrize("n_real,dp,train", [
    (999_999, True, {}), (2_000, True, {}), (999_999, False, {}),
    (999_999, True, {"batch_size": 2048}), (999_999, True, {"mesh_shape": (2,)}),
    (2_000, True, {"sparse_items_adam": True}), (2_000, True, {"sparse_items_adam": False}),
    (999_999, True, {"sparse_items_adam": False})])
def test_sparse_items_adam_resolves_as_jax(n_real, dp, train, big_cat, cat):
    """The port's resolve takes the JAX package's decision; the bridge keeps
    the field, and where the decision is on, the device step builds and
    runs the row-sparse Adam."""
    from carca_tpu.train.sparse_adam import resolve as jax_resolve

    jcfg = jax_config_at(n_real, dp, **train)
    cfg = Config(model_config_from_jax(jcfg.model), data_config_from_jax(jcfg.data),
                 TrainConfig(**dataclasses.asdict(jcfg.train)))
    want = jax_resolve(jcfg)
    assert sparse_adam.resolve(cfg) == want
    assert config_from_jax(jcfg).train == cfg.train
    if want:
        data = big_cat if n_real == 999_999 else synthetic_catalog(
            n_users=40, n_real_items=n_real, seed=1)
        one_device_step(cfg, data, sparse=True)


def test_sparse_auto_at_1m_items_raises_in_fit_and_bridge(tmp_path, big_cat):
    """C2: "auto" resolving on (1M items, device pipeline, one device) now
    runs the row-sparse Adam in fit, in make_device_train_step (a bare
    TrainConfig, whose default is "auto") and through the bridge; at 2,000
    items the dense Adam. Nothing raises."""
    big = jax_config_at(999_999, True)
    assert train_config_from_jax(big).sparse_items_adam == "auto"
    cfg = config_from_jax(big)
    assert sparse_adam.resolve(cfg) is True
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1, out_dir=str(tmp_path), checkpoint=False, batch_size=16))
    state, final = fit(cfg, big_cat, device="cpu", log=False)
    assert state.items_state is not None and state.items_state["count"] == state.step == 3
    assert final["epochs_run"] == 1 and np.isfinite(final["test_loss"])
    for tc in (cfg.train, TrainConfig(), None):
        one_device_step(dataclasses.replace(cfg, train=tc or TrainConfig()), big_cat, True)
    small = jax_config_at(2_000, True)
    assert train_config_from_jax(small).sparse_items_adam == "auto"
    assert sparse_adam.resolve(config_from_jax(small)) is False
    small_cfg = config_from_jax(small)
    small_cat = synthetic_catalog(n_users=40, n_real_items=2_000, seed=1)
    for tc in (small_cfg.train, TrainConfig(), None):
        one_device_step(dataclasses.replace(small_cfg, train=tc or TrainConfig()), small_cat,
                        False)


def test_refuse_unported_accepts_the_10m_preset_on_one_device():
    """The synthetic10m preset sets device_sampling=True, which the JAX
    package reads only under a mesh: one device accepts it, and so does a
    mesh (the dense item Adam there); the row-sparse Adam forced on under a
    mesh is refused (ROADMAP item 17)."""
    from carca_tpu_torch.train.loop import refuse_unported

    cfg = preset("synthetic10m", 10_000_001, 12, 4)
    assert cfg.data.device_sampling and cfg.data.device_pipeline
    refuse_unported(cfg)
    refuse_unported(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_pipeline=False)))
    meshed = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_shape=(1, 2)))
    refuse_unported(meshed)
    assert sparse_adam.resolve(meshed) is False
    with pytest.raises(NotImplementedError, match="item 17"):
        refuse_unported(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, mesh_shape=(2, 2), sparse_items_adam=True)))
    assert sparse_adam.resolve(cfg) is True
