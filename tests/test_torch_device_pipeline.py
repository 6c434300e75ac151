"""The port's device pipeline and negative sampler against the JAX
package's, on the CPU.

Deterministic fields compare exactly: window bounds, valid users, the
dataset's arrays, ``epoch_batches``, and the fields of ``assemble_train``
that do not depend on random draws (profile, contexts, positives, labels).
``_first_distinct_excluding`` compares exactly on the same numpy draws;
``retries_for``/``overdraw_for`` compare exactly. The negatives themselves
cannot (the two frameworks' generators differ): each branch of
``device_sample_negatives`` is held to the sampler's contract — ids in
[1, n_items − 1], no window id, distinct within a row for uniform draws —
and to its distribution by a chi-square bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from carca_tpu.data.dataset import epoch_batches as jax_epoch_batches
from carca_tpu.data.device_pipeline import DeviceDataset as JaxDeviceDataset
from carca_tpu.data.device_pipeline import assemble_train as jax_assemble_train
from carca_tpu.data.synthetic import synthetic_catalog as jax_synthetic_catalog
from carca_tpu.data.windowing import valid_users as jax_valid_users
from carca_tpu.data.windowing import window_bounds as jax_window_bounds
from carca_tpu.parallel.sampling import _first_distinct_excluding as jax_first_distinct
from carca_tpu.parallel.sampling import overdraw_for as jax_overdraw_for
from carca_tpu.parallel.sampling import retries_for as jax_retries_for
from carca_tpu_torch.data.dataset import epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_train
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.data.windowing import valid_users, window_bounds
from carca_tpu_torch.parallel.sampling import (_first_distinct_excluding,
                                               device_sample_negatives, overdraw_for,
                                               retries_for)

torch.set_num_threads(1)

L, T = 10, 15


@pytest.fixture(scope="module")
def catalogs():
    kw = dict(n_users=200, n_real_items=300, seed=5)
    return jax_synthetic_catalog(**kw), synthetic_catalog(**kw)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("test", [True, False])
def test_windowing_matches_jax(mode, test):
    lengths = np.random.default_rng(0).integers(0, 80, size=500)
    for a, b in zip(window_bounds(lengths, L, mode, test),
                    jax_window_bounds(lengths, L, mode, test)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(valid_users(lengths, L, mode, test),
                                  jax_valid_users(lengths, L, mode, test))


def test_device_dataset_arrays_match_jax(catalogs):
    jcat, cat = catalogs
    want = JaxDeviceDataset(jcat, L, T, test=True)
    got = DeviceDataset(cat, L, T, test=True, device="cpu")
    assert set(want.arrays) - set(got.arrays) == {"evt_packed"}  # not ported
    for name, t in got.arrays.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want.arrays[name]), err_msg=name)
    for mode in ("train", "val", "test"):
        np.testing.assert_array_equal(got.users(mode), want.users(mode))
    assert (got.hist_max, got.n_items, got.n_ctx) == (want.hist_max, want.n_items, want.n_ctx)


@pytest.mark.parametrize("n_neg,reject_width", [(1, 0), (2, 0), (1, -1)])
def test_assemble_train_matches_jax(catalogs, n_neg, reject_width):
    """Every field but the negatives equals the JAX package's for the same
    user rows, −1 padding rows included; negatives keep the contract."""
    jcat, cat = catalogs
    jdd = JaxDeviceDataset(jcat, L, T, test=True)
    dd = DeviceDataset(cat, L, T, test=True, device="cpu")
    rw = dd.hist_max if reject_width < 0 else reject_width
    rows = np.concatenate([dd.users("train")[:30], [-1, -1]]).astype(np.int32)
    want = jax_assemble_train(jdd.arrays, L, jcat.n_items, jnp.asarray(rows),
                              jax.random.PRNGKey(0), rw, n_neg=n_neg)
    got = assemble_train(dd.arrays, L, cat.n_items, torch.from_numpy(rows),
                         torch.Generator().manual_seed(0), rw, n_neg=n_neg)
    for k in ("p_x", "p_c", "o_c", "y_true"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["o_x"][:, :L].numpy(), np.asarray(want["o_x"][:, :L]))
    assert got["o_x"].shape == want["o_x"].shape == (32, (1 + n_neg) * L)
    assert int(got["n_valid"]) == int(want["n_valid"]) == 30
    negs, p_x, pos = got["o_x"][:, L:].numpy(), got["p_x"].numpy(), got["o_x"][:, :L].numpy()
    assert ((negs == 0) == np.tile(p_x == 0, (1, n_neg))).all()
    live = negs[negs > 0]
    assert live.min() >= 1 and live.max() <= cat.n_items - 1
    offs, lens = dd.arrays["offsets"].numpy(), dd.arrays["hist_len"].numpy()
    for b in range(30):
        row = negs[b][negs[b] > 0]
        assert len(set(row.tolist())) == len(row)  # distinct within the row
        seen = set(p_x[b].tolist()) | set(pos[b].tolist())
        if rw:
            u = rows[b]
            seen |= set(cat.items[offs[u]:offs[u] + lens[u]].tolist())
        assert not set(row.tolist()) & (seen - {0})


def test_first_distinct_excluding_matches_jax():
    rng = np.random.default_rng(3)
    draws = rng.integers(1, 40, size=(64, 30)).astype(np.int32)  # many repeats
    window = rng.integers(0, 40, size=(64, 12)).astype(np.int32)  # many collisions
    draws[0, :5] = window[0, 0]  # leading draws that hit the window
    for n_slots in (5, 10):
        want = np.asarray(jax_first_distinct(jnp.asarray(draws), jnp.asarray(window), n_slots))
        got = _first_distinct_excluding(torch.from_numpy(draws), torch.from_numpy(window),
                                        n_slots).numpy()
        np.testing.assert_array_equal(got, want)


def test_retries_and_overdraw_match_jax():
    for n_items in (50, 301, 2001, 40_000, 10_000_001):
        for w in (0, 11, 51, 250):
            for pop in (False, True):
                assert retries_for(w, n_items, pop) == jax_retries_for(w, n_items, pop)
            for n_slots in (10, 50, 100, 1000):
                assert overdraw_for(n_slots, n_items, w) == jax_overdraw_for(n_slots, n_items, w)
    assert overdraw_for(50, 2001, 51) == 82  # the flagship's branch


def chi2_uniform_p(ids, n_items):
    counts = np.bincount(ids.ravel(), minlength=n_items)[1:]
    return stats.chisquare(counts).pvalue


@pytest.mark.parametrize("branch,n_items,n_slots", [
    ("overdraw", 200, 10), ("dense top-k", 40, 30), ("retry", 40_000, 30_000)])
def test_device_sample_negatives_uniform_branches(branch, n_items, n_slots):
    window_w = 6
    assert (overdraw_for(n_slots, n_items, window_w) is not None) == (branch == "overdraw")
    b = 400 if branch != "retry" else 4
    rng = np.random.default_rng(4)
    window = torch.from_numpy(rng.integers(0, n_items, size=(b, window_w)).astype(np.int32))
    ids = device_sample_negatives(torch.Generator().manual_seed(1), window, n_items,
                                  n_slots, retries=8).numpy()
    assert ids.shape == (b, n_slots) and ids.dtype == np.int32
    assert ids.min() >= 1 and ids.max() <= n_items - 1
    for r in range(b):
        assert not set(ids[r].tolist()) & set(window[r].tolist())
        if branch != "retry":  # the retry branch may repeat within a row
            assert len(set(ids[r].tolist())) == n_slots
    if branch != "dense top-k":  # the top-k takes 30 of a row's ~33 allowed ids
        assert chi2_uniform_p(ids, n_items) > 1e-4


def test_device_sample_negatives_popularity_draws():
    """Popularity draws: each id's share follows its share of the events
    (chi-square against the empirical unigram), rejecting the window."""
    rng = np.random.default_rng(5)
    events = torch.from_numpy(rng.choice([1, 2, 3, 4, 5, 6], size=6000,
                                         p=[0.4, 0.2, 0.15, 0.1, 0.1, 0.05]).astype(np.int32))
    window = torch.full((500, 2), 6, dtype=torch.int32)
    ids = device_sample_negatives(torch.Generator().manual_seed(2), window, 7, 20,
                                  retries=retries_for(2, 7, popularity=True),
                                  events=events).numpy()
    assert (ids >= 1).all() and (ids <= 5).all()  # id 6 is the window
    counts = np.bincount(ids.ravel(), minlength=7)[1:6]
    freq = np.bincount(events.numpy(), minlength=7)[1:6].astype(np.float64)
    assert stats.chisquare(counts, freq / freq.sum() * counts.sum()).pvalue > 1e-4


def test_epoch_batches_match_jax():
    users = np.arange(3, 40)
    got = list(epoch_batches(users, 8, np.random.default_rng(1)))
    want = list(jax_epoch_batches(users, 8, np.random.default_rng(1)))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[-1][-3:] == -1).all()
    assert len(list(epoch_batches(users, 8, shuffle=False, drop_remainder=True))) == 4
