"""The port's synthetic generators against the JAX package's, on the CPU.

* Host generators (numpy): ``markov_process``, ``markov_rank_pmf``,
  ``cluster_bounds``/``cluster_of`` and ``synthetic_catalog_markov`` equal
  the JAX package's bit for bit for a seed.
* Device generators (torch, here on ``device="cpu"``): the CSR offsets and
  the markov process equal the JAX device twins'; a zero pad row, ids in
  range, and the same catalog bit for bit when regenerated with the seed.
  Their draws come from a torch generator, not JAX's threefry, so they are
  held to the JAX twins on statistics at ~17k events: the Zipf head mass
  against its exact value ln(h+1)/ln(n) (within 5 binomial sigma, both
  generators), the markov next-cluster frequencies against α·T + (1−α)·pref
  (total variation ≤ 0.06 per previous cluster, both), and nearest-centroid
  recovery of the attrs' clusters (> 0.95, both).
"""

import dataclasses

import numpy as np
import pytest
import torch

from carca_tpu.data import synthetic as jsyn
from carca_tpu_torch.data import synthetic as syn
from carca_tpu_torch.data.loaders import host_catalog

torch.set_num_threads(1)

SMALL = dict(n_users=300, n_real_items=500, n_clusters=8, hot_items=40)
STATS = dict(n_users=1000, n_real_items=800, n_clusters=8, hot_items=40)  # ~17k events
ZIPF = dict(n_users=1000, n_real_items=1000)


def same_catalog(a, b):
    a, b = host_catalog(a), host_catalog(b)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)), err_msg=f.name)


def same_process(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)), err_msg=f.name)


@pytest.mark.parametrize("seed", [0, 5])
def test_markov_host_generator_bit_equal_to_jax(seed):
    proc = syn.markov_process(SMALL["n_users"], SMALL["n_real_items"],
                              n_clusters=8, hot_items=40, seed=seed)
    jproc = jsyn.markov_process(SMALL["n_users"], SMALL["n_real_items"],
                                n_clusters=8, hot_items=40, seed=seed)
    same_process(proc, jproc)
    np.testing.assert_array_equal(proc.bounds, jproc.bounds)
    same_catalog(syn.synthetic_catalog_markov(seed=seed, **SMALL),
                 jsyn.synthetic_catalog_markov(seed=seed, **SMALL))
    ranks = np.arange(1, 70)
    clusters = np.arange(len(ranks)) % 8
    np.testing.assert_array_equal(syn.markov_rank_pmf(proc, ranks, clusters),
                                  jsyn.markov_rank_pmf(jproc, ranks, clusters))
    ids = np.arange(1, 501)
    np.testing.assert_array_equal(syn.cluster_of(ids, proc.bounds),
                                  jsyn.cluster_of(ids, jproc.bounds))
    np.testing.assert_array_equal(
        syn.cluster_of(torch.as_tensor(ids), proc.bounds).numpy(),
        jsyn.cluster_of(ids, jproc.bounds))


@pytest.mark.parametrize("process", ["zipf", "markov"])
def test_device_twin_contract(process):
    kw = dict(SMALL, seed=3) if process == "markov" else dict(n_users=300, n_real_items=500,
                                                             seed=3)
    gen = syn.synthetic_generator(process, device=True, torch_device="cpu")
    jgen = jsyn.synthetic_generator(process, device=True)
    a, b, j = gen(**kw), gen(**kw), jgen(**kw)
    assert isinstance(a.items, torch.Tensor) and a.items.dtype == torch.int32
    same_catalog(a, b)  # regenerated from the seed: the same catalog
    np.testing.assert_array_equal(a.offsets, j.offsets)
    np.testing.assert_array_equal(a.user_ids, j.user_ids)
    assert a.attrs.shape == tuple(j.attrs.shape) and a.ctx_vals.shape == tuple(j.ctx_vals.shape)
    assert torch.all(a.attrs[0] == 0)
    assert int(a.items.min()) >= 1 and int(a.items.max()) <= 500
    c = gen(**dict(kw, seed=4))
    assert not torch.equal(a.items, c.items)


def test_synthetic_generator_maps_like_jax():
    for process in ("zipf", "markov"):
        assert syn.synthetic_generator(process, device=False) is getattr(
            syn, jsyn.synthetic_generator(process, False).__name__)
        dev = syn.synthetic_generator(process, device=True, torch_device="cpu")
        assert dev.func.__name__ == jsyn.synthetic_generator(process, True).__name__
    with pytest.raises(ValueError):
        syn.synthetic_generator("uniform", device=False)


@pytest.fixture(scope="module")
def zipf_pair():
    return (syn.synthetic_catalog_device(seed=1, device="cpu", **ZIPF),
            jsyn.synthetic_catalog_device(seed=1, **ZIPF))


@pytest.mark.parametrize("head", [1, 10, 100])
def test_zipf_device_head_mass_matches_jax(zipf_pair, head):
    n = ZIPF["n_real_items"]
    want = np.log(head + 1) / np.log(n)  # P(floor(exp(u ln n)) <= head)
    for cat in zipf_pair:
        items = np.asarray(host_catalog(cat).items)
        sigma = np.sqrt(want * (1 - want) / len(items))
        assert abs((items <= head).mean() - want) <= 5 * sigma, (head, type(cat.items))
    ours, theirs = (np.asarray(host_catalog(c).items) for c in zipf_pair)
    assert len(ours) == len(theirs) > 15_000


@pytest.fixture(scope="module")
def markov_pair():
    proc = syn.markov_process(STATS["n_users"], STATS["n_real_items"], n_clusters=8,
                              hot_items=40, seed=2)
    ours = syn.synthetic_catalog_markov_device(seed=2, proc=proc, device="cpu", **STATS)
    jproc = jsyn.markov_process(STATS["n_users"], STATS["n_real_items"], n_clusters=8,
                                hot_items=40, seed=2)
    theirs = jsyn.synthetic_catalog_markov_device(seed=2, proc=jproc, **STATS)
    return proc, ours, theirs


def test_markov_device_transitions_match_the_process(markov_pair):
    proc, ours, theirs = markov_pair
    for cat in (ours, theirs):
        cat = host_catalog(cat)
        items = np.asarray(cat.items)
        cl = syn.cluster_of(items, proc.bounds)
        user = np.repeat(np.arange(proc.n_users), np.diff(proc.offsets))
        pair = np.flatnonzero(user[1:] == user[:-1])  # consecutive events of one user
        prev, nxt, u = cl[pair], cl[pair + 1], user[pair]
        for a in range(proc.n_clusters):
            sel = prev == a
            want = (proc.alpha * proc.trans[a][None, :]
                    + (1 - proc.alpha) * proc.pref[u[sel]]).mean(0)
            got = np.bincount(nxt[sel], minlength=proc.n_clusters) / sel.sum()
            assert 0.5 * np.abs(got - want).sum() <= 0.06, (a, got, want)


def test_markov_device_attrs_recover_clusters(markov_pair):
    proc, ours, theirs = markov_pair
    true = syn.cluster_of(np.arange(1, proc.n_real_items + 1), proc.bounds)
    for cat in (ours, theirs):
        attrs = np.asarray(host_catalog(cat).attrs)[1:]
        d = ((attrs[:, None, :] - proc.centroids[None, :, :]) ** 2).sum(-1)
        assert (d.argmin(1) == true).mean() > 0.95
    np.testing.assert_array_equal(ours.offsets, theirs.offsets)


def test_host_catalog_copies_a_device_catalog():
    cat = syn.synthetic_catalog_device(n_users=20, n_real_items=30, seed=0, device="cpu")
    host = host_catalog(cat)
    assert isinstance(host.items, np.ndarray) and isinstance(host.attrs, np.ndarray)
    np.testing.assert_array_equal(host.items, cat.items.numpy())
    plain = syn.synthetic_catalog(n_users=20, n_real_items=30, seed=0)
    assert host_catalog(plain) is plain
