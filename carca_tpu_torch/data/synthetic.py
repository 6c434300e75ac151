"""Deterministic synthetic catalogs (counterpart of
``carca_tpu/data/synthetic.py``) and the reference file writer.

Two generative processes, each with a host generator (numpy) and a device
generator (torch, on the card unless the caller asks for the CPU):

* **zipf**: items iid from Zipf(1) over ids ``[1, n_real_items]``, attrs
  and ctx iid normal.
* **markov**: items fall into K contiguous attribute clusters; each user
  has a private 3-cluster preference mixture; the next event's cluster
  mixes a global cluster→cluster Markov transition (weight ``alpha``) with
  the user's preference; the item within the cluster is a two-tier Zipf
  (a hot head and the full block).

The host generators are numpy copies of the JAX package's: one seed gives a
bit-identical catalog in both packages. The device generators draw from a
``torch.Generator`` on the device instead of JAX's threefry stream, so
they match the JAX package's device twins in distribution only; what they
take from numpy (the CSR offsets, and for markov the small process
tensors) is bit-equal to JAX's. A device catalog holds torch tensors
(``attrs``, ``items``, ``ctx_vals``) and numpy ``offsets``/``user_ids``;
``host_catalog`` copies it to the host for the host consumers
(``BatchBuilder``, ``write_reference_format``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import pickle

import numpy as np
import torch

from carca_tpu_torch.data.loaders import Catalog, host_catalog


def synthetic_catalog(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
) -> Catalog:
    rng = np.random.default_rng(seed)

    # zipf-ish popularity over real item ids [1, n_real_items]
    ranks = np.arange(1, n_real_items + 1, dtype=np.float64)
    popularity = 1.0 / ranks
    popularity /= popularity.sum()

    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    n_events = int(offsets[-1])

    items = rng.choice(
        np.arange(1, n_real_items + 1, dtype=np.int32), size=n_events, p=popularity
    )
    ctx_vals = rng.standard_normal((n_events, n_ctx)).astype(np.float32)

    attrs = rng.standard_normal((n_real_items + 1, n_attrs)).astype(np.float32)
    attrs[0] = 0.0  # pad row (src/data.py:33-34)

    return Catalog(
        attrs=attrs,
        user_ids=np.arange(n_users, dtype=np.int64),
        items=items.astype(np.int32),
        offsets=offsets,
        ctx_vals=ctx_vals,
    )


def _device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def _gumbel(shape, g: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, −log(−log u), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=g, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def synthetic_catalog_device(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Catalog:
    """``synthetic_catalog`` with the big arrays drawn on ``device``: only
    the ``[n_users + 1]`` CSR offsets come from numpy (the same draws as
    the host generator and the JAX package's device twin, so equal to
    theirs). Items follow the continuous Zipf(1) inverse CDF
    ``clip(floor(exp(u·ln n)), 1, n)``, ctx and attrs N(0, 1) with a zero
    pad row, all from one ``torch.Generator`` on ``device`` seeded with
    ``seed``, in that order. A generator's stream for a seed is fixed for
    one kind of device; on a CUDA card it may depend on the launch
    geometry, so another card kind may draw another catalog."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    n_events = int(offsets[-1])

    device = torch.device(device)
    g = _device_generator(seed, device)
    u = torch.rand(n_events, generator=g, device=device)
    items = torch.exp(u * math.log(float(n_real_items))).to(torch.int32).clamp_(1, n_real_items)
    ctx_vals = torch.randn(n_events, n_ctx, generator=g, device=device)
    attrs = torch.randn(n_real_items + 1, n_attrs, generator=g, device=device)
    attrs[0] = 0.0  # pad row (src/data.py:33-34)
    return Catalog(attrs=attrs, user_ids=np.arange(n_users, dtype=np.int64), items=items,
                   offsets=offsets, ctx_vals=ctx_vals)


# --------------------------------------------------------------------
# the markov process: per-user cluster preferences + cluster-Markov
# transitions + a two-tier within-cluster Zipf
# --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MarkovProcess:
    """The true parameters of the markov process, enough to compute the
    exact next-item posterior."""
    n_users: int
    n_real_items: int
    n_clusters: int
    n_attrs: int
    n_ctx: int
    alpha: float          # weight of the Markov term in the cluster mix
    hot_frac: float       # P(draw from the cluster's hot head)
    hot_items: int        # head size (per cluster, capped at block size)
    attr_noise: float     # attrs = centroid[c] + noise·N(0,1)
    trans: np.ndarray     # [K, K] row-stochastic cluster transitions
    pref: np.ndarray      # [U, K] per-user preference mixture (3 clusters)
    centroids: np.ndarray  # [K, A]
    lengths: np.ndarray   # [U] profile lengths
    offsets: np.ndarray   # [U+1] CSR

    @property
    def bounds(self) -> np.ndarray:
        """[K+1] cluster block bounds: cluster c owns the real item ids
        (bounds[c], bounds[c+1]]."""
        return cluster_bounds(self.n_real_items, self.n_clusters)


def cluster_bounds(n_real_items: int, n_clusters: int) -> np.ndarray:
    return (np.arange(n_clusters + 1, dtype=np.int64) * n_real_items) // n_clusters


def cluster_of(item_ids, bounds):
    """Cluster index of real item ids (>= 1) under contiguous blocks
    (numpy arrays or scalars; a tensor takes ``torch.searchsorted``)."""
    if isinstance(item_ids, torch.Tensor):
        b = torch.as_tensor(bounds, device=item_ids.device)
        return torch.searchsorted(b, item_ids.long() - 1, right=True) - 1
    return np.searchsorted(bounds, np.asarray(item_ids) - 1, side="right") - 1


def markov_process(
    n_users: int,
    n_real_items: int,
    n_clusters: int = 64,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    alpha: float = 0.6,
    hot_frac: float = 0.75,
    hot_items: int = 2000,
    attr_noise: float = 0.3,
    seed: int = 0,
) -> MarkovProcess:
    """Draw the (small) true parameters on the host with numpy, shared by
    the host and the device generator. Transition rows: 0.35 self + 0.30 /
    0.20 on two random successor clusters + 0.15 spread uniformly."""
    if n_clusters > n_real_items:
        raise ValueError(f"n_clusters {n_clusters} > n_items {n_real_items}")
    rng = np.random.default_rng(seed)
    K = n_clusters

    trans = np.full((K, K), 0.15 / K, np.float64)
    for c in range(K):
        others = rng.permutation(np.delete(np.arange(K), c))[:2]
        trans[c, c] += 0.35
        if len(others) >= 1:
            trans[c, others[0]] += 0.30 if len(others) >= 2 else 0.50
        if len(others) >= 2:
            trans[c, others[1]] += 0.20
        else:
            trans[c, c] += 0.0 if len(others) >= 1 else 0.50
    trans /= trans.sum(axis=1, keepdims=True)  # exact row-stochastic

    # 3 distinct preferred clusters per user, weights 0.5/0.3/0.2
    n_pref = min(3, K)
    picks = np.argpartition(rng.random((n_users, K)), n_pref - 1, axis=1)[:, :n_pref]
    w = np.array([0.5, 0.3, 0.2][:n_pref], np.float64)
    w /= w.sum()
    pref = np.zeros((n_users, K), np.float32)
    np.put_along_axis(pref, picks, w.astype(np.float32)[None, :], axis=1)

    centroids = rng.standard_normal((K, n_attrs)).astype(np.float32)

    lengths = rng.integers(min_len, max_len + 1, size=n_users)
    offsets = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return MarkovProcess(
        n_users=n_users, n_real_items=n_real_items, n_clusters=K,
        n_attrs=n_attrs, n_ctx=n_ctx, alpha=alpha, hot_frac=hot_frac,
        hot_items=hot_items, attr_noise=attr_noise, trans=trans, pref=pref,
        centroids=centroids, lengths=lengths, offsets=offsets)


def _rank_pmf_weights(proc: MarkovProcess) -> tuple:
    """(block sizes [K], hot-head sizes [K]) of the within-cluster draw."""
    sizes = np.diff(proc.bounds)
    m_hot = np.minimum(proc.hot_items, sizes)
    return sizes, m_hot


def markov_rank_pmf(proc: MarkovProcess, ranks: np.ndarray, cluster: np.ndarray) -> np.ndarray:
    """P(within-cluster rank | cluster) under the two-tier Zipf draw: the
    exact pmf of ``clip(floor(exp(u·ln m)), 1, m)``."""
    sizes, m_hot = _rank_pmf_weights(proc)
    m_full = sizes[cluster].astype(np.float64)
    mh = m_hot[cluster].astype(np.float64)
    r = ranks.astype(np.float64)
    base = np.log1p(1.0 / r)
    # ln(m)=0 for single-item blocks: the draw is deterministic rank 1
    hot = np.where((r < mh), base / np.maximum(np.log(mh), 1e-12), 0.0)
    hot = np.where(mh <= 1.0, (r == 1.0).astype(np.float64), hot)
    full = np.where((r < m_full), base / np.maximum(np.log(m_full), 1e-12), 0.0)
    full = np.where(m_full <= 1.0, (r == 1.0).astype(np.float64), full)
    return proc.hot_frac * hot + (1.0 - proc.hot_frac) * full


def _categorical_rows(rng: np.random.Generator, p: np.ndarray) -> np.ndarray:
    """One index per row of a [N, K] probability matrix (Gumbel-argmax)."""
    g = rng.gumbel(size=p.shape)
    return np.argmax(np.log(np.maximum(p, 1e-38)) + g, axis=1)


def _markov_clusters_numpy(proc: MarkovProcess, rng: np.random.Generator,
                           max_len: int) -> np.ndarray:
    """[U, max_len] cluster sequence: c_0 ~ pref, c_t ~ α·T[c_{t-1}] +
    (1-α)·pref."""
    U = proc.n_users
    seq_c = np.zeros((U, max_len), np.int64)
    c = _categorical_rows(rng, proc.pref)
    seq_c[:, 0] = c
    for t in range(1, max_len):
        p = proc.alpha * proc.trans[c] + (1.0 - proc.alpha) * proc.pref
        c = _categorical_rows(rng, p)
        seq_c[:, t] = c
    return seq_c


def _items_within_clusters_numpy(proc: MarkovProcess, rng: np.random.Generator,
                                 seq_c: np.ndarray) -> np.ndarray:
    """Two-tier Zipf item draw for every (user, t) cluster assignment."""
    sizes, m_hot = _rank_pmf_weights(proc)
    m_full = sizes[seq_c]
    mh = m_hot[seq_c]
    m = np.where(rng.random(seq_c.shape) < proc.hot_frac, mh, m_full)
    u = rng.random(seq_c.shape)
    rank = np.clip(np.floor(np.exp(u * np.log(m))).astype(np.int64), 1, m)
    return proc.bounds[seq_c] + rank


def synthetic_catalog_markov(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
    proc: MarkovProcess | None = None,
    **proc_kw,
) -> Catalog:
    """The markov catalog drawn with numpy (the deterministic source for
    tests). Pass ``proc`` to reuse an existing process."""
    if proc is None:
        proc = markov_process(n_users, n_real_items, n_attrs=n_attrs, n_ctx=n_ctx,
                              min_len=min_len, max_len=max_len, seed=seed, **proc_kw)
    rng = np.random.default_rng(seed + 1)  # event stream: distinct from proc
    T = int(proc.lengths.max())
    seq_c = _markov_clusters_numpy(proc, rng, T)
    items2d = _items_within_clusters_numpy(proc, rng, seq_c)
    keep = np.arange(T)[None, :] < proc.lengths[:, None]
    items = items2d[keep].astype(np.int32)  # row-major → CSR event order
    n_events = int(proc.offsets[-1])
    assert items.shape[0] == n_events
    ctx_vals = rng.standard_normal((n_events, proc.n_ctx)).astype(np.float32)

    attrs = (proc.centroids[cluster_of(np.arange(1, proc.n_real_items + 1), proc.bounds)]
             + proc.attr_noise * rng.standard_normal((proc.n_real_items, proc.n_attrs)))
    attrs = np.concatenate(
        [np.zeros((1, proc.n_attrs), np.float32),  # pad row (src/data.py:33-34)
         attrs.astype(np.float32)], axis=0)

    return Catalog(
        attrs=attrs,
        user_ids=np.arange(proc.n_users, dtype=np.int64),
        items=items,
        offsets=proc.offsets,
        ctx_vals=ctx_vals,
    )


def synthetic_catalog_markov_device(
    n_users: int = 2000,
    n_real_items: int = 1000,
    n_attrs: int = 12,
    n_ctx: int = 4,
    min_len: int = 4,
    max_len: int = 30,
    seed: int = 0,
    proc: MarkovProcess | None = None,
    device: torch.device | str = "cuda",
    **proc_kw,
) -> Catalog:
    """The markov catalog with its big arrays drawn on ``device``. Only the
    process tensors (transitions [K, K], preferences [U, K], centroids
    [K, A]) and the CSR offsets come from numpy, equal to the JAX
    package's for a seed. On the device, from one ``torch.Generator``
    seeded with ``seed``, in this order: the Gumbel-argmax cluster chain
    (T steps of [U, K]), the tier and rank uniforms [U, T], the ctx
    normals and the attrs noise. The [U, T] draw is flattened to CSR order
    on the device. The same caveat on card kinds holds as for
    ``synthetic_catalog_device``."""
    if proc is None:
        proc = markov_process(n_users, n_real_items, n_attrs=n_attrs, n_ctx=n_ctx,
                              min_len=min_len, max_len=max_len, seed=seed, **proc_kw)
    device = torch.device(device)
    U, K, T = proc.n_users, proc.n_clusters, int(proc.lengths.max())
    n_events = int(proc.offsets[-1])
    sizes, m_hot = _rank_pmf_weights(proc)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    trans, pref = put(proc.trans, torch.float32), put(proc.pref, torch.float32)
    bounds = put(proc.bounds, torch.int64)
    sizes_d, m_hot_d = put(sizes, torch.int64), put(m_hot, torch.int64)
    offsets = put(proc.offsets, torch.int64)
    centroids = put(proc.centroids, torch.float32)

    g = _device_generator(seed, device)
    c = torch.argmax(torch.log(pref.clamp_min(1e-38)) + _gumbel((U, K), g, device), dim=1)
    seq = [c]
    for _ in range(1, T):
        p = proc.alpha * trans[c] + (1.0 - proc.alpha) * pref
        c = torch.argmax(torch.log(p.clamp_min(1e-38)) + _gumbel((U, K), g, device), dim=1)
        seq.append(c)
    seq_c = torch.stack(seq, dim=1)  # [U, T]

    tier = torch.rand((U, T), generator=g, device=device) < proc.hot_frac
    m = torch.where(tier, m_hot_d[seq_c], sizes_d[seq_c])
    u = torch.rand((U, T), generator=g, device=device)
    rank = torch.exp(u * torch.log(m.to(torch.float32))).to(torch.int64)
    rank = torch.minimum(rank.clamp_min(1), m)
    items2d = bounds[seq_c] + rank

    # CSR flatten: event e belongs to user searchsorted(offsets) - 1, at
    # position e - offsets[user]
    e = torch.arange(n_events, device=device)
    ue = torch.searchsorted(offsets, e, right=True) - 1
    items = items2d[ue, e - offsets[ue]].to(torch.int32)

    ctx_vals = torch.randn(n_events, proc.n_ctx, generator=g, device=device)
    cl = torch.searchsorted(bounds, torch.arange(proc.n_real_items + 1, device=device) - 1,
                            right=True) - 1  # id 0 → cluster -1 → row zeroed below
    attrs = (centroids[cl.clamp_min(0)]
             + proc.attr_noise * torch.randn(proc.n_real_items + 1, proc.n_attrs, generator=g,
                                             device=device))
    attrs[0] = 0.0  # pad row (src/data.py:33-34)
    return Catalog(attrs=attrs, user_ids=np.arange(U, dtype=np.int64), items=items,
                   offsets=proc.offsets, ctx_vals=ctx_vals)


def synthetic_generator(process: str, device: bool, torch_device: torch.device | str = "cuda"):
    """A DataConfig's ``synthetic_process`` and placement → its generator,
    the one mapping that training (``cli.load_catalog``) and serving
    (``serve/service.load_catalog_for_run``) share, so a run's catalog is
    regenerable from its ``args.json``. A device generator draws on
    ``torch_device``."""
    gens = {("zipf", False): synthetic_catalog,
            ("zipf", True): synthetic_catalog_device,
            ("markov", False): synthetic_catalog_markov,
            ("markov", True): synthetic_catalog_markov_device}
    try:
        gen = gens[(process, bool(device))]
    except KeyError:
        raise ValueError(f"unknown synthetic_process {process!r} (zipf|markov)") from None
    return functools.partial(gen, device=torch_device) if device else gen


def write_reference_format(cat: Catalog, out_dir: str) -> None:
    """Dump a Catalog in the reference's file formats: ``profiles.txt``,
    ``attrs.pkl`` (without the pad row, which the loader prepends) and
    ``ctx.pkl``. The ctx dict is keyed by (user, item): where a user repeats
    an item only its last context survives, as in the reference format. A
    device catalog is copied to the host first."""
    cat = host_catalog(cat)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profiles.txt"), "w") as fh:
        for u in range(cat.n_users):
            uid = int(cat.user_ids[u])
            for e in range(cat.offsets[u], cat.offsets[u + 1]):
                fh.write(f"{uid} {int(cat.items[e])}\n")
    with open(os.path.join(out_dir, "attrs.pkl"), "wb") as fh:
        pickle.dump(cat.attrs[1:], fh)
    ctx = {}
    for u in range(cat.n_users):
        uid = int(cat.user_ids[u])
        for e in range(cat.offsets[u], cat.offsets[u + 1]):
            ctx[(uid, int(cat.items[e]))] = cat.ctx_vals[e].tolist()
    with open(os.path.join(out_dir, "ctx.pkl"), "wb") as fh:
        pickle.dump(ctx, fh)


def canonicalize_repeat_ctx(cat: Catalog) -> Catalog:
    """The reference's (user, item)-keyed context semantics: where a user
    repeats an item, every occurrence takes the surviving (last) context,
    which is what ``write_reference_format`` then ``load_dataset`` give."""
    ctx_vals = cat.ctx_vals.copy()
    for u in range(cat.n_users):
        s, e = int(cat.offsets[u]), int(cat.offsets[u + 1])
        last = {}
        for i in range(s, e):
            last[int(cat.items[i])] = i
        for i in range(s, e):
            ctx_vals[i] = cat.ctx_vals[last[int(cat.items[i])]]
    return Catalog(cat.attrs, cat.user_ids, cat.items, cat.offsets, ctx_vals)
