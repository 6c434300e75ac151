"""Deterministic synthetic catalog (counterpart of the host generator
``carca_tpu/data/synthetic.py::synthetic_catalog``) and the reference file
writer.

Items are drawn iid from Zipf(1) over ids ``[1, n_real_items]``; attrs and
ctx are iid normal. The draws are numpy's, in the same order as the JAX
package's generator, so one seed gives a bit-identical catalog in both.
The markov process and the generators on the device are not ported yet
(ROADMAP item 12): ``synthetic_generator`` raises for them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from carca_tpu_torch.data.loaders import Catalog


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


def synthetic_generator(process: str, device: bool):
    """A DataConfig's ``synthetic_process`` and placement → its generator,
    the one mapping that training (``cli.load_catalog``) and serving
    (``serve/service.load_catalog_for_run``) share. Only ("zipf", host) is
    ported; the device generators draw from the JAX package's own PRNG,
    which the port cannot reproduce."""
    if process not in ("zipf", "markov"):
        raise ValueError(f"unknown synthetic_process {process!r} (zipf|markov)")
    if process == "zipf" and not device:
        return synthetic_catalog
    where = "on the device" if device else "on the host"
    raise NotImplementedError(
        f"the {process} synthetic catalog generated {where} is not ported yet (ROADMAP "
        f"item 12); write the catalog with write_reference_format and pass --data_dir")


def write_reference_format(cat: Catalog, out_dir: str) -> None:
    """Dump a Catalog in the reference's file formats: ``profiles.txt``,
    ``attrs.pkl`` (without the pad row, which the loader prepends) and
    ``ctx.pkl``. The ctx dict is keyed by (user, item): where a user repeats
    an item only its last context survives, as in the reference format."""
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
