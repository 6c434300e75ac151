"""Deterministic synthetic catalog (counterpart of the host generator
``carca_tpu/data/synthetic.py::synthetic_catalog``).

Items are drawn iid from Zipf(1) over ids ``[1, n_real_items]``; attrs and
ctx are iid normal. The draws are numpy's, in the same order as the JAX
package's generator, so one seed gives a bit-identical catalog in both.
"""

from __future__ import annotations

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
