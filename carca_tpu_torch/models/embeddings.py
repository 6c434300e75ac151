"""Feature-fusion embeddings (counterpart of
``carca_tpu/models/embeddings.py``): (item id, attribute vector, context
vector) → d-dim token, in five variants (``src/carca.py:66-198``):

* ``all``     — id-embed·√d ⊕ Linear(a‖c → g) → Linear(g+d → d)
* ``attrctx`` — Linear(a‖c → g) → Linear(g → d), no id table
* ``attr``    — Linear(a → g) → Linear(g → d)
* ``id``      — id table · √d
* ``mlpid``   — id table (g-dim) · √d → Linear(g → d)

Positional encoding only when ``target=False`` (``src/carca.py:91-92``);
the output is zeroed at pad positions (``src/carca.py:94``). Attribute
vectors may be gathered on the device from ``attrs_table`` (``a=None``).
The item table is never lane-packed here; ``bridge.params_from_jax``
unpacks a packed JAX table. Its rows are gathered with ``F.embedding``: the
same values as ``items[x]``, but a backward that sorts the ids and sums each
id's rows as one segment. The backward of ``items[x]`` (an accumulating
index_put) walks repeated ids one by one on the card, and popular items
repeat thousands of times per batch: it took 12.5 ms of a 15.4 ms flagship
train step on an H100 (PERF.md §5). A ``lookup(table, ids)`` routes the
item and attrs gathers through another function (``parallel.embedding``'s
row-sharded lookup), as the JAX package's ``lookup`` parameter does.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models import encodings, layers
from carca_tpu_torch.utils.initializers import embedding_init


class ItemRows(NamedTuple):
    """An explicit route for the item lookup: id x reads row
    ``posmap[x]`` of ``table`` instead of row x of ``Embedding.items``.
    The row-sparse Adam (``train/sparse_adam.py``) passes the gathered
    sub-table of a batch's unique ids and each id's slot in it, so the
    gradient lands on the sub-table alone."""

    table: torch.Tensor  # [cap, W]
    posmap: torch.Tensor  # [n_items] slot of each id of the batch


Lookup = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (table, ids) -> rows


def item_table_width(cfg: ModelConfig) -> int:
    """Row width of the ``items`` table (mlpid uses a g-dim table,
    src/carca.py:180)."""
    return cfg.g if cfg.embedding == "mlpid" else cfg.d


class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.enc = encodings.Encoding(cfg.encoding, cfg.d, cfg.seq_len, generator)
        kind = cfg.embedding
        if kind in ("all", "id", "mlpid"):
            self.items = nn.Parameter(embedding_init(
                cfg.n_items, item_table_width(cfg), generator, zero_pad_row=True))
        if kind in ("all", "attrctx"):
            self.feats = layers.Dense(cfg.n_ctx + cfg.n_attrs, cfg.g, generator)
        elif kind == "attr":
            self.feats = layers.Dense(cfg.n_attrs, cfg.g, generator)
        elif kind == "mlpid":
            self.feats = layers.Dense(cfg.g, cfg.d, generator)
        if kind == "all":
            self.joint = layers.Dense(cfg.g + cfg.d, cfg.d, generator)
        elif kind in ("attrctx", "attr"):
            self.joint = layers.Dense(cfg.g, cfg.d, generator)

    def forward(
        self,
        x: torch.Tensor,
        a: Optional[torch.Tensor],
        c: Optional[torch.Tensor],
        mask: torch.Tensor,
        *,
        target: bool,
        attrs_table: Optional[torch.Tensor] = None,
        item_rows: Optional[ItemRows] = None,
        lookup: Optional[Lookup] = None,
    ) -> torch.Tensor:
        """x [B, T] ids; a [B, T, n_attrs] or None (→ ``attrs_table[x]``);
        c [B, T, n_ctx] (all/attrctx only); mask [B, T] → [B, T, d]. With
        ``item_rows`` the id embeddings come from its table; with ``lookup``
        both the id embeddings and the attrs rows are ``lookup(table, x)``."""
        cfg = self.cfg
        kind = cfg.embedding
        cd = cfg.compute_dtype
        scale = math.sqrt(cfg.d)
        x = x.long()

        def attrs() -> torch.Tensor:
            if a is not None:
                return a
            if attrs_table is None:
                raise ValueError("need either explicit attrs `a` or an `attrs_table` catalog")
            return attrs_table[x] if lookup is None else lookup(attrs_table, x)

        def ids() -> torch.Tensor:
            if item_rows is not None:
                return F.embedding(item_rows.posmap[x], item_rows.table)
            return F.embedding(x, self.items) if lookup is None else lookup(self.items, x)

        if kind == "all":  # src/carca.py:85-95
            q = self.feats(torch.cat([attrs(), c], dim=-1), cd)
            z = ids() * scale
            e = self.joint(torch.cat([z, q], dim=-1), cd)
        elif kind == "attrctx":  # src/carca.py:114-122
            e = self.joint(self.feats(torch.cat([attrs(), c], dim=-1), cd), cd)
        elif kind == "attr":  # src/carca.py:141-149
            e = self.joint(self.feats(attrs(), cd), cd)
        elif kind == "id":  # src/carca.py:163-171
            e = ids() * scale
        else:  # mlpid, src/carca.py:189-198 — √d scale (not √g) on the g-dim table
            e = self.feats(ids() * scale, cd)

        if not target:
            e = self.enc(e)
        return (e * mask[..., None]).to(torch.float32)
