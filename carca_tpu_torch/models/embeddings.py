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
unpacks a packed JAX table.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models import encodings, layers
from carca_tpu_torch.utils.initializers import embedding_init


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
    ) -> torch.Tensor:
        """x [B, T] ids; a [B, T, n_attrs] or None (→ ``attrs_table[x]``);
        c [B, T, n_ctx] (all/attrctx only); mask [B, T] → [B, T, d]."""
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
            return attrs_table[x]

        if kind == "all":  # src/carca.py:85-95
            q = self.feats(torch.cat([attrs(), c], dim=-1), cd)
            z = self.items[x] * scale
            e = self.joint(torch.cat([z, q], dim=-1), cd)
        elif kind == "attrctx":  # src/carca.py:114-122
            e = self.joint(self.feats(torch.cat([attrs(), c], dim=-1), cd), cd)
        elif kind == "attr":  # src/carca.py:141-149
            e = self.joint(self.feats(attrs(), cd), cd)
        elif kind == "id":  # src/carca.py:163-171
            e = self.items[x] * scale
        else:  # mlpid, src/carca.py:189-198 — √d scale (not √g) on the g-dim table
            e = self.feats(self.items[x] * scale, cd)

        if not target:
            e = self.enc(e)
        return (e * mask[..., None]).to(torch.float32)
