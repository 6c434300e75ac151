"""CARCA model assembly (counterpart of ``carca_tpu/models/carca.py``;
contract at ``src/carca.py:401-431``): mask the profile (id≠0), embed it
(+positional encoding, +dropout), run the encoder stack, apply a final
LayerNorm; then for each target group embed **without** positional
encoding, decode against the encoded profile, and concatenate the scores.

``CARCA`` holds the parameters under the JAX package's names (``embed``,
``blocks.<i>``, ``norm``, ``decoder``), so ``bridge.params_from_jax``
yields its ``state_dict``. Train/eval is the module's mode; dropout draws
from the ``generator`` the caller passes (on the tensors' device), and the
attention kernels' weight dropout on the card from seeds drawn by the CPU
``seed_generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models import decoders, embeddings, encoder, layers
from carca_tpu_torch.utils.masking import get_mask

Group = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


class CARCA(nn.Module):
    """Fresh weights come from ``torch.Generator().manual_seed(seed)``,
    drawn on the CPU and then moved to ``device``: the card unless the
    caller asks for the CPU (``device="cpu"``)."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = embeddings.Embedding(cfg, generator)
        self.blocks = nn.ModuleList(
            [encoder.EncoderBlock(cfg, generator) for _ in range(cfg.n_blocks)])
        self.norm = layers.LayerNorm(cfg.d)
        self.decoder = decoders.Decoder(cfg, generator)
        self.to(device)

    def forward(self, profile: Group, targets: Sequence[Group], *,
                attrs_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                seed_generator: Optional[torch.Generator] = None,
                return_logits: bool = False,
                item_rows: Optional[embeddings.ItemRows] = None) -> torch.Tensor:
        return carca_apply(self, profile, targets, attrs_table=attrs_table,
                           generator=generator, seed_generator=seed_generator,
                           return_logits=return_logits, item_rows=item_rows)


def encode_profile(
    model: CARCA,
    profile: Group,
    *,
    attrs_table: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    seed_generator: Optional[torch.Generator] = None,
    item_rows: Optional[embeddings.ItemRows] = None,
    lookup: Optional[embeddings.Lookup] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The profile tower: (encoded profile [B, L, d], p_mask [B, L])."""
    cfg = model.cfg
    p_x, p_a, p_c = profile
    p_mask = get_mask(p_x)
    p_e = model.embed(p_x, p_a, p_c, p_mask, target=False, attrs_table=attrs_table,
                      item_rows=item_rows, lookup=lookup)
    p_e = layers.dropout(p_e, cfg.dropout, model.training, generator)  # src/carca.py:416
    for block in model.blocks:
        p_e = block(p_e, p_mask, generator, seed_generator)
    return model.norm(p_e), p_mask  # src/carca.py:421


def score_targets(
    model: CARCA,
    p_e: torch.Tensor,
    p_mask: torch.Tensor,
    targets: Sequence[Group],
    *,
    attrs_table: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    seed_generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
    item_rows: Optional[embeddings.ItemRows] = None,
    lookup: Optional[embeddings.Lookup] = None,
) -> torch.Tensor:
    """Embed + decode each target group; concat scores
    (``src/carca.py:424-431``). Same-shaped groups (the train-time [pos,
    neg] pair) are folded into the batch and decoded in one call; every
    row's math is unchanged (``carca_tpu/models/carca.py:108-130``)."""
    b = p_e.shape[0]
    same_shape = (len(targets) > 1
                  and all(t[0].shape == targets[0][0].shape for t in targets)
                  and all((t[1] is None) == (targets[0][1] is None)
                          and (t[2] is None) == (targets[0][2] is None)
                          for t in targets))
    if same_shape:
        g = len(targets)

        def cat(i):
            return None if targets[0][i] is None else torch.cat([t[i] for t in targets], 0)

        o_x, o_a, o_c = cat(0), cat(1), cat(2)
        o_mask = get_mask(o_x)
        o_e = model.embed(o_x, o_a, o_c, o_mask, target=True, attrs_table=attrs_table,
                          item_rows=item_rows, lookup=lookup)
        y = model.decoder(o_e, o_mask, torch.cat([p_e] * g, 0),
                          torch.cat([p_mask] * g, 0), generator=generator,
                          seed_generator=seed_generator, return_logits=return_logits)
        # [G·B, T] → scores concatenated group-major along the last axis
        return y.reshape(g, b, -1).permute(1, 0, 2).reshape(b, -1)

    ys: List[torch.Tensor] = []
    for o_x, o_a, o_c in targets:
        o_mask = get_mask(o_x)
        o_e = model.embed(o_x, o_a, o_c, o_mask, target=True, attrs_table=attrs_table,
                          item_rows=item_rows, lookup=lookup)
        ys.append(model.decoder(o_e, o_mask, p_e, p_mask, generator=generator,
                                seed_generator=seed_generator,
                                return_logits=return_logits))
    return torch.cat(ys, dim=-1)


def carca_apply(
    model: CARCA,
    profile: Group,
    targets: Sequence[Group],
    *,
    attrs_table: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    seed_generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
    item_rows: Optional[embeddings.ItemRows] = None,
    lookup: Optional[embeddings.Lookup] = None,
) -> torch.Tensor:
    """Full forward: profile + target groups → concatenated scores
    (train [B, 2L] for [pos, neg]; eval [B, T+1] for one group).
    ``item_rows`` routes every item lookup (``embeddings.ItemRows``),
    ``lookup`` every item and attrs lookup (``embeddings.Embedding``)."""
    p_e, p_mask = encode_profile(model, profile, attrs_table=attrs_table,
                                 generator=generator, seed_generator=seed_generator,
                                 item_rows=item_rows, lookup=lookup)
    return score_targets(model, p_e, p_mask, targets, attrs_table=attrs_table,
                         generator=generator, seed_generator=seed_generator,
                         return_logits=return_logits, item_rows=item_rows, lookup=lookup)
