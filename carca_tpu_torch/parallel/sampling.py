"""On-device negative sampling (counterpart of
``carca_tpu/parallel/sampling.py``).

Negatives are uniform ids in ``[1, n_items−1]`` (the reference's
``random.randint(1, n_items-1)``, ``src/data.py:82``), distinct within a
row and rejected against a per-row window, drawn on the tensors' device
from an explicit ``torch.Generator``. Three branches, as in the JAX
package:

* overdraw-and-dedupe (``overdraw_for`` feasible): draw O ids per row and
  keep the first ``n_slots`` distinct ones that miss the window — exact
  sampling without replacement, two stable sorts;
* a dense top-k of iid uniform keys for catalogs ≤ 32,768 ids when the
  slots approach the catalog size;
* retry rejection (``retries`` draws per slot, the first that misses the
  window) for popularity draws from the event array, which keep within-row
  repeats, and for uniform draws beyond both branches above.

Every sort is ``torch.sort(stable=True)``: ``torch.topk``'s order among
ties is unspecified (ROADMAP §C).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def retries_for(reject_width: int, n_items: int, popularity: bool = False) -> int:
    """Retry count making the all-draws-collide fallback negligible: the
    collision probability per uniform draw is ≤ reject_width/(n_items − 1);
    pick R so p^R ≤ 1e−12, at least 8 and at most 64. Popularity draws use
    a pessimistic p ≥ 0.35 (R = 24)."""
    p = min(reject_width / max(n_items - 1, 1), 0.999)
    if popularity:
        p = max(p, 0.35)
    if p <= 0.03:  # 0.03^8 < 1e-12
        return 8
    return max(8, min(64, math.ceil(-12.0 / math.log10(p))))


def overdraw_for(n_slots: int, n_items: int, reject_width: int) -> Optional[int]:
    """Candidate count O for the without-replacement-by-dedupe sampler, or
    None if infeasible. The margin O − n_slots must absorb the expected
    window hits (O·W/(n−1)) and duplicates (O²/(2A), A the allowed-set
    size) with a large deviation: m ≥ D + 10·√(D + 0.15) + 4 keeps the
    Poisson tail of a short row ≲ 1e−12. None when no O ≤ 4·n_slots +
    2·reject_width + 64 satisfies it (slots close to the catalog size)."""
    a = n_items - 1 - reject_width  # pessimistic allowed-set size
    if a <= n_slots:
        return None
    p_win = reject_width / max(n_items - 1, 1)
    cap = 4 * n_slots + 2 * reject_width + 64
    o = n_slots + 8
    while o <= cap:
        d = o * o / (2.0 * a) + o * p_win
        if o - n_slots >= d + 10.0 * math.sqrt(d + 0.15) + 4.0:
            return o
        o += 8
    return None


def _first_distinct_excluding(draws: torch.Tensor, window: torch.Tensor,
                              n_slots: int) -> torch.Tensor:
    """[B, O] iid draws → the first ``n_slots`` distinct values in draw
    order that do NOT appear in ``window`` [B, W].

    Window entries are concatenated ahead of the draws, so in the stable
    value sort each window id heads its run of equal values, and a draw
    that collides with it is marked like a repeated draw. The head's window
    flag rides in the low bit of its position and spreads along the run
    with one cummax. The rank then orders good draws (in draw order), then
    repeated draws, then window-colliding draws, then the window entries:
    the ≲1e−12 short-row fallback emits a repeated negative before it ever
    emits a false (window) negative."""
    b, o = draws.shape
    w = window.shape[1]
    dev = draws.device
    vals = torch.cat([window.to(draws.dtype), draws], dim=1)
    tag = torch.cat([torch.zeros(w, dtype=torch.int64, device=dev),
                     torch.arange(1, o + 1, dtype=torch.int64, device=dev)])
    sv, order = torch.sort(vals, dim=1, stable=True)  # stable: window first
    st = tag[order]
    prev_eq = torch.cat([torch.zeros(b, 1, dtype=torch.bool, device=dev),
                         sv[:, 1:] == sv[:, :-1]], dim=1)
    pos2 = torch.arange(w + o, dtype=torch.int64, device=dev).expand(b, w + o)
    enc = torch.where(prev_eq, -1, pos2 * 2 + (st == 0).to(torch.int64))
    head_win = (torch.cummax(enc, dim=1).values & 1) == 1
    big = 2 * (w + o)
    rank = torch.where(st == 0, 4 * big,
                       torch.where(head_win, 2 * big + st,
                                   torch.where(prev_eq, big + st, st)))
    _, by_rank = torch.sort(rank, dim=1, stable=True)
    return torch.gather(sv, 1, by_rank[:, :n_slots])


def device_sample_negatives(
    generator: torch.Generator,
    profile: torch.Tensor,
    n_items: int,
    n_slots: int,
    retries: int = 8,
    events: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample ``[B, n_slots]`` negative ids avoiding ``profile`` [B, W] (the
    reject set), distinct within each row for uniform draws; ``generator``
    lives on ``profile``'s device. With ``events`` (the CSR event-item
    array) the draws are popularity-proportional instead: a uniform random
    event's item id is a draw from the empirical unigram distribution."""
    b = profile.shape[0]
    dev = profile.device
    overdraw = (overdraw_for(n_slots, n_items, profile.shape[1])
                if events is None else None)
    if overdraw is not None:
        draws = torch.randint(1, n_items, (b, overdraw), generator=generator,
                              device=dev, dtype=profile.dtype)
        return _first_distinct_excluding(draws, profile, n_slots)
    if events is None and n_slots < n_items <= 32768:
        # slots ≈ catalog: exact sampling without replacement as the top
        # n_slots of iid uniform keys over the id space, ties to the lowest id
        keys = torch.rand((b, n_items), generator=generator, device=dev)
        keys[:, 0] = -math.inf  # the pad id is never sampled
        keys.scatter_(1, profile.long(), -math.inf)
        ids = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :n_slots]
        return ids.to(profile.dtype)
    if events is not None:
        eidx = torch.randint(0, events.shape[0], (b, n_slots, retries), generator=generator,
                             device=dev)
        draws = events[eidx].to(profile.dtype)
    else:
        draws = torch.randint(1, n_items, (b, n_slots, retries), generator=generator,
                              device=dev, dtype=profile.dtype)
    hit = (draws[:, :, :, None] == profile[:, None, None, :]).any(dim=-1)
    # the first draw that misses the window; the last draw if all collide
    ok = ~hit
    first_ok = torch.argmax(ok.to(torch.int32), dim=-1)  # the first maximum
    idx = torch.where(ok.any(dim=-1), first_ok, retries - 1)
    return torch.gather(draws, 2, idx[..., None])[..., 0]
