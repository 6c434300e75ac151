"""Every kernel wrapper's launch counter, read, put back and advanced in one
place.

Each wrapper adds one to its counter where it launches its kernel, and
nowhere else: K1 ``flash_attention.fused_attention.launches`` (with
``launches_by_shape`` by (Lq, Lk, causal)), K2
``flash_attention.attention_bwd.launches`` (the same), K3
``retrieval_topk.catalog_topk.launches`` by index kind, K4
``retrieval_topk.groupmax.launches`` by layout, the rerank
``retrieval_topk.tournament_rerank.launches`` and the select kernel
``retrieval_topk.select_topk.launches`` by mode.

A CUDA graph capture runs the Python once and launches nothing; each
replay launches what the capture enqueued. So the graphs
(``train/graph.py``, ``serve/graph.py``) take a ``snapshot`` before a
capture, keep what the capture counted (``since``), ``restore`` the
snapshot, and ``add`` the captured launches at each replay: the counters
then read as the eager calls would have left them.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, NamedTuple

from carca_tpu_torch.ops.flash_attention import attention_bwd, fused_attention
from carca_tpu_torch.ops.retrieval_topk import (catalog_topk, groupmax, select_topk,
                                                tournament_rerank)


class Launches(NamedTuple):
    """The six counters' values (K1 and K2 also by shape, the select kernel
    by mode). A shorter tuple given to ``restore``, ``add`` or ``since``
    counts 0 for the rest."""

    attention_fwd: int = 0
    attention_fwd_by_shape: Counter = Counter()
    attention_bwd: int = 0
    attention_bwd_by_shape: Counter = Counter()
    catalog_topk: Dict[str, int] = {}
    groupmax: Dict[int, int] = {}
    tournament_rerank: int = 0
    select_topk: Dict[str, int] = {"positions": 0, "values": 0}


def snapshot() -> Launches:
    """The counters now, as copies."""
    return Launches(fused_attention.launches, Counter(fused_attention.launches_by_shape),
                    attention_bwd.launches, Counter(attention_bwd.launches_by_shape),
                    dict(catalog_topk.launches), dict(groupmax.launches),
                    tournament_rerank.launches, dict(select_topk.launches))


def _refill(counts: dict, values: dict) -> None:
    """``counts`` set to ``values`` in place, keeping its keys (0 if absent)."""
    keep = {key: 0 for key in counts} if not isinstance(counts, Counter) else {}
    counts.clear()
    counts.update({**keep, **values})


def restore(saved) -> None:
    """Every counter set to ``saved``'s value."""
    s = Launches(*saved)
    fused_attention.launches = s.attention_fwd
    _refill(fused_attention.launches_by_shape, s.attention_fwd_by_shape)
    attention_bwd.launches = s.attention_bwd
    _refill(attention_bwd.launches_by_shape, s.attention_bwd_by_shape)
    _refill(catalog_topk.launches, s.catalog_topk)
    _refill(groupmax.launches, s.groupmax)
    tournament_rerank.launches = s.tournament_rerank
    _refill(select_topk.launches, s.select_topk)


def reset() -> None:
    """Every counter to 0, just before a path whose launches are read."""
    restore(Launches())


def _minus(a: dict, b: dict) -> dict:
    return {key: n - b.get(key, 0) for key, n in a.items() if n - b.get(key, 0)}


def since(before, after=None) -> Launches:
    """The launches counted from ``before`` to ``after`` (default: now)."""
    a, b = Launches(*(snapshot() if after is None else after)), Launches(*before)
    return Launches(a.attention_fwd - b.attention_fwd,
                    Counter(_minus(a.attention_fwd_by_shape, b.attention_fwd_by_shape)),
                    a.attention_bwd - b.attention_bwd,
                    Counter(_minus(a.attention_bwd_by_shape, b.attention_bwd_by_shape)),
                    _minus(a.catalog_topk, b.catalog_topk), _minus(a.groupmax, b.groupmax),
                    a.tournament_rerank - b.tournament_rerank,
                    {mode: n - b.select_topk.get(mode, 0) for mode, n in a.select_topk.items()})


def add(delta) -> None:
    """Every counter advanced by ``delta``'s value."""
    d = Launches(*delta)
    fused_attention.launches += d.attention_fwd
    fused_attention.launches_by_shape.update(d.attention_fwd_by_shape)
    attention_bwd.launches += d.attention_bwd
    attention_bwd.launches_by_shape.update(d.attention_bwd_by_shape)
    for counts, more in ((catalog_topk.launches, d.catalog_topk), (groupmax.launches, d.groupmax),
                         (select_topk.launches, d.select_topk)):
        for key, n in more.items():
            counts[key] = counts.get(key, 0) + n
    tournament_rerank.launches += d.tournament_rerank


def report(by_shape: bool = False, counts=None) -> dict:
    """The counters (or ``counts``, a ``Launches``) as one flat dict
    (``catalog_topk_<kind>``, ``groupmax_layout<n>``,
    ``select_topk_<mode>``); ``by_shape`` adds
    K1's and K2's by "Lq x Lk causal c"."""
    c = snapshot() if counts is None else Launches(*counts)
    out = {"attention_fwd": c.attention_fwd, "attention_bwd": c.attention_bwd,
           **{f"catalog_topk_{kind}": n for kind, n in c.catalog_topk.items()},
           **{f"groupmax_layout{lay}": n for lay, n in c.groupmax.items()},
           "tournament_rerank": c.tournament_rerank,
           **{f"select_topk_{mode}": n for mode, n in c.select_topk.items()}}
    if by_shape:
        for name, shapes in (("attention_fwd", c.attention_fwd_by_shape),
                             ("attention_bwd", c.attention_bwd_by_shape)):
            out[f"{name}_by_shape"] = {f"{lq}x{lk} causal {causal}": n
                                       for (lq, lk, causal), n in shapes.items()}
    return out
