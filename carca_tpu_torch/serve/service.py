"""JSON-lines request loop and latency bench (counterpart of
``carca_tpu/serve/service.py``), as functions over a ``Recommender`` and a
host-side CSR copy of the catalog.

Request:  {"history": [item_id, ...], "k": 10, "ctx": [[...], ...],
           "request_ctx": [...], "id": any}
      or  {"user": <row>, ...}        (history looked up in the catalog)
Response: {"items": [...], "scores": [...], "id": any}
A malformed request answers {"error": "..."} and the loop goes on.

The ``carca-serve`` command line (``--run_dir``) comes with the checkpoint
slice: this package cannot read orbax checkpoints yet.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterable, Iterator, List

import numpy as np
import torch


class HostCSR:
    """Host copies of the catalog's CSR arrays, so a history lookup never
    touches the device."""

    def __init__(self, cat):
        self.items = np.asarray(cat.items)
        self.ctx_vals = np.asarray(cat.ctx_vals)
        self.offsets = np.asarray(cat.offsets)
        self.n_users = cat.n_users


def history(host: HostCSR, user: int):
    """(item ids, per-event ctx rows) of one catalog user."""
    # numpy would wrap a negative user to another user's range
    if not 0 <= user < host.n_users:
        raise ValueError(f"user {user} out of range [0, {host.n_users})")
    lo, hi = int(host.offsets[user]), int(host.offsets[user + 1])
    return host.items[lo:hi].tolist(), host.ctx_vals[lo:hi]


def answer(rec, host: HostCSR, line: str, *, k: int = 10, max_k: int = 100) -> Dict:
    """One request line → one response object (never raises on a bad
    request: the error goes into the response)."""
    req = None
    try:
        req = json.loads(line)
        if "history" in req:
            hist, ctx = req["history"], req.get("ctx")
        else:
            hist, ctx = history(host, int(req["user"]))
        kk = max(1, min(int(req.get("k", k)), max_k))
        ids, scores = rec.recommend(
            [hist], k=kk, ctxs=[ctx] if ctx is not None else None,
            request_ctx=(np.asarray(req["request_ctx"], np.float32)
                         if "request_ctx" in req else None))
        # -inf (exhausted) slots are not valid JSON: drop them
        keep = np.isfinite(scores[0])
        out = {"items": ids[0][keep].tolist(),
               "scores": [round(float(s), 6) for s in scores[0][keep]]}
    except Exception as exc:  # a malformed request must not stop the loop
        out = {"error": f"{type(exc).__name__}: {exc}"}
    if isinstance(req, dict) and "id" in req:
        out["id"] = req["id"]
    return out


def serve_lines(rec, host: HostCSR, lines: Iterable[str], *, k: int = 10,
                max_k: int = 100) -> Iterator[Dict]:
    """Answer each non-blank request line in order."""
    for line in lines:
        line = line.strip()
        if line:
            yield answer(rec, host, line, k=k, max_k=max_k)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(rec, host: HostCSR, k: int, iters: int, seed: int = 0) -> List[Dict]:
    """Steady-state latency of ``recommend`` per batch bucket: p50/p95/p99
    over ``iters`` timed calls after one warm call, and throughput as all
    users served over the whole timed window (so a stall counts). Each call
    already ends in a device-to-host copy of its result; the clock also
    waits for the device before it starts."""
    rng = np.random.default_rng(seed)
    rows = []
    for bb in rec.batch_buckets:
        users = rng.integers(0, host.n_users, size=bb)
        hists, ctxs = zip(*(history(host, int(u)) for u in users))
        rec.recommend(hists, k=k, ctxs=ctxs)
        lat = []
        _sync(rec.device)
        window0 = time.perf_counter()
        for _ in range(iters):
            _sync(rec.device)
            t0 = time.perf_counter()
            rec.recommend(hists, k=k, ctxs=ctxs)
            _sync(rec.device)
            lat.append((time.perf_counter() - t0) * 1e3)
        window = time.perf_counter() - window0
        lat = np.sort(np.asarray(lat))

        def pct(p):
            return float(lat[min(len(lat) - 1, int(p * len(lat)))])

        rows.append({"batch": bb, "k": k, "p50_ms": pct(0.50), "p95_ms": pct(0.95),
                     "p99_ms": pct(0.99),
                     "throughput_users_per_sec": bb * iters / window})
    return rows
