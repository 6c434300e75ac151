"""JSON-lines serving loop and latency bench (counterpart of
``carca_tpu/serve/service.py``): serves a trained run directory.

    python -m carca_tpu_torch.serve.service --run_dir RUN --data_dir DATA \
        --profile_file profiles.txt --attr_file attrs.pkl --ctx_file ctx.pkl
    python -m carca_tpu_torch.serve.service --run_dir RUN ... --bench --iters 30

Requests arrive one JSON object per stdin line, responses leave one per
stdout line:

Request:  {"history": [item_id, ...], "k": 10, "ctx": [[...], ...],
           "request_ctx": [...], "id": any}
      or  {"user": <row>, ...}        (history looked up in the catalog)
Response: {"items": [...], "scores": [...], "id": any}
A malformed request answers {"error": "..."} and the loop goes on.
``--bench`` skips stdin and prints one JSON line of latency per batch
bucket (p50/p95/p99 over ``--iters`` timed calls after a warm one).

The server runs on the card (``--device cpu`` asks for the CPU). Without
``--data_dir`` the run's synthetic catalog is regenerated from its
``args.json``, on the server's device for a device-pipeline run (as the
run generated it). ``--compilation_cache`` is a TPU knob and is ignored.

``--index_shards N`` row-shards the stage-1 index over N ranks of
``torch.distributed`` (a ``model`` axis; each rank embeds and holds one
block), launched by torchrun with N processes:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m carca_tpu_torch.serve.service --run_dir RUN --index_shards N ...

N must be the world size. Rank 0 alone reads stdin and writes stdout;
each request it accepts is broadcast to the other ranks (the padded
history and contexts as tensors, behind a header with a stop flag), and
every rank runs ``recommend`` on it in lockstep (``Lockstep``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from carca_tpu_torch.data.loaders import host_catalog


class HostCSR:
    """Host copies of the catalog's CSR arrays, so a history lookup never
    touches the device."""

    def __init__(self, cat):
        cat = host_catalog(cat)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m carca_tpu_torch.serve.service",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True, help="training output dir (args.json + ckpt/)")
    p.add_argument("--which", choices=("best", "latest"), default="best")
    p.add_argument("--data_dir", default="", help="catalog location (reference file formats); "
                   "default: the synthetic catalog regenerated from the run's data config")
    p.add_argument("--profile_file", default="")
    p.add_argument("--attr_file", default="")
    p.add_argument("--ctx_file", default="")
    p.add_argument("--shortlist", type=int, default=512)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--no_exclude_history", action="store_true",
                   help="allow already-seen items in results")
    p.add_argument("--index", choices=("seen", "full"), default="seen",
                   help="stage-1 index: seen = items with >=1 catalog event; full = every id")
    p.add_argument("--quantize_index", type=str, default="auto",
                   choices=("true", "false", "auto"),
                   help="int8 stage-1 index; auto = indexes of >= 1M rows")
    p.add_argument("--index_shards", type=int, default=1,
                   help="row-shard the stage-1 index over this many ranks (torchrun "
                        "--nproc_per_node N); rank 0 reads stdin and writes stdout")
    p.add_argument("--compilation_cache", type=str, default="", help="TPU only; ignored")
    p.add_argument("--max_k", type=int, default=100, help="cap on per-request k")
    p.add_argument("--warmup", action="store_true", help="run every batch bucket before serving")
    p.add_argument("--bench", action="store_true", help="measure latency instead of serving stdin")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="", help="the torch device; default (empty) the card")
    return p


class Lockstep:
    """A Recommender over a row-sharded index driven from rank 0: rank 0
    calls ``recommend`` (as ``answer`` and ``run_bench`` do), which
    broadcasts the padded request to every rank and runs it on all of
    them; the other ranks sit in ``follow`` until rank 0 calls ``stop``.
    A request that fails its checks fails on rank 0 before any broadcast."""

    def __init__(self, rec):
        self.rec = rec
        self.batch_buckets = rec.batch_buckets
        self.device = rec.device

    @staticmethod
    def _broadcast(*tensors: torch.Tensor) -> None:
        import torch.distributed as dist

        for t in tensors:
            dist.broadcast(t, src=0)

    def recommend(self, histories, *, k: int = 10, ctxs=None, request_ctx=None):
        rec = self.rec
        rec.check_k(k)
        p_x, p_c, rc = rec._inputs(histories, ctxs, request_ctx)
        b = len(histories)
        rc = rc.contiguous()
        self._broadcast(torch.tensor([1, b, p_x.shape[0], k], device=self.device), p_x, p_c, rc)
        return rec.recommend_padded(p_x, p_c, rc, b, int(k))

    def warmup(self, k: int = 10) -> None:
        for bb in self.batch_buckets:
            self.recommend([[1]] * bb, k=k)

    def stop(self) -> None:
        self._broadcast(torch.zeros(4, dtype=torch.int64, device=self.device))

    def follow(self) -> None:
        """The other ranks' loop: receive each request and run it, until
        the stop flag."""
        rec, cfg = self.rec, self.rec.cfg
        while True:
            header = torch.zeros(4, dtype=torch.int64, device=self.device)
            self._broadcast(header)
            go, b, bb, k = header.tolist()
            if not go:
                return
            p_x = torch.zeros((bb, cfg.seq_len), dtype=torch.int32, device=self.device)
            p_c = torch.zeros((bb, cfg.seq_len, cfg.n_ctx), device=self.device)
            rc = torch.zeros((bb, cfg.n_ctx), device=self.device)
            self._broadcast(p_x, p_c, rc)
            rec.recommend_padded(p_x, p_c, rc, b, k)


def load_catalog_for_run(args, cfg, device: str = "cuda"):
    """The catalog to serve: the reference files under ``--data_dir``, or the
    run's synthetic catalog regenerated from its data config: a
    device-pipeline run's on ``device``, with the generator and seed the
    run drew it with (the same catalog on the same kind of card)."""
    if args.data_dir:
        from carca_tpu_torch.data.loaders import load_dataset
        return load_dataset(args.data_dir, args.profile_file, args.attr_file, args.ctx_file)
    from carca_tpu_torch.data.synthetic import synthetic_generator
    d = cfg.data
    gen = synthetic_generator(d.synthetic_process, device=d.device_pipeline, torch_device=device)
    return gen(n_users=d.synthetic_users, n_real_items=d.synthetic_items, seed=d.synthetic_seed)


def main(argv: Optional[list] = None, device: Optional[str] = None, stdin=None,
         stdout=None) -> None:
    """Serve stdin (or ``--bench``) from a run directory on ``device``, else
    ``--device``, else the card."""
    from carca_tpu_torch.serve.recommender import config_from_run_dir, load_recommender

    args = build_parser().parse_args(argv)
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    if args.compilation_cache:
        print("note: --compilation_cache is a TPU knob; ignored", file=sys.stderr)
    device = device or args.device or "cuda"
    mesh = None
    if args.index_shards > 1:
        from carca_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

        device = str(initialize_distributed(device))
        mesh = make_mesh((args.index_shards,), ("model",))  # raises unless the world is N
    cfg = config_from_run_dir(args.run_dir)
    cat = load_catalog_for_run(args, cfg, device)
    host = HostCSR(cat)
    rec = load_recommender(
        args.run_dir, cat.attrs, which=args.which, device=device,
        shortlist=args.shortlist, exclude_history=not args.no_exclude_history,
        index_ids=np.unique(host.items) if args.index == "seen" else None,
        quantize={"true": True, "false": False, "auto": "auto"}[args.quantize_index],
        mesh=mesh)
    if mesh is not None:
        rec = Lockstep(rec)
        if mesh.rank != 0:
            rec.follow()
            return
        try:
            _serve(args, rec, host, stdin, stdout)
        finally:
            rec.stop()
        return
    _serve(args, rec, host, stdin, stdout)


def _serve(args, rec, host: HostCSR, stdin, stdout) -> None:
    """``--bench``, or the stdin loop, over ``rec``."""
    if args.warmup or args.bench:
        rec.warmup(k=args.k)
    if args.bench:
        for row in run_bench(rec, host, args.k, args.iters):
            stdout.write(json.dumps(row) + "\n")
        stdout.flush()
        return
    for out in serve_lines(rec, host, stdin, k=args.k, max_k=args.max_k):
        stdout.write(json.dumps(out) + "\n")
        stdout.flush()


if __name__ == "__main__":
    main()
