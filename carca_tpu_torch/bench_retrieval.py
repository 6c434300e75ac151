"""Full-catalog retrieval throughput of the port on one CUDA card
(counterpart of ``scripts/bench_retrieval.py``).

    python -m carca_tpu_torch.bench_retrieval [--items 1000000] [--batch 256] [--k 10]
    python -m carca_tpu_torch.bench_retrieval --items 10000000 --kernel_only
    python -m carca_tpu_torch.bench_retrieval --sweep   # the stream/tournament crossover

The model is the JAX bench's: d=64, g=256, 2 blocks, 2 heads,
``embedding=all``, ``decoder=dot``, random weights from seed 0, over
``--items`` items whose ``--attrs`` attributes, and the ``--batch``
profiles, are drawn on the card from seeded generators. The catalog is
embedded once; each query batch is then encoded and ranked against the
whole catalog (``full_catalog_topk``). Legs: ``kernel`` (method "auto":
the tournament, K4 and the exact rerank, from the measured crossover on),
``kernel_stream`` (K3), the same two over the int8 index
(``kernel_int8``, ``kernel_int8_stream``), and ``plain`` (the plain
version on the card: a [B, R] score matrix and a sort), which
``--kernel_only`` drops. With ``--kernel_only`` from 4M items the float
index is bf16, as in the JAX bench. Prints one JSON line: the headline
``catalog_candidates_scored_per_sec`` of the fastest exact (non-int8) leg,
queries/s of every leg, and every leg's top-k device time alone.

``--sweep`` embeds 10M items once and times ``catalog_topk`` alone (CUDA
events) with the stream and the tournament, over the first 100k, 1M, 2M, 5M
and 10M rows, B ∈ {1, 8, 64, 256}, k ∈ {10, 60, 562}, f32 and int8 indexes (bf16 at
10M), and the flat against the recursive stage 2 at 10M: one JSON line per
case. It is the measurement behind "auto"'s thresholds and
``_RECURSIVE_MIN_GROUPS`` in ``ops/retrieval_topk.py``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from carca_tpu_torch.config import ModelConfig
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops import retrieval_topk as rt
from carca_tpu_torch.parallel.retrieval import (catalog_in_decoder_space, embed_catalog,
                                                full_catalog_topk, queries)

SWEEP_ROWS = (100_000, 1_000_000, 2_000_000, 5_000_000, 10_000_000)
SWEEP_BATCHES = (1, 8, 64, 256)
SWEEP_KS = (10, 60, 562)


def device_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean device time of one call of ``fn`` (CUDA events), after a warm
    call. A sleep kernel runs first, so the host has queued every timed call
    before the device reaches the start event; the number of calls fills
    about ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(20, max(3, budget_ms / max((time.perf_counter() - t0) * 1e3, 1e-3))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(items: int, attrs: int, batch: int, d: int, seq_len: int):
    """(model, attrs table, profile) on the card: random weights drawn on
    the card from seed 0, attributes and profiles from seeded device
    generators."""
    dev = torch.device("cuda")
    mc = ModelConfig(n_items=items, n_attrs=attrs, n_ctx=4, d=d, g=256, seq_len=seq_len,
                     n_blocks=2, n_heads=2, dropout=0.0, embedding="all", decoder="dot")
    model = CARCA(mc, generator=torch.Generator(device=dev).manual_seed(0), device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn(items, attrs, generator=gen, device=dev)
    p_x = torch.randint(1, items, (batch, seq_len), generator=gen, device=dev)
    p_c = torch.randn(batch, seq_len, 4, generator=gen, device=dev)
    return model, table, (p_x, None, p_c)


def run(args) -> dict:
    model, table, profile = build(args.items, args.attrs, args.batch, args.d, args.seq_len)
    mc = model.cfg
    emb_dtype = (torch.bfloat16 if args.kernel_only and args.items >= 4_000_000
                 else torch.float32)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = catalog_in_decoder_space(embed_catalog(model, table, out_dtype=emb_dtype), mc)
        torch.cuda.synchronize()
        t_embed = time.perf_counter() - t0
        eq = rt.quantize_index(e)
        q = queries(model, profile, table).contiguous()
        legs = [("kernel", "auto", e), ("kernel_stream", "stream", e),
                ("kernel_int8", "auto", eq), ("kernel_int8_stream", "stream", eq)]
        qps, topk_ms = {}, {}
        for name, method, index in legs:
            qps[name] = _queries_per_sec(
                lambda: full_catalog_topk(model, profile, table, args.k, catalog_emb=index,
                                          method=method), args.batch, args.steps)
            topk_ms[name] = device_ms(lambda: rt.catalog_topk(q, index, args.k,
                                                              n_items=mc.n_items, method=method))
        if not args.kernel_only:
            qps["plain"] = _queries_per_sec(
                lambda: rt.catalog_topk_plain(queries(model, profile, table), e, args.k,
                                              n_items=mc.n_items), args.batch, args.steps)
            topk_ms["plain"] = device_ms(lambda: rt.catalog_topk_plain(q, e, args.k,
                                                                       n_items=mc.n_items))
    exact = {n: r for n, r in qps.items() if "int8" not in n}
    headline = max(exact, key=exact.get)
    return {
        "metric": "catalog_candidates_scored_per_sec",
        "value": exact[headline] * args.items, "unit": "candidates/sec/chip",
        "headline_leg": headline,
        **{f"queries_per_sec_{n}": r for n, r in qps.items()},
        **{f"topk_ms_{n}": t for n, t in topk_ms.items()},
        "auto_method": rt.resolve_method("auto", args.items, args.k, args.batch),
        "catalog_items": args.items, "catalog_embed_seconds": t_embed,
        "emb_dtype": str(emb_dtype).removeprefix("torch."), "top_k": args.k,
        "batch": args.batch, "device": torch.cuda.get_device_name(0),
    }


def _queries_per_sec(fn, batch: int, steps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return steps * batch / (time.perf_counter() - t0)


def sweep(args):
    """Yields one dict per (rows, index type, B, k) case, then the flat and
    the recursive stage 2 at the largest row count."""
    rows_max = max(SWEEP_ROWS)
    model, table, _ = build(rows_max, args.attrs, max(SWEEP_BATCHES), args.d, args.seq_len)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.inference_mode():
        e_full = catalog_in_decoder_space(embed_catalog(model, table), model.cfg)
        qs = {}
        for b in SWEEP_BATCHES:
            p_x = torch.randint(1, rows_max, (b, args.seq_len), generator=gen, device="cuda")
            p_c = torch.randn(b, args.seq_len, 4, generator=gen, device="cuda")
            qs[b] = queries(model, (p_x, None, p_c), table).contiguous()
        del table
        for rows in SWEEP_ROWS:
            e = e_full[:rows]
            indexes = {"f32": e, "int8": rt.quantize_index(e)}
            if rows == rows_max:
                indexes["bf16"] = e.to(torch.bfloat16)
            for dtype, index in indexes.items():
                for b in SWEEP_BATCHES:
                    for k in SWEEP_KS:
                        yield _case(qs[b], index, k, rows, dtype, b)
            if rows == rows_max:
                for dtype, index in indexes.items():
                    for b in SWEEP_BATCHES:
                        yield _recursive_case(qs[b], index, max(SWEEP_KS), rows, dtype, b)
            del indexes


def _case(q, index, k, rows, dtype, b) -> dict:
    out = {"rows": rows, "index": dtype, "batch": b, "k": k}
    results = {}
    for method in ("stream", "tournament"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[f"{method}_ms"] = device_ms(lambda: rt.catalog_topk(q, index, k, n_items=rows,
                                                                method=method))
        out[f"{method}_peak_extra_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        results[method] = rt.catalog_topk(q, index, k, n_items=rows, method=method)
    out["same_ids_and_values"] = bool(torch.equal(results["stream"][1], results["tournament"][1])
                                      and torch.equal(results["stream"][0],
                                                      results["tournament"][0]))
    out["faster"] = min(("stream", "tournament"), key=lambda m: out[f"{m}_ms"])
    out["auto"] = rt.resolve_method("auto", rows, k, b)
    return out


def _recursive_case(q, index, k, rows, dtype, b) -> dict:
    out = {"rows": rows, "index": dtype, "batch": b, "k": k, "stage2": "flat vs recursive"}
    old = rt._RECURSIVE_MIN_GROUPS
    res = {}
    try:
        for name, limit in (("flat", old), ("recursive", 1)):
            rt._RECURSIVE_MIN_GROUPS = limit
            out[f"{name}_ms"] = device_ms(lambda: rt.catalog_topk(q, index, k, n_items=rows,
                                                                  method="tournament"))
            res[name] = rt.catalog_topk(q, index, k, n_items=rows, method="tournament")
    finally:
        rt._RECURSIVE_MIN_GROUPS = old
    out["same_ids_and_values"] = bool(torch.equal(res["flat"][1], res["recursive"][1])
                                      and torch.equal(res["flat"][0], res["recursive"][0]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--attrs", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--seq_len", type=int, default=50)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kernel_only", action="store_true",
                    help="skip the plain leg (a [B, items] score matrix and sort)")
    ap.add_argument("--sweep", action="store_true",
                    help="time stream against tournament over rows, B, k and index types")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("carca_tpu_torch.bench_retrieval measures a CUDA card; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.sweep:
        for line in sweep(args):
            print(json.dumps(line), flush=True)
        return
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
