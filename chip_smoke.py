#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and train step on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root, on a machine with a card
    python3 chip_smoke.py --profile   # also phase 7: profiler breakdowns of recommend and the train step

Phases, one or more lines each; any failure raises and exits non-zero:

1. device  — a CUDA card must be present (there is no CPU fallback);
             prints nvidia-smi's name and power limit; TF32 off.
2. build   — compiles kernels K1, K2 and K3 from carca_tpu_torch/csrc/
             (one nvcc per source, all started together).
3. K1      — the attention forward kernel against its plain version on
             CUDA tensors at the serving and training shapes; one raise it
             must give. With weight dropout p = 0.5: the keep share over
             1.28M weights within 0.5 ± 0.002, the same seed giving the same
             bits and another seed other bits, the card's Philox bits equal
             to the numpy generator's, and K1's output equal to the plain
             version fed the kernel's own keep mask.
3b. K2     — the attention backward kernel (under autograd, after K1)
             against autograd over the plain version, with dropout off and
             on, at the encoder [256,50,64] causal 0, decoder
             [512,50,64]x[512,50,64] causal -1 and men [256,200,64] causal 0
             shapes: per-tensor relative error, exact zeros for fully
             masked rows, two runs bit-equal; fwd+bwd and bwd-only times
             against the plain version's.
4. K3      — the top-k kernel against its plain version (ids equal); and
             one raise it must give.
5. slice   — the beauty preset at full width (d=64, g=256, 2 blocks, 2
             heads, L=50, ca decoder) with random weights from seed 0,
             serving synthetic_catalog(4096 users, 99,999 items): JSON-lines
             requests and one recommend per batch bucket, over the seen
             index and the full index. Both kernels' launch counts must
             rise during this phase. The same requests then go through
             the same weights on the CPU plain path, and must agree.
6. timing  — recommend p50/p95 and throughput per bucket, and each kernel
             beside its plain version at the slice shapes (CUDA events).
7. profile — only with --profile: per bucket, a torch.profiler trace of
             recommend (device busy time and share, device operations per
             call, the heaviest of them), and the host cost of one K1 launch;
             after phase 8, the same for one call of the train step (K = 8
             steps) with the kernels and with the plain path.
8. train   — the flagship setup of carca_tpu_torch/bench.py (bench.py's
             build_setup: d=64, g=256, 2 blocks, 2 heads, L=50, batch 256,
             K=8 steps per call, catalog and batch assembly on the card).
             One step with dropout 0 against the CPU plain path from the
             same parameters and batch (loss within 1e-5 relative, every
             parameter's gradient within 1e-3 relative norm, and within
             1e-4 of the card's own plain path); then 64
             steps at dropout 0.5, in which K1 and K2 must both launch, the
             losses stay finite and the mean of the last 8 falls below the
             mean of the first 8; then train_examples_per_sec_flagship with
             the kernels and with the plain path, and peak device memory.

The serving slice (phase 5) and the train step (phase 8) are the two main
paths: each runs with the launch counters set to 0 just before it and read
just after. The line before the last is a JSON object listing the kernels;
the last line is {"ok": true, "device": {...}}.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from carca_tpu_torch import bench
from carca_tpu_torch.config import preset
from carca_tpu_torch.data.device_pipeline import assemble_train
from carca_tpu_torch.data.synthetic import synthetic_catalog
from carca_tpu_torch.models.attention import masked_attention
from carca_tpu_torch.models.carca import CARCA
from carca_tpu_torch.ops import _build
from carca_tpu_torch.ops.flash_attention import (SEED_LIMIT, attention_bwd,
                                                 attention_grads_plain,
                                                 attention_keep_mask, fused_attention,
                                                 philox_bits)
from carca_tpu_torch.ops.retrieval_topk import catalog_topk, catalog_topk_plain
from carca_tpu_torch.serve.recommender import Recommender
from carca_tpu_torch.serve.service import HostCSR, history, run_bench, serve_lines
from carca_tpu_torch.train.loop import train_loss

SEED = 0
N_USERS, N_REAL_ITEMS = 4096, 99_999
SHORTLIST, K = 512, 10
BUCKETS = (1, 8, 64, 256)
B, L, D, H = 256, 50, 64, 2
KK = SHORTLIST + L  # stage 1 retrieves the shortlist plus the exclusion slack
DEVICE = torch.device("cuda")
K1_TOL, K1_TOL_BF16 = 1e-5, 2e-2
K2_TOL, K2_TOL_BF16 = 1e-5, 2e-2  # relative norm per gradient tensor
P_DROP = 0.5
KEEP_SHARE_TOL = 0.002
K3_TOL = 1e-5
SLICE_TIE_TOL, SLICE_SCORE_TOL = 1e-5, 1e-4
# GPU kernels vs CPU plain, relative. Gradients: 1e-3 per tensor, because
# two float32 paths cannot agree closer on this batch: on the CPU, the plain
# path in f32 differs from the same path with a float64 attention by up to
# 2.8e-4 (blocks.0.attn.wq.w; one user's window repeats an item and makes
# the softmax backward cancel), against ~2e-7 on other batches. A gradient's
# norm is floored at 1e-3 of the whole gradient's: exact arithmetic gives
# the key projections' bias a zero gradient (softmax ignores a per-row
# shift), so both sides hold rounding noise there.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, GRAD_NORM_FLOOR = 1e-5, 1e-3, 1e-3
# the kernels against the card's own plain path (cuBLAS on both sides):
# 1e-4 holds there (measured 2.4e-7)
TRAIN_GRAD_TOL_SAME_DEVICE = 1e-4
TRAIN_CALLS = 8  # 8 calls x K=8 = the first 64 steps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls (CUDA events), after two warm calls. A sleep kernel (~50 ms) runs
    first, so the host has queued every call before the device reaches the
    start event: the events then time the device, not the host's launch
    rate (a single call's host cost is ~45 µs, near a small kernel's
    device time)."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(kernel, plain, reps: int = 20):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it drives the GPU port and has no "
              "CPU mode", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)  # name and power limit, as nvidia-smi gives them
    # IEEE fp32 in every plain path, so kernel-vs-plain is like for like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        allow_tf32=False)
    return card


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------

def phase_build() -> None:
    res = _build.build()
    _build.library()  # loads, and declares every C signature
    usage = [ln.strip() for ln in res.log.splitlines()
             if "Compiling entry" in ln or "Used" in ln]
    log("build", seconds=res.seconds, library=str(res.path), ptxas=usage)


# --------------------------------------------------------------------------
# phase 3: K1 against its plain version
# --------------------------------------------------------------------------

def padded_masks(gen, b, lq, lk, dev):
    """Profile-like masks: each row keeps its last n positions."""
    n = torch.randint(0, lk + 1, (b,), generator=gen)
    km = (torch.arange(lk)[None, :] >= (lk - n)[:, None]).float()
    if lq == lk:
        qm = km.clone()
    else:
        qm = (torch.rand(b, lq, generator=gen) > 0.05).float()
    km[0] = 0.0  # a batch row with every key masked
    return qm.to(dev), km.to(dev)


def k1_inputs(lq, lk, seed, b=B):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, D, generator=gen).to(DEVICE) for n in (lq, lk, lk))
    qm, km = padded_masks(gen, b, lq, lk, DEVICE)
    return q, k, v, qm, km


K1_CASES = [  # (name, Lq, Lk, causal, compute dtype)
    ("encoder [256,50,64] causal 0", L, L, 0, "float32"),
    ("rerank q [256,512,64] kv [256,50,64]", SHORTLIST, L, None, "float32"),
    ("train-time decoder [256,50,64] causal -1", L, L, -1, "float32"),
    ("encoder [256,50,64] causal 0 bf16", L, L, 0, "bfloat16"),
]


def phase_k1() -> float:
    worst = 0.0
    for i, (name, lq, lk, causal, cd) in enumerate(K1_CASES):
        q, k, v, qm, km = k1_inputs(lq, lk, 10 + i)
        kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H, compute_dtype=cd)
        with torch.no_grad():
            got = fused_attention(q, k, v, qm, km, **kw)
            want = masked_attention(q, k, v, qm, km, **kw)
        torch.cuda.synchronize()
        tol = K1_TOL if cd == "float32" else K1_TOL_BF16
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        check(torch.count_nonzero(got[0]).item() == 0, f"K1 {name}: masked row not 0")
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite output")
        err = (got - want).abs().max().item()
        if cd == "float32":
            worst = max(worst, err)
        log("K1", case=name, dtype=cd, max_abs_err=err, tol=tol)
    try:
        fused_attention(q.transpose(0, 1), k, v, qm, km, causal=0, scale=1.0, n_heads=H)
    except ValueError as exc:
        log("K1", case="a non-contiguous q raises", raised=str(exc)[:80])
    else:
        raise RuntimeError("K1 accepted a non-contiguous q, which it does not take")
    return max(worst, phase_k1_dropout())


def phase_k1_dropout() -> float:
    """K1's Philox weight dropout: the bits' statistics and determinism, the
    card's bits against the numpy generator's, and K1's output against the
    plain version fed the kernel's own keep mask."""
    shape = (B, H, L, L)  # 1,280,000 weights
    m1 = attention_keep_mask(1234, shape, P_DROP, DEVICE)
    m1b = attention_keep_mask(1234, shape, P_DROP, DEVICE)
    m2 = attention_keep_mask(1235, shape, P_DROP, DEVICE)
    share = m1.float().mean().item()
    check(abs(share - (1 - P_DROP)) <= KEEP_SHARE_TOL,
          f"K1 keep share {share} outside {1 - P_DROP} +- {KEEP_SHARE_TOL}")
    check(torch.equal(m1, m1b), "K1: the same seed gave other bits")
    differ = (m1 != m2).float().mean().item()
    check(0.45 < differ < 0.55, f"K1: another seed changed {differ} of the bits")
    host = philox_bits(1234, np.arange(m1.numel(), dtype=np.uint64)) < np.uint32(2**31)
    check(np.array_equal(m1.cpu().numpy().ravel(), host),
          "K1: the card's Philox bits differ from the numpy generator's")
    log("K1", case="keep mask", weights=m1.numel(), keep_share=share,
        other_seed_changed=differ, numpy_bits_equal=True)
    worst = 0.0
    for i, (name, lq, lk, causal, cd) in enumerate(K1_CASES):
        q, k, v, qm, km = k1_inputs(lq, lk, 50 + i)
        kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H, compute_dtype=cd)
        with torch.no_grad():
            got = fused_attention(q, k, v, qm, km, dropout_rate=P_DROP,
                                  seed_generator=torch.Generator().manual_seed(i), **kw)
            seed = int(torch.randint(SEED_LIMIT, (), generator=torch.Generator().manual_seed(i)))
            keep = attention_keep_mask(seed, (q.shape[0], H, lq, lk), P_DROP, DEVICE)
            want = masked_attention(q, k, v, qm, km, dropout_rate=P_DROP, keep_mask=keep, **kw)
        torch.cuda.synchronize()
        tol = K1_TOL if cd == "float32" else K1_TOL_BF16
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        check(torch.count_nonzero(got[0]).item() == 0, f"K1 dropout {name}: masked row not 0")
        err = (got - want).abs().max().item()
        if cd == "float32":
            worst = max(worst, err)
        log("K1", case=f"{name} dropout {P_DROP}", dtype=cd, max_abs_err=err, tol=tol)
    return worst


# --------------------------------------------------------------------------
# phase 3b: K2 against autograd over the plain version
# --------------------------------------------------------------------------

K2_CASES = [  # (name, B, Lq, Lk, causal, compute dtype)
    ("encoder [256,50,64] causal 0", B, L, L, 0, "float32"),
    ("decoder [512,50,64]x[512,50,64] causal -1", 2 * B, L, L, -1, "float32"),
    ("men [256,200,64] causal 0", B, 200, 200, 0, "float32"),
    ("encoder [256,50,64] causal 0 bf16", B, L, L, 0, "bfloat16"),
]


def rel_err(got, want, floor: float = 1e-30) -> float:
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


def kernel_grads(inputs, g, seed, **kw):
    """(out, dq, dk, dv) through fused_attention: K1 forward, K2 backward."""
    q, k, v, qm, km = inputs
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = fused_attention(qq, kk, vv, qm, km, seed_generator=torch.Generator().manual_seed(seed),
                          **kw)
    return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), g))


def phase_k2(card) -> tuple:
    """Returns (worst f32 abs error, {case: timings})."""
    worst, timings = 0.0, {}
    for i, (name, b, lq, lk, causal, cd) in enumerate(K2_CASES):
        inputs = k1_inputs(lq, lk, 60 + i, b=b)
        q, k, v, qm, km = inputs
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(70 + i)).to(DEVICE)
        tol = K2_TOL if cd == "float32" else K2_TOL_BF16
        for rate in (0.0, P_DROP):
            kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H, compute_dtype=cd,
                      dropout_rate=rate)
            before = attention_bwd.launches
            _, *got = kernel_grads(inputs, g, i, **kw)
            _, *again = kernel_grads(inputs, g, i, **kw)
            torch.cuda.synchronize()
            check(attention_bwd.launches == before + 2, f"K2 {name}: the kernel did not launch")
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"K2 {name} p={rate}: two runs differ")
            keep = None
            if rate > 0:
                seed = int(torch.randint(SEED_LIMIT, (),
                                         generator=torch.Generator().manual_seed(i)))
                keep = attention_keep_mask(seed, (b, H, lq, lk), rate, DEVICE)
            want = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
            errs = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
            for n, e in errs.items():
                check(e <= tol, f"K2 {name} p={rate}: {n} relative error {e} > {tol}")
            dq, dk, dv = got
            dead_rows = (qm == 0) | (km.sum(1, keepdim=True) == 0)
            check(torch.count_nonzero(dq[dead_rows]).item() == 0,
                  f"K2 {name}: a fully masked query row has a nonzero gradient")
            check(torch.count_nonzero(dk[0]).item() == 0 and torch.count_nonzero(dv[0]).item() == 0,
                  f"K2 {name}: a batch row with every key masked has nonzero dk/dv")
            abs_err = max((a - w).abs().max().item() for a, w in zip(got, want))
            if cd == "float32":
                worst = max(worst, abs_err)
            log("K2", case=name, dropout=rate, dtype=cd, rel_err=errs, max_abs_err=abs_err,
                tol=tol, bit_equal_runs=True)
        timings[name] = time_k2(card, name, inputs, g, i, causal=causal, scale=(D / H) ** 0.5,
                                n_heads=H, compute_dtype=cd, dropout_rate=P_DROP)
    return worst, timings


def time_k2(card, name, inputs, g, seed, **kw):
    """fwd+bwd and bwd-only device times, kernels against the plain version
    (whose dropout draws from a device generator, as the plain path does)."""
    q, k, v, qm, km = inputs
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    plain_kw = dict(kw, train=True, generator=gen)

    def kernel_both():
        kernel_grads(inputs, g, seed, **kw)

    def plain_both():
        out = masked_attention(qq, kk, vv, qm, km, **plain_kw)
        torch.autograd.grad(out, (qq, kk, vv), g)

    s = int(torch.randint(SEED_LIMIT, (), generator=torch.Generator().manual_seed(seed)))
    plain_out = masked_attention(qq, kk, vv, qm, km, **plain_kw)
    both, both_plain = kernel_vs_plain(kernel_both, plain_both, reps=10)
    bwd, bwd_plain = kernel_vs_plain(
        lambda: attention_bwd(q, k, v, qm, km, g, seed=s, **kw),
        lambda: torch.autograd.grad(plain_out, (qq, kk, vv), g, retain_graph=True), reps=10)
    log("timing", card=card, kernel="K1+K2 fwd+bwd", shape=name, dropout=kw["dropout_rate"],
        ms=both, plain_ms=both_plain)
    log("timing", card=card, kernel="K2 attention_bwd", shape=name, dropout=kw["dropout_rate"],
        ms=bwd, plain_ms=bwd_plain)
    return {"fwd_bwd": (both, both_plain), "bwd": (bwd, bwd_plain)}


# --------------------------------------------------------------------------
# phase 4: K3 against its plain version
# --------------------------------------------------------------------------

def k3_case(name, q, e, k, **kw):
    with torch.no_grad():
        v, i = catalog_topk(q, e, k, **kw)
        pv, pi = catalog_topk_plain(q, e, k, **kw)
    torch.cuda.synchronize()
    check(torch.equal(i, pi), f"K3 {name}: ids differ from the plain version "
                              f"({int((i != pi).sum())} slots)")
    torch.testing.assert_close(v, pv, rtol=K3_TOL, atol=K3_TOL)
    fin = torch.isfinite(pv)
    err = (v[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
    log("K3", case=name, max_abs_err=err, tol=K3_TOL, neg_inf_slots=int((~fin).sum()))
    return err, v, i


def phase_k3() -> float:
    gen = torch.Generator().manual_seed(20)
    q = torch.randn(B, D, generator=gen).to(DEVICE)
    full = torch.randn(N_REAL_ITEMS + 1, D, generator=gen).to(DEVICE)
    seen = full[:19_156].contiguous()
    worst = 0.0
    for rows_name, e in (("100,000 rows", full), ("19,156 rows", seen)):
        for k in (KK, K):
            worst = max(worst, k3_case(f"{rows_name} k={k}", q, e, k)[0])
    dup = seen.clone()
    dup[1000:1400] = dup[7]  # 400 exact ties with row 7
    dup[5000:5100] = dup[12]
    worst = max(worst, k3_case("duplicated rows k=562", q, dup, KK)[0])
    worst = max(worst, k3_case("id_offset=1000, n_items limit k=562", q, seen, KK,
                               id_offset=1000, n_items=1000 + 15_000)[0])
    _, v, i = k3_case("k beyond the 399 valid rows", q, seen[:400].contiguous(), KK)
    check(bool((i[:, 399:] == 0).all()) and bool(torch.isneginf(v[:, 399:]).all()),
          "K3: slots past the valid rows must be -inf with id 0")
    qz = q.clone()
    qz[:8] = 0.0  # batch padding embeds to zero
    _, v, i = k3_case("zero queries k=562", qz, seen, KK)
    check(torch.equal(i[:8].cpu(), torch.arange(1, KK + 1).expand(8, KK)),
          "K3: a zero query must return the lowest ids in order")
    try:
        catalog_topk(q, seen, K, method="tournament")
    except NotImplementedError as exc:
        log("K3", case="method='tournament' raises", raised=str(exc)[:80])
    else:
        raise RuntimeError("K3 accepted the tournament method, which has no kernel")
    return worst


# --------------------------------------------------------------------------
# phase 5: the serving slice
# --------------------------------------------------------------------------

def request_lines(cat, host):
    hist0, _ = history(host, 0)
    hist3, ctx3 = history(host, 3)
    rng = np.random.default_rng(SEED)
    return [
        json.dumps({"history": hist0, "id": "history"}),
        json.dumps({"user": 5, "id": "user"}),
        json.dumps({"user": 17, "k": 25, "id": "k-override"}),
        json.dumps({"history": hist3, "ctx": ctx3.tolist(), "id": "ctx"}),
        json.dumps({"history": hist3, "request_ctx": rng.standard_normal(cat.n_ctx).tolist(),
                    "id": "request_ctx"}),
        json.dumps({"history": list(range(1, 90)), "id": "long-history"}),
        "{not json",
        json.dumps({"user": N_USERS - 1, "k": 3, "id": "last-user"}),
    ]


def bucket_requests(host, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for bb in BUCKETS:
        users = rng.integers(0, host.n_users, size=bb)
        hists, ctxs = zip(*(history(host, int(u)) for u in users))
        out[bb] = (list(hists), list(ctxs))
    return out


def check_response(resp, want_k, index_set, hist):
    check("error" not in resp, f"request {resp.get('id')} failed: {resp}")
    items, scores = resp["items"], resp["scores"]
    check(len(items) == want_k, f"request {resp.get('id')}: {len(items)} items, want {want_k}")
    check(all(np.isfinite(scores)), "non-finite score in a response")
    check(all(scores[a] >= scores[a + 1] for a in range(len(scores) - 1)),
          "scores out of order")
    check(set(items) <= index_set, "an item outside the index was recommended")
    check(not set(items) & set(hist[-L:]), "a visible-history item was recommended")


def compare(tag, ids_g, sc_g, ids_c, sc_c) -> int:
    """GPU vs CPU plain results: ids equal, except near-ties whose two
    scores lie within SLICE_TIE_TOL; scores within SLICE_SCORE_TOL."""
    ids_g, ids_c = np.asarray(ids_g), np.asarray(ids_c)
    sc_g, sc_c = np.asarray(sc_g, np.float64), np.asarray(sc_c, np.float64)
    check(ids_g.shape == ids_c.shape, f"{tag}: shapes {ids_g.shape} vs {ids_c.shape}")
    np.testing.assert_allclose(sc_g, sc_c, rtol=SLICE_SCORE_TOL, atol=SLICE_SCORE_TOL,
                               err_msg=tag)
    diff = ids_g != ids_c
    if diff.any():
        gap = np.abs(sc_g[diff] - sc_c[diff]).max()
        check(gap <= SLICE_TIE_TOL, f"{tag}: {int(diff.sum())} ids differ and are "
                                    f"not near-ties (score gap {gap})")
    return int(diff.sum())


def phase_slice():
    t0 = time.perf_counter()
    cat = synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL_ITEMS, seed=SEED)
    host = HostCSR(cat)
    cfg = preset("beauty", n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx)
    model = CARCA(cfg, generator=torch.Generator().manual_seed(SEED), device=DEVICE)
    seen_ids = np.unique(cat.items)
    rec = Recommender(model, cat.attrs, shortlist=SHORTLIST, batch_buckets=BUCKETS,
                      index_ids=seen_ids)
    rec_full = Recommender(model, cat.attrs, shortlist=SHORTLIST, batch_buckets=BUCKETS)
    check(rec.catalog_emb.shape == (len(seen_ids) + 1, cfg.d), "seen index shape")
    check(rec_full.catalog_emb.shape == (cat.n_items, cfg.d), "full index shape")
    rec.warmup(k=K)
    rec_full.warmup(k=K)
    torch.cuda.synchronize()
    log("slice", setup_s=time.perf_counter() - t0, n_items=cat.n_items,
        n_events=int(len(cat.items)), seen_index_rows=int(rec.catalog_emb.shape[0]),
        full_index_rows=int(rec_full.catalog_emb.shape[0]),
        params=sum(p.numel() for p in model.parameters()),
        config=dict(d=cfg.d, g=cfg.g, n_blocks=cfg.n_blocks, n_heads=cfg.n_heads,
                    seq_len=cfg.seq_len, embedding=cfg.embedding,
                    encoding=cfg.encoding, decoder=cfg.decoder))

    lines = request_lines(cat, host)
    reqs = bucket_requests(host, SEED + 1)
    fused_attention.launches = 0
    catalog_topk.launches = 0
    responses = list(serve_lines(rec, host, lines, k=K))
    got = {}
    for name, r in (("seen", rec), ("full", rec_full)):
        for bb, (hists, ctxs) in reqs.items():
            got[name, bb] = r.recommend(hists, k=K, ctxs=ctxs)
    torch.cuda.synchronize()
    launches = {"attention_fwd": fused_attention.launches,
                "catalog_topk": catalog_topk.launches}
    log("slice", launches=launches)
    check(launches["attention_fwd"] > 0, "the slice never launched K1")
    check(launches["catalog_topk"] > 0, "the slice never launched K3")

    index_set = set(seen_ids.tolist())
    want_k = [K, K, 25, K, K, K, None, 3]
    hists = [history(host, 0)[0], history(host, 5)[0], history(host, 17)[0],
             history(host, 3)[0], history(host, 3)[0], list(range(1, 90)), None,
             history(host, N_USERS - 1)[0]]
    for resp, wk, hist in zip(responses, want_k, hists):
        if wk is None:
            check("error" in resp, "the malformed line must answer an error")
            continue
        check_response(resp, wk, index_set, hist)
    for (name, bb), (ids, sc) in got.items():
        check(ids.shape == (bb, K) and bool(np.isfinite(sc).all()),
              f"{name} bucket {bb}: shape {ids.shape} or non-finite scores")
    log("slice", responses=len(responses), errors=sum("error" in r for r in responses),
        example=responses[0])

    # the same requests, the same weights, the CPU plain path
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    rec_cpu = Recommender(cpu_model, cat.attrs, shortlist=SHORTLIST,
                          batch_buckets=BUCKETS, index_ids=seen_ids)
    rec_cpu_full = Recommender(cpu_model, cat.attrs, shortlist=SHORTLIST,
                               batch_buckets=BUCKETS)
    near_ties = 0
    for resp, cpu_resp in zip(responses, serve_lines(rec_cpu, host, lines, k=K)):
        if "error" in resp:
            check("error" in cpu_resp, "CPU path answered a malformed line")
            continue
        near_ties += compare(f"request {resp['id']}", resp["items"], resp["scores"],
                             cpu_resp["items"], cpu_resp["scores"])
    for (name, bb), (ids, sc) in got.items():
        if name == "full" and bb > 8:
            continue  # the plain full-catalog sort is slow on the host; 1 and 8 cover it
        r = rec_cpu if name == "seen" else rec_cpu_full
        cids, csc = r.recommend(reqs[bb][0], k=K, ctxs=reqs[bb][1])
        near_ties += compare(f"{name} bucket {bb}", ids, sc, cids, csc)
    log("slice", cpu_agreement="ok", near_tie_slots=near_ties,
        cpu_seconds=time.perf_counter() - t0)
    return rec, rec_full, host, launches


# --------------------------------------------------------------------------
# phase 6: timing
# --------------------------------------------------------------------------

def phase_timing(card, rec, rec_full, host):
    for name, r in (("seen", rec), ("full", rec_full)):
        for row in run_bench(r, host, k=K, iters=30):
            log("timing", card=card, index=name, **row)
    timings = {}
    with torch.no_grad():
        for name, lq, causal in (("encoder", L, 0), ("rerank", SHORTLIST, None)):
            q, k, v, qm, km = k1_inputs(lq, L, 30)
            kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H)
            ms, plain = kernel_vs_plain(lambda: fused_attention(q, k, v, qm, km, **kw),
                                        lambda: masked_attention(q, k, v, qm, km, **kw))
            timings["K1", name] = (ms, plain)
            log("timing", card=card, kernel="K1 attention_fwd", shape=name,
                ms=ms, plain_ms=plain)
        # the train step's encoder call, with weight dropout: the plain
        # version draws its mask from a device generator, as the plain path does
        q, k, v, qm, km = k1_inputs(L, L, 32)
        kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=P_DROP)
        seeds = torch.Generator().manual_seed(0)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        ms, plain = kernel_vs_plain(
            lambda: fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw),
            lambda: masked_attention(q, k, v, qm, km, train=True, generator=gen, **kw))
        timings["K1", "train"] = (ms, plain)
        log("timing", card=card, kernel="K1 attention_fwd", shape="encoder [256,50,64] "
            f"causal 0 dropout {P_DROP}", ms=ms, plain_ms=plain)
        for name, e in (("seen", rec.catalog_emb), ("full", rec_full.catalog_emb)):
            q = torch.randn(B, D, generator=torch.Generator().manual_seed(31)).to(DEVICE)
            ms, plain = kernel_vs_plain(lambda: catalog_topk(q, e, KK),
                                        lambda: catalog_topk_plain(q, e, KK))
            timings["K3", name] = (ms, plain)
            log("timing", card=card, kernel="K3 catalog_topk", shape=f"[{B},{D}] x "
                f"{e.shape[0]} rows k={KK}", ms=ms, plain_ms=plain)
    log("timing", card=card, peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
    return timings


# --------------------------------------------------------------------------
# phase 8: the train step
# --------------------------------------------------------------------------

def grads_of(model, batch, attrs, state):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = train_loss(model, batch, attrs, generator=state.generator,
                      seed_generator=state.seed_generator)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def phase_train(card, profile_run=False):
    """Returns ({kernel: launches} of the 64-step run, {use_kernel: rates})."""
    t0 = time.perf_counter()
    det = bench.build_setup("flagship", 256, DEVICE, dropout=0.0)
    det_plain = bench.build_setup("flagship", 256, DEVICE, dropout=0.0, use_kernel=False)
    check(all(torch.equal(a, b) for a, b in zip(det.state.model.parameters(),
                                                det_plain.state.model.parameters())),
          "the two setups' seeded weights differ")
    rows = det.chunks[0][0]
    batch = assemble_train(det.dd.arrays, det.mc.seq_len, det.mc.n_items, rows,
                           det.state.generator)
    before = (fused_attention.launches, attention_bwd.launches)
    loss_g, grads_g = grads_of(det.state.model, batch, det.attrs, det.state)
    torch.cuda.synchronize()
    check(fused_attention.launches > before[0] and attention_bwd.launches > before[1],
          "the dropout-0 train step did not run K1 and K2")
    loss_p, grads_p = grads_of(det_plain.state.model, batch, det.attrs, det.state)
    cpu_model = copy.deepcopy(det.state.model).cpu()
    cpu_batch = {n: t.cpu() for n, t in batch.items()}
    loss_c, grads_c = grads_of(cpu_model, cpu_batch, det.attrs.cpu(), det.state)
    loss_rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    check(loss_rel <= TRAIN_LOSS_TOL, f"train loss GPU {loss_g.item()} vs CPU {loss_c.item()}")
    floor = (GRAD_NORM_FLOOR
             * torch.sqrt(sum((g.double() ** 2).sum() for g in grads_c.values()))).item()

    def worst_of(grads, ref):
        errs = {n: rel_err(grads[n].cpu(), g.cpu(), floor) for n, g in ref.items()}
        name = max(errs, key=errs.get)
        return name, errs[name]

    worst, err = worst_of(grads_g, grads_c)
    check(err <= TRAIN_GRAD_TOL, f"train gradient {worst}: relative error {err} > {TRAIN_GRAD_TOL}")
    same_dev = worst_of(grads_g, grads_p)
    check(same_dev[1] <= TRAIN_GRAD_TOL_SAME_DEVICE,
          f"train gradient {same_dev[0]}, kernels vs the card's plain path: relative error "
          f"{same_dev[1]} > {TRAIN_GRAD_TOL_SAME_DEVICE}")
    log("train", case="dropout 0, one step, GPU kernels vs CPU plain", loss_gpu=loss_g.item(),
        loss_gpu_plain=loss_p.item(), loss_cpu=loss_c.item(), loss_rel_err=loss_rel,
        worst_grad=worst, worst_grad_rel_err=err, tol=TRAIN_GRAD_TOL,
        gpu_plain_vs_cpu=worst_of(grads_p, grads_c), gpu_kernels_vs_gpu_plain=same_dev,
        same_device_tol=TRAIN_GRAD_TOL_SAME_DEVICE, params=len(grads_c),
        n_valid=int(batch["n_valid"]), setup_s=time.perf_counter() - t0)
    del det, det_plain, cpu_model

    # the main path: the flagship at dropout 0.5, K = 8 steps per call
    s = bench.build_setup("flagship", 256, DEVICE)
    fused_attention.launches = 0
    attention_bwd.launches = 0
    losses = []
    for i in range(TRAIN_CALLS):
        s.state, k_losses = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[i % len(s.chunks)])
        losses.append(k_losses)
    torch.cuda.synchronize()
    launches = {"attention_fwd": fused_attention.launches,
                "attention_bwd": attention_bwd.launches}
    losses = torch.cat(losses).cpu()
    log("train", case="flagship dropout 0.5", steps=len(losses), launches=launches,
        first_8=losses[:8].tolist(), last_8=losses[-8:].tolist())
    check(launches["attention_fwd"] > 0, "the train step never launched K1")
    check(launches["attention_bwd"] > 0, "the train step never launched K2")
    check(bool(torch.isfinite(losses).all()), "a non-finite training loss")
    check(losses[-8:].mean() < losses[:8].mean(),
          f"the loss did not fall: first 8 mean {losses[:8].mean()}, "
          f"last 8 mean {losses[-8:].mean()}")

    rates = {}
    for use_kernel in (False, "auto"):
        setup = s if use_kernel == "auto" else bench.build_setup(
            "flagship", 256, DEVICE, use_kernel=False)
        torch.cuda.reset_peak_memory_stats()
        r = bench.measure(setup)
        rates[use_kernel] = r
        log("train", card=card, metric="train_examples_per_sec_flagship",
            use_kernel=use_kernel, median=statistics.median(r), min=min(r), max=max(r),
            windows=r, calls_per_window=max(1, 100 // setup.inner), inner_steps=setup.inner,
            batch=setup.tc.batch_size,
            peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
        if profile_run:
            profile_train(card, setup, use_kernel)
    return launches, rates


# --------------------------------------------------------------------------
# phase 7 (--profile): where the time of a recommend call goes
# --------------------------------------------------------------------------

def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def device_trace(run, steps: int):
    """(unprofiled ms, profiled ms, device busy ms, device ops, top
    [name, ms]) per step of ``run``, which does ``steps`` steps and returns
    its host wall time in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    wall_ms = run()  # unprofiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof_ms = run()
    dev = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    check(bool(dev), "profile: the trace holds no device operation")
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (wall_ms / steps, wall_prof_ms / steps, busy_ms / steps, len(dev) / steps,
            [[n[:70], t / 1e3 / steps] for n, t in top])


def profile_train(card, s, use_kernel) -> None:
    """One traced call of the scanned train step (K steps)."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.state, _ = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[0])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall, wall_prof, busy, ops, top = device_trace(run, s.inner)
    log("profile", card=card, path="train step", use_kernel=use_kernel, steps=s.inner,
        wall_ms_per_step=wall, wall_profiled_ms_per_step=wall_prof,
        device_busy_ms_per_step=busy, busy_share=busy / wall, device_ops_per_step=ops,
        top_ms_per_step=top)


def phase_profile(card, rec, host, calls: int = 10) -> None:
    """torch.profiler trace of ``calls`` recommend calls per bucket (seen
    index): device busy time (union of kernel and copy intervals), device
    operations per call, busy share of the unprofiled wall time, and the
    heaviest device operations by name. Also the host cost of enqueueing one
    K1 launch at the bucket-1 encoder shape."""
    with torch.no_grad():
        q, k, v, qm, km = (t[:1].contiguous() for t in k1_inputs(L, L, 40))
        kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H)
        fused_attention(q, k, v, qm, km, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fused_attention(q, k, v, qm, km, **kw)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    log("profile", card=card, k1_enqueue_host_us=host_us, shape="[1,50,64] causal 0")

    reqs = bucket_requests(host, SEED + 2)
    for bb in BUCKETS:
        hists, ctxs = reqs[bb]

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                rec.recommend(hists, k=K, ctxs=ctxs)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        wall_ms, wall_prof_ms, busy_ms, ops, top = device_trace(run, calls)
        log("profile", card=card, index="seen", batch=bb, calls=calls,
            wall_ms=wall_ms, wall_profiled_ms=wall_prof_ms, device_busy_ms=busy_ms,
            busy_share=busy_ms / wall_ms, device_ops_per_call=ops, top_ms_per_call=top)


def main() -> None:
    profile_run = "--profile" in sys.argv[1:]
    if set(sys.argv[1:]) - {"--profile"}:
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    card = phase_device()
    phase_build()
    k1_err = phase_k1()
    k2_err, k2_times = phase_k2(card)
    k3_err = phase_k3()
    rec, rec_full, host, serve_launches = phase_slice()
    timings = phase_timing(card, rec, rec_full, host)
    if profile_run:
        phase_profile(card, rec, host)
    del rec, rec_full
    train_launches, _ = phase_train(card, profile_run)
    log("launches", serving=serve_launches, training=train_launches)
    k2_enc = k2_times[K2_CASES[0][0]]["bwd"]
    print(json.dumps({"kernels": [
        {"name": "attention_fwd", "route": "cuda",
         "source": "carca_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "carca_tpu/ops/flash_attention.py:113",
         "launches": train_launches["attention_fwd"], "max_abs_err": k1_err,
         "ms": timings["K1", "train"][0], "plain_ms": timings["K1", "train"][1]},
        {"name": "attention_bwd", "route": "cuda",
         "source": "carca_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "carca_tpu/ops/flash_attention.py:130",
         "launches": train_launches["attention_bwd"], "max_abs_err": k2_err,
         "ms": k2_enc[0], "plain_ms": k2_enc[1]},
        {"name": "catalog_topk", "route": "cuda",
         "source": "carca_tpu_torch/csrc/catalog_topk.cu",
         "replaces": "carca_tpu/ops/retrieval_topk.py:526",
         "launches": serve_launches["catalog_topk"], "max_abs_err": k3_err,
         "ms": timings["K3", "seen"][0], "plain_ms": timings["K3", "seen"][1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
