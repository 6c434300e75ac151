#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths and train step on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root, on a machine with a card
    python3 chip_smoke.py --profile   # also phase 7: profiler breakdowns of recommend and the train step

Phases, one or more lines each, each ending with its seconds; any failure
raises and exits non-zero:

1. device  — a CUDA card must be present (there is no CPU fallback);
             prints nvidia-smi's name and power limit; TF32 off.
2. build   — compiles kernels K1–K4 from carca_tpu_torch/csrc/ (one nvcc
             per source, all started together).
3. K1      — the attention forward kernel against its plain version on
             CUDA tensors at the serving and training shapes and at men's
             [256,200,64] (four key tiles); one raise it must give. With
             weight dropout p = 0.5: the keep share over
             1.28M weights within 0.5 ± 0.002, the same seed giving the same
             bits and another seed other bits, the card's Philox bits equal
             to the numpy generator's, and K1's output equal to the plain
             version fed the kernel's own keep mask.
3b. K2     — the attention backward kernel (under autograd, after K1)
             against autograd over the plain version, with dropout off and
             on, at the encoder [256,50,64] causal 0, decoder
             [512,50,64]x[512,50,64] causal -1 and men [256,200,64] causal 0
             shapes, and at two that raised before K2 took key tiles
             ([256,200,128] with 64-dim heads, [256,320,64]), and with
             256-dim heads (128-column chunks) at Lk = 50 and 200: per-tensor
             relative error, exact zeros for fully masked rows, two runs
             bit-equal; fwd+bwd and bwd-only times against the plain
             version's.
4. K3      — the stream top-k kernel over f32, bf16 and int8 indexes against
             its plain version within the summation-order tolerance (below):
             ties, id_offset with an n_items limit, k beyond the valid rows,
             zero queries (exactly the lowest ids); one raise it must give.
4c. K4     — the group-max kernel in both layouts ([G, B] and [B, G])
             against its plain version within the tolerance at
             f32/bf16/int8 (ties across group boundaries, an n_items limit,
             B = 1, zero queries, B = 300 over two query chunks); K4's
             maxima bit-equal to the maxima of the rerank kernel's scores
             over each group, and the rerank within the tolerance of
             tournament_rerank_plain; the tournament (K4 + rerank, flat and
             recursive) bit-equal to the stream, ids and values, up to 1M
             rows at B = 256, k = 562.
4w. d=256  — rows wider than 128 columns (128-column chunks): K3 at
             f32/bf16/int8, K4 in both layouts and the rerank at [256,256] x
             100,000 rows, k = 562, within the tolerance of their plain
             versions, K4's maxima bit-equal to the rerank's, the tournament
             bit-equal to the stream; each timed beside its plain version.
5. slice   — the beauty preset at full width (d=64, g=256, 2 blocks, 2
             heads, L=50, ca decoder) with random weights from seed 0,
             serving synthetic_catalog(4096 users, 99,999 items): JSON-lines
             requests and one recommend per batch bucket, over the seen
             index and the full index. K1 and K3 must launch. The same
             requests then go through the same weights on the CPU plain
             path, and must agree.
5c. 10M    — the same preset over synthetic_catalog(4096 users, 9,999,999
             items) with quantize="auto": an int8 index of 10,000,000 rows.
             JSON-lines requests and one recommend per bucket; K1 and the
             stage-1 kernels "auto" picks (K4 and the rerank, or K3) must
             launch. Stage 1 alone (k = 562) at buckets 8 and 64 against the
             card's plain version, within the tolerance; the requests and
             buckets 1 and 8 against the CPU plain path.
5d. bench  — carca_tpu_torch/bench_retrieval.py at 10M items, kernel legs
             (bf16 and int8 indexes, stream, tournament, auto), with the
             recursive stage 2 forced: K3 over bf16 and int8 rows and K4's
             [B, G] layout must launch.
6. timing  — recommend p50/p95 and throughput per bucket (100k slice; 10M
             slice over the int8 and an f32 index), each kernel beside its
             plain version at the slices' shapes (CUDA events) and checked
             against it there within the tolerance (K4 in both layouts at
             [256,64] and [1,64] x 10M int8 rows; the rerank at bucket 256,
             k = 562, its group maxima bit-equal to K4's; K3 bf16/int8 at
             [32,64] x 10M rows), K3's scratch (planned and measured, at
             most 0.5 GB) and the tournament's memory at 10M rows, K1 at the
             encoder, decoder, men and rerank shapes, and
             F.scaled_dot_product_attention forward and backward at the same
             shapes beside K1/K2 (timed only).
7. profile — only with --profile: per bucket, a torch.profiler trace of
             recommend (device busy time and share, device operations per
             call, the heaviest of them), and the host cost of one K1 launch;
             device µs per launch of each of K1/K2's device kernels at the
             timed attention shapes; after phase 8, the same as for
             recommend for one call of the train step (K = 8 steps) with the
             kernels and with the plain path.
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
             the kernels and with the plain path, and peak device memory;
             then `python -m carca_tpu_torch.bench` (its mfu and
             hbm_bw_util must lie in (0, 1.05]) and `python -m
             carca_tpu_torch.profile_step --config flagship`, whose table
             must name K1's and K2's device kernels (phase 7 and this
             script's traces use its aggregation).
9. fit     — the port's entry points end to end: synthetic_catalog(4096
             users, 2,000 items, seed 0) written in the reference's file
             formats, then `python -m carca_tpu_torch.cli --preset beauty`
             over those files (epochs 100, early stop 20) as a subprocess,
             on the device pipeline at seed 0 (phase 12's family fits run
             the host pipeline; PERF.md keeps the earlier host and seed-1
             fits' numbers). It must reach test HR@10 >= 0.695 and NDCG@10
             >= 0.540, launch K1 and K2, and leave args.json, the CSV,
             metrics.jsonl, ckpt/best and ckpt/latest. Then `python -m
             carca_tpu_torch.serve.service --run_dir` over the seed-0 run
             answers JSON-lines requests on stdin (one malformed) and runs
             --bench; its answers must equal an in-process Recommender from
             load_recommender(run, which="best"), whose K1 and K3 launches
             are counted, and the CPU plain path's load_recommender (ids
             equal except near-ties, scores within 1e-4). At the shapes this
             path gives them: K3 f32 over the run's 1,998-row seen index, k =
             562, against its plain version at each bucket; one val batch of
             the best checkpoint through make_eval_step with the kernels
             (K1 at the eval's [256,101] x [256,50] cross-attention) and
             with the plain path on the card: HR and NDCG sums equal, loss
             within 1e-5.
10. fit 10M — the synthetic10m preset (BASELINE configs[4]) at its full
             size: synthetic_catalog_device(100,000 users, 10,000,000
             items, seed 0) generated on the card twice, bit-equal; one
             train step at dropout 0 from the same weights with the
             row-sparse and with the dense item Adam (losses equal,
             first-touch rows within 1e-6, untouched rows and moments
             bit-equal, the pad row 0) and each step's time; then `python -m
             carca_tpu_torch.cli --preset synthetic10m --epochs 2
             --eval_retrieval_every 1 --select_by retrieval_hr
             --eval_retrieval 10`: retrieval val HR@10 after epoch 1 >= 0.05,
             the retained epoch the first argmax of the retrieval curve,
             sampled test HR@10 >= 0.70, K1, K2 and K3 bf16 launched; ex/s,
             epoch seconds and peak memory. best/ on the test split through
             evaluate_retrieval's evaluator, (seen, bf16 -> K3), (full, bf16
             -> K4 + rerank), (seen, int8 -> K3 int8): with the kernels (the
             main path, launches counted), then per batch against the plain
             top-k (ids equal but for near-ties, HR sums apart by at most the
             users with a near-tie), each kernel timed beside its plain
             version at the eval's [256, 64] x k + L = 60; the service over
             the run (its catalog regenerated on the card) against an
             in-process load_recommender; `python -m carca_tpu_torch.bench
             --config 10m` (mfu and hbm_bw_util as in phase 8); K1/K2 under
             bf16 compute at the fit's encoder
             against their plain versions, timed beside them and SDPA.
             12d, after the fit's evaluation: `python -m
             carca_tpu_torch.eval_retrieval_offline RUN --which best` equal
             to the fit's own test retrieval HR@10 / NDCG@10 (the same
             parameters, seen index and users; K3 bf16 launched), and with
             --full_index --quantized (K4 and the rerank over the 10M int8
             rows) in [0, 1] and within one of the 10,000 test users of the
             unquantized full index's HR@10.
11. mesh   — two ranks of torch.distributed, each a subprocess of `python
             -m torch.distributed.run --standalone --nproc_per_node 2`
             (this script re-entered with --rank_task, or the entry points),
             sharing cuda:0 over gloo (nccl where every rank has a card).
             11a, data parallel at the flagship width: one dropout-0 step
             of make_sharded_device_train_step on phase 9's data against
             the one-device kernel step (loss within 1e-5; parameters
             within 1e-5 where the one-device |g| > 1e-6, 2·lr elsewhere),
             its time and the gradient all-reduce's; K1 and K2 at the
             rank-local [128,50,64] against their plain versions (phase
             3's tolerances); `cli --preset beauty
             --mesh 2 --epochs 15` over phase 9's files to phase 9's gates,
             K1 and K2
             on both ranks, rank 0 alone logging; its run served on one
             device equal to an in-process Recommender. The row-sparse item
             Adam: two dropout-0 steps (the first batch touching row lo of
             block 1, the second another batch) of
             make_sharded_device_train_step at --mesh 2 and --mesh 1x2 with
             the row-sparse Adam, and at --mesh 1x2 with the dense Adam,
             against two one-device steps from the same weights and global
             batches (losses and each moment tensor within 1e-6 relative,
             parameters as 11a's, untouched rows and moments bit-equal,
             counts equal). 11b, row-sharded, the JAX package's whole 10M
             training stack: `cli --preset synthetic10m --mesh 1x2
             --shard_embeddings true --sparse_items_adam true --epochs 1
             --eval_retrieval_every 1 --eval_retrieval 10 --retrieval_index
             full` (sampled test HR@10 >= 0.70, K1/K2 on both ranks, ex/s,
             wall and peak memory per rank); its latest/ resumed on one
             device (the whole row state) for one step; on its run, in
             each rank: the sharded lookup
             of the item (f32) and attrs (bf16) tables equal to the plain
             gather; service.main with --index_shards 2 over the full 10M
             int8 index, with and without history exclusion (K4 + the
             rerank, then K3, on both ranks); the index its ranks built
             block by block against the one-device build (scales within
             1e-4 relative, values within one int8 step); the service's
             answers equal to a one-shard recommender over the gathered
             index (ids but for near-ties); the blocks' K3 and tournament
             results merged over the ranks bit-equal to one device; the
             lookup all-reduce and the top-k all-gather timed; K3, K4 and
             the rerank over one 5M-row block against their plain
             versions (the summation-order bound) and timed beside them.
             With --profile, one 10M K-step train call under the profiler.
12. families — the BASELINE families (games: d=128, 8 context features;
             fashion: attrctx, 128 dense attributes, g=512; men: L=200) on
             the host pipeline with the native C++ assembler. 12a: the
             assembler built from carca_tpu_torch/native/assembler.cpp; at
             the games family's catalog its train/val/test batches equal
             the numpy path's in the deterministic keys, its negatives
             keep the sampler contract, 1 and 8 threads give bit-equal
             batches; one epoch's assembly timed against numpy's. 12b:
             `python -m carca_tpu_torch.validate_presets all --epochs 25
             --early_stop 8` (a subprocess): each family's run directory
             complete, `assembler: native` in the log, K1 and K2 launched,
             test HR@10 / NDCG@10 at its gate (FAMILY_GATES: the
             reference's less ~2.5 sigma); then the games fit's train ex/s
             with the native assembler against numpy (2 epochs each, in
             turns). 12c: K1/K2 at the families' encoder and `ca` decoder
             shapes (d=128 at L=50, the decoder at L=200) against their
             plain versions (phase 3's tolerances), timed beside them and
             SDPA; one val batch of the games run's best/ through
             make_eval_step with the kernels and without (HR/NDCG sums
             equal, loss within 1e-5); the fashion run through `python -m
             carca_tpu_torch.serve.service --run_dir` against an
             in-process Recommender and the CPU plain path, and K3 f32 at
             d=128 over its seen index against its plain version, timed.
13. scaling + failover — 13a: `python -m carca_tpu_torch.bench_scaling
             --sizes 1,2` and `--sizes 2 --shard_embeddings` (subprocesses,
             one group of rank processes per size, sharing the card over
             gloo): one line per size with finite rates, logged as
             mechanics, not scaling; every rank ran K1 and K2 on the card;
             each group's transport in its stderr held to the rule (nccl
             only when every rank has a card); K1/K2 at the flagship
             encoder and decoder at a rank's batch of 256 (the harness) and
             128 (the failover's rank-local batch) against their plain
             versions (phase 3's tolerances), timed beside them and SDPA.
             13b, the failure path on phase 9's data: run a, `torchrun
             --nproc_per_node 2 -m carca_tpu_torch.cli --preset beauty
             --mesh 2 --epochs 99 --checkpoint_interval 1`, its rank 1
             SIGKILLed once ckpt/latest/state.pt exists (torchrun must exit
             non-zero); run b, the same directory with `--resume true
             --epochs 3`, must train exactly the epochs after latest/'s and
             end at epoch 3 with both ranks' final metrics equal and K1/K2
             launched; a control of `--epochs 3` in its own directory. The
             card's attention gradients and scatter-adds are not
             bit-deterministic, so the resumed per-epoch train loss is held
             within 1e-3 relative of the control's same epochs and the final
             val and test NDCG@10 within 0.01 (the CPU test holds equality).

Tolerance of the retrieval kernels against their plain versions: K3, K4
and the rerank score on the tensor cores (csrc/scoring.cuh), the plain
versions sum the same d products in index order, so values agree within
SCORE_ORDER_TOL = 1e-5 of sum_j |q_j e_rj| (x the int8 scale) and ids are
equal except near-ties within that bound
(retrieval_topk.compare_within_order_tol). Between the kernels the checks
are bit-equal.

The main paths are the 100k slice (phase 5), the 10M slice (5c), the
retrieval bench (5d), the train step (8), the fit and serve entry points
(9), the 10M fit, its retrieval evaluation and the offline evaluation
(10, 12d), the mesh fits and the sharded service (11, counted in each
rank), the family fits and the fashion service (12), and the scaling
harness's ranks and the failover's resumed and control runs (13, counted
in each rank): each runs with every
launch counter set to 0 just before it and read just after (the fits run
as subprocesses, which start at 0 and print their counts at the end). The line before the
last is a JSON object listing the kernels, each with its launches on the
path that runs it, its error against its plain version, its time, the plain
version's, its bound (bytes over 3.35 TB/s against operations over the
peak of how they run: 3xTF32 for K1/K2 and K3 over f32 rows, bf16 for
bf16/int8 rows) and the library call's time where
one exists; K1/K2 have one entry per timed shape, with the launches at
that shape;
the last line is {"ok": true, "device": {...}}.
"""

import argparse
import ast
import contextlib
import copy
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from carca_tpu_torch import bench, bench_retrieval
from carca_tpu_torch.cli import launch_counts
from carca_tpu_torch.config import Config, preset
from carca_tpu_torch.data.dataset import BatchBuilder, epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset, assemble_train
from carca_tpu_torch.data.loaders import load_dataset
from carca_tpu_torch.data.synthetic import (synthetic_catalog, synthetic_catalog_device,
                                            write_reference_format)
from carca_tpu_torch.models.attention import NEG_MASK, masked_attention, pair_mask
from carca_tpu_torch.models.carca import CARCA, encode_profile
from carca_tpu_torch.native import get_assembler
from carca_tpu_torch.ops import _build
from carca_tpu_torch.ops import retrieval_topk as rt
from carca_tpu_torch.ops.flash_attention import (SEED_LIMIT, attention_bwd,
                                                 attention_grads_plain,
                                                 attention_keep_mask, fused_attention,
                                                 philox_bits)
from carca_tpu_torch.ops.retrieval_topk import (GROUP, SCORE_ORDER_TOL, QuantizedIndex,
                                                catalog_topk, catalog_topk_plain,
                                                compare_within_order_tol, groupmax,
                                                groupmax_plain, quantize_index, stream_plan,
                                                tournament_rerank, tournament_rerank_plain)
from carca_tpu_torch.parallel.retrieval import query_from_encoded, retrieval_hr_ndcg
from carca_tpu_torch.profile_step import device_ops, device_trace
from carca_tpu_torch.serve.recommender import (Recommender, config_from_run_dir,
                                               load_recommender)
from carca_tpu_torch.serve.service import HostCSR, history, run_bench, serve_lines
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.checkpoint import CheckpointKeeper
from carca_tpu_torch.train.loop import (RetrievalEvaluator, _sparse_device_update,
                                        apply_gradients, attrs_dtype, make_eval_step, to_device,
                                        train_loss, train_loss_terms)
from carca_tpu_torch.train.loop import fit as fit_loop
from carca_tpu_torch.train.state import create_train_state
from carca_tpu_torch.validate_presets import FAMILIES, family_catalog, family_config

SEED = 0
N_USERS, N_REAL_ITEMS = 4096, 99_999
N_REAL_ITEMS_10M = 9_999_999  # the >=1M-row slice: 10,000,000 item ids
STAGE1_BUCKETS = (8, 64)  # stage 1 at 10M rows against the plain [B, 10M] sort (B = 256: tens of GB)
K3_10M_B = 32  # K3 bf16/int8 at 10M rows against the plain [B, 10M] sort
K4_BIG_ROWS = 1_000_000  # the largest tournament-vs-stream case of phase 4c
BENCH_ITEMS = 10_000_000  # the retrieval bench path of phase 5d
SHORTLIST, K = 512, 10
BUCKETS = (1, 8, 64, 256)
B, L, D, H = 256, 50, 64, 2
L_MEN = 200  # the men config's sequence length (carca_tpu_torch/bench.py)
KK = SHORTLIST + L  # stage 1 retrieves the shortlist plus the exclusion slack
DEVICE = torch.device("cuda")
K1_TOL, K1_TOL_BF16 = 1e-5, 2e-2
K2_TOL, K2_TOL_BF16 = 1e-5, 2e-2  # relative norm per gradient tensor
P_DROP = 0.5
# the shapes K1/K2 are timed at: (batch, Lq, Lk, causal, weight dropout);
# encoder and decoder are the flagship train step's calls, men the men
# config's encoder, rerank the serving slice's stage 2 (forward only)
ATTN_SHAPES = {
    "encoder": (B, L, L, 0, P_DROP),
    "decoder": (2 * B, L, L, -1, P_DROP),
    "men": (B, L_MEN, L_MEN, 0, P_DROP),
    "rerank": (B, SHORTLIST, L, None, 0.0),
}
KEEP_SHARE_TOL = 0.002
K3_SCRATCH_LIMIT = 512 << 20  # bytes of K3 scratch at 10M rows, B = 256, k = 562
INDEX_KINDS = ("f32", "bf16", "int8")
# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet): bytes/s of
# HBM3, and dense operations/s by how the products run: float32 on the
# tensor cores as 3xTF32 (K1, K2, and K3/K4 on f32 rows: three TF32
# products of 495 TFLOP/s each), bf16 (bf16 rows, and int8 rows, which meet
# the bf16 query as bf16)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"3xtf32": 495e12 / 3, "bfloat16": 989e12}
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
D_WIDE, R_WIDE = 256, 100_000  # phase 4w: rows of 256 columns (two 128-column chunks)
# phase 9: results/convergence_flagship.json's dataset and protocol; the
# floors lie ~2.5 sigma (sigma ~0.007 at 4,096 test users) below the
# reference's test HR@10 / NDCG@10 of 0.7144 / 0.5563
FIT_USERS, FIT_ITEMS = 4096, 2000
FIT_TARGETS = 100  # the beauty preset's eval negatives (target_len)
FIT_EPOCHS, FIT_EARLY_STOP = 100, 20
FIT_HR_FLOOR, FIT_NDCG_FLOOR = 0.695, 0.540
FIT_TIMEOUT_S = 600
SERVE_SCORE_TOL = 1e-5  # the service against the in-process Recommender
SERVE_BENCH_ITERS = 30
# phase 10: the synthetic10m preset (BASELINE configs[4]) at its full size.
# Its floors: retrieval val HR@10 after epoch 1 (the JAX package on a TPU,
# the same process with another draw: 0.0954) and sampled test HR@10 (the
# JAX package: ~0.77)
FIT10M_USERS, FIT10M_ITEMS = 100_000, 10_000_000
FIT10M_EPOCHS = 2
FIT10M_RETRIEVAL_FLOOR, FIT10M_SAMPLED_FLOOR = 0.05, 0.70
FIT10M_TIMEOUT_S = 900
# 12d: the offline full-index int8 eval against the unquantized full index:
# at most one of the fit's 10,000 test users (eval_subsample) may rank its
# item otherwise
OFFLINE_INT8_HR_TOL = 1 / 10_000
# first-touch rows, row-sparse against dense Adam: the same gradient rows,
# the bias corrections folded into the step (torch) or dividing the moments
# (the row update), so updates of ~lr = 1e-3 differ in their last bits
SPARSE_DENSE_TOL = 1e-6
# their first moments, (1 - b1)·g of the two paths' item gradients, as the
# card test of the sparse step holds them: 1e-2 relative or 1e-9 absolute
SPARSE_DENSE_MOMENT_RTOL, SPARSE_DENSE_MOMENT_ATOL = 1e-2, 1e-9
EVAL10M_CASES = (("seen bf16", True, False), ("full bf16", False, False),
                 ("seen int8", True, True))
# kernel against plain on (test users, batch): the plain top-k over the
# 10M index holds a [B, 10M] score matrix, so it takes batches of 32
EVAL10M_CMP = {"seen bf16": (2048, B), "full bf16": (512, 32), "seen int8": (2048, B)}
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def kernel_vs_plain(kernel, plain, reps: int = 20, plain_reps: int = None):
    """(kernel ms, plain ms), each the mean of two runs in the order plain,
    kernel, kernel, plain."""
    plain_reps = reps if plain_reps is None else plain_reps
    p1, k1, k2, p2 = (cuda_ms(f, n) for f, n in ((plain, plain_reps), (kernel, reps),
                                                   (kernel, reps), (plain, plain_reps)))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(bytes_moved: float, ops: float, operand: str):
    """(least ms, what binds it): each input read once and each output
    written once at the HBM rate, against the operations at the peak rate
    of their operand type."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[operand] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    fused_attention.launches = 0
    attention_bwd.launches = 0
    fused_attention.launches_by_shape.clear()
    attention_bwd.launches_by_shape.clear()
    catalog_topk.launches.update({kind: 0 for kind in INDEX_KINDS})
    groupmax.launches.update({0: 0, 1: 0})
    tournament_rerank.launches = 0


def counts() -> dict:
    """Every kernel's launch count in this process, K1's and K2's also by shape."""
    return launch_counts(by_shape=True)


def shape_key(lq, lk, causal) -> str:
    """K1/K2's by-shape launch keys, as ``counts()`` and the entry points
    name them."""
    return f"{lq}x{lk} causal {causal}"


def as_index(e, kind: str):
    """The f32 rows e as an index of ``kind``."""
    if kind == "int8":
        return quantize_index(e)
    return e.to(torch.bfloat16) if kind == "bf16" else e


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


def k1_inputs(lq, lk, seed, b=B, d=D):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, d, generator=gen).to(DEVICE) for n in (lq, lk, lk))
    qm, km = padded_masks(gen, b, lq, lk, DEVICE)
    return q, k, v, qm, km


K1_CASES = [  # (name, Lq, Lk, causal, compute dtype)
    ("encoder [256,50,64] causal 0", L, L, 0, "float32"),
    ("rerank q [256,512,64] kv [256,50,64]", SHORTLIST, L, None, "float32"),
    ("train-time decoder [256,50,64] causal -1", L, L, -1, "float32"),
    ("encoder [256,50,64] causal 0 bf16", L, L, 0, "bfloat16"),
    ("men [256,200,64] causal 0", L_MEN, L_MEN, 0, "float32"),
    # the fit's eval decoder: T + 1 = 101 candidates against the profile
    ("eval q [256,101,64] kv [256,50,64]", FIT_TARGETS + 1, L, None, "float32"),
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

K2_CASES = [  # (name, B, Lq, Lk, causal, compute dtype, d); the first three are timed
    ("encoder [256,50,64] causal 0", B, L, L, 0, "float32", D),
    ("decoder [512,50,64]x[512,50,64] causal -1", 2 * B, L, L, -1, "float32", D),
    ("men [256,200,64] causal 0", B, L_MEN, L_MEN, 0, "float32", D),
    ("encoder [256,50,64] causal 0 bf16", B, L, L, 0, "bfloat16", D),
    # shared memory refused these before K2 walked key tiles (Lk > ~160 at dh = 64)
    ("[256,200,128] 64-dim heads causal 0", B, L_MEN, L_MEN, 0, "float32", 2 * D),
    ("[256,320,64] causal 0", B, 320, 320, 0, "float32", D),
    # heads wider than 128 dims, in 128-column chunks (one key tile, then four)
    ("[64,50,512] 256-dim heads causal 0", 64, L, L, 0, "float32", 8 * D),
    ("[64,200,512] 256-dim heads causal 0", 64, L_MEN, L_MEN, 0, "float32", 8 * D),
]
K2_TIMED = {"encoder": K2_CASES[0][0], "decoder": K2_CASES[1][0], "men": K2_CASES[2][0]}


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
    for i, (name, b, lq, lk, causal, cd, d) in enumerate(K2_CASES):
        inputs = k1_inputs(lq, lk, 60 + i, b=b, d=d)
        q, k, v, qm, km = inputs
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(70 + i)).to(DEVICE)
        tol = K2_TOL if cd == "float32" else K2_TOL_BF16
        for rate in (0.0, P_DROP):
            kw = dict(causal=causal, scale=(d / H) ** 0.5, n_heads=H, compute_dtype=cd,
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
        if name in K2_TIMED.values():
            timings[name] = time_k2(card, name, inputs, g, i, causal=causal,
                                    scale=(d / H) ** 0.5, n_heads=H, compute_dtype=cd,
                                    dropout_rate=P_DROP)
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
    """K3 against its plain version within the summation-order tolerance."""
    with torch.no_grad():
        v, i = catalog_topk(q, e, k, method="stream", **kw)
        pv, pi = catalog_topk_plain(q, e, k, **kw)
    torch.cuda.synchronize()
    err, swapped = compare_within_order_tol(v, i, pv, pi, q, e, kw.get("id_offset", 0))
    log("K3", case=name, max_abs_err=err, tol=f"{SCORE_ORDER_TOL} * sum|q e|",
        near_tie_slots=swapped, neg_inf_slots=int((~torch.isfinite(pv)).sum()))
    return err, v, i


def phase_k3() -> dict:
    """K3 over f32, bf16 and int8 indexes against the plain version; returns
    the worst value error per index type."""
    gen = torch.Generator().manual_seed(20)
    q = torch.randn(B, D, generator=gen).to(DEVICE)
    full = torch.randn(N_REAL_ITEMS + 1, D, generator=gen).to(DEVICE)
    seen = full[:19_156].contiguous()
    dup = seen.clone()
    dup[1000:1400] = dup[7]  # 400 exact ties with row 7
    dup[5000:5100] = dup[12]
    qz = q.clone()
    qz[:8] = 0.0  # batch padding embeds to zero
    worst = {}
    for kind in INDEX_KINDS:
        full_i, seen_i, dup_i = (as_index(t, kind) for t in (full, seen, dup))
        few_i = as_index(seen[:400].contiguous(), kind)
        errs = []
        for rows_name, e in (("100,000 rows", full_i), ("19,156 rows", seen_i)):
            for k in (KK, K):
                errs.append(k3_case(f"{kind} {rows_name} k={k}", q, e, k)[0])
        errs.append(k3_case(f"{kind} duplicated rows k=562", q, dup_i, KK)[0])
        errs.append(k3_case(f"{kind} id_offset=1000, n_items limit k=562", q, seen_i, KK,
                            id_offset=1000, n_items=1000 + 15_000)[0])
        err, v, i = k3_case(f"{kind} k beyond the 399 valid rows", q, few_i, KK)
        errs.append(err)
        check(bool((i[:, 399:] == 0).all()) and bool(torch.isneginf(v[:, 399:]).all()),
              f"K3 {kind}: slots past the valid rows must be -inf with id 0")
        err, v, i = k3_case(f"{kind} zero queries k=562", qz, seen_i, KK)
        errs.append(err)
        check(torch.equal(i[:8].cpu(), torch.arange(1, KK + 1).expand(8, KK)),
              f"K3 {kind}: a zero query must return the lowest ids in order")
        worst[kind] = max(errs)
    try:
        catalog_topk(q, seen.to(torch.int8), K, method="stream")
    except TypeError as exc:
        log("K3", case="an int8 index without its scales raises", raised=str(exc)[:80])
    else:
        raise RuntimeError("K3 accepted int8 rows without their scales")
    return worst


# --------------------------------------------------------------------------
# phase 4c: K4 against its plain version; the tournament against the stream
# --------------------------------------------------------------------------

def check_groupmax(tag, q, rows, scales, lim0, row0, layout):
    """K4 against groupmax_plain: -inf groups alike, maxima within
    SCORE_ORDER_TOL of each group's largest sum_j |q_j e_rj|. Returns
    (K4's output, max |K4 - plain|)."""
    got = groupmax(q, rows, scales, lim0, row0, layout)
    want = groupmax_plain(q, rows, scales, lim0, row0, layout)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"K4 {tag}: shape {tuple(got.shape)}")
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"K4 {tag}: -inf groups differ")
    err = (got - want).abs().where(fin, 0)
    bound = SCORE_ORDER_TOL * groupmax_plain(q.abs(), rows.abs(), scales, rows.shape[0], False,
                                             layout)
    check(bool((err[fin] <= bound[fin]).all()), f"K4 {tag}: beyond the summation-order bound "
                                                f"(max |err| {err.max().item()})")
    return got, err.max().item()


def check_rerank(tag, q, rows, scales, gi, lim0, row0, gmax):
    """The rerank kernel over winner groups gi: its group maxima bit-equal
    to K4's maxima gmax [B, kg] of those groups, its scores within the
    tolerance of tournament_rerank_plain. Returns max |rerank - plain|."""
    s = tournament_rerank(q, rows, scales, gi, lim0, row0)
    plain = tournament_rerank_plain(q, rows, scales, gi, lim0, row0)
    torch.cuda.synchronize()
    b, kg = gi.shape
    check(torch.equal(s.view(b, kg, GROUP).amax(dim=2), gmax),
          f"rerank {tag}: group maxima are not bit-equal to K4's")
    fin = torch.isfinite(plain)
    check(torch.equal(torch.isfinite(s), fin), f"rerank {tag}: -inf rows differ")
    err = (s - plain).abs().where(fin, 0)
    bound = SCORE_ORDER_TOL * tournament_rerank_plain(q.abs(), rows.abs(), scales, gi,
                                                      rows.shape[0], False)
    check(bool((err[fin] <= bound[fin]).all()), f"rerank {tag}: beyond the summation-order bound")
    return err.max().item()


def phase_k4() -> dict:
    """K4 in both layouts and the rerank within the tolerance of their plain
    versions, K4's maxima bit-equal to the rerank's group maxima, and the
    tournament (K4 + rerank) bit-equal to the stream (K3), ids and values,
    flat and recursive, at f32/bf16/int8. Returns the worst |kernel - plain|
    per layout and of the rerank ("rerank")."""
    gen = torch.Generator().manual_seed(22)
    q = torch.randn(300, D, generator=gen).to(DEVICE)
    q[:8] = 0.0  # zero queries
    e = torch.randn(20_000, D, generator=gen).to(DEVICE)
    e[120:140] = e[3]  # exact ties straddling the first group boundary
    e[1000:1400] = e[7]  # and three more
    big = torch.randn(K4_BIG_ROWS, D, generator=gen).to(DEVICE)
    q, q300 = q[:B].contiguous(), q
    worst = {0: 0.0, 1: 0.0, "rerank": 0.0}
    before = sum(groupmax.launches.values()), tournament_rerank.launches
    for kind in INDEX_KINDS:
        for name, qq, ee, lim0, row0 in (
                ("ties across groups, zero queries, B=256", q, e, 20_000, True),
                ("n_items limit, no pad row, B=33", q[:33], e[:19_156], 15_000, False),
                ("B=1", q[8:9], e[:2_049], 2_049, True),
                ("B=300, two query chunks", q300, e[:3_000], 3_000, True)):
            idx = as_index(ee.contiguous(), kind)
            rows, scales = (idx.qvals, idx.scales) if kind == "int8" else (idx, None)
            qq = qq.contiguous()
            for layout in (0, 1):
                got, err = check_groupmax(f"{kind} {name} layout {layout}", qq, rows, scales,
                                          lim0, row0, layout)
                worst[layout] = max(worst[layout], err)
            n_g = -(-rows.shape[0] // GROUP)
            gi = torch.arange(n_g, device=DEVICE).expand(qq.shape[0], n_g).contiguous()
            worst["rerank"] = max(worst["rerank"], check_rerank(
                f"{kind} {name}", qq, rows, scales, gi, lim0, row0, got[:, :n_g]))
            log("K4", case=f"{kind} {name}", layouts=[0, 1],
                tol=f"{SCORE_ORDER_TOL} * sum|q e|", rerank_group_maxima_bit_equal=True)
    check(sum(groupmax.launches.values()) > before[0], "K4 never launched")
    check(tournament_rerank.launches > before[1], "the rerank kernel never launched")
    old = rt._RECURSIVE_MIN_GROUPS
    try:
        for kind in INDEX_KINDS:
            small, big_i = as_index(e[:19_156].contiguous(), kind), as_index(big, kind)
            few = as_index(e[:400].contiguous(), kind)
            cases = (("duplicated rows k=562", q, small, KK, {}),
                     ("id_offset=1000, n_items limit k=562", q[:33], small, KK,
                      dict(id_offset=1000, n_items=16_000)),
                     ("zero queries k=10", q[:16], as_index(e, kind), K, {}),
                     ("B=1 k=10", q[8:9], small, K, {}),
                     ("k beyond the 399 valid rows", q[:16], few, KK, {}),
                     ("1M rows B=256 k=562", q, big_i, KK, {}))
            for recursive in (False, True):
                rt._RECURSIVE_MIN_GROUPS = 1 if recursive else old
                for name, qq, idx, k, kw in cases:
                    qq = qq.contiguous()
                    with torch.no_grad():
                        tv, ti = catalog_topk(qq, idx, k, method="tournament", **kw)
                        sv, si = catalog_topk(qq, idx, k, method="stream", **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(ti, si) and torch.equal(tv, sv),
                          f"tournament {kind} {name} recursive={recursive}: differs from "
                          f"the stream ({int((ti != si).sum())} ids)")
                log("K4", case=f"{kind} tournament == stream, bit-equal", recursive=recursive,
                    cases=[c[0] for c in cases])
    finally:
        rt._RECURSIVE_MIN_GROUPS = old
    return worst


# --------------------------------------------------------------------------
# phase 4w: rows wider than 128 columns
# --------------------------------------------------------------------------

def phase_k_wide(card) -> None:
    """K3 at f32/bf16/int8, K4 in both layouts and the rerank over rows of
    D_WIDE columns (128-column chunks) against their plain versions, K4's
    maxima bit-equal to the rerank's, the tournament bit-equal to the
    stream; each timed beside its plain version and its bound."""
    gen = torch.Generator().manual_seed(23)
    q = torch.randn(B, D_WIDE, generator=gen).to(DEVICE)
    e = torch.randn(R_WIDE, D_WIDE, generator=gen).to(DEVICE)
    e[1000:1400] = e[7]  # exact ties
    errs, times = {}, {}
    n_g = 64  # the rerank over the first 64 groups
    gi = torch.arange(n_g, device=DEVICE).expand(B, n_g).contiguous()
    with torch.no_grad():
        for kind in INDEX_KINDS:
            idx = as_index(e, kind)
            rows, scales = (idx.qvals, idx.scales) if kind == "int8" else (idx, None)
            errs["K3", kind] = k3_case(f"{kind} d={D_WIDE} {R_WIDE} rows k={KK}", q, idx, KK)[0]
            times["K3", kind] = kernel_vs_plain(lambda: catalog_topk(q, idx, KK, method="stream"),
                                                lambda: catalog_topk_plain(q, idx, KK),
                                                reps=10, plain_reps=2)
            for layout in (0, 1):
                got, errs[f"K4 layout {layout}", kind] = check_groupmax(
                    f"{kind} d={D_WIDE} layout {layout}", q, rows, scales, R_WIDE, True, layout)
                times[f"K4 layout {layout}", kind] = kernel_vs_plain(
                    lambda: groupmax(q, rows, scales, R_WIDE, True, layout),
                    lambda: groupmax_plain(q, rows, scales, R_WIDE, True, layout),
                    reps=10, plain_reps=2)
            errs["rerank", kind] = check_rerank(f"{kind} d={D_WIDE}", q, rows, scales, gi, R_WIDE,
                                                True, got[:, :n_g])
            times["rerank", kind] = kernel_vs_plain(
                lambda: tournament_rerank(q, rows, scales, gi, R_WIDE, True),
                lambda: tournament_rerank_plain(q, rows, scales, gi, R_WIDE, True),
                reps=10, plain_reps=2)
            tv, ti = catalog_topk(q, idx, KK, method="tournament")
            sv, si = catalog_topk(q, idx, KK, method="stream")
            torch.cuda.synchronize()
            check(torch.equal(ti, si) and torch.equal(tv, sv),
                  f"tournament {kind} d={D_WIDE}: differs from the stream")
            # bounds: the index's rows (and int8 scales) read once, the
            # queries, the outputs written; the rerank reads its n_g groups'
            # rows once (every query reranks the same groups)
            row_bytes = D_WIDE * rows.element_size() + (4 if kind == "int8" else 0)
            operand = "3xtf32" if kind == "f32" else "bfloat16"
            q_bytes, n_rr = B * D_WIDE * 4, n_g * GROUP
            work = {"K3": (R_WIDE * row_bytes + q_bytes + B * KK * 12, 2 * B * R_WIDE * D_WIDE),
                    "rerank": (n_rr * row_bytes + q_bytes + B * n_g * 8 + B * n_rr * 4,
                               2 * B * n_rr * D_WIDE)}
            for layout in (0, 1):
                work[f"K4 layout {layout}"] = (R_WIDE * row_bytes + q_bytes
                                               + -(-R_WIDE // GROUP) * B * 4,
                                               2 * B * R_WIDE * D_WIDE)
            log("K4w", card=card, case=f"{kind} [{B},{D_WIDE}] x {R_WIDE} rows k={KK}",
                tournament_equals_stream=True, rerank_group_maxima_bit_equal=True,
                rerank_groups=n_g,
                kernels={name: dict(zip(("ms", "plain_ms"), times[name, kind]),
                                    max_abs_err=errs[name, kind],
                                    **dict(zip(("bound_ms", "bound_by"),
                                               bound(*work[name], operand))))
                         for name in work})


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


def check_response(resp, want_k, in_index, hist):
    check("error" not in resp, f"request {resp.get('id')} failed: {resp}")
    items, scores = resp["items"], resp["scores"]
    check(len(items) == want_k, f"request {resp.get('id')}: {len(items)} items, want {want_k}")
    check(all(np.isfinite(scores)), "non-finite score in a response")
    check(all(scores[a] >= scores[a + 1] for a in range(len(scores) - 1)),
          "scores out of order")
    check(all(map(in_index, items)), "an item outside the index was recommended")
    check(not set(items) & set(hist[-L:]), "a visible-history item was recommended")


def compare(tag, ids_g, sc_g, ids_c, sc_c, score_tol=SLICE_SCORE_TOL) -> int:
    """GPU vs CPU plain results: ids equal, except near-ties whose two
    scores lie within SLICE_TIE_TOL; scores within ``score_tol``."""
    ids_g, ids_c = np.asarray(ids_g), np.asarray(ids_c)
    sc_g, sc_c = np.asarray(sc_g, np.float64), np.asarray(sc_c, np.float64)
    check(ids_g.shape == ids_c.shape, f"{tag}: shapes {ids_g.shape} vs {ids_c.shape}")
    np.testing.assert_allclose(sc_g, sc_c, rtol=score_tol, atol=score_tol, err_msg=tag)
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
    cfg = preset("beauty", n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx).model
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
    reset_counts()
    responses = list(serve_lines(rec, host, lines, k=K))
    got = {}
    for name, r in (("seen", rec), ("full", rec_full)):
        for bb, (hists, ctxs) in reqs.items():
            got[name, bb] = r.recommend(hists, k=K, ctxs=ctxs)
    torch.cuda.synchronize()
    launches = counts()
    log("slice", launches=launches)
    check(launches["attention_fwd"] > 0, "the slice never launched K1")
    check(launches["catalog_topk_f32"] > 0, "the slice never launched K3")

    index_set = set(seen_ids.tolist())
    want_k = [K, K, 25, K, K, K, None, 3]
    hists = [history(host, 0)[0], history(host, 5)[0], history(host, 17)[0],
             history(host, 3)[0], history(host, 3)[0], list(range(1, 90)), None,
             history(host, N_USERS - 1)[0]]
    for resp, wk, hist in zip(responses, want_k, hists):
        if wk is None:
            check("error" in resp, "the malformed line must answer an error")
            continue
        check_response(resp, wk, index_set.__contains__, hist)
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
# phase 5c: the >=1M-row serving slice (10M items, int8 index)
# --------------------------------------------------------------------------

def stage1_queries(rec, hists, ctxs):
    """The retrieval queries [B, d] that recommend computes for hists."""
    p_x, p_c, _ = rec._inputs(hists, ctxs, None)
    with torch.inference_mode():
        p_e, _ = encode_profile(rec.model, (p_x, None, p_c), attrs_table=rec.attrs)
        return query_from_encoded(p_e, rec.cfg)[:len(hists)].contiguous()


def phase_slice_10m():
    """The beauty preset over 10,000,000 item ids with quantize="auto" (an
    int8 index). Returns (recommender, host, launches, catalog)."""
    t0 = time.perf_counter()
    cat = synthetic_catalog(n_users=N_USERS, n_real_items=N_REAL_ITEMS_10M, seed=SEED)
    host = HostCSR(cat)
    cfg = preset("beauty", n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx).model
    model = CARCA(cfg, generator=torch.Generator().manual_seed(SEED), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    rec = Recommender(model, cat.attrs, shortlist=SHORTLIST, batch_buckets=BUCKETS,
                      quantize="auto")
    check(isinstance(rec.catalog_emb, QuantizedIndex), "quantize='auto' kept a float index")
    check(rec.catalog_emb.rows == cat.n_items, "10M index shape")
    build_peak = torch.cuda.max_memory_allocated() / 2**20
    rec.warmup(k=K)
    torch.cuda.synchronize()
    methods = {bb: rt.resolve_method("auto", cat.n_items, KK, bb) for bb in BUCKETS}
    log("slice_10m", setup_s=time.perf_counter() - t0, n_items=cat.n_items,
        n_events=int(len(cat.items)), index="int8", index_rows=rec.catalog_emb.rows,
        index_mib=(rec.catalog_emb.qvals.numel() + 4 * rec.catalog_emb.rows) / 2**20,
        stage1_method=methods, build_peak_device_mib=build_peak,
        device_mib=torch.cuda.memory_allocated() / 2**20)

    lines = request_lines(cat, host)
    reqs = bucket_requests(host, SEED + 3)
    reset_counts()
    responses = list(serve_lines(rec, host, lines, k=K))
    got = {bb: rec.recommend(hists, k=K, ctxs=ctxs) for bb, (hists, ctxs) in reqs.items()}
    torch.cuda.synchronize()
    launches = counts()
    log("slice_10m", launches=launches)
    check(launches["attention_fwd"] > 0, "the 10M slice never launched K1")
    if "tournament" in methods.values():
        check(launches["groupmax_layout0"] > 0, "the 10M slice never launched K4")
        check(launches["tournament_rerank"] > 0, "the 10M slice never launched the rerank")
    if "stream" in methods.values():
        check(launches["catalog_topk_int8"] > 0, "the 10M slice never launched K3 (int8)")

    want_k = [K, K, 25, K, K, K, None, 3]
    hists = [history(host, 0)[0], history(host, 5)[0], history(host, 17)[0],
             history(host, 3)[0], history(host, 3)[0], list(range(1, 90)), None,
             history(host, N_USERS - 1)[0]]
    for resp, wk, hist in zip(responses, want_k, hists):
        if wk is None:
            check("error" in resp, "the malformed line must answer an error")
            continue
        check_response(resp, wk, lambda i: 0 < i < cat.n_items, hist)
    for bb, (ids, sc) in got.items():
        check(ids.shape == (bb, K) and bool(np.isfinite(sc).all()),
              f"10M bucket {bb}: shape {ids.shape} or non-finite scores")

    # stage 1 alone at 10M rows against the card's plain version, at served buckets
    for bb in STAGE1_BUCKETS:
        q = stage1_queries(rec, *reqs[bb])
        with torch.no_grad():
            v, i = catalog_topk(q, rec.catalog_emb, KK, n_items=cat.n_items)
            pv, pi = catalog_topk_plain(q, rec.catalog_emb, KK, n_items=cat.n_items)
        torch.cuda.synchronize()
        err, swapped = compare_within_order_tol(v, i, pv, pi, q, rec.catalog_emb)
        log("slice_10m", case=f"stage 1, bucket {bb} x 10M rows k={KK}, {methods[bb]} vs plain",
            tol=f"{SCORE_ORDER_TOL} * sum|q e|", near_tie_slots=swapped, max_abs_err=err)
        del v, i, pv, pi

    # the same requests, the same weights, the CPU plain path
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    rec_cpu = Recommender(cpu_model, cat.attrs, shortlist=SHORTLIST, batch_buckets=BUCKETS,
                          quantize="auto")
    near_ties = 0
    for resp, cpu_resp in zip(responses, serve_lines(rec_cpu, host, lines, k=K)):
        if "error" in resp:
            check("error" in cpu_resp, "CPU path answered a malformed line")
            continue
        near_ties += compare(f"10M request {resp['id']}", resp["items"], resp["scores"],
                             cpu_resp["items"], cpu_resp["scores"])
    for bb in (1, 8):  # the plain 10M stage 1 is slow on the host; 1 and 8 cover it
        cids, csc = rec_cpu.recommend(reqs[bb][0], k=K, ctxs=reqs[bb][1])
        near_ties += compare(f"10M bucket {bb}", *got[bb], cids, csc)
    log("slice_10m", cpu_agreement="ok", near_tie_slots=near_ties,
        cpu_seconds=time.perf_counter() - t0)
    del rec_cpu, cpu_model
    return rec, host, launches, cat


# --------------------------------------------------------------------------
# phase 5d: the retrieval bench path at 10M rows (bf16 and int8 indexes)
# --------------------------------------------------------------------------

def phase_bench_10m(card):
    """carca_tpu_torch.bench_retrieval at 10M items, --kernel_only (a bf16
    float index and an int8 index; stream, tournament and "auto" legs) with
    the recursive stage 2 forced: the path that runs K3 over bf16 and int8
    rows and K4 in its query-major layout."""
    args = argparse.Namespace(items=BENCH_ITEMS, attrs=32, batch=B, k=K, d=D, seq_len=L,
                              steps=3, kernel_only=True, sweep=False)
    old = rt._RECURSIVE_MIN_GROUPS
    rt._RECURSIVE_MIN_GROUPS = 1
    reset_counts()
    try:
        out = bench_retrieval.run(args)
    finally:
        rt._RECURSIVE_MIN_GROUPS = old
    torch.cuda.synchronize()
    launches = counts()
    log("bench_10m", card=card, recursive_stage2=True, launches=launches, **out)
    for name in ("catalog_topk_bf16", "catalog_topk_int8", "groupmax_layout1"):
        check(launches[name] > 0, f"the 10M bench path never launched {name}")
    return launches


def timing_10m(card, rec, host, cat):
    """recommend per bucket over the int8 index against the f32 index, and
    K3 (bf16, int8), K4 (both layouts, B = 256 and 1) and the rerank checked
    against and timed beside their plain versions at the slice's shapes, K3's
    scratch, with peak device memory.
    Returns (timings, {kernel: max |error|})."""
    timings, errs = {}, {}
    for row in run_bench(rec, host, k=K, iters=30):
        log("timing_10m", card=card, index="int8", **row)
    rec_f32 = Recommender(rec.model, cat.attrs, shortlist=SHORTLIST, batch_buckets=BUCKETS,
                          quantize=False)
    for row in run_bench(rec_f32, host, k=K, iters=30):
        log("timing_10m", card=card, index="f32", **row)
    e32 = rec_f32.catalog_emb
    del rec_f32
    qi = rec.catalog_emb
    n = cat.n_items
    hists, ctxs = bucket_requests(host, SEED + 4)[256]
    q = stage1_queries(rec, hists, ctxs)  # [256, 64]
    with torch.no_grad():
        for bb in (B, 1):
            qb = q[:bb].contiguous()
            for layout in (0, 1):
                got, err = check_groupmax(f"layout {layout} at [{bb},{D}] x {n} int8 rows", qb,
                                          qi.qvals, qi.scales, n, True, layout)
                del got
                ms, plain = kernel_vs_plain(
                    lambda: groupmax(qb, qi.qvals, qi.scales, n, True, layout),
                    lambda: groupmax_plain(qb, qi.qvals, qi.scales, n, True, layout),
                    reps=20, plain_reps=2)
                if bb == B:
                    errs["K4", layout] = err
                    timings["K4", layout] = (ms, plain)
                log("timing", card=card, kernel="K4 groupmax", layout=layout,
                    shape=f"[{bb},{D}] x {n} int8 rows", max_abs_err=err, ms=ms, plain_ms=plain)
        # the rerank at bucket 256, k = 562: the k + 8 best groups by K4
        gm = groupmax(q, qi.qvals, qi.scales, n, True, 0)
        kg = KK + 8
        gi = torch.sort(gm.t(), dim=1, descending=True, stable=True).indices[:, :kg]
        gi = gi.sort(dim=1).values.contiguous()
        errs["rerank"] = check_rerank(f"bucket {B} k={KK} at {n} int8 rows", q, qi.qvals,
                                      qi.scales, gi, n, True, torch.gather(gm.t(), 1, gi))
        del gm
        ms, plain = kernel_vs_plain(
            lambda: tournament_rerank(q, qi.qvals, qi.scales, gi, n, True),
            lambda: tournament_rerank_plain(q, qi.qvals, qi.scales, gi, n, True),
            reps=20, plain_reps=2)
        timings["rerank"] = (ms, plain)
        log("timing", card=card, kernel="tournament_rerank", shape=f"[{B},{D}] x {kg} groups "
            f"x {GROUP} int8 rows", group_maxima_bit_equal_to_K4=True,
            max_abs_err=errs["rerank"], ms=ms, plain_ms=plain)
        q32 = q[:K3_10M_B].contiguous()
        for kind, idx in (("bf16", e32.to(torch.bfloat16)), ("int8", qi)):
            v, i = catalog_topk(q32, idx, K, n_items=n, method="stream")
            pv, pi = catalog_topk_plain(q32, idx, K, n_items=n)
            torch.cuda.synchronize()
            errs["K3", kind], swapped = compare_within_order_tol(v, i, pv, pi, q32, idx)
            ms, plain = kernel_vs_plain(
                lambda: catalog_topk(q32, idx, K, n_items=n, method="stream"),
                lambda: catalog_topk_plain(q32, idx, K, n_items=n), reps=5, plain_reps=2)
            timings["K3", kind] = (ms, plain)
            log("timing", card=card, kernel=f"K3 catalog_topk {kind}",
                shape=f"[{K3_10M_B},{D}] x {n} rows k={K}", near_tie_slots=swapped,
                max_abs_err=errs["K3", kind], ms=ms, plain_ms=plain)
        del e32
        torch.cuda.synchronize()
        for k in (K, KK):
            plan = stream_plan(k, B, n, D, 1)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_ms(lambda: catalog_topk(q, qi, k, n_items=n, method="stream"), 3)
            peak = torch.cuda.max_memory_allocated() - base
            check(plan.scratch_bytes <= K3_SCRATCH_LIMIT,
                  f"K3 scratch {plan.scratch_bytes} bytes at {n} rows, B = {B}, k = {k}")
            log("timing", card=card, kernel="K3 catalog_topk int8",
                shape=f"[{B},{D}] x {n} rows k={k}", ms=ms, plan=plan._asdict(),
                scratch_mib=plan.scratch_bytes / 2**20, call_peak_mib=peak / 2**20)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: catalog_topk(q, qi, k, n_items=n, method="tournament"), 3)
            log("timing", card=card, path="tournament (K4 + stages 2-3) int8",
                shape=f"[{B},{D}] x {n} rows k={k}", ms=ms,
                peak_extra_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
    log("timing_10m", card=card, peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
    return timings, errs


# --------------------------------------------------------------------------
# phase 6: timing
# --------------------------------------------------------------------------

def phase_timing(card, rec, rec_full, host):
    for name, r in (("seen", rec), ("full", rec_full)):
        for row in run_bench(r, host, k=K, iters=30):
            log("timing", card=card, index=name, **row)
    timings = {}
    with torch.no_grad():
        # the serving encoder's call, without dropout
        q, k, v, qm, km = k1_inputs(L, L, 30)
        kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H)
        ms, plain = kernel_vs_plain(lambda: fused_attention(q, k, v, qm, km, **kw),
                                    lambda: masked_attention(q, k, v, qm, km, **kw))
        log("timing", card=card, kernel="K1 attention_fwd", shape="encoder [256,50,64] causal 0",
            ms=ms, plain_ms=plain)
        # the timed shapes, with the train step's weight dropout where it has
        # one: the plain version draws its mask from a device generator, as
        # the plain path does
        for name, (b, lq, lk, causal, rate) in ATTN_SHAPES.items():
            q, k, v, qm, km = k1_inputs(lq, lk, 32, b=b)
            kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=rate)
            seeds = torch.Generator().manual_seed(0)
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            ms, plain = kernel_vs_plain(
                lambda: fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw),
                lambda: masked_attention(q, k, v, qm, km, train=rate > 0, generator=gen, **kw))
            timings["K1", name] = (ms, plain)
            log("timing", card=card, kernel="K1 attention_fwd", shape=f"{name} [{b},{lq},{D}] x "
                f"[{b},{lk},{D}] causal {causal} dropout {rate}", ms=ms, plain_ms=plain)
        for name, e in (("seen", rec.catalog_emb), ("full", rec_full.catalog_emb)):
            q = torch.randn(B, D, generator=torch.Generator().manual_seed(31)).to(DEVICE)
            ms, plain = kernel_vs_plain(lambda: catalog_topk(q, e, KK, method="stream"),
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
    """Returns {kernel: launches} of the 64-step run."""
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
    reset_counts()
    losses = []
    for i in range(TRAIN_CALLS):
        s.state, k_losses = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[i % len(s.chunks)])
        losses.append(k_losses)
    torch.cuda.synchronize()
    launches = counts()
    losses = torch.cat(losses).cpu()
    log("train", case="flagship dropout 0.5", steps=len(losses), launches=launches,
        first_8=losses[:8].tolist(), last_8=losses[-8:].tolist())
    check(launches["attention_fwd"] > 0, "the train step never launched K1")
    check(launches["attention_bwd"] > 0, "the train step never launched K2")
    check(bool(torch.isfinite(losses).all()), "a non-finite training loss")
    check(losses[-8:].mean() < losses[:8].mean(),
          f"the loss did not fall: first 8 mean {losses[:8].mean()}, "
          f"last 8 mean {losses[-8:].mean()}")

    # the plain path's rate here; the kernels' comes from `python -m
    # carca_tpu_torch.bench` (bench_utilisation), in the same call
    plain = bench.build_setup("flagship", 256, DEVICE, use_kernel=False)
    torch.cuda.reset_peak_memory_stats()
    r = bench.measure(plain)
    log("train", card=card, metric="train_examples_per_sec_flagship", use_kernel=False,
        median=statistics.median(r), min=min(r), max=max(r), windows=r,
        calls_per_window=max(1, 100 // plain.inner), inner_steps=plain.inner,
        batch=plain.tc.batch_size, peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
    if profile_run:
        profile_train(card, plain, False)
        profile_train(card, s, "auto")
    del plain
    bench_utilisation(card)
    return launches


def check_utilisation(line: dict, what: str) -> None:
    """``bench``'s utilisation keys present and in (0, 1.05]."""
    for key in ("mfu", "hbm_bw_util"):
        check(key in line and 0.0 < line[key] <= 1.05, f"{what}: {key} = {line.get(key)} not in "
                                                       f"(0, 1.05] ({line})")
    check(line["hbm_gbps"] > 0, f"{what}: hbm_gbps {line['hbm_gbps']}")


# K1's, K2's dQ and K2's dK/dV device kernels by their names in a trace,
# demangled (rows_kernel<kDh, kBf16, kBwd>) or mangled
K1_K2_KERNELS = {"K1": re.compile(r"rows_kernel(<\d+, (true|false), false>|ILi\d+ELb[01]ELb0E)"),
                 "K2 dQ": re.compile(r"rows_kernel(<\d+, (true|false), true>|ILi\d+ELb[01]ELb1E)"),
                 "K2 dK/dV": re.compile(r"dkv_kernel")}


def bench_utilisation(card) -> None:
    """`python -m carca_tpu_torch.bench` (flagship, the kernels' ex/s): its
    mfu and hbm_bw_util in (0, 1.05]; then `python -m
    carca_tpu_torch.profile_step --config flagship` once: its table names
    K1's and K2's kernels."""
    line = json.loads(run_module("carca_tpu_torch.bench", ["--config", "flagship"],
                                 600).strip().splitlines()[-1])
    log("train", card=card, case="python -m carca_tpu_torch.bench", **line)
    check_utilisation(line, "bench flagship")
    out = run_module("carca_tpu_torch.profile_step", ["--config", "flagship", "--top", "60"], 600)
    rows = [ln for ln in out.splitlines() if ln and not ln.startswith("#")][1:]
    found = {k: [ln.split(None, 3)[3] for ln in rows if pat.search(ln)]
             for k, pat in K1_K2_KERNELS.items()}
    log("profile_step", card=card, config="flagship", head=out.splitlines()[:12],
        summary=[ln for ln in out.splitlines() if ln.startswith("# wall")], kernels=found)
    check(all(found.values()), f"profile_step's table does not name K1's and K2's kernels: {found}")


# --------------------------------------------------------------------------
# phase 9: fit and serve through the entry points
# --------------------------------------------------------------------------

def run_module(module, args, timeout, stdin_text=None, with_stderr=False):
    """``python -m module args`` from the repository root; its stdout (and
    its stderr, ``with_stderr``). Fails on a non-zero exit."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, input=stdin_text,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0, f"python -m {module} {' '.join(args[:6])} ... exited "
                                f"{proc.returncode}")
    return (proc.stdout, proc.stderr) if with_stderr else proc.stdout


def fit_run(card, data_dir, out_dir, seed) -> dict:
    """One `python -m carca_tpu_torch.cli` run of the beauty preset over the
    reference files in data_dir, on the device pipeline; its checks and
    numbers."""
    t0 = time.perf_counter()
    out = run_module("carca_tpu_torch.cli", [
        "--preset", "beauty", "--data_dir", data_dir, "--profile_file", "profiles.txt",
        "--attr_file", "attrs.pkl", "--ctx_file", "ctx.pkl", "--device_pipeline", "true",
        "--epochs", str(FIT_EPOCHS), "--early_stop", str(FIT_EARLY_STOP), "--resume", "false",
        "--out_dir", out_dir, "--seed", str(seed)], FIT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    final = ast.literal_eval(next(ln for ln in lines if ln.startswith("final: "))[7:])
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[10:])
    with open(os.path.join(out_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    for name in ("args.json", "metrics.jsonl", "ckpt/best/params.pt", "ckpt/best/metrics.json",
                 "ckpt/latest/state.pt"):
        check(os.path.exists(os.path.join(out_dir, name)), f"{out_dir}: no {name}")
    check(len(glob.glob(os.path.join(out_dir, "*.csv"))) == 1, f"{out_dir}: no CSV log")
    check(launches["attention_fwd"] > 0 and launches["attention_bwd"] > 0,
          f"{out_dir}: the fit did not run K1 and K2 ({launches})")
    summary = {"seed": seed, "device_pipeline": True,
               "epochs_run": final["epochs_run"], "best_epoch": max(rows, key=lambda r: r[
                   "val_ndcg"])["epoch"],
               "test_hr10": final["test_hr"], "test_ndcg10": final["test_ndcg"],
               "val_hr10": final["val_hr"], "val_ndcg10": final["val_ndcg"],
               "median_examples_per_sec": statistics.median(r["examples_per_sec"] for r in rows),
               "median_epoch_seconds": statistics.median(r["epoch_seconds"] for r in rows),
               "median_val_candidates_per_sec": statistics.median(r["candidates_per_sec"]
                                                                  for r in rows),
               "wall_s": wall, "launches": launches}
    log("fit", card=card, run=os.path.basename(out_dir), **summary)
    check(final["test_hr"] >= FIT_HR_FLOOR and final["test_ndcg"] >= FIT_NDCG_FLOOR,
          f"{out_dir}: test HR@10 {final['test_hr']} / NDCG@10 {final['test_ndcg']} below "
          f"{FIT_HR_FLOOR} / {FIT_NDCG_FLOOR}")
    return summary


def serve_requests(host):
    """~20 request lines: catalog users, explicit histories (with and
    without their contexts), a request context, a k override, id echoes, a
    user out of range and a malformed line."""
    rng = np.random.default_rng(SEED + 9)
    lines = [json.dumps({"user": int(u), "id": f"user {u}"})
             for u in rng.integers(0, host.n_users, size=8)]
    for u in rng.integers(0, host.n_users, size=4):
        hist, ctx = history(host, int(u))
        lines.append(json.dumps({"history": hist, "id": f"history {u}"}))
        lines.append(json.dumps({"history": hist, "ctx": ctx.tolist(), "k": 5}))
    lines += [json.dumps({"user": 11, "k": 25, "id": "k-override"}),
              json.dumps({"history": [3, 1, 2], "request_ctx": rng.standard_normal(
                  host.ctx_vals.shape[1]).tolist(), "id": "request_ctx"}),
              json.dumps({"user": host.n_users, "id": "out of range"}),
              "{not json"]
    return lines


def served_equal(tag, lines, served, mine) -> int:
    """The service's answers (``served``) against an in-process
    recommender's (``mine``) to the same request ``lines``: the same ids
    (but for near-ties), scores within SERVE_SCORE_TOL, and exactly the
    out-of-range user and the malformed line answered with an error.
    Returns the near-tie slots."""
    check(len(served) == len(lines), f"{tag}: {len(served)} responses to {len(lines)} requests")
    near_ties = 0
    for line, got, want in zip(lines, served, mine):
        check(got.get("id") == want.get("id"), f"{tag}: response ids differ: {got} vs {want}")
        if "error" in want:
            check("error" in got, f"{tag}: the service answered {line!r}: {got}")
            continue
        check("error" not in got and len(got["items"]) > 0, f"{tag}: {line!r}: {got}")
        near_ties += compare(f"{tag} {got.get('id')}", got["items"], got["scores"],
                             want["items"], want["scores"], score_tol=SERVE_SCORE_TOL)
    errors = sum("error" in r for r in served)
    check(errors == 2, f"{tag}: {errors} error answers; want the out-of-range user and the "
                       "malformed line")
    return near_ties


def serve_vs_cpu_plain(run_dir, cat, host, lines, served, tag="fit_serve") -> None:
    """The service's answers against the CPU plain path's (K1 and K3 off):
    load_recommender on the CPU, the same requests."""
    rec_cpu = load_recommender(run_dir, cat.attrs, which="best", device="cpu",
                               index_ids=np.unique(host.items))
    near_ties = 0
    for got, want in zip(served, serve_lines(rec_cpu, host, lines, k=K)):
        check(("error" in got) == ("error" in want), f"CPU plain path: {got} vs {want}")
        if "error" not in want:
            near_ties += compare(f"service {got.get('id')} vs the CPU plain path", got["items"],
                                 got["scores"], want["items"], want["scores"])
    log(tag, cpu_plain_agreement="ok", near_tie_slots=near_ties, score_tol=SLICE_SCORE_TOL)


def eval_kernel_vs_plain(run_dir, cat, tag="fit_serve") -> None:
    """One val batch of the run's best checkpoint through make_eval_step,
    with the kernels and with the plain path on the card: HR and NDCG sums
    equal, loss within TRAIN_LOSS_TOL; K1 launched at the eval decoder's
    shape by the first only."""
    cfg = config_from_run_dir(run_dir)
    mc = cfg.model
    check(mc.use_kernel is not False, f"{run_dir} trained without the kernels")
    builder = BatchBuilder(cat, mc.seq_len, mc.target_len, test=cfg.train.test)
    batch = builder.eval_batch(builder.users("val")[:B], np.random.default_rng(SEED), "val")
    n_valid = int(batch.pop("n_valid"))
    batch = to_device(batch, DEVICE)
    attrs = torch.as_tensor(cat.attrs, dtype=torch.float32, device=DEVICE)
    step = make_eval_step(mc, cfg.train.top_k)
    eval_key = (mc.target_len + 1, mc.seq_len, None)
    out = {}
    for use_kernel in (mc.use_kernel, False):
        model = CARCA(dataclasses.replace(mc, use_kernel=use_kernel), device=DEVICE)
        CheckpointKeeper(os.path.join(run_dir, "ckpt")).restore_best(model)
        before = fused_attention.launches_by_shape.get(eval_key, 0), fused_attention.launches
        out[use_kernel] = [float(x) for x in step(model, attrs, batch)]
        after = fused_attention.launches_by_shape.get(eval_key, 0), fused_attention.launches
        if use_kernel is False:
            check(after == before, f"the plain eval launched K1: {before} -> {after}")
        else:
            check(after[0] > before[0], f"the eval did not launch K1 at {eval_key}")
    (hr, ndcg, loss), (hr_p, ndcg_p, loss_p) = out[mc.use_kernel], out[False]
    loss_err = abs(loss - loss_p) / abs(loss_p)
    log(tag, eval_batch=n_valid, hr_sum=hr, ndcg_sum=ndcg, loss=loss,
        plain_hr_sum=hr_p, plain_ndcg_sum=ndcg_p, plain_loss=loss_p, loss_rel_err=loss_err,
        tol=TRAIN_LOSS_TOL)
    check(hr == hr_p and ndcg == ndcg_p, f"eval with the kernels HR/NDCG {hr}/{ndcg}, plain "
                                         f"{hr_p}/{ndcg_p}")
    check(loss_err <= TRAIN_LOSS_TOL, f"eval loss {loss} vs plain {loss_p}")


def phase_fit_serve(card):
    """Phase 9. Returns the runs' summaries, the in-process serving check's
    launches and K3's worst error at the serving shapes."""
    tmp = tempfile.mkdtemp(prefix="carca_fit_")
    try:
        data_dir = os.path.join(tmp, "data")
        cat = synthetic_catalog(n_users=FIT_USERS, n_real_items=FIT_ITEMS, seed=SEED)
        write_reference_format(cat, data_dir)
        run_s0 = os.path.join(tmp, "run_s0")
        runs = {"run_s0": fit_run(card, data_dir, run_s0, SEED)}
        files = ["--data_dir", data_dir, "--profile_file", "profiles.txt", "--attr_file",
                 "attrs.pkl", "--ctx_file", "ctx.pkl"]
        cat = load_dataset(data_dir, "profiles.txt", "attrs.pkl", "ctx.pkl")
        host = HostCSR(cat)
        lines = serve_requests(host)
        t0 = time.perf_counter()
        out = run_module("carca_tpu_torch.serve.service",
                         ["--run_dir", run_s0, *files, "--k", str(K)], 300,
                         stdin_text="\n".join(lines) + "\n")
        served = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
        serve_s = time.perf_counter() - t0
        bench = [json.loads(ln) for ln in run_module(
            "carca_tpu_torch.serve.service",
            ["--run_dir", run_s0, *files, "--k", str(K), "--bench", "--iters",
             str(SERVE_BENCH_ITERS)], 300).splitlines() if ln.startswith("{")]
        for row in bench:
            log("fit_serve", card=card, bench=row)
        check([row["batch"] for row in bench] == list(BUCKETS), f"bench rows {bench}")

        reset_counts()
        rec = load_recommender(run_s0, cat.attrs, which="best", index_ids=np.unique(host.items))
        mine = list(serve_lines(rec, host, lines, k=K))
        torch.cuda.synchronize()
        launches = counts()
        check(launches["attention_fwd"] > 0 and launches["catalog_topk_f32"] > 0,
              f"the in-process Recommender did not run K1 and K3: {launches}")
        near_ties = served_equal("service", lines, served, mine)
        log("fit_serve", card=card, requests=len(lines), errors=2, near_tie_slots=near_ties,
            serve_wall_s=serve_s, equal_to_in_process=True, launches=launches,
            example=served[0])
        serve_vs_cpu_plain(run_s0, cat, host, lines, served)
        k3_err = max(k3_case(f"f32 fit run's seen index ({rec.catalog_emb.shape[0]:,} rows) "
                             f"bucket {bb} k={KK}", stage1_queries(rec, *reqs), rec.catalog_emb,
                             KK, n_items=rec.catalog_emb.shape[0])[0]
                     for bb, reqs in bucket_requests(host, SEED + 10).items())
        eval_kernel_vs_plain(run_s0, cat)
        return runs, launches, k3_err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 10: the synthetic10m preset on the card
# --------------------------------------------------------------------------

def sparse_vs_dense_step(card, cat) -> dict:
    """One train step of the 10M preset at dropout 0 from the same weights
    and batch, with the row-sparse item Adam and with the dense Adam: equal
    losses, first-touch rows within SPARSE_DENSE_TOL and their first moments
    within SPARSE_DENSE_MOMENT_RTOL/ATOL, untouched rows (and
    the sparse step's untouched moments) bit-equal to the start, the pad
    row zero; then each step's time on that batch."""
    cfg = preset("synthetic10m", cat.n_items, cat.n_attrs, cat.n_ctx)
    mc, tc = dataclasses.replace(cfg.model, dropout=0.0), cfg.train
    check(sparse_adam.resolve(Config(mc, cfg.data, tc)),
          "the synthetic10m preset must resolve the row-sparse Adam on")
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device=DEVICE)
    attrs = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc), device=DEVICE)
    sparse = create_train_state(mc, tc, DEVICE, sparse_items=True)
    dense = create_train_state(mc, tc, DEVICE, model=copy.deepcopy(sparse.model))
    table0 = sparse.model.embed.items.detach().clone()
    rows = torch.as_tensor(dd.users("train")[:tc.batch_size], device=DEVICE)
    batch = assemble_train(dd.arrays, mc.seq_len, mc.n_items, rows,
                           torch.Generator(device=DEVICE).manual_seed(SEED))

    def dense_step():
        return apply_gradients(dense, lambda: train_loss_terms(
            dense.model, batch, attrs, generator=dense.generator,
            seed_generator=dense.seed_generator))

    def sparse_step():
        return _sparse_device_update(tc, sparse, batch, attrs)

    for st in (sparse, dense):
        st.model.train()
    loss_s, loss_d = sparse_step().item(), dense_step().item()
    ids = torch.unique(torch.cat([batch["p_x"].reshape(-1), batch["o_x"].reshape(-1)]).long())
    untouched = torch.ones(mc.n_items, dtype=torch.bool, device=DEVICE)
    untouched[ids] = False
    s_items, d_items = sparse.model.embed.items.detach(), dense.model.embed.items.detach()
    err = (s_items[ids] - d_items[ids]).abs().max().item()
    moments = dense.optimizer.state[dense.model.embed.items]
    mu_s, mu_d = sparse.items_state["munu"][ids, :D], moments["exp_avg"][ids]
    mu_err = (mu_s - mu_d).abs().max().item()
    check(abs(loss_s - loss_d) <= TRAIN_LOSS_TOL * abs(loss_d),
          f"10M step: sparse loss {loss_s} vs dense {loss_d}")
    check(err <= SPARSE_DENSE_TOL, f"10M step: first-touch rows differ by {err} > "
                                   f"{SPARSE_DENSE_TOL} between the sparse and the dense Adam")
    check(bool(((mu_s - mu_d).abs() <= SPARSE_DENSE_MOMENT_ATOL
                + SPARSE_DENSE_MOMENT_RTOL * mu_d.abs()).all()),
          f"10M step: first moments differ by {mu_err} between the sparse and the dense Adam "
          f"(tol {SPARSE_DENSE_MOMENT_RTOL} relative or {SPARSE_DENSE_MOMENT_ATOL})")
    check(torch.equal(s_items[untouched], table0[untouched])
          and torch.equal(d_items[untouched], table0[untouched]), "10M step: untouched rows moved")
    check(not bool(sparse.items_state["munu"][untouched].any()),
          "10M step: the moments of untouched rows changed")
    check(not bool(s_items[0].any()), "10M step: the pad row moved")

    def step_ms(step, n=10) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    times = {"dense_ms": step_ms(dense_step), "sparse_ms": step_ms(sparse_step),
             "dense_ms_again": step_ms(dense_step), "sparse_ms_again": step_ms(sparse_step)}
    out = {"loss_sparse": loss_s, "loss_dense": loss_d, "touched_rows": int(ids.numel()),
           "first_touch_max_abs_err": err, "first_moment_max_abs_err": mu_err,
           "tol": SPARSE_DENSE_TOL, "moment_rtol": SPARSE_DENSE_MOMENT_RTOL,
           "moment_atol": SPARSE_DENSE_MOMENT_ATOL, "untouched_bit_equal": True,
           "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20, **times}
    log("fit_10m", card=card, case="one step at dropout 0, sparse vs dense item Adam", **out)
    return out


def fit_10m_run(card, run) -> dict:
    """`python -m carca_tpu_torch.cli --preset synthetic10m` with per-epoch
    retrieval monitoring, retention on retrieval HR and the retrieval eval
    at the end; its gates and numbers."""
    t0 = time.perf_counter()
    out = run_module("carca_tpu_torch.cli", [
        "--preset", "synthetic10m", "--epochs", str(FIT10M_EPOCHS), "--eval_retrieval_every",
        "1", "--select_by", "retrieval_hr", "--eval_retrieval", str(K), "--resume", "false",
        "--out_dir", run], FIT10M_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    final = ast.literal_eval(next(ln for ln in lines if ln.startswith("final: "))[7:])
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[10:])
    memory = json.loads(next(ln for ln in lines if ln.startswith("memory: "))[8:])
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    for name in ("args.json", "ckpt/best/params.pt", "ckpt/best/metrics.json",
                 "ckpt/latest/state.pt"):
        check(os.path.exists(os.path.join(run, name)), f"{run}: no {name}")
    epochs = [r for r in rows if "train_loss" in r]
    curve = {r["epoch"]: r["retrieval_val_hr"] for r in rows if "retrieval_val_hr" in r}
    check(sorted(curve) == list(range(1, FIT10M_EPOCHS + 1)), f"retrieval curve {curve}")
    first_argmax = max(sorted(curve), key=lambda e: (curve[e], -e))
    with open(os.path.join(run, "ckpt", "best", "metrics.json")) as fh:
        best = json.load(fh)
    summary = {
        "epochs_run": final["epochs_run"], "retrieval_val_hr10": curve,
        "retrieval_val_ndcg10": {r["epoch"]: r["retrieval_val_ndcg"] for r in rows
                                 if "retrieval_val_ndcg" in r},
        "best_epoch": best["epoch"], "first_argmax_epoch": first_argmax,
        "test_hr10": final["test_hr"], "test_ndcg10": final["test_ndcg"],
        "val_hr10": [r["val_hr"] for r in epochs], "val_ndcg10": [r["val_ndcg"] for r in epochs],
        "retrieval_test_hr10": final["retrieval_test_hr"],
        "retrieval_test_ndcg10": final["retrieval_test_ndcg"],
        "examples_per_sec": [r["examples_per_sec"] for r in epochs],
        "epoch_seconds": [r["epoch_seconds"] for r in epochs],
        "train_loss": [r["train_loss"] for r in epochs],
        "peak_device_mib": memory["peak_device_mib"], "wall_s": wall, "launches": launches}
    log("fit_10m", card=card, run="cli --preset synthetic10m", **summary)
    check(curve[1] >= FIT10M_RETRIEVAL_FLOOR, f"retrieval val HR@10 after epoch 1 {curve[1]} "
                                              f"below {FIT10M_RETRIEVAL_FLOOR}")
    check(best["select_by"] == "retrieval_hr" and best["epoch"] == first_argmax,
          f"retained epoch {best['epoch']} is not the first argmax {first_argmax} of {curve}")
    check(final["test_hr"] >= FIT10M_SAMPLED_FLOOR,
          f"sampled test HR@10 {final['test_hr']} below {FIT10M_SAMPLED_FLOOR}")
    for name in ("attention_fwd", "attention_bwd", "catalog_topk_bf16"):
        check(launches[name] > 0, f"the 10M fit never launched {name}: {launches}")
    return summary


def eval_10m(card, run, cat):
    """best/ on the test split through evaluate_retrieval's evaluator, with
    the kernels (the eval's batch, every test user, launches counted) and
    then, on a subset, each batch with the kernels and with the plain top-k:
    the raw k + L lists within the summation-order tolerance
    (compare_within_order_tol), and HR sums that differ by at most the
    users with a differing id. Then each kernel timed beside its plain
    version at the eval's shapes. Returns (launches, errors, timings,
    metrics by case)."""
    cfg = config_from_run_dir(run)
    mc = cfg.model
    model = CARCA(mc, device=DEVICE)
    check(CheckpointKeeper(os.path.join(run, "ckpt")).restore_best(model) is not None,
          f"{run}: no best/")
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, test=cfg.train.test, device=DEVICE)
    launches, errs, timings, results = {}, {}, {}, {}
    for case, seen_only, quantized in EVAL10M_CASES:
        ev = RetrievalEvaluator(cfg, cat, mode="test", k=K, log=False, seen_only=seen_only,
                                quantized=quantized, device=DEVICE, dd=dd)
        reset_counts()
        t0 = time.perf_counter()
        metrics = ev(model)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches[case], results[case] = counts(), metrics
        emb = ev.index(model)
        n_local = emb.rows if quantized else emb.shape[0]
        kk = min(K + mc.seq_len, n_local)
        cmp_cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, eval_subsample=EVAL10M_CMP[case][0]),
            train=dataclasses.replace(cfg.train, batch_size=EVAL10M_CMP[case][1]))
        evc = RetrievalEvaluator(cmp_cfg, cat, mode="test", k=K, log=False, seen_only=seen_only,
                                 quantized=quantized, device=DEVICE, dd=dd)
        worst, near, tie_users, hr_k, hr_p, users = 0.0, 0, 0, 0.0, 0.0, 0
        for rows in evc.row_batches:
            q, ids_k, pos, alive = evc.batch(model, emb, rows, use_kernel=True)
            q = q.contiguous()
            ids_p = evc.batch(model, emb, rows, use_kernel=False)[1]
            with torch.no_grad():
                v, i = catalog_topk(q, emb, kk, n_items=n_local)
                pv, pi = catalog_topk_plain(q, emb, kk, n_items=n_local)
            err, swapped = compare_within_order_tol(v, i, pv, pi, q, emb)
            worst, near = max(worst, err), near + swapped
            ties = int(((i != pi).any(dim=1) & alive).sum())
            hk, hp = (retrieval_hr_ndcg(x, pos, K)[0].item() for x in (ids_k, ids_p))
            check(abs(hk - hp) <= ties, f"10M eval {case}: HR sums {hk} vs plain {hp} with "
                                        f"{ties} near-tie users")
            tie_users, hr_k, hr_p = tie_users + ties, hr_k + hk, hr_p + hp
            users += int(alive.sum())
        errs[case] = worst
        log("fit_10m", card=card, case=f"best/ test retrieval, {case}", index_rows=n_local,
            kk=kk, **metrics, main_path_s=main_s, launches=launches[case],
            compared_users=users, compared_batch=EVAL10M_CMP[case][1], max_abs_err=worst,
            tol=f"{SCORE_ORDER_TOL} * sum|q e|", near_tie_slots=near, near_tie_users=tie_users,
            hr_sum_kernels=hr_k, hr_sum_plain=hr_p)
        q = ev.batch(model, emb, ev.row_batches[0])[0].contiguous()  # the eval's [B, d] queries
        with torch.no_grad():
            if case == "full bf16":
                timings.update(time_tournament_10m(card, q, emb, kk, errs))
            else:
                timings[case] = kernel_vs_plain(
                    lambda: catalog_topk(q, emb, kk, n_items=n_local, method="stream"),
                    lambda: catalog_topk_plain(q, emb, kk, n_items=n_local), reps=20,
                    plain_reps=3)
                log("timing", card=card, kernel=f"K3 catalog_topk {case}",
                    shape=f"[{q.shape[0]},{D}] x {n_local} rows k={kk}", ms=timings[case][0],
                    plain_ms=timings[case][1])
        timings["rows", case] = n_local
        del emb
    return launches, errs, timings, results


def offline_eval_10m(card, run, fit, full_hr) -> dict:
    """12d: `python -m carca_tpu_torch.eval_retrieval_offline` over the 10M
    run. ``--which best`` must equal the fit's own test retrieval (the same
    parameters, seen index and users: K3 over bf16 rows); ``--full_index
    --quantized`` (K4 and the rerank over the 10M int8 rows) must lie in
    [0, 1] and within one user of the 10,000 of the unquantized full-index
    value ``full_hr``. Returns each run's line, launches and seconds."""
    out = {}
    for case, flags in (("best", []), ("best full int8", ["--full_index", "--quantized"])):
        t0 = time.perf_counter()
        stdout, stderr = run_module("carca_tpu_torch.eval_retrieval_offline",
                                    [run, "--which", "best", *flags], 600, with_stderr=True)
        line = json.loads(stdout.strip().splitlines()[-1])
        launches = json.loads(next(ln for ln in stderr.splitlines()
                                   if ln.startswith("launches: "))[10:])
        out[case] = {"line": line, "launches": launches, "wall_s": time.perf_counter() - t0}
        log("offline_eval_10m", card=card, case=case, flags=flags, **out[case])
    best, full = out["best"], out["best full int8"]
    check(best["line"]["epoch"] == fit["best_epoch"], f"offline eval epoch {best['line']}")
    check((best["line"]["retrieval_test_hr"], best["line"]["retrieval_test_ndcg"]) ==
          (fit["retrieval_test_hr10"], fit["retrieval_test_ndcg10"]),
          f"offline eval of best/ {best['line']} differs from the fit's test retrieval "
          f"{fit['retrieval_test_hr10']} / {fit['retrieval_test_ndcg10']}")
    check(best["launches"]["catalog_topk_bf16"] > 0,
          f"the offline eval of the seen index did not launch K3 bf16: {best['launches']}")
    hr = full["line"]["retrieval_test_hr"]
    check(0.0 <= hr <= 1.0 and abs(hr - full_hr) <= OFFLINE_INT8_HR_TOL,
          f"offline full int8 HR@10 {hr} vs the unquantized full index's {full_hr}")
    n = full["launches"]
    check(n["groupmax_layout0"] + n["groupmax_layout1"] > 0 and n["tournament_rerank"] > 0,
          f"the offline full int8 eval did not launch K4 and the rerank: {n}")
    return out


def time_tournament_10m(card, q, e, kk, errs) -> dict:
    """K4 (layout 0) and the rerank at the eval's [B, d] queries over the
    10M bf16 index: within the tolerance of their plain versions, the
    rerank's group maxima bit-equal to K4's, each timed beside its plain
    version."""
    n = e.shape[0]
    got, errs["K4 full bf16"] = check_groupmax(f"layout 0 at [{q.shape[0]},{D}] x {n} bf16 rows",
                                               q, e, None, n, True, 0)
    kg = kk + 8
    gi = torch.sort(got.t(), dim=1, descending=True, stable=True).indices[:, :kg]
    gi = gi.sort(dim=1).values.contiguous()
    errs["rerank full bf16"] = check_rerank(f"[{q.shape[0]},{D}] x {kg} groups of {n} bf16 rows",
                                            q, e, None, gi, n, True, torch.gather(got.t(), 1, gi))
    del got
    out = {"K4 full bf16": kernel_vs_plain(lambda: groupmax(q, e, None, n, True, 0),
                                           lambda: groupmax_plain(q, e, None, n, True, 0),
                                           reps=20, plain_reps=2),
           "rerank full bf16": kernel_vs_plain(
               lambda: tournament_rerank(q, e, None, gi, n, True),
               lambda: tournament_rerank_plain(q, e, None, gi, n, True), reps=20, plain_reps=2),
           "kg": kg, "unique_groups": int(torch.unique(gi).numel())}
    for name in ("K4 full bf16", "rerank full bf16"):
        log("timing", card=card, kernel=name, shape=f"[{q.shape[0]},{D}] x {n} bf16 rows, "
            f"{kg} groups", max_abs_err=errs[name], ms=out[name][0], plain_ms=out[name][1])
    return out


def attention_bf16(card) -> dict:
    """K1 and K2 at the 10M fit's encoder call under bf16 compute ([256,50,64]
    causal 0, weight dropout 0.5): K1 against the plain version fed its keep
    mask, K2 against autograd over it, each timed beside its plain version
    and F.scaled_dot_product_attention on bf16 tensors."""
    inputs = k1_inputs(L, L, 80)
    q, k, v, qm, km = inputs
    kw = dict(causal=0, scale=(D / H) ** 0.5, n_heads=H, compute_dtype="bfloat16",
              dropout_rate=P_DROP)
    keep = attention_keep_mask(
        int(torch.randint(SEED_LIMIT, (), generator=torch.Generator().manual_seed(3))),
        (B, H, L, L), P_DROP, DEVICE)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(81)).to(DEVICE)
    with torch.no_grad():
        got = fused_attention(q, k, v, qm, km, seed_generator=torch.Generator().manual_seed(3),
                              **kw)
        want = masked_attention(q, k, v, qm, km, keep_mask=keep, **kw)
    k1_err = (got - want).abs().max().item()
    check(k1_err <= K1_TOL_BF16, f"K1 bf16 at the 10M encoder: {k1_err} > {K1_TOL_BF16}")
    _, *grads = kernel_grads(inputs, g, 3, **kw)
    plain = attention_grads_plain(q, k, v, qm, km, g, keep_mask=keep, **kw)
    rel = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), grads, plain)}
    check(max(rel.values()) <= K2_TOL_BF16, f"K2 bf16 at the 10M encoder: {rel}")
    k2_err = max((a - w).abs().max().item() for a, w in zip(grads, plain))
    seeds, gen = torch.Generator().manual_seed(0), torch.Generator(device=DEVICE).manual_seed(0)
    with torch.no_grad():
        k1_ms = kernel_vs_plain(
            lambda: fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw),
            lambda: masked_attention(q, k, v, qm, km, train=True, generator=gen, **kw))
    k2_times = time_k2(card, "encoder [256,50,64] causal 0 bf16", inputs, g, 3, **kw)
    scale = (D / H) ** 0.5
    add = (torch.where(pair_mask(qm, km, 0) > 0, 0.0, NEG_MASK)[:, None] / scale).to(torch.bfloat16)

    def heads(x):
        return (x.to(torch.bfloat16).view(B, L, H, D // H).transpose(1, 2).contiguous()
                .requires_grad_())

    qh, kh, vh = heads(q), heads(k), heads(v)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=add, dropout_p=P_DROP,
                                              scale=1.0 / scale)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 20)
    out = sdpa()
    gh = torch.randn_like(out)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True), 20)
    res = {"k1_err": k1_err, "k2_err": k2_err, "k2_rel_err": rel, "K1": k1_ms,
           "K2": k2_times["bwd"], "lib_fwd": lib_fwd, "lib_bwd": lib_bwd}
    log("timing", card=card, kernel="K1/K2 bf16", shape="10M fit encoder [256,50,64] causal 0 "
        f"dropout {P_DROP}", **res)
    return res


def phase_fit_10m(card, profile_run=False) -> dict:
    """Phase 10. Returns what the kernels line needs: the fit's launches and
    the in-process evaluation's, errors and timings."""
    tmp = tempfile.mkdtemp(prefix="carca_fit10m_")
    try:
        t0 = time.perf_counter()
        cat = synthetic_catalog_device(FIT10M_USERS, FIT10M_ITEMS, seed=SEED, device=DEVICE)
        again = synthetic_catalog_device(FIT10M_USERS, FIT10M_ITEMS, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        for name in ("attrs", "items", "ctx_vals"):
            check(torch.equal(getattr(cat, name), getattr(again, name)),
                  f"the 10M catalog's {name} differ when regenerated")
        check(np.array_equal(cat.offsets, again.offsets), "the 10M catalog's offsets differ")
        del again
        log("fit_10m", card=card, catalog=f"synthetic_catalog_device({FIT10M_USERS}, "
            f"{FIT10M_ITEMS}, seed {SEED})", n_items=cat.n_items, events=int(cat.offsets[-1]),
            regenerated_bit_equal=True, both_generations_s=time.perf_counter() - t0)
        step = sparse_vs_dense_step(card, cat)
        torch.cuda.empty_cache()
        run = os.path.join(tmp, "run")
        fit = fit_10m_run(card, run)
        eval_launches, errs, timings, results = eval_10m(card, run, cat)
        torch.cuda.empty_cache()
        offline = offline_eval_10m(card, run, fit, results["full bf16"]["retrieval_test_hr"])
        serve_10m(card, run, cat)
        torch.cuda.empty_cache()
        bench10 = json.loads(run_module("carca_tpu_torch.bench", ["--config", "10m"],
                                        600).strip().splitlines()[-1])
        log("fit_10m", card=card, **bench10)
        check_utilisation(bench10, "bench 10m")
        if profile_run:
            setup = bench.build_setup("10m", B, DEVICE)
            profile_train(card, setup, "auto")
            del setup
        attn = attention_bf16(card)
        return {"fit": fit, "eval_launches": eval_launches, "errs": errs, "timings": timings,
                "attn": attn, "step": step, "bench": bench10, "offline": offline}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_10m(card, run, cat) -> None:
    """The service over the 10M run (its catalog regenerated on the card
    from args.json) on ~20 requests, against an in-process
    load_recommender over the catalog this process generated."""
    host = HostCSR(cat)
    lines = serve_requests(host)
    t0 = time.perf_counter()
    out = run_module("carca_tpu_torch.serve.service", ["--run_dir", run, "--k", str(K)], 600,
                     stdin_text="\n".join(lines) + "\n")
    serve_s = time.perf_counter() - t0
    served = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    rec = load_recommender(run, cat.attrs, which="best", device=DEVICE,
                           index_ids=np.unique(host.items))
    mine = list(serve_lines(rec, host, lines, k=K))
    near_ties = served_equal("10M service", lines, served, mine)
    index = rec.catalog_emb
    log("fit_10m", card=card, case="service over the 10M run", requests=len(lines),
        errors=2, near_tie_slots=near_ties, equal_to_in_process=True, serve_wall_s=serve_s,
        index_rows=index.rows if isinstance(index, QuantizedIndex) else index.shape[0],
        index_int8=isinstance(index, QuantizedIndex), example=served[0])


# --------------------------------------------------------------------------
# phase 7 (--profile): where the time of a recommend call goes
# --------------------------------------------------------------------------

def top_ms(trace, n: int = 8) -> list:
    """[name, ms per step] of the ``n`` heaviest device operations of a
    ``profile_step.device_trace`` summary."""
    return [[name[:70], us / 1e3] for name, us, _, _ in trace["table"][:n]]


def profile_train(card, s, use_kernel) -> None:
    """One traced call of the scanned train step (K steps)."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.state, _ = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[0])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    t = device_trace(run, s.inner)
    log("profile", card=card, path="train step", use_kernel=use_kernel, steps=s.inner,
        **{k: v for k, v in t.items() if k != "table"}, top_ms_per_step=top_ms(t))


def profile_attention(card, reps: int = 10) -> None:
    """Device µs per launch of each of K1/K2's device kernels (the keep-bits
    pre-pass, K1, K2's dQ and dK/dV passes) at ATTN_SHAPES: ``reps`` runs
    of K1, and of K2 where the shape trains, under torch.profiler, after a
    profiled warm-up step of as many runs (a trace of a few short launches
    alone lost some or all of them)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for name, (b, lq, lk, causal, rate) in ATTN_SHAPES.items():
        q, k, v, qm, km = k1_inputs(lq, lk, 34, b=b)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(35)).to(DEVICE)
        kw = dict(causal=causal, scale=(D / H) ** 0.5, n_heads=H, dropout_rate=rate)
        seeds = torch.Generator().manual_seed(0)

        def run():
            fused_attention(q, k, v, qm, km, seed_generator=seeds, **kw)
            if rate > 0:  # the shapes the train step differentiates
                attention_bwd(q, k, v, qm, km, g, seed=5, **kw)

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
                prof.step()
        per_kernel = {}
        for op, start, end in device_ops(prof):
            per_kernel.setdefault(op[:70], []).append(end - start)
        log("profile", card=card, path="attention kernels", shape=name, dropout=rate,
            us_per_launch={n: sum(ts) / len(ts) for n, ts in per_kernel.items()},
            launches={n: len(ts) for n, ts in per_kernel.items()})


def phase_profile(card, rec, host, index: str = "seen", calls: int = 10) -> None:
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

        t = device_trace(run, calls)  # a "step" here: one recommend call
        log("profile", card=card, index=index, batch=bb, calls=calls,
            wall_ms=t["wall_ms_per_step"], wall_profiled_ms=t["wall_profiled_ms_per_step"],
            device_busy_ms=t["device_busy_ms_per_step"], busy_share=t["busy_share"],
            device_ops_per_call=t["device_ops_per_step"], top_ms_per_call=top_ms(t))


def sdpa_ms(b, lq, lk, causal, rate, d=D) -> dict:
    """F.scaled_dot_product_attention beside K1 and K2, timed only (the port
    never calls it), forward and (with weight dropout, where the shape
    trains) backward, 2 heads, with the shape's causal offset. It takes the
    same additive mask; unlike the kernels it does not re-mask after the
    softmax, so a fully masked query row gets uniform weights instead of
    zeros, and it draws its own dropout bits. Returns {"fwd": ms, "bwd": ms
    or None}."""
    q, k, v, qm, km = k1_inputs(lq, lk, 33, b=b, d=d)
    scale = (d / H) ** 0.5
    add = torch.where(pair_mask(qm, km, causal) > 0, 0.0, NEG_MASK)[:, None] / scale

    def heads(x):
        return (x.view(x.shape[0], x.shape[1], H, d // H).transpose(1, 2).contiguous()
                .requires_grad_())

    qh, kh, vh = heads(q), heads(k), heads(v)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=add, dropout_p=rate,
                                              scale=1.0 / scale)

    with torch.no_grad():
        fwd = cuda_ms(sdpa, 20)
    bwd = None
    if rate > 0:  # the shapes the train step differentiates
        out = sdpa()
        g = torch.randn_like(out)
        bwd = cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True), 20)
    return {"fwd": fwd, "bwd": bwd}


def library_attention(card) -> dict:
    """``sdpa_ms`` at each of ATTN_SHAPES: {shape: {"fwd": ms, "bwd": ms or
    None}}."""
    out_ms = {}
    for name, (b, lq, lk, causal, rate) in ATTN_SHAPES.items():
        out_ms[name] = sdpa_ms(b, lq, lk, causal, rate)
        log("timing", card=card, library="F.scaled_dot_product_attention",
            shape=f"{name} [{b},{lq},{D}] x [{b},{lk},{D}] causal {causal} dropout {rate}",
            fwd_ms=out_ms[name]["fwd"], bwd_ms=out_ms[name]["bwd"])
    return out_ms


# --------------------------------------------------------------------------
# phase 11: more than one device (two ranks of torch.distributed on the card)
# --------------------------------------------------------------------------

MESH_RANKS = 2  # torchrun --nproc_per_node; ranks share cuda:0 over gloo on a one-card machine
MESH_TIMEOUT_S = 900
MESH_STEP_TOL, MESH_TINY_GRAD = 1e-5, 1e-6  # 11a: the first Adam step, as PR 7 found it
MESH_STEP_REPS = 10
# 11a: the --mesh 2 fit's best val NDCG on phase 9's data comes at epoch 5
# and early stop would run it to 25 over gloo; 15 epochs keep that best
MESH_FIT_EPOCHS = 15
# 11 sparse: two steps against one device; the loss and each moment tensor
# (normwise) within 1e-6 relative; table rows as 11a's rule
MESH_SPARSE_REL_TOL = 1e-6
SHARD_ROWS = (FIT10M_ITEMS + 1) // MESH_RANKS  # 11b: rows of one index block
LOOKUP_IDS = (B, 3 * L)  # 11b: a train step's profile and [pos, neg] ids
# 11b: the int8 scales of a row embedded on its rank against one device: the
# same item tower, its GEMMs over chunks of other sizes, so f32 sums of up to
# g = 256 terms in another order, which may differ by 256 * 2^-24 = 1.5e-5 of
# the sum of |terms|; 1e-4 of the row's max allows that sum up to 6.5 times
# the max (measured on an H100 at 10M items: 8.0e-6, one row a step off)
BLOCK_SCALE_RTOL = 1e-4


def run_ranks(args, timeout, stdin_text=None) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 args``
    from the repository root, in a session of its own, so that a timeout
    ends every rank with it; its stdout. A failed rank fails it."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MESH_RANKS), *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(stdin_text, timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError(f"check failed: torchrun {' '.join(args[:4])} ... timed out")
    if proc.returncode != 0:
        sys.stderr.write(out[-4000:] + err[-6000:])
    check(proc.returncode == 0, f"torchrun {' '.join(args[:4])} ... exited {proc.returncode}")
    return out


def rank_task(task: str, out_dir: str, *args) -> list:
    """This script's ``--rank_task`` under torchrun; each rank's JSON result."""
    run_ranks([os.path.abspath(__file__), "--rank_task", task, out_dir, *args], MESH_TIMEOUT_S)
    results = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"{task}.rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


def transport() -> str:
    n = torch.cuda.device_count()
    return (f"nccl ({MESH_RANKS} ranks on {n} cards)" if n >= MESH_RANKS
            else f"gloo ({MESH_RANKS} ranks share {n} card)")


def launches_line(out: str, key: str):
    return json.loads(next(ln for ln in out.splitlines() if ln.startswith(key + ": "))
                      [len(key) + 2:])


def sum_ranks(by_rank) -> dict:
    return {k: sum(int(r[k]) for r in by_rank) for k, v in by_rank[0].items()
            if not isinstance(v, dict)}


def mesh_fit_run(card, data_dir, run) -> dict:
    """11a: `torchrun ... -m carca_tpu_torch.cli --preset beauty --mesh 2`
    over phase 9's files, held to phase 9's gates, K1/K2 on both ranks."""
    t0 = time.perf_counter()
    out = run_ranks(["-m", "carca_tpu_torch.cli", "--preset", "beauty", "--data_dir", data_dir,
                     "--profile_file", "profiles.txt", "--attr_file", "attrs.pkl",
                     "--ctx_file", "ctx.pkl", "--device_pipeline", "true", "--epochs",
                     str(MESH_FIT_EPOCHS), "--early_stop", str(FIT_EARLY_STOP), "--resume", "false",
                     "--out_dir", run, "--seed", str(SEED), "--mesh", str(MESH_RANKS)],
                    MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    final = ast.literal_eval(next(ln for ln in out.splitlines() if ln.startswith("final: "))[7:])
    by_rank = launches_line(out, "launches_by_rank")
    memory = launches_line(out, "memory")
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    check(len(glob.glob(os.path.join(run, "*.csv"))) == 1, f"{run}: not one CSV log")
    check(len(rows) == final["epochs_run"], f"{run}: {len(rows)} metrics lines for "
                                            f"{final['epochs_run']} epochs")
    summary = {"mesh": f"{MESH_RANKS} (data)", "transport": transport(),
               "epochs_run": final["epochs_run"], "test_hr10": final["test_hr"],
               "test_ndcg10": final["test_ndcg"],
               "median_examples_per_sec": statistics.median(r["examples_per_sec"] for r in rows),
               "median_epoch_seconds": statistics.median(r["epoch_seconds"] for r in rows),
               "wall_s": wall, "peak_device_mib_by_rank": memory["by_rank"],
               "launches_by_rank": by_rank}
    log("mesh_fit", card=card, run="torchrun cli --preset beauty --mesh 2", **summary)
    check(final["test_hr"] >= FIT_HR_FLOOR and final["test_ndcg"] >= FIT_NDCG_FLOOR,
          f"--mesh 2: test HR@10 {final['test_hr']} / NDCG@10 {final['test_ndcg']} below "
          f"{FIT_HR_FLOOR} / {FIT_NDCG_FLOOR}")
    for r, n in enumerate(by_rank):
        check(n["attention_fwd"] > 0 and n["attention_bwd"] > 0,
              f"--mesh 2: rank {r} did not run K1 and K2 ({n})")
    return summary


def mesh_run_served(card, run, data_dir) -> None:
    """11a: the --mesh 2 run directory served on one device (the service,
    a subprocess) equals the in-process Recommender over it."""
    cat = load_dataset(data_dir, "profiles.txt", "attrs.pkl", "ctx.pkl")
    host = HostCSR(cat)
    lines = serve_requests(host)
    out = run_module("carca_tpu_torch.serve.service",
                     ["--run_dir", run, "--data_dir", data_dir, "--profile_file", "profiles.txt",
                      "--attr_file", "attrs.pkl", "--ctx_file", "ctx.pkl", "--k", str(K)], 300,
                     stdin_text="\n".join(lines) + "\n")
    served = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    rec = load_recommender(run, cat.attrs, which="best", index_ids=np.unique(host.items))
    near_ties = served_equal("mesh run served", lines, served,
                             list(serve_lines(rec, host, lines, k=K)))
    log("mesh_fit", card=card, case="the --mesh 2 run served on one device",
        requests=len(lines), near_tie_slots=near_ties, equal_to_in_process=True)


def attention_at(card, b, lq, lk, causal, d=D, train=True, where="rank-local") -> dict:
    """K1 and K2 at one shape of a path (weight dropout P_DROP where the
    path trains; an eval shape, ``train=False``, runs K1 alone without
    dropout), beside their plain versions and SDPA: times, and errors at
    dropout 0, held to phase 3's K1_TOL (elementwise) and K2_TOL
    (relative, per gradient)."""
    inputs = k1_inputs(lq, lk, 81, b=b, d=d)
    q, k, v, qm, km = inputs
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(82)).to(DEVICE)
    kw = dict(causal=causal, scale=(d / H) ** 0.5, n_heads=H)
    shape = f"{where} [{b},{lq},{d}] x [{b},{lk},{d}] causal {causal}"
    with torch.no_grad():
        out = fused_attention(q, k, v, qm, km, **kw)
        plain = masked_attention(q, k, v, qm, km, **kw)
    torch.testing.assert_close(out, plain, rtol=K1_TOL, atol=K1_TOL,
                               msg=lambda m: f"K1 {shape}: {m}")
    k1_err = (out - plain).abs().max().item()
    rate = P_DROP if train else 0.0
    seeds, gen = torch.Generator().manual_seed(0), torch.Generator(device=DEVICE).manual_seed(0)
    with torch.no_grad():
        k1 = kernel_vs_plain(
            lambda: fused_attention(q, k, v, qm, km, seed_generator=seeds, dropout_rate=rate,
                                    **kw),
            lambda: masked_attention(q, k, v, qm, km, train=train, generator=gen,
                                     dropout_rate=rate, **kw))
    res = {"k1": k1, "k1_err": k1_err, "lib": sdpa_ms(b, lq, lk, causal, rate, d=d)}
    if train:
        _, *grads = kernel_grads(inputs, g, 83, **kw)
        want = attention_grads_plain(q, k, v, qm, km, g, **kw)
        rel = {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), grads, want)}
        check(max(rel.values()) <= K2_TOL, f"K2 {shape}: relative errors {rel} > {K2_TOL}")
        res["k2_err"] = max((a - w).abs().max().item() for a, w in zip(grads, want))
        res["k2"] = time_k2(card, shape, inputs, g, 84, compute_dtype="float32",
                            dropout_rate=P_DROP, **kw)["bwd"]
    return res


def phase_mesh(card) -> dict:
    """Phase 11: the port over two ranks of torch.distributed on the card.
    11a, data parallel at the flagship width: one dropout-0 step of
    make_sharded_device_train_step against the one-device step, the
    row-sparse (and the dense 1x2) two-step checks, the beauty fit at
    --mesh 2 to phase 9's gates, its run served on one device. 11b, the
    synthetic10m preset at --mesh 1x2 with row-sharded tables and the
    row-sparse item Adam (one epoch), its latest/ resumed on one device,
    then on its run: the sharded lookup, the
    --index_shards 2 service over the full 10M int8 index against a
    one-shard recommender, and the shard-local K3/K4 results merged
    bit-equal to one device."""
    tmp = tempfile.mkdtemp(prefix="carca_mesh_")
    try:
        log("mesh", card=card, ranks=MESH_RANKS, transport=transport())
        t0 = time.perf_counter()
        step = rank_task("dp_step", tmp)
        log("mesh_step", card=card, transport=transport(), wall_s=time.perf_counter() - t0,
            **{k: v for k, v in step[0].items()
               if k not in ("launches", "collective_ms", "two_steps")},
            collective_ms_by_rank=[r["collective_ms"] for r in step],
            launches_by_rank=[r["launches"] for r in step],
            step_ms_by_rank=[r["step_ms"] for r in step])
        s0 = step[0]
        check(s0["ok"], f"--mesh 2 step against one device: loss relative error "
                        f"{s0['loss_rel_err']} (tol {MESH_STEP_TOL}), parameters "
                        f"{s0['param_err_where_grad_big']} where |g| > {MESH_TINY_GRAD} (tol "
                        f"{MESH_STEP_TOL}), {s0['param_err_max']} anywhere (tol 2 lr = "
                        f"{2 * s0['lr']})")
        sparse = [r["two_steps"] for r in step]
        s0 = sparse[0]
        log("mesh_sparse_step", card=card, transport=transport(),
            lo=s0["lo"], first_batch_at=s0["first_batch_at"],
            **{tag: {k: v for k, v in s0[tag].items() if k != "launches"}
               for tag in s0 if tag.startswith("mesh")},
            step_ms_by_rank={tag: [r[tag]["step_ms"] for r in sparse]
                             for tag in s0 if tag.startswith("mesh")},
            launches_by_rank={tag: [r[tag]["launches"] for r in sparse]
                              for tag in s0 if tag.startswith("mesh")})
        for tag in (t for t in s0 if t.startswith("mesh")):
            check(s0[tag]["ok"], f"{tag}: two steps against one device: {s0[tag]}")
        data_dir = os.path.join(tmp, "data")
        write_reference_format(synthetic_catalog(n_users=FIT_USERS, n_real_items=FIT_ITEMS,
                                                 seed=SEED), data_dir)
        run = os.path.join(tmp, "run_mesh2")
        fit = mesh_fit_run(card, data_dir, run)
        mesh_run_served(card, run, data_dir)
        attn = attention_at(card, B // MESH_RANKS, L, L, 0)
        torch.cuda.empty_cache()

        run10 = os.path.join(tmp, "run10m_mesh1x2")
        t0 = time.perf_counter()
        out = run_ranks(["-m", "carca_tpu_torch.cli", "--preset", "synthetic10m", "--mesh",
                         f"1x{MESH_RANKS}", "--shard_embeddings", "true", "--sparse_items_adam",
                         "true", "--epochs", "1", "--eval_retrieval_every", "1",
                         "--eval_retrieval", str(K), "--retrieval_index", "full", "--resume",
                         "false", "--out_dir", run10], MESH_TIMEOUT_S)
        final = ast.literal_eval(next(ln for ln in out.splitlines()
                                      if ln.startswith("final: "))[7:])
        fit10 = {"mesh": f"1x{MESH_RANKS} (model)", "transport": transport(),
                 "wall_s": time.perf_counter() - t0, "test_hr10": final["test_hr"],
                 "test_ndcg10": final["test_ndcg"], "val_hr10": final["val_hr"],
                 "retrieval_val_hr10": final.get("retrieval_val_hr"),
                 "retrieval_test_hr10": final.get("retrieval_test_hr"),
                 "peak_device_mib_by_rank": launches_line(out, "memory")["by_rank"],
                 "launches_by_rank": launches_line(out, "launches_by_rank")}
        with open(os.path.join(run10, "metrics.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        fit10["examples_per_sec"] = [r["examples_per_sec"] for r in rows if "train_loss" in r]
        fit10["epoch_seconds"] = [r["epoch_seconds"] for r in rows if "train_loss" in r]
        log("mesh_fit_10m", card=card, run="torchrun cli --preset synthetic10m --mesh 1x2 "
            "--shard_embeddings true --sparse_items_adam true --epochs 1 "
            "--eval_retrieval_every 1 --eval_retrieval 10 --retrieval_index full", **fit10)
        check(all(np.isfinite([final["test_hr"], final["test_ndcg"], final["test_loss"]])),
              f"--mesh 1x2: non-finite metrics {final}")
        check(final["test_hr"] >= FIT10M_SAMPLED_FLOOR,
              f"--mesh 1x2 sparse: sampled test HR@10 {final['test_hr']} below "
              f"{FIT10M_SAMPLED_FLOOR}")
        for r, n in enumerate(fit10["launches_by_rank"]):
            check(n["attention_fwd"] > 0 and n["attention_bwd"] > 0,
                  f"--mesh 1x2: rank {r} did not run K1 and K2 ({n})")
        fit10["resume"] = resume_one_device(card, run10)
        t0 = time.perf_counter()
        shard = rank_task("shard_10m", tmp, run10)
        log("mesh_shard_10m", card=card, transport=transport(), wall_s=time.perf_counter() - t0,
            **{k: v for k, v in shard[0].items()
               if k not in ("launches", "timings", "collective_ms")},
            collective_ms_by_rank=[r["collective_ms"] for r in shard],
            launches_by_rank=[r["launches"] for r in shard])
        for r, res in enumerate(shard):
            n = res["launches"]
            check(n["catalog_topk_int8"] > 0 and n["groupmax_layout0"] > 0
                  and n["tournament_rerank"] > 0,
                  f"--index_shards 2: rank {r} did not run K3, K4 and the rerank ({n})")
        return {"step": step, "fit": fit, "attn": attn, "fit10": fit10, "shard": shard}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def resume_one_device(card, run) -> dict:
    """The sparse --mesh 1x2 run's latest/ on one device: the whole row
    state (every row of the table, pad rows cut) loads into a one-device
    row-sparse state, which takes one step."""
    from carca_tpu_torch.serve import service
    from carca_tpu_torch.train.loop import make_device_train_step

    t0 = time.perf_counter()
    cfg = config_from_run_dir(run)
    mc, tc = cfg.model, cfg.train
    cat = service.load_catalog_for_run(argparse.Namespace(data_dir=""), cfg, DEVICE)
    state = create_train_state(mc, tc, DEVICE, sparse_items=True)
    epoch = CheckpointKeeper(os.path.join(run, "ckpt")).restore_latest(state)
    count = state.items_state["count"]
    check(epoch == 1 and count == state.step > 0,
          f"the sparse 1x2 latest/ on one device: epoch {epoch}, count {count}, step {state.step}")
    check(bool(state.items_state["munu"][1:].any(dim=1).any()), "the restored moments are zero")
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device=DEVICE)
    attrs = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc), device=DEVICE)
    rows = torch.as_tensor(dd.users("train")[:tc.batch_size], device=DEVICE)
    state, loss = make_device_train_step(mc, tc, sparse_items=True)(state, attrs, dd.arrays, rows)
    out = {"epoch": epoch, "count": count, "munu_rows": int(state.items_state["munu"].shape[0]),
           "loss_after_one_step": float(loss), "count_after": state.items_state["count"],
           "seconds": time.perf_counter() - t0}
    log("mesh_fit_10m", card=card, case="latest/ of the sparse 1x2 run resumed on one device",
        **out)
    check(np.isfinite(out["loss_after_one_step"]) and out["count_after"] == count + 1
          and out["munu_rows"] == mc.n_items, f"one-device resume: {out}")
    del state, dd, cat
    torch.cuda.empty_cache()
    return out


def _rank_setup():
    from carca_tpu_torch.parallel.mesh import initialize_distributed

    dev = initialize_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def collective_ms(fn, reps: int = 20) -> float:
    """Host-clock ms of one call of a collective ``fn``, every rank
    starting together, the device synchronised before and after."""
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _rank_write(task, out_dir, result) -> None:
    import torch.distributed as dist

    with open(os.path.join(out_dir, f"{task}.rank{dist.get_rank()}.json"), "w") as fh:
        json.dump(result, fh)
    dist.barrier()
    dist.destroy_process_group()


def rank_dp_step(out_dir) -> None:
    """11a on each rank: one dropout-0 step of make_sharded_device_train_step
    at --mesh 2 on phase 9's data; rank 0 then runs the one-device kernel
    step from the same seed and rows and holds the two; then the sharded
    step's time, MESH_STEP_REPS steps on the host clock; then
    ``two_step_checks`` in the same ranks."""
    import torch.distributed as dist

    from carca_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh
    from carca_tpu_torch.parallel.step import make_sharded_device_train_step
    from carca_tpu_torch.train.loop import make_device_train_step

    dev = _rank_setup()
    mesh = make_mesh((MESH_RANKS,), ("data",))
    cat = synthetic_catalog(n_users=FIT_USERS, n_real_items=FIT_ITEMS, seed=SEED)
    cfg = preset("beauty", cat.n_items, cat.n_attrs, cat.n_ctx)
    mc = dataclasses.replace(cfg.model, dropout=0.0)
    tc = dataclasses.replace(cfg.train, batch_size=B, inner_steps=1)
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, device=dev)
    attrs = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc), device=dev)
    users = dd.users("train")
    rows = torch.as_tensor(users[:B], device=dev)
    state = create_train_state(mc, tc, dev)
    step = make_sharded_device_train_step(mc, tc, mesh)
    reset_counts()
    state, loss = step(state, attrs, dd.arrays, rows)
    torch.cuda.synchronize()
    res = {"loss": float(loss), "launches": counts(), "rank": mesh.rank}
    if mesh.rank == 0:
        one = create_train_state(mc, tc, dev)
        one, loss1 = make_device_train_step(mc, tc)(one, attrs, dd.arrays, rows)
        worst, worst_tiny = 0.0, 0.0
        for (name, p), q in zip(state.model.named_parameters(), one.model.parameters()):
            err = (p.detach() - q.detach()).abs()
            big = q.grad.abs() > MESH_TINY_GRAD
            worst = max(worst, err[big].max().item() if big.any() else 0.0)
            worst_tiny = max(worst_tiny, err.max().item())
        res.update(one_device_loss=float(loss1),
                   loss_rel_err=abs(float(loss) - float(loss1)) / abs(float(loss1)),
                   param_err_where_grad_big=worst, param_err_max=worst_tiny,
                   tol=MESH_STEP_TOL, lr=tc.lr)
        res["ok"] = (res["loss_rel_err"] <= MESH_STEP_TOL and worst <= MESH_STEP_TOL
                     and worst_tiny <= 2 * tc.lr)
        del one
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(MESH_STEP_REPS):
        r = torch.as_tensor(users[(i + 1) * B:(i + 2) * B], device=dev)
        if r.shape[0] == B:
            state, loss = step(state, attrs, dd.arrays, r)
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_STEP_REPS
    res["peak_device_mib"] = torch.cuda.max_memory_allocated() / 2**20
    flat = torch.zeros(sum(p.numel() for p in state.model.parameters()), device=dev)
    res["collective_ms"] = {f"gradient all_reduce, {flat.numel()} f32": collective_ms(
        lambda: all_reduce_sum(flat, mesh.data_group))}
    del state, flat
    res["two_steps"] = two_step_checks(dev, mc, tc, dd, attrs)
    _rank_write("dp_step", out_dir, res)


def one_device_steps(mc, tc, dev, dd, attrs, rows_list, sparse: bool) -> dict:
    """Two (or more) one-device device-pipeline steps from a fresh state:
    the losses, the parameters, the least |g| of each element over the
    steps (for the row-sparse item table: over the steps touching its row),
    and the row state."""
    from carca_tpu_torch.models.losses import masked_mean
    from carca_tpu_torch.train.loop import make_device_train_step

    state = create_train_state(mc, tc, dev, sparse_items=sparse)
    step = make_device_train_step(mc, tc, sparse_items=sparse)
    losses, mag = [], {}
    for rows in rows_list:
        g_items = None
        if sparse:  # the item table's gradient, dense, on the batch the step draws
            probe = torch.Generator(device=dev).set_state(state.generator.get_state())
            batch = assemble_train(dd.arrays, mc.seq_len, mc.n_items, rows, probe)
            model = copy.deepcopy(state.model).train()
            masked_mean(train_loss_terms(model, batch, attrs)).backward()
            ids = torch.cat([batch["p_x"].reshape(-1), batch["o_x"].reshape(-1)]).long()
            away = torch.full((mc.n_items, 1), float("inf"), device=dev)
            away[ids] = 0.0
            g_items = torch.maximum(model.embed.items.grad.abs(), away)
            del model
        state, loss = step(state, attrs, dd.arrays, rows)
        losses.append(float(loss))
        for n, p_ in state.model.named_parameters():
            g = g_items if (sparse and n == "embed.items") else p_.grad.abs()
            mag[n] = torch.minimum(mag[n], g) if n in mag else g
    return {"losses": losses, "mag": mag,
            "params": {n: p_.detach() for n, p_ in state.model.named_parameters()},
            "items_state": state.items_state}


def hold_steps(got: dict, ref: dict, table0, lr: float) -> dict:
    """The mesh steps (whole parameters, row state) against one device: the
    losses and the moment tensors within MESH_SPARSE_REL_TOL relative, the
    parameters within MESH_STEP_TOL where every step's |g| > MESH_TINY_GRAD
    and within 2·lr·steps elsewhere, rows no step touched (and their
    moments) bit-equal to the start, the counts equal."""
    n_steps = len(ref["losses"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    big_err = any_err = 0.0
    for name, want in ref["params"].items():
        err = (got["params"][name] - want).abs()
        big = ref["mag"][name] > MESH_TINY_GRAD
        big_err = max(big_err, err[big].max().item() if big.any() else 0.0)
        any_err = max(any_err, err.max().item())
    out = {"loss_rel_err": loss_rel, "param_err_where_grad_big": big_err,
           "param_err_max": any_err}
    ok = (loss_rel <= MESH_SPARSE_REL_TOL and big_err <= MESH_STEP_TOL
          and any_err <= 2 * n_steps * lr)
    if ref["items_state"] is not None:
        w = table0.shape[1]
        munu, want = got["munu"], ref["items_state"]["munu"]
        untouched = torch.isinf(ref["mag"]["embed.items"]).all(dim=1)
        out["moment_rel_err"] = [((munu[:, sl] - want[:, sl]).norm() / want[:, sl].norm()).item()
                                 for sl in (slice(0, w), slice(w, 2 * w))]
        out["untouched_bit_equal"] = bool(
            torch.equal(got["params"]["embed.items"][untouched], table0[untouched])
            and not munu[untouched].any())
        out["count"] = [got["count"], ref["items_state"]["count"]]
        ok = (ok and max(out["moment_rel_err"]) <= MESH_SPARSE_REL_TOL
              and out["untouched_bit_equal"] and got["count"] == ref["items_state"]["count"])
    out["ok"] = bool(ok)
    return out


def two_step_checks(dev, mc, tc, dd, attrs) -> dict:
    """11 on each rank (inside the dp_step task): two dropout-0 steps of
    make_sharded_device_train_step at --mesh 2 (replicated table) and
    --mesh 1x2 (row-sharded) with the row-sparse item Adam, and at --mesh
    1x2 with the dense Adam, on phase 9's data at the beauty width; the
    first batch touches row lo of block 1, the second is another batch (a
    lazy gap for rows it does not touch). Rank 0 holds each against two
    one-device steps (``hold_steps``)."""
    import torch.distributed as dist

    from carca_tpu_torch.parallel.mesh import (gather_rows, local_rows, make_mesh,
                                               prepare_state_for_mesh)
    from carca_tpu_torch.parallel.step import make_sharded_device_train_step

    users = dd.users("train")
    lo = -(-mc.n_items // MESH_RANKS)  # rows per block of the padded table
    fresh = create_train_state(mc, tc, dev)  # every case starts from these weights
    gen, table0 = fresh.generator, fresh.model.embed.items.detach().clone()
    del fresh
    # the first batch: the first run of B users whose batch touches row lo
    first = None
    for i in range(0, len(users) - 2 * B, B):
        rows = torch.as_tensor(users[i:i + B], device=dev)
        probe = torch.Generator(device=dev).set_state(gen.get_state())
        b = assemble_train(dd.arrays, mc.seq_len, mc.n_items, rows, probe)
        if bool((b["p_x"] == lo).any() or (b["o_x"] == lo).any()):
            first = i
            break
    check(first is not None, f"no batch touches row {lo}")
    rows_list = [torch.as_tensor(users[first:first + B], device=dev),
                 torch.as_tensor(users[first + B:first + 2 * B], device=dev)]
    res = {"rank": dist.get_rank(), "lo": lo, "first_batch_at": first}
    refs = {}
    cases = (("mesh 2 sparse", (MESH_RANKS,), ("data",), False, True),
             ("mesh 1x2 sparse", (1, MESH_RANKS), ("data", "model"), True, True),
             ("mesh 1x2 dense", (1, MESH_RANKS), ("data", "model"), True, False))
    for tag, shape, axes, shard, sparse in cases:
        mesh = make_mesh(shape, axes)
        state = create_train_state(mc, tc, dev, sparse_items=sparse and not shard)
        prepare_state_for_mesh(state, mesh, shard, sparse_items=sparse)
        a = local_rows(attrs, mesh).contiguous() if shard else attrs
        step = make_sharded_device_train_step(mc, tc, mesh, shard_embeddings=shard,
                                              sparse_items=sparse)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for rows in rows_list:
            state, loss = step(state, a, dd.arrays, rows)
            losses.append(float(loss))
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(rows_list)
        params = {n: p_.detach() for n, p_ in state.model.named_parameters()}
        munu = None if state.items_state is None else state.items_state["munu"]
        if shard:
            params["embed.items"] = gather_rows(params["embed.items"], mesh, mc.n_items)
            if munu is not None:
                munu = gather_rows(munu, mesh, mc.n_items)
        got = {"losses": losses, "params": params, "munu": munu,
               "count": None if state.items_state is None else state.items_state["count"]}
        entry = {"losses": losses, "step_ms": wall_ms, "launches": counts(),
                 "block_rows": state.model.embed.items.shape[0]}
        if mesh.rank == 0:
            if sparse not in refs:
                refs[sparse] = one_device_steps(mc, tc, dev, dd, attrs, rows_list, sparse)
            entry.update(hold_steps(got, refs[sparse], table0, tc.lr))
        res[tag] = entry
        del state, got, params, munu
        dist.barrier()
    return res


def rank_shard_10m(out_dir, run) -> None:
    """11b on each rank, over the --mesh 1x2 run: the sharded lookup of the
    run's item table (f32) and attrs (bf16) against the plain gather; the
    --index_shards 2 service (service.main in this rank) over the full 10M
    int8 index with and without history exclusion (K4 + rerank, then K3),
    its launches counted; rank 0 holds its answers to a one-shard
    recommender; then the same index's blocks through the shard-local
    top-k, merged over the ranks, against one device, bit for bit; then
    rank 0 times K3/K4/the rerank over its 5M-row block."""
    import io

    import torch.distributed as dist

    from carca_tpu_torch.parallel.embedding import make_sharded_lookup
    from carca_tpu_torch.parallel.mesh import (all_gather, all_reduce_sum, gather_rows,
                                               local_rows, make_mesh)
    from carca_tpu_torch.parallel.retrieval import _shard_topk, merge_shard_topk
    from carca_tpu_torch.serve import service

    dev = _rank_setup()
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"))
    res = {"rank": mesh.rank}
    cfg = config_from_run_dir(run)
    cat = service.load_catalog_for_run(argparse.Namespace(data_dir=""), cfg, str(dev))
    params = torch.load(os.path.join(run, "ckpt", "best", "params.pt"), map_location=dev)
    lookup = make_sharded_lookup(mesh)
    ids = torch.randint(0, cfg.model.n_items, LOOKUP_IDS,
                        generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    exact = {}
    for name, table in (("items f32", params["embed.items"]),
                        ("attrs bf16", torch.as_tensor(cat.attrs, device=dev).to(torch.bfloat16))):
        got = lookup(local_rows(table, mesh).contiguous(), ids)
        exact[name] = bool(torch.equal(got, table[ids]))
    res["lookup_equal_plain_gather"] = exact
    del params

    host = HostCSR(cat)
    lines = serve_requests(host)
    stdin = "\n".join(lines) + "\n"
    answers = {}
    reset_counts()
    for name, extra in (("exclude history", []), ("no exclusion", ["--no_exclude_history"])):
        buf = io.StringIO()
        service.main(["--run_dir", run, "--index", "full", "--quantize_index", "true", "--k",
                      str(K), "--index_shards", str(MESH_RANKS), *extra],
                     stdin=io.StringIO(stdin), stdout=buf)
        answers[name] = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]
    torch.cuda.synchronize()
    res["launches"] = counts()
    # the service's blocks, rebuilt as it built them, and the whole index
    # they make: the one-shard recommender answers over that same index
    block = load_recommender(run, cat.attrs, device=dev, quantize=True, mesh=mesh).catalog_emb
    n_rows = cfg.model.n_items
    index = QuantizedIndex(gather_rows(block.qvals, mesh, n_rows),
                           gather_rows(block.scales.T.contiguous(), mesh, n_rows).T.contiguous())
    rec = load_recommender(run, cat.attrs, device=dev, quantize=True)
    res["index"] = dict(rows=index.rows, int8=isinstance(rec.catalog_emb, QuantizedIndex),
                        block_rows=block.rows, **blocks_against_one_device(index, rec.catalog_emb))
    rec.catalog_emb = index
    if mesh.rank == 0:
        near = {}
        for name, served in answers.items():
            rec.exclude_history = name == "exclude history"
            want = list(serve_lines(rec, host, lines, k=K))
            check(len(served) == len(want), f"{name}: {len(served)} answers, {len(want)} wanted")
            near[name] = 0
            for got, w in zip(served, want):
                check(("error" in got) == ("error" in w), f"{name}: {got} vs {w}")
                if "error" not in w:
                    near[name] += compare(f"--index_shards 2 {name} {got.get('id')}",
                                          got["items"], got["scores"], w["items"], w["scores"],
                                          score_tol=SERVE_SCORE_TOL)
        res["served_equal_one_shard"] = {"requests": len(lines), "near_tie_slots": near}

    # the shard-local kernels merged over the ranks = one device, bit for bit
    lo = mesh.m_idx * block.rows
    merged = {}
    for bq in (1, 64):
        q = torch.randn(bq, cfg.model.d, generator=torch.Generator(device=dev).manual_seed(bq),
                        device=dev)
        for method, kk in (("stream", K), ("tournament", K + L)):
            v, i = _shard_topk(q, block, kk, n_rows, lo, mesh, True, method)
            if mesh.rank == 0:
                wv, wi = catalog_topk(q, index, kk, n_items=n_rows, method=method)
                merged[f"{method} B={bq} k={kk}"] = bool(torch.equal(v, wv) and torch.equal(i, wi))
    rows = torch.zeros(*LOOKUP_IDS, cfg.model.d, device=dev)
    v = torch.zeros(1, K + L, device=dev)
    res["collective_ms"] = {
        f"lookup all_reduce {list(rows.shape)} f32": collective_ms(
            lambda: all_reduce_sum(rows, mesh.model_group)),
        f"top-k all_gather [1, {K + L}] values and ids": collective_ms(
            lambda: merge_shard_topk(all_gather(v, mesh.model_group, MESH_RANKS),
                                     all_gather(v.long(), mesh.model_group, MESH_RANKS),
                                     K + L))}
    dist.barrier()
    if mesh.rank == 0:
        res["merged_bit_equal_one_device"] = merged
        check(all(merged.values()), f"shard-local top-k merged != one device: {merged}")
        check(all(exact.values()), f"sharded lookup != plain gather: {exact}")
        res["timings"] = time_shard(block, cfg.model.d)
    _rank_write("shard_10m", out_dir, res)


def blocks_against_one_device(index, one) -> dict:
    """The int8 index gathered from the ranks' blocks (each embedded and
    quantized on its rank) against the one-device build: the same rows with
    a scale of 0, scales within BLOCK_SCALE_RTOL, values within one step.
    The two builds embed the rows in chunks of different sizes, so cuBLAS
    may sum in another order."""
    check(index.rows == one.rows, f"gathered blocks hold {index.rows} rows, one device "
                                  f"{one.rows}")
    zero = one.scales == 0
    check(torch.equal(zero, index.scales == 0), "gathered blocks: rows of scale 0 differ")
    rel = ((index.scales - one.scales).abs() / one.scales.where(~zero, 1.0)).max().item()
    step = (index.qvals.to(torch.int16) - one.qvals.to(torch.int16)).abs()
    out = {"bit_equal_one_device_build": bool(torch.equal(index.qvals, one.qvals)
                                               and torch.equal(index.scales, one.scales)),
           "scale_rel_err": rel, "scale_rtol": BLOCK_SCALE_RTOL,
           "max_value_steps": int(step.max()),
           "rows_off_by_a_step": int((step.amax(dim=1) > 0).sum())}
    check(rel <= BLOCK_SCALE_RTOL and out["max_value_steps"] <= 1,
          f"gathered blocks against the one-device index: {out}")
    return out


def time_shard(block, d) -> dict:
    """K3 int8, K4 layout 0 and the rerank over one 5M-row block at the
    --index_shards 2 service's shapes (bucket 1: k = 10 without exclusion
    for K3, k + L = 60 for the tournament), beside their plain versions;
    their errors against the plain versions, held to the summation-order
    bound of phases 4-6 (K3 ids equal but for near-ties, K4 and the rerank
    within SCORE_ORDER_TOL of sum|q e|, the rerank's group maxima
    bit-equal to K4's)."""
    q = torch.randn(1, d, generator=torch.Generator().manual_seed(91)).to(DEVICE)
    rows = block.rows
    out = {"rows": rows}
    v, i = catalog_topk(q, block, K, method="stream")
    pv, pi = catalog_topk_plain(q, block, K)
    out["k3_err"], _ = compare_within_order_tol(v, i, pv, pi, q, block)
    out["K3"] = kernel_vs_plain(lambda: catalog_topk(q, block, K, method="stream"),
                                lambda: catalog_topk_plain(q, block, K), reps=10, plain_reps=5)
    e, scales = block.qvals, block.scales
    g, out["k4_err"] = check_groupmax(f"shard of {rows} rows layout 0", q, e, scales, rows,
                                      True, 0)
    out["K4"] = kernel_vs_plain(lambda: groupmax(q, e, scales, rows, True, 0),
                                lambda: groupmax_plain(q, e, scales, rows, True, 0), reps=10,
                                plain_reps=5)
    kg = K + L + 8
    gi = rt._stable_desc(g.t(), kg).sort(dim=1).values.contiguous()
    out["rerank_err"] = check_rerank(f"shard of {rows} rows, {kg} groups", q, e, scales, gi,
                                     rows, True, g.t().gather(1, gi))
    out["rerank"] = kernel_vs_plain(lambda: tournament_rerank(q, e, scales, gi, rows, True),
                                    lambda: tournament_rerank_plain(q, e, scales, gi, rows, True),
                                    reps=10)
    out["kg"] = kg
    return out


RANK_TASKS = {"dp_step": rank_dp_step, "shard_10m": rank_shard_10m}


# --------------------------------------------------------------------------
# phase 12: the BASELINE families on the card
# --------------------------------------------------------------------------

# 12b's gates: the reference's test HR@10 / NDCG@10 (VALIDATION_<family>
# _ref.json, the PyTorch reference on a CPU) less ~2.5 sigma, phase 9's
# rule. sigma is the binomial sigma of HR@10 over the run's test users,
# sqrt(p (1 - p) / n) with n = 4,096 (games, fashion) or 2,048 (men);
# NDCG's margin is phase 9's 0.0163 scaled by sqrt(4096 / n):
#   games   HR 0.7048 - 2.5 x 0.00713 = 0.687   NDCG 0.5546 - 0.0163 = 0.538
#   fashion HR 0.4749 - 2.5 x 0.00780 = 0.455   NDCG 0.3613 - 0.0163 = 0.345
#   men     HR 0.7432 - 2.5 x 0.00965 = 0.719   NDCG 0.6241 - 0.0231 = 0.601
FAMILY_GATES = {"games": (0.687, 0.538), "fashion": (0.455, 0.345), "men": (0.719, 0.601)}
FAMILY_EPOCHS, FAMILY_EARLY_STOP = 25, 8  # scripts/validate_presets.py's defaults
FAMILY_TIMEOUT_S = 700
AB_EPOCHS = 2  # each of the four games fits of the native-against-numpy comparison
# 12c: K1/K2 at the families' shapes: (batch, Lq, Lk, causal, d, trained,
# the families whose fits run it). games and fashion share d = 128 (2
# heads of 64) at L = 50; men is d = 64 at L = 200 (its encoder is
# ATTN_SHAPES' "men")
FAMILY_ATTN = {
    "games_encoder": (B, L, L, 0, 2 * D, True, ("games", "fashion")),
    "games_decoder": (2 * B, L, L, -1, 2 * D, True, ("games", "fashion")),
    "games_decoder_eval": (B, FIT_TARGETS + 1, L, None, 2 * D, False, ("games", "fashion")),
    "men_decoder": (2 * B, L_MEN, L_MEN, -1, D, True, ("men",)),
    "men_decoder_eval": (B, FIT_TARGETS + 1, L_MEN, None, D, False, ("men",)),
}
FAMILY_RUN_FILES = ("args.json", "metrics.jsonl", "ckpt/best/params.pt", "ckpt/best/metrics.json",
                    "ckpt/latest/state.pt")


def assembled(builder, mode, rows, seed):
    rng = np.random.default_rng(seed)
    if mode == "train":
        return builder.train_batch(rows, rng)
    return builder.eval_batch(rows, rng, mode)


def native_checks(card, cat) -> dict:
    """12a: the native assembler, built here, against the numpy path at the
    games family's catalog: the deterministic keys bit-equal, the negatives
    under the sampler contract (in [1, n_items - 1], distinct, outside the
    user's history, 0 on dead slots), 1 and 8 threads bit-equal; then one
    epoch of train batches assembled by each, timed on the host."""
    t0 = time.perf_counter()
    one, eight = get_assembler(1), get_assembler(8)
    build_s = time.perf_counter() - t0
    builders = {"numpy": BatchBuilder(cat, L, FIT_TARGETS),
                "native 1": BatchBuilder(cat, L, FIT_TARGETS, native=one),
                "native 8": BatchBuilder(cat, L, FIT_TARGETS, native=eight)}
    for mode in ("train", "val", "test"):
        rows = np.concatenate([builders["numpy"].users(mode)[:B - 2], [-1, -1]])
        ref, got, got8 = (assembled(b, mode, rows, SEED + 12) for b in builders.values())
        for key in got:
            check(np.array_equal(got[key], got8[key]), f"12a {mode}: 1 and 8 threads differ "
                                                       f"in {key}")
        for key in ("p_x", "p_c", "y_true", "o_c", "n_valid"):
            check(np.array_equal(got[key], ref[key]), f"12a {mode}: native {key} differs from "
                                                      "numpy")
        pos = L if mode == "train" else 1  # the positives' slots
        check(np.array_equal(got["o_x"][:, :pos], ref["o_x"][:, :pos]),
              f"12a {mode}: native positives differ from numpy")
        for b, u in enumerate(rows):
            negs = got["o_x"][b, pos:]
            live = got["p_x"][b] > 0 if mode == "train" else np.full(FIT_TARGETS, u >= 0)
            check(not negs[~live].any(), f"12a {mode}: row {b} has negatives in dead slots")
            n = negs[live]
            hist = set(cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist()) if u >= 0 else set()
            check(n.size == 0 or (n.min() >= 1 and n.max() < cat.n_items
                                  and len(set(n.tolist())) == n.size
                                  and not set(n.tolist()) & hist),
                  f"12a {mode}: row {b} breaks the sampler contract")
    rates = {}
    for name in ("numpy", "native 8"):
        rng = np.random.default_rng(SEED)
        t0, n = time.perf_counter(), 0
        for rows in epoch_batches(builders[name].users("train"), B, rng, shuffle=True):
            n += int(builders[name].train_batch(rows, rng)["n_valid"])
        rates[name] = n / (time.perf_counter() - t0)
    out = {"build_s": build_s, "host_assembly_examples_per_sec": rates,
           "assembly_speedup": rates["native 8"] / rates["numpy"]}
    log("family_native", card=card, catalog="games family (4,096 users, 2,000 items, 8 ctx)",
        checks="train/val/test: deterministic keys = numpy, sampler contract, 1 = 8 threads",
        **out)
    return out


def family_fits(card, out) -> dict:
    """12b: `python -m carca_tpu_torch.validate_presets all` on the card:
    each family's run directory complete, the native assembler named in
    the log, K1 and K2 launched, and its test HR@10 / NDCG@10 at its gates."""
    t0 = time.perf_counter()
    stdout = run_module("carca_tpu_torch.validate_presets", [
        "all", "--epochs", str(FAMILY_EPOCHS), "--early_stop", str(FAMILY_EARLY_STOP),
        "--out", out], FAMILY_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(stdout.count("assembler: native") == len(FAMILIES) and "assembler: numpy" not in stdout,
          "the family fits did not all assemble with the native library")
    fits, below = {}, []
    for name in FAMILIES:
        with open(os.path.join(out, f"VALIDATION_{name}.json")) as fh:
            res = json.load(fh)
        run = os.path.join(out, f"run_{name}")
        for f in FAMILY_RUN_FILES:
            check(os.path.exists(os.path.join(run, f)), f"{run}: no {f}")
        check(len(glob.glob(os.path.join(run, "*.csv"))) == 1, f"{run}: not one CSV log")
        with open(os.path.join(run, "metrics.jsonl")) as fh:
            rows = [json.loads(ln) for ln in fh]
        with open(os.path.join(run, "ckpt", "best", "metrics.json")) as fh:
            best = json.load(fh)
        ours, ref, n = res["carca_tpu_torch"], res["reference"], res["launches"]
        fits[name] = {
            "epochs_run": ours["epochs_run"], "best_epoch": best["epoch"],
            "test_hr10": ours["test_hr"], "test_ndcg10": ours["test_ndcg"],
            "val_hr10": ours["val_hr"], "val_ndcg10": ours["val_ndcg"],
            "reference_test_hr10": ref["test_hr10"], "reference_test_ndcg10": ref["test_ndcg10"],
            "gates": FAMILY_GATES[name],
            "median_examples_per_sec": statistics.median(r["examples_per_sec"] for r in rows),
            "median_epoch_seconds": statistics.median(r["epoch_seconds"] for r in rows),
            "wall_s": res["wall_seconds"], "device": res["device"], "launches": n}
        log("family_fit", card=card, family=name, **fits[name])
        check(res["device"] == torch.cuda.get_device_name(0), f"{name} ran on {res['device']}")
        check(n["attention_fwd"] > 0 and n["attention_bwd"] > 0,
              f"the {name} fit did not run K1 and K2: {n}")
        hr_gate, ndcg_gate = FAMILY_GATES[name]
        if ours["test_hr"] < hr_gate or ours["test_ndcg"] < ndcg_gate:
            below.append(f"{name}: test HR@10 {ours['test_hr']} / NDCG@10 {ours['test_ndcg']} "
                         f"below {hr_gate} / {ndcg_gate}")
    log("family_fit", card=card, all_families_wall_s=wall)
    check(not below, "; ".join(below))
    return fits


def native_vs_numpy_fit(card, cat, tmp) -> dict:
    """The games family fit's train examples/s with the native assembler
    and with numpy (AB_EPOCHS each, checkpoints off), in turns numpy,
    native, native, numpy; the median of each's epochs."""
    rates = {"numpy": [], "native": []}
    for i, kind in enumerate(("numpy", "native", "native", "numpy")):
        cfg = family_config(FAMILIES["games"], AB_EPOCHS, AB_EPOCHS, os.path.join(tmp, f"ab{i}"))
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, use_native=kind == "native"),
            train=dataclasses.replace(cfg.train, checkpoint=False))
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            fit_loop(cfg, cat, device=DEVICE)
        check(f"assembler: {kind}" in printed.getvalue(), f"the {kind} fit used another assembler")
        with open(os.path.join(cfg.train.out_dir, "metrics.jsonl")) as fh:
            rates[kind] += [json.loads(ln)["examples_per_sec"] for ln in fh]
    out = {f"{kind}_examples_per_sec": statistics.median(v) for kind, v in rates.items()}
    out["by_epoch"] = rates
    out["speedup"] = out["native_examples_per_sec"] / out["numpy_examples_per_sec"]
    log("family_native", card=card, case=f"games fit, {AB_EPOCHS} epochs x 2 each, in turns",
        **out)
    return out


def family_kernels(card) -> dict:
    """12c: K1 and K2 at each of FAMILY_ATTN's shapes against their plain
    versions (phase 3's tolerances), timed beside them and SDPA."""
    out = {}
    for name, (b, lq, lk, causal, d, trained, _) in FAMILY_ATTN.items():
        out[name] = attention_at(card, b, lq, lk, causal, d=d, train=trained, where=name)
        log("timing", card=card, kernel="K1/K2 at a family's shape", shape=name,
            dropout=P_DROP if trained else 0.0, **out[name])
    return out


def fashion_service(card, run, tmp) -> dict:
    """12c: the fashion run (attrctx, d = 128) through `python -m
    carca_tpu_torch.serve.service --run_dir` over its catalog in the
    reference's files: equal to an in-process Recommender (whose K1 and K3
    launches are counted) and to the CPU plain path; K3 f32 at d = 128
    over the run's seen index, k = KK, against its plain version at each
    bucket and timed at bucket 256."""
    data_dir = os.path.join(tmp, "fashion_data")
    write_reference_format(family_catalog(FAMILIES["fashion"]), data_dir)
    files = ["--data_dir", data_dir, "--profile_file", "profiles.txt", "--attr_file",
             "attrs.pkl", "--ctx_file", "ctx.pkl"]
    cat = load_dataset(data_dir, "profiles.txt", "attrs.pkl", "ctx.pkl")
    host = HostCSR(cat)
    lines = serve_requests(host)
    out = run_module("carca_tpu_torch.serve.service", ["--run_dir", run, *files, "--k", str(K)],
                     300, stdin_text="\n".join(lines) + "\n")
    served = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    reset_counts()
    rec = load_recommender(run, cat.attrs, which="best", index_ids=np.unique(host.items))
    mine = list(serve_lines(rec, host, lines, k=K))
    torch.cuda.synchronize()
    launches = counts()
    check(launches["attention_fwd"] > 0 and launches["catalog_topk_f32"] > 0,
          f"the fashion Recommender did not run K1 and K3: {launches}")
    near_ties = served_equal("fashion service", lines, served, mine)
    serve_vs_cpu_plain(run, cat, host, lines, served, tag="family_serve")
    e = rec.catalog_emb
    r = e.shape[0]
    queries = {bb: stage1_queries(rec, *reqs)
               for bb, reqs in bucket_requests(host, SEED + 10).items()}
    err = max(k3_case(f"f32 fashion seen index ({r:,} rows, d={e.shape[1]}) bucket {bb} k={KK}",
                      q, e, KK, n_items=r)[0] for bb, q in queries.items())
    q = queries[B]
    with torch.no_grad():
        ms = kernel_vs_plain(lambda: catalog_topk(q, e, KK, n_items=r, method="stream"),
                             lambda: catalog_topk_plain(q, e, KK, n_items=r))
    res = {"launches": launches, "k3_err": err, "k3": ms, "rows": r, "d": e.shape[1]}
    log("family_serve", card=card, run="fashion", requests=len(lines),
        near_tie_slots=near_ties, equal_to_in_process=True, example=served[0], **res)
    return res


def phase_families(card) -> dict:
    """Phase 12. Returns what the kernels line needs: the fits (their
    launches), the kernels at the families' shapes and the fashion
    service's K3."""
    tmp = tempfile.mkdtemp(prefix="carca_families_")
    try:
        games = family_catalog(FAMILIES["games"])
        native = native_checks(card, games)
        out = os.path.join(tmp, "validate")
        fits = family_fits(card, out)
        ab = native_vs_numpy_fit(card, games, tmp)
        torch.cuda.empty_cache()
        attn = family_kernels(card)
        eval_kernel_vs_plain(os.path.join(out, "run_games"), games, tag="family_eval")
        serve = fashion_service(card, os.path.join(out, "run_fashion"), tmp)
        return {"native": native, "fits": fits, "ab": ab, "attn": attn, "serve": serve}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 13: the weak-scaling harness and the mesh run's failure path
# --------------------------------------------------------------------------

# 13a: `python -m carca_tpu_torch.bench_scaling` runs (--sizes, --shard_embeddings)
SCALING_RUNS = (("1,2", False), ("2", True))
SCALING_TIMEOUT_S = 600
# 13b: run a is killed once latest/ is committed; run b and the control end
# at FAILOVER_EPOCHS. The card's attention gradients and the embedding's
# scatter-add are not bit-deterministic, so the resumed run equals the
# control within these (exact equality is the CPU test's job,
# tests/test_torch_mesh_failover.py)
FAILOVER_EPOCHS = 3
FAILOVER_SNAPSHOT_S = 300  # run a's first latest/ must be committed within
FAILOVER_GRACE_S = 60  # the survivor's time to end after the kill (the JAX test's)
FAILOVER_LOSS_RTOL = 1e-3  # per-epoch train loss after the resume point, relative
FAILOVER_NDCG_TOL = 0.01  # final val and test NDCG@10, absolute


def scaling_run(card, sizes: str, shard: bool) -> dict:
    """13a: one `python -m carca_tpu_torch.bench_scaling` run (a subprocess
    that starts a group of rank processes per size): its lines, each
    rank's K1/K2 launches, and the transport each group logged, held to
    the rule (nccl when every rank has a card, else gloo)."""
    args = ["--sizes", sizes] + (["--shard_embeddings"] if shard else [])
    t0 = time.perf_counter()
    out, err = run_module("carca_tpu_torch.bench_scaling", args, SCALING_TIMEOUT_S,
                          with_stderr=True)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    ranks = [json.loads(ln[len("launches: "):]) for ln in err.splitlines()
             if ln.startswith("launches: ")]
    backends = [ln for ln in err.splitlines() if ln.startswith("initialize_distributed: ")]
    n_sizes = [int(n) for n in sizes.split(",")]
    check([r["devices"] for r in lines] == n_sizes, f"bench_scaling {args}: lines {lines}")
    base = n_sizes[0]
    for r in lines:
        check(np.isfinite(r["examples_per_sec"]) and r["examples_per_sec"] > 0
              and f"efficiency_vs_{base}dev" in r and "per_chip" in r,
              f"bench_scaling {args}: line {r}")
    for n in n_sizes:
        group = [r for r in ranks if r["size"] == n]
        check(sorted(r["rank"] for r in group) == list(range(n)),
              f"bench_scaling {args}: size {n} printed launches for ranks "
              f"{[r['rank'] for r in group]}")
        for r in group:
            check(r["device"].startswith("cuda") and r["attention_fwd"] > 0
                  and r["attention_bwd"] > 0,
                  f"bench_scaling {args}: size {n} rank {r['rank']} did not run K1 and K2 "
                  f"on the card ({r})")
        if n > 1:
            want = "nccl" if torch.cuda.device_count() >= n else "gloo"
            said = [ln for ln in backends if f"/{n} on " in ln]
            check(len(said) == n and all(f"backend {want} " in ln for ln in said),
                  f"bench_scaling {args}: size {n} logged {said}, want backend {want}")
    mechanics = ("ranks share one card over gloo" if torch.cuda.device_count() < max(n_sizes)
                 else "one card per rank over nccl")
    log("scaling", card=card, run="python -m carca_tpu_torch.bench_scaling " + " ".join(args),
        mechanics=mechanics, lines=lines, backends=backends, wall_s=wall,
        launches_by_rank=[{k: r[k] for k in ("size", "rank", "attention_fwd", "attention_bwd")}
                          for r in ranks])
    return {"args": args, "lines": lines, "ranks": ranks}


def descendants(pid: int) -> list:
    """The processes under ``pid``, from /proc."""
    kids = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def rank_pid(pid: int, rank: int) -> int:
    """The pid of torchrun ``pid``'s worker of ``rank`` (by its environment;
    the workers are torchrun's children, listed before their own)."""
    for c in descendants(pid):
        try:
            with open(f"/proc/{c}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
        except OSError:
            continue
        if f"RANK={rank}".encode() in env:
            return c
    raise RuntimeError(f"check failed: no worker of rank {rank} under torchrun {pid}")


def killed_run(args, latest: str, log_dir: str) -> dict:
    """13b's run a: ``torchrun --nproc_per_node 2 args`` in a session of its
    own; once ``latest`` exists, rank 1's worker is SIGKILLed; torchrun
    (and the survivor) get FAILOVER_GRACE_S to end, then the session is
    killed. Every process it started is gone when this returns."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MESH_RANKS), *args]
    with open(os.path.join(log_dir, "run_a.out"), "w") as out, \
            open(os.path.join(log_dir, "run_a.err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err, start_new_session=True)
    t0 = time.perf_counter()
    try:
        while not os.path.exists(latest):
            check(proc.poll() is None, f"run a ended (exit {proc.returncode}) before {latest}")
            check(time.perf_counter() - t0 < FAILOVER_SNAPSHOT_S,
                  f"run a: no {latest} within {FAILOVER_SNAPSHOT_S} s")
            time.sleep(0.02)
        snapshot_s = time.perf_counter() - t0
        victim = rank_pid(proc.pid, 1)
        os.kill(victim, 9)
        try:
            rc = proc.wait(timeout=FAILOVER_GRACE_S)
            ended = "by itself"
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            rc, ended = proc.wait(), f"killed after {FAILOVER_GRACE_S} s"
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, 9)
        proc.wait()
    return {"seconds_to_first_snapshot": snapshot_s, "killed_rank": 1, "torchrun_exit": rc,
            "torchrun_ended": ended}


def epochs_trained(out: str) -> list:
    """The epochs whose train loss a run printed."""
    return [int(m.group(1)) for m in re.finditer(r"Epoch (\d+): Train Loss", out)]


def mesh_run_numbers(out: str, t0: float) -> dict:
    """A `cli --mesh 2` run's numbers from its stdout (rank 0's lines)."""
    return {"wall_s": time.perf_counter() - t0,
            "final": ast.literal_eval(next(ln for ln in out.splitlines()
                                           if ln.startswith("final: "))[7:]),
            "final_by_rank": launches_line(out, "final_by_rank"),
            "launches_by_rank": launches_line(out, "launches_by_rank"),
            "epochs": epochs_trained(out)}


def failover(card, base: list, tmp: str) -> dict:
    """13b: a `cli --mesh 2` run killed once its first latest/ is committed
    (run a, `--epochs 99`), restarted on its directory with `--resume true
    --epochs 3` (run b), against an uninterrupted `--epochs 3` run (the
    control, started beside run a: process start-up is most of each run).
    ``base``: the cli's arguments without --epochs, --resume and --out_dir.
    Checks the resume; returns the runs' numbers."""
    run, control = os.path.join(tmp, "run_failover"), os.path.join(tmp, "run_control")
    latest = os.path.join(run, "ckpt", "latest", "state.pt")

    def args(epochs, resume, out_dir):
        return base + ["--epochs", str(epochs), "--resume", str(resume).lower(),
                       "--checkpoint_interval", "1", "--out_dir", out_dir]

    t0 = time.perf_counter()
    with open(os.path.join(tmp, "control.out"), "w+") as control_out:
        control_proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             str(MESH_RANKS), *args(FAILOVER_EPOCHS, False, control)],
            cwd=ROOT, stdout=control_out, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            a = killed_run(args(99, False, run), latest, tmp)
            a["wall_s"] = time.perf_counter() - t0
            check(a["torchrun_exit"] != 0,
                  f"run a: expected an unclean death, torchrun exited 0 ({a})")
            resumed_from = int(torch.load(latest, map_location="cpu",
                                          weights_only=False)["epoch"])
            check(1 <= resumed_from < FAILOVER_EPOCHS,
                  f"run a's latest/ is at epoch {resumed_from}: nothing left to resume to "
                  f"{FAILOVER_EPOCHS}")
            for d, name in (("latest", "state.pt"), ("best", "params.pt")):  # torn leftovers
                with open(os.path.join(run, "ckpt", d, f"{name}.tmp99999"), "wb") as fh:
                    fh.write(b"torn")
            t1 = time.perf_counter()
            b = mesh_run_numbers(run_ranks(args(FAILOVER_EPOCHS, True, run), MESH_TIMEOUT_S), t1)
            control_rc = control_proc.wait(timeout=MESH_TIMEOUT_S)
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(control_proc.pid, 9)
            control_proc.wait()
        control_out.seek(0)
        out = control_out.read()
    if control_rc != 0:
        sys.stderr.write(out[-6000:])
    check(control_rc == 0, f"the control run exited {control_rc}")
    c = mesh_run_numbers(out, t0)

    want_epochs = list(range(resumed_from + 1, FAILOVER_EPOCHS + 1))
    check(b["epochs"] == want_epochs, f"run b trained epochs {b['epochs']}, want {want_epochs} "
                                      f"(latest/ at epoch {resumed_from})")
    check(c["epochs"] == list(range(1, FAILOVER_EPOCHS + 1)), f"control epochs {c['epochs']}")
    for tag, r in (("b", b), ("control", c)):
        check(r["final"]["epochs_run"] == FAILOVER_EPOCHS, f"run {tag}: {r['final']}")
        check(all(f == r["final_by_rank"][0] for f in r["final_by_rank"]),
              f"run {tag}: the ranks disagree: {r['final_by_rank']}")
    check(int(torch.load(latest, map_location="cpu", weights_only=False)["epoch"])
          == FAILOVER_EPOCHS, "run b did not refresh latest/ to its last epoch")
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        resumed_rows = [json.loads(ln) for ln in fh][-len(want_epochs):]
    with open(os.path.join(control, "metrics.jsonl")) as fh:
        control_rows = [json.loads(ln) for ln in fh][resumed_from:]
    check([r["epoch"] for r in resumed_rows] == [r["epoch"] for r in control_rows] == want_epochs,
          "the resumed and the control runs' metrics.jsonl do not line up")
    loss_rel = [abs(x["train_loss"] - y["train_loss"]) / abs(y["train_loss"])
                for x, y in zip(resumed_rows, control_rows)]
    ndcg_diff = {k: abs(b["final"][k] - c["final"][k]) for k in ("val_ndcg", "test_ndcg")}
    result = {"run_a": a, "resumed_from_epoch": resumed_from, "epochs_after_resume": want_epochs,
              "train_loss_rel_diff": loss_rel, "ndcg10_abs_diff": ndcg_diff,
              **{f"run_{tag}": {k: r[k] for k in ("wall_s", "final", "launches_by_rank")}
                 for tag, r in (("b", b), ("control", c))}}
    log("failover", card=card, transport=transport(), run="torchrun cli " + " ".join(base),
        **result)
    check(max(loss_rel) <= FAILOVER_LOSS_RTOL,
          f"resumed train loss differs from the control's by {loss_rel} (tol {FAILOVER_LOSS_RTOL})")
    check(max(ndcg_diff.values()) <= FAILOVER_NDCG_TOL,
          f"resumed NDCG@10 differs from the control's by {ndcg_diff} (tol {FAILOVER_NDCG_TOL})")
    return result


def phase_scaling_failover(card) -> dict:
    """Phase 13. 13a: the weak-scaling harness at --sizes 1,2 and at --sizes
    2 --shard_embeddings, K1/K2 on every rank; K1/K2 at the harness's
    shapes (the flagship encoder and decoder at a rank's batch of 256 and
    128) against their plain versions. 13b: the failure path of a
    `cli --preset beauty --mesh 2` run on phase 9's data."""
    tmp = tempfile.mkdtemp(prefix="carca_scaling_")
    try:
        scaling = [scaling_run(card, sizes, shard) for sizes, shard in SCALING_RUNS]
        attn = {(b, causal): attention_at(card, b * (2 if causal == -1 else 1), L, L, causal,
                                          where="bench_scaling")
                for b in (B, B // MESH_RANKS) for causal in (0, -1)}
        torch.cuda.empty_cache()
        data_dir = os.path.join(tmp, "data")
        write_reference_format(synthetic_catalog(n_users=FIT_USERS, n_real_items=FIT_ITEMS,
                                                 seed=SEED), data_dir)
        base = ["-m", "carca_tpu_torch.cli", "--preset", "beauty", "--data_dir", data_dir,
                "--profile_file", "profiles.txt", "--attr_file", "attrs.pkl", "--ctx_file",
                "ctx.pkl", "--device_pipeline", "true", "--seed", str(SEED), "--mesh",
                str(MESH_RANKS)]
        fo = failover(card, base, tmp)
        for tag in ("run_b", "run_control"):
            for r, n in enumerate(fo[tag]["launches_by_rank"]):
                check(n["attention_fwd"] > 0 and n["attention_bwd"] > 0,
                      f"failover {tag}: rank {r} did not run K1 and K2 ({n})")
        return {"scaling": scaling, "attn": attn, "failover": fo}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_entry(name, source, replaces, n, err, ms_plain, bytes_moved, ops, operand, lib=None,
                 shape=None) -> dict:
    """One kernel of the kernels line."""
    b_ms, b_by = bound(bytes_moved, ops, operand)
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": n, "max_abs_err": err, "ms": ms_plain[0], "plain_ms": ms_plain[1],
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    if shape is not None:
        out["shape"] = shape
    return out


def family_entries(f) -> list:
    """The kernels line's entries for phase 12: K1/K2 at each FAMILY_ATTN
    shape (launches: the family fits that run it, by (Lq, Lk, causal)), K3
    f32 at d = 128 over the fashion run's seen index (launches: the
    in-process fashion Recommender)."""
    f32 = 4
    entries = []
    for name, (b, lq, lk, causal, d, trained, fams) in FAMILY_ATTN.items():
        key = shape_key(lq, lk, causal)
        n = {kind: sum(f["fits"][fam]["launches"][f"attention_{kind}_by_shape"].get(key, 0)
                       for fam in fams) for kind in ("fwd", "bwd")}
        res, masks = f["attn"][name], b * (lq + lk) * f32
        shape = f"{name} [{b},{lq},{d}] x [{b},{lk},{d}] causal {causal}"
        entries.append(kernel_entry(f"attention_fwd_{name}", "carca_tpu_torch/csrc/attention_fwd.cu",
                             "carca_tpu/ops/flash_attention.py:113", n["fwd"], res["k1_err"],
                             res["k1"], 2 * b * (lq + lk) * d * f32 + masks, 4 * b * lq * lk * d,
                             "3xtf32", res["lib"]["fwd"], shape))
        if trained:
            entries.append(kernel_entry(
                f"attention_bwd_{name}", "carca_tpu_torch/csrc/attention_bwd.cu",
                "carca_tpu/ops/flash_attention.py:130", n["bwd"], res["k2_err"], res["k2"],
                (3 * lq + 4 * lk) * b * d * f32 + masks, 10 * b * lq * lk * d, "3xtf32",
                res["lib"]["bwd"], shape))
    s = f["serve"]
    r, d = s["rows"], s["d"]
    entries.append(kernel_entry("catalog_topk_fashion", "carca_tpu_torch/csrc/catalog_topk.cu",
                         "carca_tpu/ops/retrieval_topk.py:526", s["launches"]["catalog_topk_f32"],
                         s["k3_err"], s["k3"], r * d * f32 + B * d * f32 + B * KK * 12,
                         2 * B * r * d, "3xtf32", None,
                         f"fashion seen index {r} rows x d={d}, bucket {B}, k={KK}"))
    return entries


def mesh_entries(m) -> list:
    """The kernels line's entries for phase 11: K1/K2 at the --mesh 2 fit's
    rank-local encoder (launches: every K1/K2 launch of that fit, both
    ranks), K3 int8, K4 layout 0 and the rerank over one 5M-row block of
    the 10M int8 index at the --index_shards 2 service's bucket 1
    (launches: both ranks' service runs)."""
    f32, b = 4, B // MESH_RANKS
    attn, fit, t = m["attn"], sum_ranks(m["fit"]["launches_by_rank"]), m["shard"][0]["timings"]
    serve = sum_ranks([r["launches"] for r in m["shard"]])
    rows = t["rows"]
    entries = []

    def add(*args):
        entries.append(kernel_entry(*args))

    masks = b * 2 * L * f32
    local = f"mesh 2 rank-local encoder [{b},{L},{D}] causal 0 dropout {P_DROP}"
    add("attention_fwd_mesh2", "carca_tpu_torch/csrc/attention_fwd.cu",
        "carca_tpu/ops/flash_attention.py:113", fit["attention_fwd"], attn["k1_err"],
        attn["k1"], 4 * b * L * D * f32 + masks, 4 * b * L * L * D, "3xtf32",
        attn["lib"]["fwd"], local)
    add("attention_bwd_mesh2", "carca_tpu_torch/csrc/attention_bwd.cu",
        "carca_tpu/ops/flash_attention.py:130", fit["attention_bwd"], attn["k2_err"],
        attn["k2"], 7 * b * L * D * f32 + masks, 10 * b * L * L * D, "3xtf32",
        attn["lib"]["bwd"], local)
    shard = f"index_shards 2: one {rows}-row int8 block, bucket 1"
    add("catalog_topk_int8_shard", "carca_tpu_torch/csrc/catalog_topk.cu",
        "carca_tpu/ops/retrieval_topk.py:526", serve["catalog_topk_int8"], t["k3_err"],
        t["K3"], rows * (D + f32) + D * f32 + K * 12, 2 * rows * D, "bfloat16", None,
        f"{shard}, k={K}")
    groups = -(-rows // GROUP)
    add("groupmax_shard", "carca_tpu_torch/csrc/groupmax.cu",
        "carca_tpu/ops/retrieval_topk.py:183", serve["groupmax_layout0"], t["k4_err"], t["K4"],
        rows * (D + f32) + D * f32 + groups * f32, 2 * rows * D, "bfloat16", None, shard)
    kg = t["kg"]
    add("tournament_rerank_shard", "carca_tpu_torch/csrc/groupmax.cu",
        "carca_tpu/ops/retrieval_topk.py:497", serve["tournament_rerank"], t["rerank_err"],
        t["rerank"], kg * GROUP * (D + f32) + kg * 8 + D * f32 + kg * GROUP * f32,
        2 * kg * GROUP * D, "bfloat16", None, f"{shard}, k={K + L}, {kg} groups")
    return entries


def scaling_entries(p) -> list:
    """The kernels line's entries for phase 13: K1/K2 at the flagship encoder
    and decoder at a rank's batch of 256 (launches: every rank of both
    bench_scaling runs) and of 128 (the --mesh 2 failover's rank-local
    batch; launches: both ranks of run b and of the control), by shape."""
    f32 = 4
    harness = [r for run in p["scaling"] for r in run["ranks"]]
    failover = [n for tag in ("run_b", "run_control")
                for n in p["failover"][tag]["launches_by_rank"]]
    entries = []
    for (b, causal), res in p["attn"].items():
        ranks, path = ((harness, "scaling") if b == B else (failover, "failover"))
        part = "encoder" if causal == 0 else "decoder"
        bb = b * (2 if causal == -1 else 1)
        key, masks = shape_key(L, L, causal), bb * 2 * L * f32
        n = {kind: sum(r[f"attention_{kind}_by_shape"].get(key, 0) for r in ranks)
             for kind in ("fwd", "bwd")}
        shape = (f"{'bench_scaling ranks' if b == B else 'cli --mesh 2 failover, rank-local'} "
                 f"{part} [{bb},{L},{D}] x [{bb},{L},{D}] causal {causal} dropout {P_DROP}")
        entries.append(kernel_entry(
            f"attention_fwd_{path}_{part}", "carca_tpu_torch/csrc/attention_fwd.cu",
            "carca_tpu/ops/flash_attention.py:113", n["fwd"], res["k1_err"], res["k1"],
            4 * bb * L * D * f32 + masks, 4 * bb * L * L * D, "3xtf32", res["lib"]["fwd"], shape))
        entries.append(kernel_entry(
            f"attention_bwd_{path}_{part}", "carca_tpu_torch/csrc/attention_bwd.cu",
            "carca_tpu/ops/flash_attention.py:130", n["bwd"], res["k2_err"], res["k2"],
            7 * bb * L * D * f32 + masks, 10 * bb * L * L * D, "3xtf32", res["lib"]["bwd"],
            shape))
    return entries


def kernel_entries(k1_err, k2_err, k3_err, k4_err, timings, k2_times, library, launches):
    """The kernels line: every kernel with its launches on the path that
    runs it, its error against the plain version, its time, the plain
    version's, the bound and the library call."""
    f32 = 4
    n10 = N_REAL_ITEMS_10M + 1
    r_seen = 19_157  # rows of the 100k slice's seen index, K3's timed shape
    entries = []

    def add(*args, **kw):
        entries.append(kernel_entry(*args, **kw))

    # K1 and K2 at each timed shape: bytes of q/out (K2: q, dO, dq) at Lq and
    # k/v (K2: k, v, dk, dv) at Lk plus the masks; 2 (K2: 5) products of
    # Lq Lk d multiply-adds, counted whole (causal masking skips none), at
    # the 3xTF32 rate. Launches at the shape on the path that runs it (the
    # train step runs encoder and decoder, phase 12's men fit men's encoder)
    for shape, (b, lq, lk, causal, rate) in ATTN_SHAPES.items():
        suffix = "" if shape == "encoder" else f"_{shape}"
        path = {"rerank": "slice", "men": "family men"}.get(shape, "train")
        key = shape_key(lq, lk, causal)
        masks = b * (lq + lk) * f32
        add(f"attention_fwd{suffix}", "carca_tpu_torch/csrc/attention_fwd.cu",
            "carca_tpu/ops/flash_attention.py:113",
            launches[path]["attention_fwd_by_shape"].get(key, 0), k1_err,
            timings["K1", shape], 2 * b * (lq + lk) * D * f32 + masks, 4 * b * lq * lk * D,
            "3xtf32", library[shape]["fwd"], shape)
        if shape in K2_TIMED:
            add(f"attention_bwd{suffix}", "carca_tpu_torch/csrc/attention_bwd.cu",
                "carca_tpu/ops/flash_attention.py:130",
                launches[path]["attention_bwd_by_shape"].get(key, 0),
                k2_err, k2_times[K2_TIMED[shape]]["bwd"], (3 * lq + 4 * lk) * b * D * f32 + masks,
                10 * b * lq * lk * D, "3xtf32", library[shape]["bwd"], shape)
    add("catalog_topk", "carca_tpu_torch/csrc/catalog_topk.cu",
        "carca_tpu/ops/retrieval_topk.py:526", launches["slice"]["catalog_topk_f32"],
        k3_err["f32"], timings["K3", "seen"], r_seen * D * f32 + B * D * f32 + B * KK * 12,
        2 * B * r_seen * D, "3xtf32")
    for kind, row_bytes in (("bf16", 2 * D), ("int8", D + f32)):
        add(f"catalog_topk_{kind}", "carca_tpu_torch/csrc/catalog_topk.cu",
            "carca_tpu/ops/retrieval_topk.py:526", launches["bench"][f"catalog_topk_{kind}"],
            k3_err[kind], timings["K3", kind],
            n10 * row_bytes + K3_10M_B * D * f32 + K3_10M_B * K * 12,
            2 * K3_10M_B * n10 * D, "bfloat16")
    groups = -(-n10 // 128)
    for layout, replaces, path in ((0, "carca_tpu/ops/retrieval_topk.py:183", "slice_10m"),
                                   (1, "carca_tpu/ops/retrieval_topk.py:235", "bench")):
        add("groupmax" if layout == 0 else "groupmax_bq", "carca_tpu_torch/csrc/groupmax.cu",
            replaces, launches[path][f"groupmax_layout{layout}"], k4_err[layout],
            timings["K4", layout], n10 * (D + f32) + B * D * f32 + groups * B * f32,
            2 * B * n10 * D, "bfloat16")
    # the rerank at bucket 256, k = 562 on the 10M int8 slice: each winner
    # row and its scale read once, the group ids and queries, the scores
    # written; its products at the bf16 rate (the JAX package's stage-3
    # einsum, outside any pallas_call)
    kg = KK + 8
    add("tournament_rerank", "carca_tpu_torch/csrc/groupmax.cu",
        "carca_tpu/ops/retrieval_topk.py:497", launches["slice_10m"]["tournament_rerank"],
        k4_err["rerank"], timings["rerank"],
        B * kg * GROUP * (D + f32) + B * kg * 8 + B * D * f32 + B * kg * GROUP * f32,
        2 * B * kg * GROUP * D, "bfloat16")
    return entries


def fit10m_entries(f, launches):
    """The kernels line's entries for the synthetic10m path (phase 10): K1/K2
    under bf16 compute at the fit's encoder (launches: the fit), K3 bf16 and
    int8 over the seen index at the eval's [256, 64] queries and k + L = 60
    (launches: the fit's monitoring and final eval, and the in-process int8
    eval), K4 layout 0 and the rerank over the 10M bf16 index (launches: the
    in-process full-index eval)."""
    f32, bf16, n10 = 4, 2, FIT10M_ITEMS + 1
    t, errs, attn = f["timings"], f["errs"], f["attn"]
    kk = K + L
    entries = []

    def add(*args):
        entries.append(kernel_entry(*args, shape="synthetic10m"))

    masks = B * 2 * L * f32
    add("attention_fwd_bf16", "carca_tpu_torch/csrc/attention_fwd.cu",
        "carca_tpu/ops/flash_attention.py:113", launches["fit_10m"]["attention_fwd"],
        attn["k1_err"], attn["K1"], 4 * B * L * D * f32 + masks, 4 * B * L * L * D, "bfloat16",
        attn["lib_fwd"])
    add("attention_bwd_bf16", "carca_tpu_torch/csrc/attention_bwd.cu",
        "carca_tpu/ops/flash_attention.py:130", launches["fit_10m"]["attention_bwd"],
        attn["k2_err"], attn["K2"], 7 * B * L * D * f32 + masks, 10 * B * L * L * D,
        "bfloat16", attn["lib_bwd"])
    for case, row_bytes, n in (
            ("seen bf16", D * bf16, launches["fit_10m"]["catalog_topk_bf16"]),
            ("seen int8", D + f32, launches["eval_10m seen int8"]["catalog_topk_int8"])):
        r = t["rows", case]
        add(f"catalog_topk_{case.split()[1]}_seen_10m", "carca_tpu_torch/csrc/catalog_topk.cu",
            "carca_tpu/ops/retrieval_topk.py:526", n, errs[case], t[case],
            r * row_bytes + B * D * f32 + B * kk * 12, 2 * B * r * D, "bfloat16")
    groups = -(-n10 // GROUP)
    full = launches["eval_10m full bf16"]
    add("groupmax_10m_bf16", "carca_tpu_torch/csrc/groupmax.cu",
        "carca_tpu/ops/retrieval_topk.py:183", full["groupmax_layout0"],
        max(errs["full bf16"], errs["K4 full bf16"]), t["K4 full bf16"],
        n10 * D * bf16 + B * D * f32 + groups * B * f32, 2 * B * n10 * D, "bfloat16")
    # the rows of the winner groups read once (the trained queries share
    # most of their groups), each query's kg groups scored
    kg = t["kg"]
    add("tournament_rerank_10m_bf16", "carca_tpu_torch/csrc/groupmax.cu",
        "carca_tpu/ops/retrieval_topk.py:497", full["tournament_rerank"],
        errs["rerank full bf16"], t["rerank full bf16"],
        t["unique_groups"] * GROUP * D * bf16 + B * kg * 8 + B * D * f32 + B * kg * GROUP * f32,
        2 * B * kg * GROUP * D, "bfloat16")
    return entries


def main() -> None:
    if sys.argv[1:2] == ["--rank_task"]:  # one rank of phase 11, under torchrun
        RANK_TASKS[sys.argv[2]](*sys.argv[3:])
        return
    profile_run = "--profile" in sys.argv[1:]
    if set(sys.argv[1:]) - {"--profile"}:
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log("phase_seconds", name=name, seconds=seconds[name])
        return out

    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    k1_err = timed("3 K1", phase_k1)
    k2_err, k2_times = timed("3b K2", phase_k2, card)
    k3_err = timed("4 K3", phase_k3)
    k4_err = timed("4c K4", phase_k4)
    timed("4w d=256", phase_k_wide, card)
    torch.cuda.empty_cache()
    rec, rec_full, host, serve_launches = timed("5 slice 100k", phase_slice)
    timings = timed("6 timing 100k", phase_timing, card, rec, rec_full, host)
    if profile_run:
        timed("7 profile 100k", phase_profile, card, rec, host)
    del rec, rec_full
    rec10, host10, launches_10m, cat10 = timed("5c slice 10M", phase_slice_10m)
    if profile_run:
        timed("7 profile 10M", phase_profile, card, rec10, host10, "10M int8")
    timings_10m, errs_10m = timed("6 timing 10M", timing_10m, card, rec10, host10, cat10)
    timings.update(timings_10m)
    for kind in ("bf16", "int8"):
        k3_err[kind] = max(k3_err[kind], errs_10m["K3", kind])
    for layout in (0, 1):
        k4_err[layout] = max(k4_err[layout], errs_10m["K4", layout])
    k4_err["rerank"] = max(k4_err["rerank"], errs_10m["rerank"])
    del rec10, host10, cat10
    torch.cuda.empty_cache()
    bench_launches = timed("5d bench 10M", phase_bench_10m, card)
    torch.cuda.empty_cache()
    library = timed("6 library", library_attention, card)
    if profile_run:
        timed("7 profile attention", profile_attention, card)
    train_launches = timed("8 train", phase_train, card, profile_run)
    torch.cuda.empty_cache()
    _, fit_launches, k3_fit_err = timed("9 fit + serve", phase_fit_serve, card)
    k3_err["f32"] = max(k3_err["f32"], k3_fit_err)
    torch.cuda.empty_cache()
    fit10m = timed("10 fit 10M", phase_fit_10m, card, profile_run)
    torch.cuda.empty_cache()
    mesh = timed("11 mesh", phase_mesh, card)
    torch.cuda.empty_cache()
    families = timed("12 families", phase_families, card)
    torch.cuda.empty_cache()
    scaling = timed("13 scaling + failover", phase_scaling_failover, card)
    launches = {"slice": serve_launches, "slice_10m": launches_10m, "bench": bench_launches,
                "train": train_launches, "fit_serve": fit_launches,
                "fit_10m": fit10m["fit"]["launches"], **{
                    f"eval_10m {case}": n for case, n in fit10m["eval_launches"].items()},
                **{f"offline_eval_10m {case}": r["launches"]
                   for case, r in fit10m["offline"].items()},
                **{f"family {name}": r["launches"] for name, r in families["fits"].items()},
                "family_serve": families["serve"]["launches"],
                **{"scaling " + " ".join(run["args"]): run["ranks"]
                   for run in scaling["scaling"]},
                **{f"failover {tag}": scaling["failover"][tag]["launches_by_rank"]
                   for tag in ("run_b", "run_control")}}
    log("launches", **launches)
    log("phase_seconds", total=sum(seconds.values()), **seconds)
    entries = (kernel_entries(k1_err, k2_err, k3_err, k4_err, timings, k2_times, library,
                              launches) + fit10m_entries(fit10m, launches) + mesh_entries(mesh)
               + family_entries(families) + scaling_entries(scaling))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
