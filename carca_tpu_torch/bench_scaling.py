"""Weak-scaling harness: examples/s per data rank at mesh sizes 1..N
(counterpart of ``scripts/bench_scaling.py``).

    python -m carca_tpu_torch.bench_scaling --sizes 1,2,4,8 [--shard_embeddings]
    python -m carca_tpu_torch.bench_scaling --sizes 1,2 --device cpu   # gloo ranks on the CPU

Per size n the global batch grows with the data axis (weak scaling: the
work per data rank stays constant) through the train step the trainer
uses over a mesh (``parallel/step.make_sharded_train_step``), and the
efficiency is the throughput per data rank relative to the smallest size
run. With ``--shard_embeddings`` an even size runs the mesh (n/2, 2) over
("data", "model"), the item and attrs tables row-sharded over "model".

Each size is one group of n rank processes of this module (``--_child
n``), started with the environment torchrun gives its ranks; each joins
through ``parallel/mesh.initialize_distributed``, which takes NCCL where
every local rank has a card of its own and gloo otherwise, and says which
on stderr. A size of 1 builds no group and runs the one-device step. The
run goes on the card, with the attention kernels K1/K2 (``use_kernel``
left at "auto"); ``--device cpu`` asks for gloo ranks on the CPU and the
plain attention, and nothing falls back to the CPU when no card is found.
Each rank prints its K1/K2 ``launches:`` on stderr, which the parent
passes on; a failed rank makes the parent raise with that rank's stderr.

Ranks that share one card (or the CPU's cores) measure the mechanics of
the collectives, not hardware scaling: their ideal efficiency is ~1/N,
not 1. The parent prints one JSON line per size, in the JAX script's keys
and rounding: ``devices``, ``data_axis``, ``global_batch``,
``examples_per_sec``, ``per_chip`` and ``efficiency_vs_{n}dev``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from carca_tpu_torch.config import ModelConfig, TrainConfig
from carca_tpu_torch.data.dataset import BatchBuilder
from carca_tpu_torch.data.synthetic import Catalog, synthetic_catalog

ROOT = Path(__file__).resolve().parents[1]
SIZE_TIMEOUT_S = 1800.0  # one size's ranks, as the JAX script's child


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m carca_tpu_torch.bench_scaling",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--per_chip_batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shard_embeddings", action="store_true")
    ap.add_argument("--device", default="", choices=("", "cpu"),
                    help="empty = the card (one per rank where there are enough); "
                         "cpu = gloo ranks on the CPU")
    ap.add_argument("--_child", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def model_parallel(n: int, shard_embeddings: bool) -> int:
    """The model axis: 2 at even sizes under ``--shard_embeddings``, else 1."""
    return 2 if (shard_embeddings and n % 2 == 0) else 1


def catalog() -> Catalog:
    return synthetic_catalog(n_users=4096, n_real_items=2000, seed=0)


def model_config(cat: Catalog, use_kernel="auto") -> ModelConfig:
    """The flagship widths of the JAX script's ``run_one``."""
    return ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx, d=64, g=256,
                       seq_len=50, target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
                       embedding="all", decoder="ca", use_kernel=use_kernel)


def host_batch(cat: Catalog, mc: ModelConfig, global_batch: int) -> Dict[str, np.ndarray]:
    """The one global batch every step takes: the train users resized to
    ``global_batch`` rows, negatives from ``default_rng(0)``."""
    builder = BatchBuilder(cat, mc.seq_len, mc.target_len, test=True)
    rows = np.resize(builder.users("train"), global_batch)
    batch = builder.train_batch(rows, np.random.default_rng(0))
    batch.pop("n_valid")
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _require_card(device: str) -> None:
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("carca_tpu_torch.bench_scaling runs on a CUDA card and none is "
                           "visible; pass --device cpu for gloo ranks on the CPU")


def run_one(n: int, args) -> Optional[dict]:
    """Examples/s of this rank's group of ``n`` (a rank process); the line on
    rank 0, None on the others."""
    from carca_tpu_torch.parallel.mesh import (initialize_distributed, local_rows, make_mesh,
                                               prepare_state_for_mesh, rank)
    from carca_tpu_torch.parallel.step import make_sharded_train_step
    from carca_tpu_torch.train.loop import attrs_dtype, make_train_step, to_device
    from carca_tpu_torch.train.state import create_train_state
    from carca_tpu_torch.cli import launch_counts

    _require_card(args.device)
    device = initialize_distributed(args.device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_par = model_parallel(n, args.shard_embeddings)
    data_axis = n // model_par
    global_batch = args.per_chip_batch * data_axis
    cat = catalog()
    mc = model_config(cat)
    tc = TrainConfig(batch_size=global_batch, seed=0)
    state = create_train_state(mc, tc, device)
    attrs = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc), device=device)
    if n == 1:
        step = make_train_step(mc, tc)
    else:
        mesh = (make_mesh((data_axis, model_par), ("data", "model")) if model_par > 1
                else make_mesh((n,), ("data",)))
        state = prepare_state_for_mesh(state, mesh, model_par > 1)
        if model_par > 1:
            attrs = local_rows(attrs, mesh).contiguous()
        step = make_sharded_train_step(mc, tc, mesh, shard_embeddings=model_par > 1)
    batch = host_batch(cat, mc, global_batch)

    # the batch crosses to the device every step, as the JAX script hands
    # its numpy batch to every call
    for _ in range(2):
        state, loss = step(state, attrs, to_device(batch, device))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, attrs, to_device(batch, device))
    _sync(device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite training loss {float(loss)}")
    counts = launch_counts(by_shape=True)
    sys.stderr.write("launches: " + json.dumps({
        "size": n, "rank": rank(), "device": str(device),
        **{k: counts[k] for k in ("attention_fwd", "attention_bwd", "attention_fwd_by_shape",
                                  "attention_bwd_by_shape")}}) + "\n")
    if rank() != 0:
        return None
    return {"devices": n, "data_axis": data_axis, "global_batch": global_batch,
            "examples_per_sec": round(args.steps * global_batch / dt, 1)}


def summarize(results: List[dict]) -> List[dict]:
    """The JAX script's summary: per-chip = per *data-axis* rank (the
    per-chip batch is defined per data shard; model shards split the
    lookup, not the batch), and the efficiency baseline is the smallest
    size run (the first)."""
    def data_chips(r):
        return r.get("data_axis", r["devices"])

    base = results[0]["examples_per_sec"] / data_chips(results[0])
    base_n = results[0]["devices"]
    out = []
    for r in results:
        per_chip = r["examples_per_sec"] / data_chips(r)
        out.append(dict(r, per_chip=round(per_chip, 1),
                        **{f"efficiency_vs_{base_n}dev": round(per_chip / base, 3)}))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_size(n: int, args, log_dir: str) -> dict:
    """Start ``n`` rank processes of this module with torchrun's rank
    environment and wait for them; rank 0's line. Every rank's stderr goes
    to this process's stderr; a failed rank (or a group past its time)
    raises with that rank's stderr."""
    port = _free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), base.get("PYTHONPATH")]))
    cmd = [sys.executable, "-m", "carca_tpu_torch.bench_scaling", "--_child", str(n),
           "--per_chip_batch", str(args.per_chip_batch), "--steps", str(args.steps),
           "--device", args.device] + (["--shard_embeddings"] if args.shard_embeddings else [])
    procs = []
    for r in range(n):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out = open(os.path.join(log_dir, f"size{n}.rank{r}.out"), "w")
        err = open(os.path.join(log_dir, f"size{n}.rank{r}.err"), "w")
        procs.append((subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=out, stderr=err),
                      out, err))
    deadline = time.monotonic() + SIZE_TIMEOUT_S
    try:
        while True:
            rcs = [p.poll() for p, _, _ in procs]
            if (all(rc == 0 for rc in rcs) or any(rc not in (None, 0) for rc in rcs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
            err.close()

    def text(r, kind):
        return Path(log_dir, f"size{n}.rank{r}.{kind}").read_text()

    # the first rank that failed, else the first still running at the deadline
    failed = next((r for r, rc in enumerate(rcs) if rc not in (None, 0)),
                  next((r for r, rc in enumerate(rcs) if rc is None), None))
    if failed is not None:
        sys.stderr.write(text(failed, "err")[-4000:])
        raise RuntimeError(f"size {n} failed: rank {failed} " + (
            f"exited {rcs[failed]}" if rcs[failed] is not None
            else f"still running after {SIZE_TIMEOUT_S:.0f} s"))
    for r in range(n):
        sys.stderr.write(text(r, "err"))
    return json.loads(text(0, "out").strip().splitlines()[-1])


def main(argv: Optional[list] = None) -> List[dict]:
    """Run every size, print one JSON line per size and return them."""
    args = build_parser().parse_args(argv)
    if args._child:
        line = run_one(args._child, args)
        if line is not None:
            print(json.dumps(line), flush=True)
        from carca_tpu_torch.parallel.mesh import world_size

        if world_size() > 1:
            torch.distributed.destroy_process_group()
        return []
    _require_card(args.device)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="carca_scaling_") as log_dir:
        results = [run_size(int(s), args, log_dir) for s in args.sizes.split(",")]
    out = summarize(results)
    for r in out:
        print(json.dumps(r), flush=True)
    return out


if __name__ == "__main__":
    main()
