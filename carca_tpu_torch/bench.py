"""Train throughput of the port on one CUDA card (counterpart of the
repository's ``bench.py``).

    python -m carca_tpu_torch.bench                      # flagship, kernels
    python -m carca_tpu_torch.bench --use_kernel false   # the plain path
    python -m carca_tpu_torch.bench --config men         # L = 200
    python -m carca_tpu_torch.bench --config 10m         # 10M items, row-sparse Adam

``build_setup`` builds what ``bench.py::build_setup`` builds — the flagship
model (d=64, g=256, 2 blocks, 2 heads, L=50, target_len 100, dropout 0.5,
``embedding=all``, ``encoding=identity``, ``decoder=ca``, f32) over
``synthetic_catalog(n_users=4096, n_real_items=2000, seed=0)``, or the
``men`` shape (L=200 over a 2,048-user catalog of longer histories), or
``10m`` (BASELINE configs[4]: ``synthetic_catalog_device(100,000 users,
10,000,000 items)`` generated on the card, ``decoder=dot``, bf16 compute,
bf16 attrs and the lazy row-sparse item Adam), with ``TrainConfig``
defaults at batch 256, the catalog on the device and K = ``inner_steps``
steps per call of the scanned step, which on the card is one CUDA graph
(``train/graph.py``; ``graph=False`` the eager loop). ``measure`` times it
as ``bench.py`` does: 2 warm calls (for the graph, its eager warm-up and its
capture), then the median of 5 windows of ``max(1, 100 // K)`` calls, each
window ended by a device synchronize, in examples per second. Prints
``step: graph`` (or ``step: eager``), then one JSON line. Needs a CUDA card.

Beside the rate, the line holds ``bench.py``'s utilisation keys, under its
names and formulas (``utils/flops.py``): ``mfu``, the step's analytic
matmul FLOPs at the median rate over the card's dense bf16 peak;
``hbm_gbps``, the step's modelled HBM bytes at that rate (the row-sparse
Adam's touched rows where ``build_setup`` resolved it on); and
``hbm_bw_util``, that over the card's HBM peak. ``mfu`` and
``hbm_bw_util`` are left out on a card the peak tables do not know.
``bench.py``'s ``hbm_gbps_xla`` has no counterpart: it is XLA's
``cost_analysis`` of the compiled step, and an eager PyTorch step has no
compiled whole to ask.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu_torch.data.dataset import epoch_batches
from carca_tpu_torch.data.device_pipeline import DeviceDataset
from carca_tpu_torch.data.synthetic import synthetic_catalog, synthetic_catalog_device
from carca_tpu_torch.train import sparse_adam
from carca_tpu_torch.train.loop import attrs_dtype, make_scanned_device_train_step
from carca_tpu_torch.train.state import create_train_state
from carca_tpu_torch.utils.flops import utilisation

CONFIGS = ("flagship", "men", "10m")
N_WINDOWS = 5


@dataclasses.dataclass
class Setup:
    step: object
    state: object
    attrs: torch.Tensor
    dd: DeviceDataset
    chunks: list  # four [inner, B] user-row matrices of full batches
    inner: int
    tc: TrainConfig
    mc: ModelConfig
    sparse_items: bool  # the item table's Adam: row-sparse (True) or dense


def build_setup(config: str = "flagship", batch: int = 256, device="cuda",
                use_kernel="auto", graph=None, **model_overrides) -> Setup:
    """The model, state and scanned device-pipeline step of one headline
    config (``bench.py::build_setup``); ``graph`` as
    ``make_scanned_device_train_step`` takes it; ``model_overrides`` replace
    ModelConfig fields (e.g. ``dropout=0.0`` for a deterministic step)."""
    device = torch.device(device)
    at_scale = config == "10m"
    if at_scale:
        cat = synthetic_catalog_device(n_users=100_000, n_real_items=10_000_000, seed=0,
                                       device=device)
        seq_len = 50
    elif config == "men":
        cat = synthetic_catalog(n_users=2048, n_real_items=2000, n_attrs=12,
                                n_ctx=4, min_len=40, max_len=250, seed=0)
        seq_len = 200
    elif config == "flagship":
        cat = synthetic_catalog(n_users=4096, n_real_items=2000, seed=0)
        seq_len = 50
    else:
        raise ValueError(f"unknown config {config!r}; want one of {CONFIGS}")
    fields = dict(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                  d=64, g=256, seq_len=seq_len, target_len=100, n_blocks=2, n_heads=2,
                  dropout=0.5, embedding="all", encoding="identity",
                  decoder="dot" if at_scale else "ca",
                  compute_dtype="bfloat16" if at_scale else "float32", use_kernel=use_kernel)
    fields.update(model_overrides)
    mc = ModelConfig(**fields)
    tc = TrainConfig(batch_size=batch, seed=0)
    sparse_items = sparse_adam.resolve(Config(mc, DataConfig(device_pipeline=True), tc))
    state = create_train_state(mc, tc, device, sparse_items=sparse_items)
    attrs = torch.as_tensor(cat.attrs, dtype=attrs_dtype(mc), device=device)
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, test=True, device=device)
    rng = np.random.default_rng(0)
    inner = tc.inner_steps
    # full batches only: -1 padding rows would inflate the examples count
    rows = [r for r in epoch_batches(dd.users("train"), tc.batch_size, rng, shuffle=True)
            if (r >= 0).all()]
    if not rows:
        raise ValueError(f"batch {batch} exceeds the config's user count "
                         f"({len(dd.users('train'))}): no full batch to measure")
    chunks = [torch.as_tensor(np.stack([rows[(j * inner + i) % len(rows)]
                                        for i in range(inner)]), dtype=torch.int64).to(device)
              for j in range(4)]
    step = make_scanned_device_train_step(mc, inner, tc, sparse_items=sparse_items, graph=graph)
    return Setup(step, state, attrs, dd, chunks, inner, tc, mc, sparse_items)


def measure(s: Setup):
    """Examples/s of each timed window (after two warm calls)."""
    losses = None
    for i in range(2):
        s.state, losses = s.step(s.state, s.attrs, s.dd.arrays, s.chunks[i % len(s.chunks)])
    torch.cuda.synchronize()
    n_calls = max(1, 100 // s.inner)
    rates = []
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        for i in range(n_calls):
            s.state, losses = s.step(s.state, s.attrs, s.dd.arrays,
                                     s.chunks[i % len(s.chunks)])
        torch.cuda.synchronize()
        rates.append(n_calls * s.inner * s.tc.batch_size / (time.perf_counter() - t0))
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"non-finite training loss: {losses.tolist()}")
    return rates


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=CONFIGS, default="flagship")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--use_kernel", choices=("auto", "false"), default="auto",
                    help="auto = the attention kernels K1/K2; false = the plain path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("carca_tpu_torch.bench measures a CUDA card; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = build_setup(args.config, args.batch,
                    use_kernel="auto" if args.use_kernel == "auto" else False)
    torch.cuda.reset_peak_memory_stats()
    rates = measure(s)
    rate = statistics.median(rates)
    print(f"step: {s.step.mode}")
    print(json.dumps({
        "metric": f"train_examples_per_sec_{args.config}",
        "value": rate, "unit": "examples/sec/chip",
        "rates": {"min": min(rates), "median": rate, "max": max(rates)},
        **utilisation(s.mc, s.tc.batch_size, rate, s.sparse_items, s.state.generator.device),
        "sparse_items": s.sparse_items, "use_kernel": args.use_kernel, "batch": args.batch,
        "step": s.step.mode,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
