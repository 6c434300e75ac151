"""Convergence against the reference across the BASELINE families
(counterpart of ``scripts/validate_presets.py``, the port's side alone).

    python -m carca_tpu_torch.validate_presets games|fashion|men|all \
        [--epochs 25] [--early_stop 8] [--out DIR] [--device cpu]

The families differ in shape, not protocol: games adds 8 context features
at d = 128, fashion fuses 128 dense attributes through ``attrctx`` at
g = 512, men has sequences of 200. Each is fitted over its family-shaped
synthetic catalog (``synthetic_catalog`` then ``canonicalize_repeat_ctx``,
seed 0) on the host pipeline with the native assembler, on the card
unless ``--device cpu`` asks for the CPU. The reference's numbers are read
from ``VALIDATION_<family>_ref.json`` at the repository root (measured by
``scripts/measure_reference.py`` with the PyTorch reference on a CPU),
never written. Each family writes ``DIR/VALIDATION_<family>.json``
(``family``, ``config``, the port's metrics under ``carca_tpu_torch``, its
kernel launches and wall seconds, ``reference``) and its run directory
``DIR/run_<family>``, and prints the side-by-side line.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch

from carca_tpu_torch.cli import launch_counts
from carca_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

ROOT = Path(__file__).resolve().parents[1]

# family-shaped synthetic datasets (scripts/validate_presets.py:32-48)
FAMILIES = {
    # configs[1]: contextual (time) features, d=128
    "games": dict(users=4096, items=2000, d_dim=128, g_dim=256, seq_len=50,
                  n_attrs=12, n_ctx=8, min_len=4, max_len=30,
                  embedding="all", decoder="ca"),
    # configs[2]: dense image-attribute vectors fused via attrctx
    "fashion": dict(users=4096, items=2000, d_dim=128, g_dim=512, seq_len=50,
                    n_attrs=128, n_ctx=4, min_len=4, max_len=30,
                    embedding="attrctx", decoder="ca"),
    # configs[3]: long sequences stressing the cross-attention scorer
    "men": dict(users=2048, items=2000, d_dim=64, g_dim=256, seq_len=200,
                n_attrs=12, n_ctx=4, min_len=40, max_len=250,
                embedding="all", decoder="ca"),
}


def family_catalog(fam: dict):
    """The family's synthetic catalog, its repeated (user, item) contexts
    canonicalized as the reference's (user, item)-keyed dict reads them."""
    from carca_tpu_torch.data.synthetic import canonicalize_repeat_ctx, synthetic_catalog

    cat = synthetic_catalog(n_users=fam["users"], n_real_items=fam["items"],
                            n_attrs=fam["n_attrs"], n_ctx=fam["n_ctx"],
                            min_len=fam["min_len"], max_len=fam["max_len"], seed=0)
    return canonicalize_repeat_ctx(cat)


def family_config(fam: dict, epochs: int, early_stop: int, out_dir: str) -> Config:
    """The Config ``scripts/validate_presets.py::run_ours`` fits the family
    with (its ``use_pallas="auto"`` is ``use_kernel="auto"``)."""
    mc = ModelConfig(
        n_items=fam["items"] + 1, n_attrs=fam["n_attrs"], n_ctx=fam["n_ctx"],
        d=fam["d_dim"], g=fam["g_dim"], seq_len=fam["seq_len"],
        target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
        embedding=fam["embedding"], encoding="identity",
        decoder=fam["decoder"], use_kernel="auto")
    return Config(model=mc, data=DataConfig(synthetic=True),
                  train=TrainConfig(batch_size=256, epochs=epochs, early_stop=early_stop,
                                    seed=0, out_dir=out_dir, checkpoint_resume=True))


def _since(before: dict, after: dict) -> dict:
    out = {}
    for key, n in after.items():
        if isinstance(n, dict):
            out[key] = {s: m - before[key].get(s, 0) for s, m in n.items()
                        if m - before[key].get(s, 0)}
        else:
            out[key] = n - before[key]
    return out


def run_family(name: str, epochs: int, early_stop: int, out: str, device: str) -> dict:
    """Fit one family and write ``out/VALIDATION_<name>.json``; the result."""
    from carca_tpu_torch.train.loop import fit

    fam = FAMILIES[name]
    with open(ROOT / f"VALIDATION_{name}_ref.json") as fh:
        reference = json.load(fh)
    cat = family_catalog(fam)
    cfg = family_config(fam, epochs, early_stop, os.path.join(out, f"run_{name}"))
    before = launch_counts(by_shape=True)
    t0 = time.perf_counter()
    _, metrics = fit(cfg, cat, device=device)
    wall = time.perf_counter() - t0
    dev = torch.device(device)
    result = {"family": name, "config": fam, "carca_tpu_torch": metrics,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
              "wall_seconds": wall, "launches": _since(before, launch_counts(by_shape=True)),
              "reference": reference}
    with open(os.path.join(out, f"VALIDATION_{name}.json"), "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(metrics), flush=True)
    print(f"[{name}] test HR@10 ours={metrics['test_hr']:.4f} ref={reference.get('test_hr10')} "
          f"| test NDCG@10 ours={metrics['test_ndcg']:.4f} ref={reference.get('test_ndcg10')}",
          flush=True)
    return result


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Fit the named family (or all three) on ``device``, else ``--device``,
    else the card; returns {family: result}."""
    p = argparse.ArgumentParser(prog="python -m carca_tpu_torch.validate_presets",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("family", choices=[*FAMILIES, "all"])
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--early_stop", type=int, default=8)
    p.add_argument("--out", default="results/validate_presets",
                   help="directory for VALIDATION_<family>.json and the run directories")
    p.add_argument("--device", default="", help="the torch device; default (empty) the card")
    args = p.parse_args(argv)
    device = device or args.device or "cuda"
    os.makedirs(args.out, exist_ok=True)
    names = list(FAMILIES) if args.family == "all" else [args.family]
    return {name: run_family(name, args.epochs, args.early_stop, args.out, device)
            for name in names}


if __name__ == "__main__":
    main()
