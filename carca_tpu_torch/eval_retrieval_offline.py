"""Full-catalog retrieval evaluation of a saved run directory (counterpart
of ``scripts/eval_retrieval_offline.py``): the post-hoc check of retrieval
quality, for runs that trained without the in-fit monitor and for any
later analysis.

    python -m carca_tpu_torch.eval_retrieval_offline RUN_DIR [--mode val|test]
        [--k K] [--which best|latest] [--quantized] [--full_index] [--device cpu]

Rebuilds the Config from ``RUN_DIR/args.json`` (regenerating a synthetic
catalog from its recorded seed, on the device for a device-pipeline run,
or reloading the data files), loads the checkpoint's parameters, ranks
each user's held-out item against the seen items (``--full_index``: every
id; ``--quantized``: the int8 serving index) with ``evaluate_retrieval``
and prints one JSON line of ``retrieval_{mode}_hr/ndcg`` and its
provenance; the kernels' launch counts go to stderr. It runs on the card
unless ``--device cpu`` asks for the CPU. The reference has no
counterpart: its eval samples 100 negatives (``src/data.py:140-192``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Evaluate on ``device``, else ``--device``, else the card; prints and
    returns the JSON line's dict."""
    p = argparse.ArgumentParser(prog="python -m carca_tpu_torch.eval_retrieval_offline",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir")
    p.add_argument("--mode", default="test", choices=("val", "test"))
    p.add_argument("--k", type=int, default=0, help="top-k (default: the run's top_k)")
    p.add_argument("--which", default="best", choices=("best", "latest"))
    p.add_argument("--quantized", action="store_true",
                   help="score against the int8 serving index")
    p.add_argument("--full_index", action="store_true",
                   help="rank the whole id space, not just seen items")
    p.add_argument("--device", default="", help="the torch device; default (empty) the card")
    args = p.parse_args(argv)
    device = device or args.device or "cuda"

    from carca_tpu_torch.cli import launch_counts, load_catalog
    from carca_tpu_torch.models.carca import CARCA
    from carca_tpu_torch.serve.recommender import config_from_run_dir
    from carca_tpu_torch.train.checkpoint import CheckpointKeeper
    from carca_tpu_torch.train.loop import evaluate_retrieval

    cfg = config_from_run_dir(args.run_dir)
    catalog = load_catalog(None, dc=cfg.data, device=device)
    model = CARCA(cfg.model, device=device)
    keeper = CheckpointKeeper(os.path.join(args.run_dir, "ckpt"))
    restore = keeper.restore_best if args.which == "best" else keeper.restore_latest_model
    epoch = restore(model)
    if epoch is None:
        raise FileNotFoundError(f"no {args.which!r} checkpoint under {args.run_dir}/ckpt")
    k = args.k or cfg.train.top_k
    out = evaluate_retrieval(cfg, catalog, model, mode=args.mode, k=k, log=False,
                             seen_only=not args.full_index, quantized=args.quantized)
    out.update({"run_dir": args.run_dir, "which": args.which, "epoch": int(epoch), "k": k,
                "loss": cfg.train.loss, "n_train_negatives": cfg.train.n_train_negatives,
                "neg_distribution": cfg.data.neg_distribution})
    print(json.dumps(out), flush=True)
    print("launches:", json.dumps(launch_counts()), file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    main()
