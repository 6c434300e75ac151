"""The training command line (counterpart of ``carca_tpu/cli.py``): trains
a model with ``train/loop.fit`` and writes its run directory.

    python -m carca_tpu_torch.cli --preset beauty --data_dir DATA \
        --profile_file profiles.txt --attr_file attrs.pkl --ctx_file ctx.pkl \
        --out_dir results/run --resume false

The flags and their defaults are the JAX package's (the reference's,
``scripts/training.py:32-63``, plus its additions), with strict booleans.
The run goes on the card; ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU, and nothing falls back to it.

* ``--use_pallas`` sets ``use_kernel`` (the CUDA kernels: ``auto``/``true``
  launch them on the card, ``false`` runs the plain PyTorch path).
* The TPU-only ``--pack_tables``, ``--remat`` and ``--compilation_cache``
  are accepted and ignored with a note. The host pipeline assembles
  batches with the native C++ assembler (``carca_tpu_torch/native``, built
  with g++ at first use; a failed build raises) unless ``--use_native
  false`` asks for numpy; the run prints ``assembler: native|numpy``.
* A synthetic catalog with ``--device_pipeline true`` (the ``synthetic10m``
  preset: 100,000 users, 10M items) is generated on the run's device.
* ``--model knn`` evaluates the KNN content baseline instead of training;
  ``--eval_retrieval K`` ranks each test user's held-out item against the
  whole catalog after training (``--retrieval_index seen|full``), once the
  train state's optimizer is dropped.
* ``--mesh N`` (data parallel) or ``NxM`` (data × model, with
  ``--shard_embeddings true`` the item and attrs tables row-sharded over
  the model axis) trains over N·M ranks of ``torch.distributed``, one
  process each, launched by torchrun:

      python -m torch.distributed.run --standalone --nproc_per_node 2 \
          -m carca_tpu_torch.cli --preset beauty --mesh 2 ...

  Each rank takes ``cuda:{LOCAL_RANK % device_count}`` (``--device cpu``:
  the CPU, on gloo); ranks that share a card talk over gloo, which checks
  correctness and measures no scaling. The world size must equal the
  mesh's product. Rank 0 writes the run directory and prints ``final:``,
  and every rank's fit metrics as ``final_by_rank:``.
  ``--sparse_items_adam true`` trains the item table with the row-sparse
  Adam there too (each model rank updating its block's rows); "auto"
  stays dense under a mesh, as in the JAX package.
  ``--device_sampling`` is read only under a mesh, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Optional

import torch

from carca_tpu_torch.config import (Config, DataConfig, ModelConfig, TrainConfig, parse_bool,
                                    parse_kernel_flag, preset)


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: prefix matching would route --profile into --profile_file
    p = argparse.ArgumentParser(prog="python -m carca_tpu_torch.cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter,
                                allow_abbrev=False)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--profile_file", type=str, default="")
    p.add_argument("--attr_file", type=str, default="")
    p.add_argument("--ctx_file", type=str, default="")
    p.add_argument("--out_dir", type=str, default="results/run")

    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_schedule", type=str, default="none", help="none | cosine | exponential")
    p.add_argument("--lr_decay_steps", type=int, default=0)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--debug_nans", type=parse_bool, default=False,
                   help="torch.autograd anomaly detection")
    p.add_argument("--profile", type=parse_bool, default=False,
                   help="a torch.profiler trace of the second epoch into OUT_DIR/profile")
    p.add_argument("--seq_len", type=int, default=50)
    p.add_argument("--n_blocks", type=int, default=3)
    p.add_argument("--n_heads", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--l2_reg", type=float, default=0.0)
    p.add_argument("--d_dim", type=int, default=64)
    p.add_argument("--g_dim", type=int, default=256)
    p.add_argument("--residual_sa", type=parse_bool, default=True)
    p.add_argument("--residual_ca", type=parse_bool, default=True)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--early_stop", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--l2_norm", type=parse_bool, default=False)
    p.add_argument("--device", type=str, default="",
                   help="the torch device; default (empty) the card")
    p.add_argument("--test", type=parse_bool, default=True)
    p.add_argument("--n_workers", type=int, default=0, help="ignored; no workers needed")
    p.add_argument("--target_seq_len", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)

    p.add_argument("--encoding", type=str, default="identity")
    p.add_argument("--embedding", type=str, default="all")
    p.add_argument("--decoder", type=str, default="dot")
    p.add_argument("--model", type=str, default="carca",
                   help="carca | knn (the content baseline, evaluated without training)")

    p.add_argument("--preset", type=str, default="",
                   help="named config: beauty|games|fashion|men|synthetic10m|smoke")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--use_pallas", type=parse_kernel_flag, default="auto",
                   help="the CUDA kernels: true | false (plain path) | auto")
    p.add_argument("--remat", type=parse_bool, default=False, help="TPU only; ignored")
    p.add_argument("--pack_tables", type=parse_kernel_flag, default="auto",
                   help="TPU only; ignored")
    p.add_argument("--compilation_cache", type=str, default="", help="TPU only; ignored")
    p.add_argument("--synthetic", type=parse_bool, default=False)
    p.add_argument("--synthetic_users", type=int, default=2000)
    p.add_argument("--synthetic_items", type=int, default=1000)
    p.add_argument("--synthetic_process", default="zipf", choices=("zipf", "markov"),
                   help="zipf = iid Zipf(1) items; markov = cluster-Markov sequences")
    p.add_argument("--resume", type=parse_bool, default=True)
    p.add_argument("--use_native", type=parse_bool, default=True,
                   help="host pipeline: the native C++ batch assembler (false: numpy)")
    p.add_argument("--device_pipeline", type=parse_bool, default=False,
                   help="catalog on the device and batches assembled there")
    p.add_argument("--inner_steps", type=int, default=8,
                   help="device-pipeline train/eval steps per call")
    p.add_argument("--mesh", type=str, default="",
                   help="mesh shape over torchrun's ranks: '8' (data parallel) or '4x2' "
                        "(data x model; row-sharded tables with --shard_embeddings true)")
    p.add_argument("--shard_embeddings", type=parse_bool, default=False,
                   help="row-shard the item and attrs tables over the mesh's model axis")
    p.add_argument("--device_sampling", type=parse_bool, default=False,
                   help="sample train negatives on the device (the host pipeline under a "
                        "mesh); no effect on one device")
    p.add_argument("--neg_distribution", type=str, default="uniform",
                   choices=("uniform", "popularity"),
                   help="train negatives (device pipeline): uniform | popularity")
    p.add_argument("--exact_rejection", type=parse_kernel_flag, default="auto",
                   help="device-pipeline negative rejection against the full history: "
                        "true | false (visible window) | auto (history <= 4x seq_len)")
    p.add_argument("--sparse_items_adam", type=parse_kernel_flag, default="auto",
                   help="lazy row-sparse Adam for the item table (device pipeline): true | "
                        "false | auto (>=1M-item catalogs on one device; dense under --mesh)")
    p.add_argument("--checkpoint", type=parse_bool, default=True,
                   help="false disables all checkpoint IO")
    p.add_argument("--checkpoint_interval", type=int, default=1,
                   help="refresh latest/ every N-th epoch (and the first)")
    p.add_argument("--loss", type=str, default="bce", choices=("bce", "softmax"))
    p.add_argument("--n_train_negatives", type=int, default=1,
                   help="negatives per positive train position (>1 needs --device_pipeline)")
    p.add_argument("--eval_retrieval", type=int, default=0,
                   help="after training, full-catalog leave-one-out retrieval eval at this "
                        "top-k (dot/wdot decoders)")
    p.add_argument("--eval_retrieval_every", type=int, default=0,
                   help="the retrieval eval on the val split every N-th epoch, logged to "
                        "metrics.jsonl (0 = off; dot/wdot decoders)")
    p.add_argument("--select_by", type=str, default="ndcg",
                   choices=("ndcg", "retrieval_hr", "retrieval_ndcg"),
                   help="best-checkpoint metric: ndcg (sampled val NDCG) or the monitored "
                        "retrieval_* (needs --eval_retrieval_every)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA weight averaging: 0 = off; d in (0, 1)")
    p.add_argument("--retrieval_index", type=str, default="seen", choices=("seen", "full"),
                   help="retrieval index: seen = items with >=1 training event; full = every id")
    return p


# flags that overlay a --preset Config when set to other than their parser
# default: execution and tuning knobs, not the model's shape
_PRESET_OVERLAY = {
    "train": {
        "lr": "lr", "lr_schedule": "lr_schedule",
        "lr_decay_steps": "lr_decay_steps", "lr_decay_rate": "lr_decay_rate",
        "beta1": "beta1", "beta2": "beta2", "l2_reg": "l2_reg",
        "batch_size": "batch_size", "epochs": "epochs",
        "early_stop": "early_stop", "seed": "seed", "test": "test",
        "out_dir": "out_dir", "resume": "checkpoint_resume",
        "debug_nans": "debug_nans", "profile": "profile",
        "inner_steps": "inner_steps", "shard_embeddings": "shard_embeddings",
        "checkpoint_interval": "checkpoint_interval", "checkpoint": "checkpoint",
        "sparse_items_adam": "sparse_items_adam",
        "loss": "loss", "n_train_negatives": "n_train_negatives",
        "eval_retrieval_every": "eval_retrieval_every",
        "select_by": "select_by", "ema_decay": "ema_decay",
    },
    "data": {
        "use_native": "use_native", "device_pipeline": "device_pipeline",
        "synthetic_users": "synthetic_users", "synthetic_items": "synthetic_items",
        "synthetic_process": "synthetic_process", "device_sampling": "device_sampling",
        "exact_rejection": "exact_rejection", "neg_distribution": "neg_distribution",
        # the synthetic catalog must be regenerable from args.json alone
        "seed": "synthetic_seed",
        "data_dir": "data_dir", "profile_file": "profile_file",
        "attr_file": "attr_file", "ctx_file": "ctx_file", "synthetic": "synthetic",
    },
    "model": {
        "use_pallas": "use_kernel", "compute_dtype": "compute_dtype",
        "dropout": "dropout", "l2_norm": "l2_norm", "gamma": "gamma",
        "embedding": "embedding", "encoding": "encoding", "decoder": "decoder",
    },
}


def parse_mesh(spec: str):
    """'8' → ((8,), ('data',)); '4x2' → ((4, 2), ('data', 'model'))."""
    if not spec:
        return (), ("data",)
    dims = tuple(int(d) for d in spec.lower().split("x"))
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh wants 'N' or 'NxM', got {spec!r}")
    return dims, ("data", "model")[: len(dims)]


def _overlay_cli_flags(cfg: Config, args) -> Config:
    """Apply the flags that differ from their parser defaults on top of a
    preset Config (a flag at its default keeps the preset's value)."""
    defaults = vars(build_parser().parse_args([]))
    sections = {"train": cfg.train, "data": cfg.data, "model": cfg.model}
    changed = {}
    for section, fields in _PRESET_OVERLAY.items():
        repl = {dst: getattr(args, src) for src, dst in fields.items()
                if getattr(args, src) != defaults[src]}
        if repl:
            changed[section] = dataclasses.replace(sections[section], **repl)
    if not changed:
        return cfg
    return Config(model=changed.get("model", cfg.model), data=changed.get("data", cfg.data),
                  train=changed.get("train", cfg.train))


def config_from_args(args, n_items: int, n_attrs: int, n_ctx: int) -> Config:
    mesh_shape, mesh_axes = parse_mesh(args.mesh)
    if args.preset:
        cfg = _overlay_cli_flags(preset(args.preset, n_items, n_attrs, n_ctx), args)
        if mesh_shape:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, mesh_shape=mesh_shape, mesh_axes=mesh_axes))
        return cfg
    mc = ModelConfig(
        n_items=n_items, n_attrs=n_attrs, n_ctx=n_ctx,
        d=args.d_dim, g=args.g_dim, seq_len=args.seq_len,
        target_len=args.target_seq_len, n_blocks=args.n_blocks,
        n_heads=args.n_heads, dropout=args.dropout,
        embedding=args.embedding.lower(), encoding=args.encoding.lower(),
        decoder=args.decoder.lower(), residual_sa=args.residual_sa,
        residual_ca=args.residual_ca, gamma=args.gamma, l2_norm=args.l2_norm,
        compute_dtype=args.compute_dtype, use_kernel=args.use_pallas)
    dc = DataConfig(
        data_dir=args.data_dir, profile_file=args.profile_file,
        attr_file=args.attr_file, ctx_file=args.ctx_file,
        use_native=args.use_native, device_pipeline=args.device_pipeline,
        device_sampling=args.device_sampling, exact_rejection=args.exact_rejection,
        neg_distribution=args.neg_distribution, synthetic=args.synthetic,
        synthetic_users=args.synthetic_users, synthetic_items=args.synthetic_items,
        synthetic_seed=args.seed, synthetic_process=args.synthetic_process)
    tc = TrainConfig(
        lr=args.lr, loss=args.loss, n_train_negatives=args.n_train_negatives,
        lr_schedule=args.lr_schedule, lr_decay_steps=args.lr_decay_steps,
        lr_decay_rate=args.lr_decay_rate, beta1=args.beta1, beta2=args.beta2,
        l2_reg=args.l2_reg, batch_size=args.batch_size, epochs=args.epochs,
        early_stop=args.early_stop, seed=args.seed, test=args.test,
        out_dir=args.out_dir, checkpoint_resume=args.resume,
        debug_nans=args.debug_nans, profile=args.profile,
        inner_steps=args.inner_steps, checkpoint=args.checkpoint,
        sparse_items_adam=args.sparse_items_adam,
        checkpoint_interval=args.checkpoint_interval,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        shard_embeddings=args.shard_embeddings,
        eval_retrieval_every=args.eval_retrieval_every,
        select_by=args.select_by, ema_decay=args.ema_decay)
    return Config(model=mc, data=dc, train=tc)


def load_catalog(args, dc: Optional[DataConfig] = None, device: str = "cuda"):
    """The catalog the resolved DataConfig describes: the reference files
    under ``data_dir``, or the synthetic catalog (regenerable from
    args.json alone), generated on ``device`` with the device pipeline."""
    if dc is None:
        dc = config_from_args(args, 0, 0, 0).data
    if dc.synthetic or not dc.data_dir:
        from carca_tpu_torch.data.synthetic import synthetic_generator
        gen = synthetic_generator(dc.synthetic_process, device=dc.device_pipeline,
                                  torch_device=device)
        return gen(n_users=dc.synthetic_users, n_real_items=dc.synthetic_items,
                   seed=dc.synthetic_seed)
    from carca_tpu_torch.data.loaders import load_dataset
    return load_dataset(dc.data_dir, dc.profile_file, dc.attr_file, dc.ctx_file)


def check_flags(args) -> None:
    if args.model.lower() not in ("carca", "knn"):
        raise ValueError(f"--model {args.model}: want carca or knn")


_TPU_ONLY = ("pack_tables", "remat", "compilation_cache")


def launch_counts(by_shape: bool = False) -> dict:
    """Every kernel wrapper's launch count in this process; ``by_shape``
    adds K1's and K2's by (Lq x Lk causal) shape."""
    from carca_tpu_torch.ops.flash_attention import attention_bwd, fused_attention
    from carca_tpu_torch.ops.retrieval_topk import catalog_topk, groupmax, tournament_rerank

    out = {"attention_fwd": fused_attention.launches,
           "attention_bwd": attention_bwd.launches,
           **{f"catalog_topk_{kind}": n for kind, n in catalog_topk.launches.items()},
           **{f"groupmax_layout{lay}": n for lay, n in groupmax.launches.items()},
           "tournament_rerank": tournament_rerank.launches}
    if by_shape:
        for name, fn in (("attention_fwd", fused_attention), ("attention_bwd", attention_bwd)):
            out[f"{name}_by_shape"] = {f"{lq}x{lk} causal {causal}": n
                                       for (lq, lk, causal), n in fn.launches_by_shape.items()}
    return out


def join_mesh(args, device: str):
    """Under ``--mesh`` of more than one device: join torchrun's process
    group (before any catalog is drawn on the device) and check that the
    world is the mesh; returns (this rank's device, the mesh or None)."""
    n = math.prod(parse_mesh(args.mesh)[0])
    if n <= 1:
        return device, None
    from carca_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    device = str(initialize_distributed(device))
    return device, make_mesh(*parse_mesh(args.mesh))  # raises unless the world is n


def _objects_by_rank(obj) -> list:
    """Every rank's ``obj`` (any picklable value), in rank order."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def main(argv: Optional[list] = None, device: Optional[str] = None) -> dict:
    """Train (or with ``--model knn`` evaluate the baseline) and print
    ``final: {...}``; returns the final metrics. The run goes on
    ``device``, else ``--device``, else the card; under ``--mesh`` on this
    rank's device of that kind."""
    args = build_parser().parse_args(argv)
    check_flags(args)
    device, mesh = join_mesh(args, device or args.device or "cuda")
    defaults = vars(build_parser().parse_args([]))
    for name in _TPU_ONLY:
        if getattr(args, name) != defaults[name]:
            print(f"note: --{name} is a TPU knob; ignored")
    dc = config_from_args(args, 0, 0, 0).data
    catalog = load_catalog(args, dc, device)
    cfg = config_from_args(args, catalog.n_items, catalog.n_attrs, catalog.n_ctx)
    from carca_tpu_torch.train import loop

    finals = None
    if args.model.lower() == "knn":
        metrics = loop.evaluate_knn(cfg, catalog, device=device)
    else:
        state, metrics = loop.fit(cfg, catalog, device=device)
        if mesh is not None:  # every rank's metrics, before rank 0 adds its own
            finals = _objects_by_rank(dict(metrics))
        if args.eval_retrieval and cfg.model.decoder == "ca":
            print("note: --eval_retrieval applies to the dot/wdot decoders (the cross-attention "
                  "decoder is a ranking model, not a retrieval tower); skipping retrieval eval")
        if args.eval_retrieval and cfg.model.decoder != "ca":
            model = state.model
            # drop the optimizer's moments (5 GB at 10M items) before the
            # catalog pass; training is over
            del state
            if mesh is not None:  # rank 0 evaluates the gathered tables
                model = loop.gather_model(model, mesh, cfg.train.shard_embeddings
                                          and mesh.n_model > 1)
            if model is not None:
                metrics.update(loop.evaluate_retrieval(
                    cfg, catalog, model, k=args.eval_retrieval,
                    seen_only=args.retrieval_index == "seen"))
    rank0 = mesh is None or mesh.rank == 0
    launches = _objects_by_rank(launch_counts(by_shape=True))
    if rank0:
        print("final:", metrics)
        print("launches:", json.dumps(launch_counts()), flush=True)
        if mesh is not None:
            print("launches_by_rank:", json.dumps(launches), flush=True)
            if finals is not None:
                print("final_by_rank:", json.dumps(finals), flush=True)
    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        peaks = _objects_by_rank({"peak_device_mib": torch.cuda.max_memory_allocated() / 2**20})
        if rank0:
            print("memory:", json.dumps(dict(peaks[0], by_rank=[p["peak_device_mib"]
                                                                for p in peaks])), flush=True)
    return metrics


if __name__ == "__main__":
    main()
