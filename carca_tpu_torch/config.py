"""Typed configuration (counterpart of ``carca_tpu/config.py``).

``ModelConfig``, ``DataConfig``, ``TrainConfig`` and ``Config`` (with its
flat ``args.json`` dump), the six named presets, and strict flag parsers.
Field names and defaults follow the JAX package, so an ``args.json`` of
either package rebuilds a ``Config`` of either, except:

* ``use_kernel`` replaces ``use_pallas``. ``"auto"`` (and ``True``) routes
  attention through the CUDA kernel wrapper
  (``ops/flash_attention.fused_attention``), which decides by device alone:
  the plain version for CPU tensors, the kernel for CUDA tensors — where
  what the kernel lacks (weight dropout, autograd) raises rather than
  falling back. ``False`` always runs the plain version, on any device.
  There is no size threshold: the TPU's measured crossover does not carry
  over to the GPU.
* ``pack_tables`` is gone: lane packing exists only for the TPU's (8, 128)
  tiling (``params_from_jax`` unpacks).

``remat`` is the JAX package's: each encoder block runs under activation
checkpointing (``models/remat.py``, the counterpart of its
``jax.checkpoint``), trading the blocks' saved activations for a second
forward in the backward; the result is the same, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

EMBEDDINGS = ("all", "attrctx", "attr", "id", "mlpid")
ENCODINGS = ("identity", "learnable", "positional")
DECODERS = ("ca", "dot", "wdot")
COMPUTE_DTYPES = ("float32", "bfloat16")
LOSSES = ("bce", "softmax")
LR_SCHEDULES = ("none", "cosine", "exponential")
SELECT_BY = ("ndcg", "retrieval_hr", "retrieval_ndcg")
PRESETS = ("beauty", "games", "fashion", "men", "synthetic10m", "smoke")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (``carca_tpu.config.ModelConfig``).

    ``n_items`` counts the pad row: item id 0 is the universal pad.
    """

    n_items: int
    n_attrs: int
    n_ctx: int
    d: int = 64
    g: int = 256
    seq_len: int = 50
    target_len: int = 100
    n_blocks: int = 3
    n_heads: int = 2
    dropout: float = 0.5
    embedding: str = "all"
    encoding: str = "identity"
    decoder: str = "dot"
    residual_sa: bool = True
    residual_ca: bool = True
    gamma: float = 0.9
    l2_norm: bool = False
    compute_dtype: str = "float32"
    use_kernel: Any = "auto"
    remat: bool = False  # checkpoint each encoder block: device memory for a recompute

    def __post_init__(self) -> None:
        if self.embedding not in EMBEDDINGS:
            raise ValueError(f"unknown embedding {self.embedding!r}; want one of {EMBEDDINGS}")
        if self.encoding not in ENCODINGS:
            raise ValueError(f"unknown encoding {self.encoding!r}; want one of {ENCODINGS}")
        if self.decoder not in DECODERS:
            raise ValueError(f"unknown decoder {self.decoder!r}; want one of {DECODERS}")
        if self.d % self.n_heads != 0:
            raise ValueError("d must be divisible by n_heads (src/carca.py:208)")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}; got {self.compute_dtype!r}")
        if not (self.use_kernel is True or self.use_kernel is False
                or self.use_kernel == "auto"):
            raise ValueError(
                f"use_kernel must be True, False, or 'auto'; got {self.use_kernel!r}")

    @property
    def head_dim(self) -> int:
        return self.d // self.n_heads


@dataclass(frozen=True)
class DataConfig:
    """Dataset location and input-pipeline knobs
    (``carca_tpu.config.DataConfig``). File formats follow the reference
    loaders (``data/loaders.py``). ``device_pipeline``: the catalog on the
    device and batches assembled there; else host batches from
    ``BatchBuilder``, assembled by the native C++ assembler
    (``carca_tpu_torch/native``) with ``use_native``, else by numpy.
    ``exact_rejection``: the device pipeline rejects
    negatives against the user's full history (True), the visible window
    (False), or the full history when the longest history is at most 4 x
    seq_len ("auto")."""

    data_dir: str = ""
    profile_file: str = ""
    attr_file: str = ""
    ctx_file: str = ""
    eval_subsample: int = 10_000  # val/test user cap (scripts/training.py:154-157)
    use_native: bool = True
    device_pipeline: bool = False
    device_sampling: bool = False
    exact_rejection: Any = "auto"
    neg_distribution: str = "uniform"  # train negatives: uniform | popularity
    synthetic: bool = False
    synthetic_users: int = 2000
    synthetic_items: int = 1000
    synthetic_seed: int = 0
    synthetic_process: str = "zipf"  # zipf | markov


@dataclass(frozen=True)
class TrainConfig:
    """Optimization and loop hyperparameters (``carca_tpu.config.TrainConfig``,
    reference defaults ``scripts/training.py:40-59``). ``inner_steps`` train
    steps run per call of the device pipeline's step. ``ema_decay`` 0 is
    off; d in (0, 1) keeps shadow = d·shadow + (1−d)·params after every
    optimizer step and evaluates, retains and serves the shadow."""

    lr: float = 1e-3
    loss: str = "bce"  # "bce" (the reference) | "softmax" (sampled softmax)
    n_train_negatives: int = 1  # negatives per positive train position
    lr_schedule: str = "none"  # none | cosine | exponential
    lr_decay_steps: int = 0  # horizon in steps (0 → constant lr)
    lr_decay_rate: float = 0.1  # exponential: rate per horizon; cosine: alpha
    beta1: float = 0.9
    beta2: float = 0.98
    l2_reg: float = 0.0  # torch Adam weight_decay semantics (grad += wd * p)
    batch_size: int = 256
    epochs: int = 500
    early_stop: int = 20
    top_k: int = 10
    seed: int = 0
    verbose: int = 1
    test: bool = True  # leave-one-out mode flag (src/data.py:59-72)
    out_dir: str = "results/run"
    mesh_shape: Tuple[int, ...] = ()  # () = one device; else (n_data[, n_model]) ranks
    mesh_axes: Tuple[str, ...] = ("data",)
    shard_embeddings: bool = False
    inner_steps: int = 8  # train steps per call of the device pipeline's step
    profile: bool = False  # torch.profiler trace of the second epoch
    debug_nans: bool = False  # torch.autograd anomaly detection
    checkpoint_resume: bool = True
    checkpoint: bool = True  # False: no checkpoint is written or read
    checkpoint_interval: int = 1  # refresh latest/ every N-th epoch (and the first)
    sparse_items_adam: Any = "auto"  # row-sparse item-table Adam (train/sparse_adam.py)
    eval_retrieval_every: int = 0
    select_by: str = "ndcg"
    ema_decay: float = 0.0

    def __post_init__(self) -> None:
        if self.loss not in LOSSES:
            raise ValueError(f"TrainConfig.loss must be one of {LOSSES}, got {self.loss!r}")
        if self.lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}; want one of {LR_SCHEDULES}")
        if self.n_train_negatives < 1:
            raise ValueError("n_train_negatives must be >= 1")
        if self.inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        if self.select_by not in SELECT_BY:
            raise ValueError(f"TrainConfig.select_by must be one of {SELECT_BY}, "
                             f"got {self.select_by!r}")


@dataclass(frozen=True)
class Config:
    model: ModelConfig
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def dump_args_json(self, path: str) -> None:
        """Write the flat args.json contract (``scripts/training.py:108-110``)."""
        flat: Dict[str, Any] = {}
        for section in (self.model, self.data, self.train):
            for f in dataclasses.fields(section):
                flat[f.name] = getattr(section, f.name)
        with open(path, "w") as fh:
            fh.write(json.dumps(flat, default=str))


def preset(name: str, n_items: int = 0, n_attrs: int = 0, n_ctx: int = 0) -> Config:
    """Named presets for the five BASELINE configs and ``smoke``
    (``carca_tpu/config.py:252-305``). Catalog dimensions are dataset
    properties; pass them in when known."""
    def model(**kw) -> ModelConfig:
        return ModelConfig(n_items=n_items, n_attrs=n_attrs, n_ctx=n_ctx, **kw)

    if name == "beauty":  # configs[0]: 2-block d=64, seq 50, 100-neg eval
        return Config(model=model(d=64, n_blocks=2, seq_len=50, embedding="all",
                                  decoder="ca", encoding="identity"))
    if name == "games":  # configs[1]: contextual time features, d=128
        return Config(model=model(d=128, n_blocks=2, seq_len=50, embedding="all",
                                  decoder="ca"))
    if name == "fashion":  # configs[2]: dense image-attribute vectors
        return Config(model=model(d=128, g=512, n_blocks=2, seq_len=50,
                                  embedding="attrctx", decoder="ca"))
    if name == "men":  # configs[3]: long sequences (len 200)
        return Config(model=model(d=64, n_blocks=2, seq_len=200, embedding="all",
                                  decoder="ca"))
    if name == "synthetic10m":  # configs[4]: full-catalog scoring at 10M items
        m = ModelConfig(n_items=n_items or 10_000_001, n_attrs=n_attrs or 64,
                        n_ctx=n_ctx or 8, d=64, n_blocks=2, seq_len=50, embedding="all",
                        decoder="dot", compute_dtype="bfloat16")
        return Config(model=m,
                      data=DataConfig(synthetic=True, synthetic_users=100_000,
                                      synthetic_items=10_000_000, device_sampling=True,
                                      device_pipeline=True),
                      train=TrainConfig(shard_embeddings=True, mesh_axes=("data", "model"),
                                        checkpoint_interval=10))
    if name == "smoke":  # tiny deterministic CPU config for tests
        m = ModelConfig(n_items=n_items or 101, n_attrs=n_attrs or 12, n_ctx=n_ctx or 4,
                        d=16, g=32, n_blocks=2, n_heads=2, seq_len=10, target_len=20,
                        dropout=0.1, decoder="ca")
        return Config(model=m,
                      data=DataConfig(synthetic=True, synthetic_users=200, synthetic_items=100),
                      train=TrainConfig(batch_size=32, epochs=5, early_stop=3))
    raise ValueError(f"unknown preset {name!r}; want one of {PRESETS}")


def parse_bool(s: Any) -> bool:
    """Strict boolean parsing (the reference's ``type=bool`` read any string
    as True, ``scripts/training.py:48``)."""
    if isinstance(s, bool):
        return s
    v = str(s).strip().lower()
    if v in ("1", "true", "t", "yes", "y"):
        return True
    if v in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean from {s!r}")


def parse_kernel_flag(s: Any) -> Any:
    """A ``use_kernel``-style value: a strict boolean or the string "auto"
    (``carca_tpu.config.parse_pallas_flag``)."""
    if str(s).strip().lower() == "auto":
        return "auto"
    return parse_bool(s)
