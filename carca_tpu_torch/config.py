"""Model configuration (counterpart of ``carca_tpu/config.py``).

Only what the serving slice needs: ``ModelConfig`` with its validation and
the ``beauty`` preset (BASELINE configs[0]). Field names and defaults follow
the JAX package, except:

* ``use_kernel`` replaces ``use_pallas``. ``"auto"`` (and ``True``) routes
  attention through the CUDA kernel wrapper
  (``ops/flash_attention.fused_attention``), which decides by device alone:
  the plain version for CPU tensors, the kernel for CUDA tensors — where
  what the kernel lacks (weight dropout, autograd) raises rather than
  falling back. ``False`` always runs the plain version, on any device.
  There is no size threshold: the TPU's measured crossover does not carry
  over to the GPU.
* ``pack_tables`` and ``remat`` are gone: lane packing exists only for the
  TPU's (8, 128) tiling (``params_from_jax`` unpacks), and the port has no
  training path yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

EMBEDDINGS = ("all", "attrctx", "attr", "id", "mlpid")
ENCODINGS = ("identity", "learnable", "positional")
DECODERS = ("ca", "dot", "wdot")
COMPUTE_DTYPES = ("float32", "bfloat16")


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


def preset(name: str, n_items: int = 0, n_attrs: int = 0, n_ctx: int = 0) -> ModelConfig:
    """Named model presets. Catalog dimensions are dataset properties; pass
    them in when known."""
    if name == "beauty":  # BASELINE configs[0]: 2-block d=64, seq 50
        return ModelConfig(n_items=n_items, n_attrs=n_attrs, n_ctx=n_ctx,
                           d=64, n_blocks=2, seq_len=50, embedding="all",
                           decoder="ca", encoding="identity")
    raise ValueError(f"unknown preset {name!r}")
