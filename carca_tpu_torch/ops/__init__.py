"""Hand-written CUDA kernels for the serving path and the train step, each
beside its plain PyTorch version:

* :mod:`carca_tpu_torch.ops.flash_attention` — ``fused_attention``, the
  masked attention forward with weight dropout (kernel K1,
  ``csrc/attention_fwd.cu``) and, under autograd, its backward
  (``attention_bwd``, kernel K2, ``csrc/attention_bwd.cu``);
* :mod:`carca_tpu_torch.ops.retrieval_topk` — ``catalog_topk`` over an
  f32, bf16 or int8 index: the stream top-k (kernel K3,
  ``csrc/catalog_topk.cu``) or the tournament (group maxima, kernel K4, and
  its rerank, ``csrc/groupmax.cu``), all three on one tensor-core scoring
  routine (``csrc/scoring.cuh``); the tournament's stage 2 and final top-k
  run ``select_topk``, the select kernel (``csrc/select_topk.cu``,
  ``jax.lax.top_k``'s counterpart).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. ``build()`` compiles the kernels ahead of
the first launch (``ops/_build.py``).
"""

from carca_tpu_torch.ops._build import build
from carca_tpu_torch.ops.flash_attention import attention_bwd, fused_attention
from carca_tpu_torch.ops.retrieval_topk import (
    QuantizedIndex,
    catalog_topk,
    dequantize_index,
    quantize_index,
)

__all__ = ["build", "fused_attention", "attention_bwd", "catalog_topk", "QuantizedIndex",
           "quantize_index", "dequantize_index"]
