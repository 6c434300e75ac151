"""Hand-written CUDA kernels for the serving path, each beside its plain
PyTorch version:

* :mod:`carca_tpu_torch.ops.flash_attention` — ``fused_attention``, the
  masked attention forward (kernel K1, ``csrc/attention_fwd.cu``);
* :mod:`carca_tpu_torch.ops.retrieval_topk` — ``catalog_topk``, the
  streaming catalog top-k over an f32 index (kernel K3,
  ``csrc/catalog_topk.cu``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. ``build()`` compiles the kernels ahead of
the first launch (``ops/_build.py``).
"""

from carca_tpu_torch.ops._build import build
from carca_tpu_torch.ops.flash_attention import fused_attention
from carca_tpu_torch.ops.retrieval_topk import (
    QuantizedIndex,
    catalog_topk,
    dequantize_index,
    quantize_index,
)

__all__ = ["build", "fused_attention", "catalog_topk", "QuantizedIndex",
           "quantize_index", "dequantize_index"]
