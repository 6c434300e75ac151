"""carca_tpu_torch — the CARCA scoring engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``carca_tpu`` (JAX/Pallas on TPU), which stays in the repository
as the reference this package is tested against. The module paths mirror
the JAX package: ``carca_tpu/models/encoder.py`` has its counterpart at
``carca_tpu_torch/models/encoder.py``. This package imports ``torch`` and
``numpy`` only — never JAX — so it runs on a machine without JAX.

Kernels live in ``csrc/`` and are compiled with ``nvcc`` on first use
(``ops/_build.py``). Every kernel wrapper keeps a plain PyTorch version of
the same function: CPU tensors take the plain version, CUDA tensors launch
the kernel or raise.
"""

from carca_tpu_torch.config import ModelConfig, preset

__version__ = "0.1.0"

__all__ = ["ModelConfig", "preset", "__version__"]
