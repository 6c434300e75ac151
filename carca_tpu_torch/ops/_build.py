"""Build and load the CUDA kernels in ``carca_tpu_torch/csrc/``.

Every ``*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
goes to ``build/carca_tpu_torch/<hash>/`` under the repository root, keyed
by a hash of the sources and flags, at the first kernel launch (or an
explicit ``build()``), so a fresh checkout builds everything it runs.

Calling convention of every C entry point: tensors are passed as
``ctypes.c_void_p`` from ``Tensor.data_ptr()``, the stream as
``ctypes.c_void_p`` from ``torch.cuda.current_stream().cuda_stream``, and
the function returns ``cudaGetLastError()`` after its launches; the
wrapper raises unless it is 0 (``check``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "carca_tpu_torch"
LIB_NAME = "libcarca_tpu_torch.so"
SMEM_LIMIT = 232_448  # bytes of dynamic shared memory one block may use on sm_90
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu: name -> (restype, argtypes)
SIGNATURES = {
    "carca_error_string": (ctypes.c_char_p, [_I]),
    "carca_attention_fwd_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "carca_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, ctypes.c_float, _I, _P]),
    "carca_catalog_topk_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "carca_catalog_topk": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P]),
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including ptxas register / shared-memory usage


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA kernels need the CUDA toolkit to build")


def build() -> BuildResult:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        return BuildResult(lib, 0.0, log_file.read_text() if log_file.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp_lib), *cu],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
        log_file.write_text(log)
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, time.perf_counter() - t0, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every C
    signature declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().carca_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
