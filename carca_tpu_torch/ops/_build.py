"""Build and load the CUDA kernels in ``carca_tpu_torch/csrc/``.

Every ``*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build goes to ``build/carca_tpu_torch/<hash>/`` under the repository root,
keyed by a hash of the sources and flags, at the first kernel launch (or an
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64
_U32 = ctypes.c_uint32
_I64 = ctypes.c_int64
# C signatures of csrc/*.cu: name -> (restype, argtypes)
SIGNATURES = {
    "carca_error_string": (ctypes.c_char_p, [_I]),
    "carca_attention_fwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _U64, _P, _U32, _F, _P]),
    "carca_attention_fwd_branch": (_I, [_I, _I]),
    "carca_attention_keep_bits": (_I, [_P, _U64, _U64, _P, _U32, _P]),
    "carca_attention_bwd": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _I, _U64, _P, _U32, _F, _P]),
    "carca_attention_bwd_branch": (_I, [_I, _I]),
    "carca_catalog_topk_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I, _I, _I, _I]),
    "carca_catalog_topk": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I64, _I, _P]),
    "carca_groupmax_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "carca_groupmax": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "carca_groupmax_branch": (_I, [_I, _I]),
    "carca_groupmax_probe": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "carca_tournament_rerank_smem_bytes": (ctypes.c_size_t, [_I, _I]),
    "carca_tournament_rerank": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "carca_select_topk_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "carca_select_topk_tma": (_I, [_P, _I64, _I64, _I, _I, _I]),
    "carca_select_topk": (_I, [_P, _I64, _I64, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I64,
                               _P, _P, _P]),
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output, including ptxas register / shared-memory usage


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{cu.stem}.o" for cu in sorted(CSRC.glob("*.cu"))]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(CSRC / f"{obj.stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for obj in objs]
        outs = [(obj.stem, proc.communicate()[0], proc.returncode)  # waits for every one
                for obj, proc in zip(objs, procs)]
        log = "".join(f"== {name}.cu\n{out}" for name, out, _ in outs)
        failed = [name for name, _, rc in outs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp_lib), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed (exit {link.returncode}):\n{log}")
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
