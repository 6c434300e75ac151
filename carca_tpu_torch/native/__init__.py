"""The native (C++) host batch assembler: its build and its ctypes binding
(counterpart of ``carca_tpu/native/__init__.py``).

``assembler.cpp`` is compiled by ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` at first use into ``build/carca_tpu_torch/native/<hash>/`` under
the repository root, keyed by a hash of the source and the command, and
published with ``os.replace`` from a temporary file of its own, so that
processes building at once (pytest-xdist workers) never interleave their
writes. This is a host library, not a CUDA kernel: ``ops/_build.py`` does
not link it.

Unlike the JAX package, nothing falls back to numpy: a failed build or load
raises with the compiler's output. ``DataConfig.use_native=False`` is the
way to ask for the numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "assembler.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "carca_tpu_torch" / "native"
LIB_NAME = "libassembler.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_TIMEOUT_S = 120

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
# items, offsets, ctx, n_ctx, win_start, win_end, user_rows, batch, L
_COMMON = [_p_i32, _p_i64, _p_f32, _i64, _p_i64, _p_i64, _p_i64, _i64, _i64]
_OUTPUTS = [_p_i32, _p_f32, _p_i32, _p_f32, _p_f32]  # p_x, p_c, o_x, o_c, y
SIGNATURES = {
    # ... n_items, seed, n_threads, outputs
    "carca_train_batch": (_i64, _COMMON + [_i64, _u64, _i64] + _OUTPUTS),
    # ... T, n_items, seed, n_threads, outputs
    "carca_eval_batch": (_i64, _COMMON + [_i64, _i64, _u64, _i64] + _OUTPUTS),
}


def source_hash() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """The shared library's path, compiling it unless it exists. Raises
    RuntimeError with the compiler's output when the build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f"{LIB_NAME}.", suffix=".tmp")
    os.close(fd)
    try:
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building the native assembler ({' '.join(cmd)}) failed: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the native assembler ({' '.join(cmd)}) failed "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: another builder or loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def load(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with its C signatures declared."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the native assembler {path} failed: {e}") from e
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class NativeAssembler:
    """``BatchBuilder``'s ``native`` slot: the same Batch contract as the
    numpy path. Negatives come from the library's splitmix64 streams,
    seeded per call from one draw of the caller's numpy Generator, so
    batches are reproducible and equal to the JAX package's native batches
    for the same generator state, whatever ``n_threads``."""

    def __init__(self, lib: ctypes.CDLL, n_threads: Optional[int] = None):
        self._lib = lib
        self.n_threads = int(n_threads or min(8, os.cpu_count() or 1))

    @staticmethod
    def _inputs(builder, user_rows, mode):
        cat = builder.cat
        start, end = builder._windows[mode]
        rows = np.ascontiguousarray(user_rows, dtype=np.int64)
        if rows.ndim != 1 or (rows.size and rows.max() >= cat.n_users):
            raise ValueError(f"user rows must be a 1-D array of ids below {cat.n_users} "
                             "(-1 pads)")
        if cat.ctx_vals.shape != (len(cat.items), cat.n_ctx):
            raise ValueError(f"ctx_vals {cat.ctx_vals.shape} is not [events, n_ctx]")
        return (np.ascontiguousarray(cat.items, dtype=np.int32),
                np.ascontiguousarray(cat.offsets, dtype=np.int64),
                np.ascontiguousarray(cat.ctx_vals, dtype=np.float32), cat.n_ctx,
                np.ascontiguousarray(start, dtype=np.int64),
                np.ascontiguousarray(end, dtype=np.int64), rows, len(rows), builder.L)

    @staticmethod
    def _outputs(b, L, width, n_ctx):
        return (np.zeros((b, L), np.int32), np.zeros((b, L, n_ctx), np.float32),
                np.zeros((b, width), np.int32), np.zeros((b, width, n_ctx), np.float32),
                np.zeros((b, width), np.float32))

    def train_batch(self, builder, user_rows, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        inputs = self._inputs(builder, user_rows, "train")
        b, L, n_ctx = inputs[7], inputs[8], inputs[3]
        outs = self._outputs(b, L, 2 * L, n_ctx)
        alive = self._lib.carca_train_batch(*inputs, builder.cat.n_items,
                                            np.uint64(rng.integers(0, 2**63)), self.n_threads,
                                            *outs)
        return self._batch(outs, alive)

    def eval_batch(self, builder, user_rows, rng: np.random.Generator,
                   mode: str) -> Dict[str, np.ndarray]:
        inputs = self._inputs(builder, user_rows, mode)
        b, L, n_ctx = inputs[7], inputs[8], inputs[3]
        outs = self._outputs(b, L, builder.T + 1, n_ctx)
        alive = self._lib.carca_eval_batch(*inputs, builder.T, builder.cat.n_items,
                                           np.uint64(rng.integers(0, 2**63)), self.n_threads,
                                           *outs)
        return self._batch(outs, alive)

    @staticmethod
    def _batch(outs, alive) -> Dict[str, np.ndarray]:
        p_x, p_c, o_x, o_c, y = outs
        return {"p_x": p_x, "p_c": p_c, "o_x": o_x, "o_c": o_c, "y_true": y,
                "n_valid": np.int32(alive)}


def get_assembler(n_threads: Optional[int] = None) -> NativeAssembler:
    """The native assembler, built at first use; raises when the library
    cannot be built or loaded."""
    return NativeAssembler(load(build()), n_threads)
