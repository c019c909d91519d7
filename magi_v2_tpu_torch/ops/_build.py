"""Build and load the hand-written CUDA kernels of the port.

The sources under ``magi_v2_tpu_torch/csrc/`` have a plain C interface. At
first use they are compiled with ``nvcc`` for Hopper (sm_90a) into a shared
library under ``magi_v2_tpu_torch/_build/``, named by a hash of the sources
and flags (so an edited source builds anew), and loaded with ``ctypes``.
Nothing is built when a module is imported, and nothing is built on a
machine that never launches a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("manifold_seir.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures of the entry points, by kernel (pointers and stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints)
SIGNATURES = {
    "fwd": [_P] * 10 + [_D, _I, _I, _I] + [_P] * 3 + [_P],
    "energy": [_P] * 7 + [_D, _I, _I, _I] + [_P] * 2 + [_P],
    "bwd": [_P] * 9 + [_I, _I, _I] + [_P] * 3 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of magi_v2_tpu_torch need the CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared library, its build time and the compiler's log."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))

    def entry(self, kernel: str, model: str, dtype_suffix: str):
        fn = getattr(self.lib, f"magi_manifold_{kernel}_{model}_{dtype_suffix}")
        fn.argtypes = SIGNATURES[kernel]
        fn.restype = ctypes.c_int
        return fn


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Compile (once per source hash) and load the kernel library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmagi_manifold_{_digest()}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}"
            )
        log = res.stderr
        os.replace(tmp, out)
    return KernelLibrary(out, time.perf_counter() - t0, log)
