"""Build and load the hand-written CUDA kernels of the port.

The sources under ``magi_v2_tpu_torch/csrc/`` have a plain C interface. At
first use each is compiled with ``nvcc`` for Hopper (sm_90a) into its own
shared library under ``magi_v2_tpu_torch/_build/``, named by a hash of the
source, the headers beside it and the flags (so an edited source or header
builds anew), all sources at once in parallel processes, and loaded with
``ctypes``. Nothing is built when a module is imported, and nothing is
built on a machine that never launches a kernel.
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
SOURCES = ("manifold.cu", "banded.cu", "leapfrog.cu", "nuts.cu", "pt.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# C signatures of the entry points, by family (pointers and stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints)
SIGNATURES = {
    # beta_temp and its stride (0: one for all chains, 1: one per chain)
    "manifold_fwd": [_P] * 10 + [_I] + [_D, _I, _I, _I] + [_P] * 5 + [_P],
    "manifold_energy": [_P] * 7 + [_I] + [_D, _I, _I, _I] + [_P] * 4 + [_P],
    "manifold_bwd": [_P] * 9 + [_I] + [_I, _I, _I] + [_P] * 5 + [_P],
    "manifold_fwd_given": [_P] * 10 + [_I] + [_P] + [_D] + [_I] * 4
    + [_P] * 5 + [_P],
    # the whitened form: dz after RmD
    "manifold_fwd_whitened": [_P] * 11 + [_I] + [_D, _I, _I, _I] + [_P] * 5
    + [_P],
    "manifold_fwd_whitened_given": [_P] * 11 + [_I] + [_P] + [_D] + [_I] * 4
    + [_P] * 5 + [_P],
    "manifold_energy_given": [_P] * 7 + [_I] + [_D] + [_I] * 4 + [_P] * 4
    + [_P],
    "manifold_bwd_given": [_P] * 9 + [_I] + [_P] * 2 + [_I] * 4 + [_P] * 5
    + [_P],
    "banded_matvec": [_P] * 6 + [_I] * 7 + [_L] * 8 + [_D, _D, _I] + [_P],
    "banded_solve": [_P] * 3 + [_I] * 5 + [_L] * 6 + [_P],
    "leapfrog_update": [_P] * 6 + [_I] * 7 + [_P] * 4 + [_I, _P] + [_P],
    "pt_swap": [_P] * 5 + [_I] * 3 + [_P] * 2 + [_P],
    "nuts_leaf": [_P] * 9 + [_I] + [_P] * 14 + [_I] + [_P] * 2 + [_D]
    + [_I] * 5 + [_P],
}


class Launch:
    """One kernel launch with its argument list made once: ``args`` (all
    but the stream; tensors stand for their pointers) are converted to
    ctypes values here, so that a call converts nothing. ``rebind`` points
    one argument at another tensor (the caller keeps that tensor alive; the
    tensors given here are kept by the object); a call takes the stream,
    raises when the launch is refused, and adds one to ``counts[key]``
    (to each of the keys, for a tuple of them)."""

    __slots__ = ("fn", "cargs", "counts", "key", "keys", "keep")

    def __init__(self, fn, args, counts: dict, key):
        import torch

        self.keys = (key,) if isinstance(key, str) else tuple(key)
        self.fn, self.counts, self.key = fn, counts, self.keys[0]
        self.keep = [a for a in args if isinstance(a, torch.Tensor)]
        if len(args) + 1 != len(fn.argtypes):
            raise TypeError(f"{key} takes {len(fn.argtypes) - 1} arguments "
                            f"and the stream, got {len(args)}")
        self.cargs = [ctype(a.data_ptr() if isinstance(a, torch.Tensor)
                            else a)
                      for ctype, a in zip(fn.argtypes, args)] + [_P(0)]

    def rebind(self, index: int, tensor) -> None:
        self.cargs[index].value = tensor.data_ptr()

    def __call__(self, stream: int) -> None:
        self.cargs[-1].value = stream
        err = self.fn(*self.cargs)
        if err != 0:
            raise RuntimeError(f"CUDA launch of {self.key} failed: error "
                               f"{err}")
        for key in self.keys:
            self.counts[key] += 1


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


def _digest(source: str) -> str:
    """A hash of the source, the headers it may include (every ``.cuh``
    under ``csrc/``) and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared libraries, the build's wall time and the
    compiler's log of each source built in this process."""

    def __init__(self, paths, build_seconds: float, logs: dict):
        self.paths = list(paths)
        self.build_seconds = build_seconds
        self.logs = logs
        self.libs = [ctypes.CDLL(str(p)) for p in self.paths]

    @property
    def log(self) -> str:
        return "\n".join(self.logs.values())

    def entry(self, symbol: str, family: str):
        """The C entry point ``symbol`` with the signature of ``family``."""
        for lib in self.libs:
            try:
                fn = getattr(lib, symbol)
            except AttributeError:
                continue
            fn.argtypes = SIGNATURES[family]
            fn.restype = ctypes.c_int
            return fn
        raise AttributeError(f"no kernel entry point {symbol}")


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Compile each source (once per source hash), all in parallel, and
    load the libraries."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    outs = [BUILD_DIR / f"lib{Path(s).stem}_{_digest(s)}.so" for s in SOURCES]
    nvcc = _nvcc()
    procs = {}
    for src, out in zip(SOURCES, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for src, (cmd, tmp, out, proc) in procs.items():
        _, err = proc.communicate()
        logs[src] = err
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return KernelLibrary(outs, time.perf_counter() - t0, logs)
