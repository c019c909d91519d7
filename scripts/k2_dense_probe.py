"""Where the time of K2's dense block goes, on one CUDA card.

    python3 scripts/k2_dense_probe.py

Prints the device time per launch (50 launches replayed from one CUDA
graph, timed with CUDA events) of the leapfrog update (two kicks, the
velocity, the drift; float32):

1. of the full dense metric at widths k = 64 ... 1100 and 16 ... 256
   chains, and of the 3081-wide diagonal and 8-wide tail;
2. of copies of csrc/leapfrog.cu with parts of the dense block removed
   (the FMAs, the copies of M^{-1}, the stream of kicked momenta back
   from L2 into the ring, the cluster barrier), built into
   magi_v2_tpu_torch/_build/probe/. A copy computes wrong values; only
   its time is read.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from magi_v2_tpu_torch.ops import _build  # noqa: E402
from magi_v2_tpu_torch.sampler import hmc  # noqa: E402

FMA = "acc[r][u][c] = fmadd(ps[c], m[u], acc[r][u][c]);"
FETCH = "copy16_async(dst + e * W, a.tail_inv + (size_t)i * a.ld + j);"
STREAM = "dst[at_of(row_of(e), chain_of(e) / 4) + chain_of(e) % 4] = pf[u];"
VARIANTS = {
    "as_is": [],
    "no_fma": [(FMA, ";")],
    "no_fetch": [(FETCH, ";")],
    "no_stream": [(STREAM, ";")],
    "no_fma_fetch_stream": [(FMA, ";"), (FETCH, ";"), (STREAM, ";")],
    "no_stream_no_cluster_barrier": [("cluster.sync();", "__syncthreads();"),
                                     (STREAM, ";")],
}


def device_us(fn, reps=50):
    """Device time of one call of ``fn``, from a graph of ``reps`` calls."""
    return chip_smoke._graph_ms(fn, reps=reps, rounds=1) * 1e3


def time_case(device, C, dim, k):
    q, p, g, eps, mass = chip_smoke.leapfrog_case(C, dim, k, torch.float32,
                                                  device)
    launch = hmc.bind_leapfrog(q, p, g, eps, mass, 2, True)
    return device_us(lambda: launch(
        torch.cuda.current_stream(device).cuda_stream))


def build_variants():
    """{name: shared library} of the copies of csrc/leapfrog.cu."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "leapfrog.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = so
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("k2_dense_probe: no CUDA device")
    device = torch.device("cuda:0")
    _build.load_library()
    for C in (16, 64, 128, 256):
        print(f"dense, {C} chains, us: " + ", ".join(
            f"k {k} {time_case(device, C, k, k):.2f}"
            for k in (64, 128, 256, 489, 1100)), flush=True)
    for C in (64, 256):
        print(f"3081 wide, {C} chains, us: diagonal "
              f"{time_case(device, C, 3081, 0):.2f}, tail of 8 "
              f"{time_case(device, C, 3081, 8):.2f}", flush=True)
    saved = hmc._ENTRIES.get(torch.float32)
    try:
        for name, so in build_variants().items():
            fn = ctypes.CDLL(str(so)).magi_leapfrog_update_f32
            fn.argtypes = _build.SIGNATURES["leapfrog_update"]
            fn.restype = ctypes.c_int
            hmc._ENTRIES[torch.float32] = fn
            print(f"{name}, us: " + ", ".join(
                f"k {k} at {C} chains {time_case(device, C, k, k):.2f}"
                for C, k in ((16, 489), (256, 489), (64, 1100), (16, 64))),
                flush=True)
    finally:
        hmc._ENTRIES[torch.float32] = saved


if __name__ == "__main__":
    main()
