"""Where the time of the NUTS leaf kernel goes, on one CUDA card.

    python3 scripts/nuts_leaf_probe.py

Prints the device time per launch (chip_smoke._graph_ms: 50 launches
replayed from one CUDA graph, the state the work depends on restored before
each launch and its time taken off) of the leaf kernel (float32, the dense
489 metric of the SEIR NUTS path, leaf 7 of doubling 4: three slots
checked, the next leaf opened) at 16 and 256 chains, of the copy of
csrc/nuts.cu as it is and of copies with parts removed (the product's FMAs,
the copies of M^{-1}, the momenta's stream into the ring, the cluster
barrier after the kicks, the U-turn dots, the cluster's decision and
proposal copies, the grid's ticket), built into
magi_v2_tpu_torch/_build/probe/. A copy computes wrong values; only its
time is read.
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
from magi_v2_tpu_torch.ops import nuts as nu  # noqa: E402

FMA = "acc[r][u][c] = fmadd(ps[c], m[u], acc[r][u][c]);"
FETCH = "copy16_async(dst + e * W, a.tail_inv + (size_t)i * a.ld + j);"
STREAM = "dst[at_of(row_of(e), chain_of(e) / 4) + chain_of(e) % 4] = pf[u];"
DOTS = "for (int s = l.s0 + kq; s < l.pc; s += kSplitK) {"
DECIDE = "    cluster_decide(a, l, c_blk, rank, own, on, vals, flags, cluster);"
GRID = "  if (atomicAdd(a.grid_ticket, 1) != (int)gridDim.x - 1) return;"
VARIANTS = {
    "as_is": [],
    "no_fma": [(FMA, ";")],
    "no_fetch_no_stream": [(FETCH, ";"), (STREAM, ";")],
    "no_cluster_barrier": [("  cluster.sync();\n\n  // 2.",
                            "  __syncthreads();\n\n  // 2.")],
    "no_dots": [(DOTS, "for (int s = l.pc; s < l.pc; s += kSplitK) {")],
    "no_cluster_decision": [(DECIDE, "")],
    "no_grid_ticket": [(GRID, "  return;")],
}


def build_variants():
    """{name: shared library} of the copies of csrc/nuts.cu."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "nuts.cu").read_text()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"nuts_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"nuts_{name}.so"
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


def time_case(device, C, dim=489, k=489, d=4, n=7):
    """Device us of one launch at C chains, as check_nuts_leaf times it."""
    x = chip_smoke.nuts_leaf_case(C, dim, k, torch.float32, device, d, n)
    a = {key: v.clone() if isinstance(v, torch.Tensor) else v
         for key, v in x.items()}
    launch = nu.bind_nuts_leaf(*[a[key] for key in chip_smoke.NUTS_LEAF_ARGS],
                               1000.0)

    def rearm():
        for key in ("q", "p", "ctr", "active", "lsw", "sum_alpha"):
            a[key].copy_(x[key])

    return 1e3 * chip_smoke._graph_ms(
        lambda: launch(torch.cuda.current_stream(device).cuda_stream), rearm)


def main():
    if not torch.cuda.is_available():
        sys.exit("nuts_leaf_probe: no CUDA device")
    device = torch.device("cuda:0")
    _build.load_library()
    saved = nu._ENTRIES.get(torch.float32)
    try:
        for name, so in build_variants().items():
            fn = ctypes.CDLL(str(so)).magi_nuts_leaf_f32
            fn.argtypes = _build.SIGNATURES["nuts_leaf"]
            fn.restype = ctypes.c_int
            nu._ENTRIES[torch.float32] = fn
            print(f"{name}, us: " + ", ".join(
                f"{C} chains {time_case(device, C):.2f}"
                for C in (16, 256)), flush=True)
    finally:
        nu._ENTRIES[torch.float32] = saved


if __name__ == "__main__":
    main()
