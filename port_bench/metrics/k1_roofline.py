"""k1_roofline: K1's three kernels (fwd, energy, bwd; csrc/manifold.cu) in
the profiled slice: their frozen bounds times their launches, over their
device time."""

from port_bench.harness.roofline import share
from port_bench.yardstick.bounds import k1_bound

NAMES = ("manifold_fwd", "manifold_energy", "manifold_bwd")


def read(run):
    if run.profile is None:
        return None
    s, counts = run.shapes, run.profile["counts"]
    total = sum(counts.get(k, 0) * k1_bound(k, s["C"], s["N"], s["D"],
                                            s["P"], s["dtype"])["bound_ms"]
                for k in NAMES)
    return share(run, total, *(f"{k}_kernel" for k in NAMES))
