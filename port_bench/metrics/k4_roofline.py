"""k4_roofline: K4 (csrc/banded.cu), the banded triangular solve and its
adjoint, in the profiled slice of a hybrid or banded call: each launch
the port's counters saw at the bound of one solve of its factor (N D
unknowns, the factor's bandwidth, the chains as right-hand sides), over
K4's device time."""

from port_bench.harness.roofline import share
from port_bench.yardstick.bounds import k4_bound


def read(run):
    s = run.shapes
    if run.profile is None or "factor_bw" not in s:
        return None
    counts = run.profile["counts"]
    launches = (counts.get("banded_solve", 0)
                + counts.get("banded_solve_adjoint", 0))
    bound = k4_bound(s["C"], s["N"] * s["D"], s["factor_bw"], s["dtype"])
    return share(run, launches * bound["bound_ms"], "banded_solve_kernel")
