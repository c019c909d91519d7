"""k2_roofline: K2 (csrc/leapfrog.cu) in the profiled slice of an HMC
call: each leapfrog replay's launch at the leapfrog's bound, each
transition's two kinetic launches at theirs, over K2's device time."""

from port_bench.harness.roofline import share
from port_bench.yardstick.bounds import k2_bound, k2_kinetic_bound


def read(run):
    if run.profile is None or run.shapes["algorithm"] != "hmc":
        return None
    s, counts = run.shapes, run.profile["counts"]
    C, dim, k, dt = s["C"], s["dim"], s["k"], s["dtype"]
    leapfrogs = counts.get("graph:first", 0) + counts.get("graph:next", 0)
    kinetic = counts.get("leapfrog_update", 0) - leapfrogs
    total = (leapfrogs * k2_bound(C, dim, k, dt)["bound_ms"]
             + kinetic / 2 * (k2_kinetic_bound(C, dim, k, dt, 0)["bound_ms"]
                              + k2_kinetic_bound(C, dim, k, dt, 1)["bound_ms"]))
    return share(run, total, "leapfrog_kernel")
