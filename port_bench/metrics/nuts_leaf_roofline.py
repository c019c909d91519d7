"""nuts_leaf_roofline: the NUTS leaf kernel (csrc/nuts.cu) in the profiled
slice: the frozen leaf bound summed over its launches with the chains
that ran counted as the inputs need (the slice's draws' num_leapfrogs;
yardstick/bounds.py:nuts_leaves_bound), over its device time."""

from port_bench.harness.roofline import sampled, share
from port_bench.yardstick.bounds import nuts_leaves_bound


def read(run):
    if run.profile is None or run.shapes["algorithm"] != "nuts":
        return None
    s, counts = run.shapes, run.profile["counts"]
    call, rows = sampled(run)
    chain_leaves = float(call.num_leapfrogs[rows].sum())
    total = nuts_leaves_bound(
        s["C"], chain_leaves, counts.get("nuts_leaf", 0),
        counts.get("graph:nuts_prologue", 0), s["dim"], s["k"],
        s["dtype"])["bound_ms"]
    return share(run, total, "nuts_leaf_kernel")
