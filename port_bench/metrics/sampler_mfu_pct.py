"""sampler_mfu_pct: the operations one evaluation and update need per
chain at the configuration's shapes (yardstick/flops.py: dense storage,
or hybrid storage with the factor's bandwidth), times the evaluations the
chains needed in the sampling phase, over its wall and the float32 peak
(TF32 is off in the port)."""

from port_bench.yardstick.bounds import PEAK_FLOPS
from port_bench.yardstick.flops import (evaluation_flops,
                                        hybrid_evaluation_flops)


def read(run):
    s = run.shapes
    if s["storage"] == "dense":
        per = evaluation_flops(s["N"], s["D"], s["P"], s["k"],
                               s["algorithm"])
    elif s["storage"] == "hybrid" and "factor_bw" in s:
        per = hybrid_evaluation_flops(s["N"], s["D"], s["P"], s["k"],
                                      s["algorithm"], s["factor_bw"])
    else:
        return None
    calls = [c for c in run.timed_calls() if c.timings]
    wall = sum(c.timings["sample_total_s"] for c in calls)
    if not wall:
        return None
    evals = sum(float(c.num_leapfrogs.sum()) for c in calls)
    return 100.0 * per * evals / wall / PEAK_FLOPS[s["dtype"]]
