"""sampling_evals_per_s: the target evaluations the chains needed in the
sampling phase (the sum of kernel_results["num_leapfrogs"] over draws and
chains) over the sampling phase's wall (results["timings"]
["sample_total_s"], profile_timings=True)."""


def read(run):
    calls = [c for c in run.timed_calls() if c.timings]
    wall = sum(c.timings["sample_total_s"] for c in calls)
    if not wall:
        return None
    return sum(float(c.num_leapfrogs.sum()) for c in calls) / wall
