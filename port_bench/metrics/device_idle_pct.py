"""device_idle_pct: the profiled slice's wall less the union of its device
intervals, over its wall (torch.profiler, CUPTI)."""


def read(run):
    p = run.profile
    if p is None or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
