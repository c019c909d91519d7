"""ess_per_s: each call's worst theta component's ESS, pooled over its
chains (the frozen Geyer estimator), summed over the window's calls and
divided by the window's wall."""


def read(run):
    if not run.calls:
        return None
    return sum(c.ess_min for c in run.calls) / run.window_s
