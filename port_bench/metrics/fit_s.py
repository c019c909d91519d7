"""fit_s: the sum of MAGI_v2.fit_timings over the cell's initial_fit
calls (the setup math: hyperparameters, operators, theta start,
smoother)."""


def read(run):
    return sum(sum(t.values()) for t in run.fit_timings) or None
