"""predict_s: the window's wall over the predict calls it completed, host
clock: the time to a posterior for a fitted model."""


def read(run):
    return run.window_s / len(run.calls) if run.calls else None
