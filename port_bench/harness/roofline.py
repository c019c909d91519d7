"""A kernel's share of its roofline over the profiled slice: the frozen
bounds (yardstick/bounds.py) times the launches the port's counters saw in
the slice, over the device time the trace gives the kernel's name."""


def device_s(run, *names):
    """The slice's device seconds of every kernel whose name holds one of
    ``names``."""
    return sum(s for k, s in run.profile["kernel_s"].items()
               if any(n in k for n in names))


def share(run, bound_ms: float, *names):
    """100 x bound / device time, or None where the slice has no such
    kernel (a reader returns nothing rather than 0)."""
    if run.profile is None or not bound_ms:
        return None
    t = device_s(run, *names)
    return 100.0 * bound_ms * 1e-3 / t if t > 0 else None


def sampled(run):
    """The profiled call and its slice's draws (the transitions' indices
    less the warmup)."""
    p = run.profile
    call = run.calls[run.profile_call]
    burnin = int(run.recipe["num_burnin_steps"])
    return call, slice(p["first"] - burnin, p["last"] - burnin + 1)
