"""hmc_leapfrog_ms: the HMC sampling phase's wall over its leapfrog-step
replays (all chains share a transition's length, so a draw's replays are
its num_leapfrogs of any chain)."""


def read(run):
    if run.shapes["algorithm"] != "hmc":
        return None
    calls = [c for c in run.timed_calls() if c.timings]
    replays = sum(float(c.num_leapfrogs[:, 0].sum()) for c in calls)
    if not replays:
        return None
    return 1e3 * sum(c.timings["sample_total_s"] for c in calls) / replays
