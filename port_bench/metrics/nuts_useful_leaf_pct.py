"""nuts_useful_leaf_pct: the leaves the chains needed (the sum of
num_leapfrogs over the sampling phase's draws and chains) over the leaf
graph's replays in that phase times the chains: masked lockstep replays
every chain's doublings up to the deepest tree."""


def read(run):
    if run.shapes["algorithm"] != "nuts":
        return None
    needed = replayed = 0.0
    for c in run.calls:
        n = c.sampling_counts.get("graph:nuts_leaf", 0)
        if n:
            needed += float(c.num_leapfrogs.sum())
            replayed += n * run.shapes["C"]
    return 100.0 * needed / replayed if replayed else None
