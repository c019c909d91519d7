"""worst_chain_accept: the lowest mean acceptance of any chain over a
call's sampling phase (the ``sample`` span's ``worst_chain_accept``, which
the sampler computes once at the phase's end; profile_timings=True), the
median over the window's calls. A chain that never moves reads 0. None
where no call's trace carries it (a program without the counter)."""

import statistics


def read(run):
    values = []
    for c in run.calls:
        spans = ((c.timings or {}).get("trace") or {}).get("spans", [])
        sampling = {s["id"] for s in spans if s["name"] == "sampling"}
        for s in spans:
            if (s["name"] == "sample" and s["parent"] in sampling
                    and "worst_chain_accept" in s["attrs"]):
                values.append(float(s["attrs"]["worst_chain_accept"]))
    return statistics.median(values) if values else None
