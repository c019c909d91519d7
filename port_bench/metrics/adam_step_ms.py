"""adam_step_ms: the theta start's wall (the ``theta_init`` span of the
port's fit trace, results["timings"]["trace"]["fit"]) over the Adam steps
it counted ("adam_steps" in the span's counters)."""


def read(run):
    for c in run.timed_calls():
        fit = ((c.timings or {}).get("trace") or {}).get("fit")
        for s in (fit or {}).get("spans", []):
            steps = s["attrs"].get("counts", {}).get("adam_steps", 0)
            if s["name"] == "theta_init" and steps:
                return 1e-6 * (s["t1_ns"] - s["t0_ns"]) / steps
    return None
