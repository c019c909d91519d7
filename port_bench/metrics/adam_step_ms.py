"""adam_step_ms: the theta start's wall (the ``theta_init`` span of a
fit's trace, ``MAGI_v2.fit_trace``) over the Adam steps it counted
("adam_steps" in the span's counters): the first fit of the run whose
theta start ran Adam. A fit that takes its theta start from the fit
before it (``thetas_init``) counts no steps."""


def read(run):
    for fit in getattr(run, "fit_traces", None) or []:
        for s in (fit or {}).get("spans", []):
            steps = s["attrs"].get("counts", {}).get("adam_steps", 0)
            if s["name"] == "theta_init" and steps:
                return 1e-6 * (s["t1_ns"] - s["t0_ns"]) / steps
    return None
