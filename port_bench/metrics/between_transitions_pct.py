"""between_transitions_pct: the card's time between consecutive
transitions of the sampling phases (``warmup`` and ``sample``), by the
port's device markers (each next transition's dev_t0_ns less this one's
dev_t1_ns: the sampling loop's eager work between transitions, the
warmup's adaptation among it, and any wait for the host), over the
phases' walls, summed over the timed calls
(``utils.profiling.marker_gaps`` of results["timings"]["trace"],
profile_timings=True; markers on one card only). The warmup's wall holds
the capture of the sampler's graphs."""


def read(run):
    traces = [c.timings["trace"] for c in run.timed_calls()
              if (c.timings or {}).get("trace")]
    if not traces:
        return None
    from magi_v2_tpu_torch.utils.profiling import marker_gaps, sampling_phase

    gap = wall = 0
    for trace in traces:
        for name in ("warmup", "sample"):
            phase = sampling_phase(trace["spans"], name)
            gaps = phase and marker_gaps(trace["spans"], phase)
            if gaps:
                gap += gaps["between"]
                wall += gaps["wall"]
    return 100.0 * gap / wall if wall else None
