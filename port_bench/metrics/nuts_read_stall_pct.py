"""nuts_read_stall_pct: the card's idle after the NUTS doublings' device
reads in the sampling phases (``warmup`` and ``sample``), by the port's
device markers: over consecutive doublings of one transition, the next
one's dev_t0_ns less this one's dev_t1_ns (nothing is queued between the
two), over the phases' walls, summed over the timed calls
(``utils.profiling.marker_gaps`` of results["timings"]["trace"],
profile_timings=True; markers on one card only). The warmup's wall holds
the capture of the sampler's graphs."""


def read(run):
    if run.shapes["algorithm"] != "nuts":
        return None
    traces = [c.timings["trace"] for c in run.timed_calls()
              if (c.timings or {}).get("trace")]
    if not traces:
        return None
    from magi_v2_tpu_torch.utils.profiling import marker_gaps, sampling_phase

    stall = wall = 0
    for trace in traces:
        for name in ("warmup", "sample"):
            phase = sampling_phase(trace["spans"], name)
            gaps = phase and marker_gaps(trace["spans"], phase)
            if gaps and gaps["doublings"]:
                stall += gaps["read_stalls"]
                wall += gaps["wall"]
    return 100.0 * stall / wall if wall else None
