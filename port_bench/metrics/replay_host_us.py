"""replay_host_us: the host microseconds of one step of the sampler's
bound transitions in the sampling phase (on the card a CUDA-graph replay,
the whole of the port's ``CapturedStep.replay``): the port's counters
"replay_ns.<step>" over "replays.<step>", summed over steps, as the
``sample`` span records their change (results["timings"]["trace"],
profile_timings=True).

Where the host runs ahead of the card, as in HMC, whose transitions read
nothing from the device, the launch queue fills and each replay waits in
``cudaGraphLaunch`` for the card: the reading is then the card's pace per
replay, not the launch's host cost. A NUTS doubling's read drains the
queue, so there the reading is the launch's cost."""


def read(run):
    traces = [c.timings["trace"] for c in run.timed_calls()
              if (c.timings or {}).get("trace")]
    if not traces:
        return None
    from magi_v2_tpu_torch.utils.profiling import sampling_phase

    ns = replays = 0
    for trace in traces:
        s = sampling_phase(trace["spans"], "sample")
        for k, v in (s or {"attrs": {}})["attrs"].get("counts", {}).items():
            if k.startswith("replay_ns."):
                ns += v
            elif k.startswith("replays."):
                replays += v
    return 1e-3 * ns / replays if replays else None
