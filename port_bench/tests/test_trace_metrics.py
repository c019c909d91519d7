"""The readers of the port's trace (replay_host_us, nuts_read_stall_pct,
between_transitions_pct, adam_step_ms) on synthetic runs carrying
hand-made traces: their arithmetic, the profiled call left out, and None
where the trace, the markers or the algorithm is absent (as the parent of
the trace reads); and k4_roofline and sampler_mfu_pct's hybrid count on
a synthetic dense-grid run with known launches, device time and shapes."""

from types import SimpleNamespace

import pytest

from port_bench.harness import manifest

NAMES = ("replay_host_us", "nuts_read_stall_pct", "between_transitions_pct",
         "adam_step_ms")


def span(i, parent, name, t0, t1, **attrs):
    return {"id": i, "parent": parent, "name": name, "t0_ns": t0,
            "t1_ns": t1, "attrs": attrs}


FIT = {"spans": [span(0, None, "initial_fit", 0, 10**9),
                 span(1, 0, "hparam_mle", 0, 10**8,
                      counts={"lbfgs_iters": 9}),
                 span(2, 0, "theta_init", 10**8, 5 * 10**8,
                      counts={"adam_steps": 200})],
       "counts": {}}


def trace(markers=True):
    """A predict's trace. The warmup phase (500 ns): two transitions, the
    first with two doublings, whose read leaves 20 ns; the second starts
    30 ns after the first ends on the card. The sample phase (1000 ns):
    two transitions, the second with three doublings, whose reads leave
    60 and 40 ns; the second starts 50 ns after the first ends; 10
    replays took 2000 host ns."""
    m = lambda t0, t1: ({"dev_t0_ns": t0, "dev_t1_ns": t1} if markers
                        else {})
    spans = [span(0, None, "predict", 0, 3000),
             span(1, 0, "sampling", 50, 2500),
             span(2, 1, "warmup", 60, 560),
             span(3, 2, "block", 61, 559),
             span(4, 3, "transition", 62, 200, **m(70, 210)),
             span(5, 4, "doubling", 63, 150, depth=0, **m(75, 150)),
             span(6, 4, "doubling", 160, 199, depth=1, **m(170, 205)),
             span(7, 3, "transition", 230, 550, **m(240, 540)),
             span(8, 1, "sample", 1000, 2000,
                  counts={"replays.nuts_leaf": 8, "replay_ns.nuts_leaf": 1800,
                          "replays.next": 2, "replay_ns.next": 200,
                          "adam_steps": 3}),
             span(9, 8, "block", 1010, 1990),
             span(10, 9, "transition", 1020, 1300, **m(1030, 1320)),
             span(11, 9, "transition", 1350, 1900, **m(1370, 1960)),
             span(12, 11, "doubling", 1380, 1500, depth=0, **m(1400, 1480)),
             span(13, 12, "device_read", 1490, 1500),
             span(14, 11, "doubling", 1510, 1700, depth=1, **m(1540, 1690)),
             span(15, 11, "doubling", 1710, 1890, depth=2, **m(1730, 1900)),
             span(16, 8, "drain", 1995, 1999)]
    return {"spans": spans, "counts": {}, "fit": FIT}


def make_run(traces, algorithm="nuts", profile_call=None, fits=()):
    """A run of calls with the predict traces ``traces`` and fits with the
    traces ``fits``."""
    calls = [SimpleNamespace(timings=None if t is None else {
        "sample_total_s": 1e-6, **({} if t is False else {"trace": t})})
        for t in traces]
    run = SimpleNamespace(calls=calls, profile_call=profile_call,
                          shapes={"algorithm": algorithm},
                          fit_traces=list(fits))
    rest = [c for i, c in enumerate(calls) if i != profile_call]
    run.timed_calls = lambda: rest or calls
    return run


def read(name, run):
    return manifest.reader(name)(run)


def test_the_readers_arithmetic():
    run = make_run([trace(), trace()], fits=[FIT])
    assert read("replay_host_us", run) == pytest.approx(2000 / 10 / 1e3)
    assert read("nuts_read_stall_pct", run) == pytest.approx(
        100.0 * (20 + 60 + 40) / (500 + 1000))
    assert read("between_transitions_pct", run) == pytest.approx(
        100.0 * (30 + 50) / (500 + 1000))
    assert read("adam_step_ms", run) == pytest.approx(
        4e8 / 200 * 1e-6)


def test_the_profiled_call_is_left_out():
    """The profiled call (index 0) reads 10 times the replay time; the
    reader sees the others only."""
    slow = trace()
    (sample,) = [s for s in slow["spans"] if s["name"] == "sample"]
    sample["attrs"]["counts"]["replay_ns.nuts_leaf"] *= 10
    run = make_run([slow, trace()], profile_call=0)
    assert read("replay_host_us", run) == pytest.approx(0.2)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_a_trace(name):
    """The parent's calls: timings without a trace, or no timings."""
    assert read(name, make_run([False, False])) is None
    assert read(name, make_run([None])) is None


@pytest.mark.parametrize("name", ["nuts_read_stall_pct",
                                  "between_transitions_pct"])
def test_none_without_markers(name):
    """A run on more than one card, or on the CPU: spans, no markers."""
    assert read(name, make_run([trace(markers=False)])) is None


def test_the_algorithm_and_the_spans_that_must_be_there():
    run = make_run([trace()], algorithm="hmc")
    assert read("nuts_read_stall_pct", run) is None
    assert read("between_transitions_pct", run) == pytest.approx(
        100.0 * 80 / 1500)
    bare = trace()
    bare["spans"] = [s for s in bare["spans"] if s["name"] != "doubling"]
    assert read("nuts_read_stall_pct", make_run([bare])) is None
    fit = dict(FIT, spans=[s for s in FIT["spans"]
                           if s["name"] != "theta_init"])
    assert read("adam_step_ms", make_run([trace()], fits=[fit])) is None
    assert read("adam_step_ms", make_run([trace()], fits=[None])) is None


def test_adam_step_ms_reads_the_fit_that_ran_adam():
    """Two fits, as a dense-grid configuration runs them: the second takes
    theta from the first and counts no Adam steps; the reader reads the
    first. The predicts' traces carry only the last fit's."""
    second = dict(FIT, spans=[dict(s, attrs={}) if s["name"] == "theta_init"
                              else s for s in FIT["spans"]])
    run = make_run([dict(trace(), fit=second)], fits=[FIT, second])
    assert read("adam_step_ms", run) == pytest.approx(4e8 / 200 * 1e-6)
    assert read("adam_step_ms", make_run([trace()], fits=[second])) is None


def test_a_phase_without_markers_is_left_out():
    """Markers on the sample phase only: the readers read that phase."""
    t = trace()
    for s in t["spans"]:
        if s["id"] in range(2, 8):
            s["attrs"].pop("dev_t0_ns", None)
            s["attrs"].pop("dev_t1_ns", None)
    run = make_run([t])
    assert read("nuts_read_stall_pct", run) == pytest.approx(10.0)
    assert read("between_transitions_pct", run) == pytest.approx(5.0)


# the kernels' rooflines and the step's share of the peak, hybrid storage


def hybrid_run(profile=True, storage="hybrid", factor_bw=1200):
    """A hybrid HMC run at the dense-grid shapes: two calls of 4 draws x
    256 chains, 32 leapfrogs a chain and draw, 0.5 s of sampling each; a
    slice whose counters saw 40 K4 launches (20 solves, 20 adjoints) in
    8 ms of K4 device time."""
    import numpy as np
    import torch

    shapes = {"C": 256, "N": 1025, "D": 3, "P": 3, "dim": 3081, "k": 0,
              "storage": storage, "algorithm": "hmc", "dtype": torch.float32}
    if factor_bw is not None:
        shapes["factor_bw"] = factor_bw
    calls = [SimpleNamespace(timings={"sample_total_s": 0.5},
                             num_leapfrogs=np.full((4, 256), 32))
             for _ in range(2)]
    run = SimpleNamespace(calls=calls, profile_call=None, shapes=shapes,
                          profile=None)
    run.timed_calls = lambda: calls
    if profile:
        run.profile = {"counts": {"banded_solve": 20,
                                  "banded_solve_adjoint": 20},
                       "kernel_s": {
                           "void banded_solve_kernel<float, 64, false>": 5e-3,
                           "void banded_solve_kernel<float, 64, true>": 3e-3,
                           "void banded_matvec_kernel<float, 0>": 1.0}}
    return run


def test_k4_roofline_arithmetic():
    from port_bench.yardstick.bounds import band_nonzeros, bound

    run = hybrid_run()
    nnz = band_nonzeros(3075, 0, 1200)
    one = bound((nnz + 2 * 256 * 3075) * 4, 2 * 256 * nnz)["bound_ms"]
    assert read("k4_roofline", run) == pytest.approx(
        100.0 * 40 * one * 1e-3 / 8e-3)


def test_k4_roofline_reads_nothing_without_its_inputs():
    assert read("k4_roofline", hybrid_run(profile=False)) is None
    assert read("k4_roofline", hybrid_run(storage="dense",
                                          factor_bw=None)) is None
    run = hybrid_run()
    run.profile["kernel_s"] = {"void banded_matvec_kernel<float, 0>": 1.0}
    assert read("k4_roofline", run) is None


def test_sampler_mfu_counts_by_storage():
    """Hybrid: two banded solves of U's nonzeros in place of the dense
    factor's two products, the rest as dense; dense unchanged."""
    from port_bench.yardstick.bounds import K1_FLOPS, PEAK_FLOPS, band_nonzeros
    from port_bench.yardstick.flops import evaluation_flops

    n, N, D = 3075, 1025, 3
    rest = D * 12 * N * N + sum(K1_FLOPS.values()) * n + 7 * 3081
    per = 4 * band_nonzeros(n, 0, 1200) + rest
    evals = 2 * 4 * 256 * 32
    run = hybrid_run()
    assert read("sampler_mfu_pct", run) == pytest.approx(
        100.0 * per * evals / 1.0 / PEAK_FLOPS[run.shapes["dtype"]])
    assert evaluation_flops(N, D, 3, 0, "hmc") == 4 * n * n + rest
    dense = hybrid_run(storage="dense", factor_bw=None)
    assert read("sampler_mfu_pct", dense) == pytest.approx(
        100.0 * (4 * n * n + rest) * evals / PEAK_FLOPS[run.shapes["dtype"]])
    assert read("sampler_mfu_pct", hybrid_run(factor_bw=None)) is None
    assert read("sampler_mfu_pct", hybrid_run(storage="banded")) is None
