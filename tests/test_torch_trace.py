"""The port's trace (``utils.profiling.PhaseTimer``): the spans of a
profiled ``initial_fit`` and ``predict``, their parents and times, the
views (``fit_timings``, ``predict_timings``, ``results["timings"]``) that
are read from them, the fit's counters, the spans in ``torch.profiler``'s
events, the arithmetic of the device markers, and, on a card, the
markers themselves. The card's tests skip without one; run them with

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import magi_v2_tpu_torch.api as api_mod
import magi_v2_tpu_torch.hparams as hparams_mod
import magi_v2_tpu_torch.sampler.run as run_mod
from magi_v2_tpu_torch import MAGI_v2, MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec
from magi_v2_tpu_torch.utils.data import simulate_ode
from magi_v2_tpu_torch.utils.profiling import (
    PhaseTimer,
    children,
    marker_gaps,
    sampling_phase,
)

PREDICT = dict(num_results=4, num_burnin_steps=4, num_chains=3, seed=5,
               hmc_num_leapfrogs=4, mass_matrix="dense",
               dispatch_block_steps=3)
ALGORITHMS = {"hmc": dict(algorithm="hmc", thin=2),
              "nuts": dict(algorithm="nuts")}


def seir_model(device="cpu", **config):
    ts, X, _ = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005)
    cfg = dict(device=device, hparam_num_iters=50, init_num_iters=100,
               max_tree_depth=4)
    cfg.update(config)
    m = MAGI_v2(3, ts, X, None, seir_f_vec, MagiConfig(**cfg))
    m.initial_fit(1)
    return m


@pytest.fixture(scope="module")
def model():
    return seir_model()


@pytest.fixture(scope="module", params=list(ALGORITHMS))
def traced(request, model):
    kw = {**PREDICT, **ALGORITHMS[request.param]}
    res = model.predict(profile_timings=True, **kw)
    return request.param, kw, res, dict(model.predict_timings)


def by_name(spans, name, parent=None):
    return [s for s in spans if s["name"] == name
            and (parent is None or s["parent"] == parent["id"])]


def sec(s):
    return (s["t1_ns"] - s["t0_ns"]) * 1e-9


def test_predict_trace_is_well_formed(traced):
    """Ids are unique; every parent exists and holds its child in time;
    one transition span per transition (burn-in + results x thin); under
    NUTS one doubling span per doubling run (the deepest chain's depth)
    and a device read per doubling that was not the deepest allowed."""
    algorithm, kw, res, _ = traced
    spans = res["timings"]["trace"]["spans"]
    ids = [s["id"] for s in spans]
    assert len(set(ids)) == len(ids)
    at = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "predict"
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is not None:
            p = at[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]
    trans = by_name(spans, "transition")
    thin = kw.get("thin", 1)
    assert len(trans) == kw["num_burnin_steps"] + kw["num_results"] * thin
    assert all(at[at[t["parent"]]["parent"]]["name"] in ("warmup", "sample")
               for t in trans)
    kids = children(spans)
    if algorithm == "hmc":
        assert not by_name(spans, "doubling")
        return
    depths = np.asarray(res["kernel_results"]["depths"])    # (T, C)
    (sample,) = by_name(spans, "sample")
    sampled = [t for b in by_name(spans, "block", sample)
               for t in by_name(spans, "transition", b)]
    for t, depth in zip(sampled, depths.max(axis=1)):
        dbl = by_name(kids[t["id"]], "doubling")
        assert [d["attrs"]["depth"] for d in dbl] == list(range(depth))
        reads = [r for d in dbl for r in kids.get(d["id"], [])]
        assert all(r["name"] == "device_read" for r in reads)
        assert len(reads) == min(depth, 3)     # max_tree_depth 4
    counts = res["timings"]["trace"]["counts"]
    assert counts["replays.nuts_leaf"] == sum(
        2 ** d["attrs"]["depth"] for d in by_name(spans, "doubling"))


def test_views_equal_the_spans(traced, model):
    """fit_timings, predict_timings and results["timings"]'s JAX keys are
    read from the spans: the same numbers."""
    _, _, res, predict_timings = traced
    t = res["timings"]
    spans = t["trace"]["spans"]
    fit = t["trace"]["fit"]["spans"]
    assert fit == model.fit_trace["spans"]
    (fit_root,) = by_name(fit, "initial_fit")
    for name, v in model.fit_timings.items():
        assert v == sum(sec(s) for s in by_name(fit, name, fit_root))
    assert set(model.fit_timings) == {"hparam_mle", "kernel_matrices",
                                      "theta_init", "cv_smoother"}
    (rest,) = by_name(spans, "setup_rest")
    parts = [s for s in spans if s["parent"] == rest["id"]]
    assert [s["name"] for s in parts] + ["setup_rest", "sampling",
                                         "unwhiten"] == list(predict_timings)
    for s in parts:
        assert predict_timings[s["name"]] == sec(s)
    assert predict_timings["setup_rest"] == pytest.approx(
        sec(rest) - sum(sec(s) for s in parts), abs=1e-12)
    (sampling,) = by_name(spans, "sampling")
    (unwhiten,) = by_name(spans, "unwhiten")
    (fetch,) = by_name(spans, "x_fetch")
    (host_copy,) = by_name(spans, "host_copy")
    assert predict_timings["sampling"] == t["sampler_total_s"] == sec(
        sampling)
    assert predict_timings["unwhiten"] == t["unwhiten_s"] == sec(unwhiten)
    assert t["x_fetch_s"] == sec(fetch)
    assert t["post_total_s"] == (host_copy["t1_ns"]
                                 - unwhiten["t0_ns"]) * 1e-9
    (eps_init,) = by_name(spans, "eps_init", sampling)
    (warmup,) = by_name(spans, "warmup", sampling)
    (sample,) = by_name(spans, "sample", sampling)
    assert t["eps_init_s"] == sec(eps_init)
    assert t["warmup_s"] == sec(warmup)
    assert t["warmup_block_walls_s"] == [
        sec(b) for b in by_name(spans, "block", warmup)]
    blocks = [sec(b) for b in by_name(spans, "block", sample)]
    assert t["block_walls_s"] == blocks and len(blocks) > 1
    assert t["sample_total_s"] == sec(sample)
    assert t["sample_dispatch_s"] == sum(blocks)
    assert t["sample_first_dispatch_s"] == blocks[0]
    (drain,) = by_name(spans, "drain", sample)
    assert t["sample_drain_s"] == sec(drain)
    assert t["sample_stage_s"] == 0.0 and t["staged_bytes"] == 0


def test_untraced_predict_makes_no_span_and_no_event(model, monkeypatch):
    """profile_timings=False: the predict's recorder keeps its phase walls
    and no span, the sampler makes no recorder of its own, the bound
    transitions count nothing and no CUDA event is made."""
    made = []

    class Recorded(PhaseTimer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(api_mod, "PhaseTimer", Recorded)
    monkeypatch.setattr(run_mod, "PhaseTimer", Recorded)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    for algorithm in ALGORITHMS:
        made.clear()
        res = model.predict(**{**PREDICT, **ALGORITHMS[algorithm]})
        assert res["timings"] is None
        (timer,) = made
        assert not timer.trace and timer.spans == [] and timer.counts == {}
        assert list(timer.phases)[-2:] == ["sampling", "unwhiten"]


def test_transition_spans_show_in_the_profiler(model):
    """Under torch.profiler each transition span is one record_function
    event of its name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = model.predict(profile_timings=True,
                            **{**PREDICT, **ALGORITHMS["nuts"]})
    spans = res["timings"]["trace"]["spans"]
    names = [e.name for e in prof.events()]
    for name in ("transition", "doubling", "sample", "sampling"):
        assert names.count(name) == len(by_name(spans, name)), name


def test_marker_gaps_on_synthetic_offsets():
    """The split of a sample span's wall by hand-made markers: two
    transitions, the second with three doublings."""
    def span(i, parent, name, t0, t1, **attrs):
        return {"id": i, "parent": parent, "name": name, "t0_ns": t0,
                "t1_ns": t1, "attrs": attrs}

    spans = [span(0, None, "sample", 100, 1100),
             span(1, 0, "block", 110, 1090),
             span(2, 1, "transition", 120, 400, dev_t0_ns=130,
                  dev_t1_ns=420),
             span(3, 1, "transition", 450, 1000, dev_t0_ns=470,
                  dev_t1_ns=1060),
             span(4, 3, "doubling", 480, 600, dev_t0_ns=500,
                  dev_t1_ns=580),
             span(5, 4, "device_read", 590, 600),
             span(6, 3, "doubling", 610, 800, dev_t0_ns=640,
                  dev_t1_ns=790),
             span(7, 3, "doubling", 810, 990, dev_t0_ns=830,
                  dev_t1_ns=1000)]
    gaps = marker_gaps(spans, spans[0])
    assert gaps == {"wall": 1000, "transitions": 290 + 590,
                    "doublings": 80 + 150 + 170,
                    "read_stalls": (640 - 580) + (830 - 790),
                    "between": 470 - 420}
    del spans[6]["attrs"]["dev_t1_ns"]
    assert marker_gaps(spans, spans[0]) is None
    del spans[3]["attrs"]["dev_t0_ns"]
    assert marker_gaps(spans, spans[0]) is None
    assert marker_gaps(spans[:2], spans[0]) is None


def test_sampling_phase_finds_the_predicts_phases(traced):
    """``sampling_phase`` finds the children of the ``sampling`` span, and
    nothing outside it."""
    spans = traced[2]["timings"]["trace"]["spans"]
    (sampling,) = by_name(spans, "sampling")
    for name in ("eps_init", "warmup", "sample"):
        (s,) = by_name(spans, name, sampling)
        assert sampling_phase(spans, name) is s
    assert sampling_phase(spans, "block") is None
    assert sampling_phase([s for s in spans if s["name"] != "sampling"],
                          "sample") is None


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_fit_counters_match_the_optimizers(optimizer, monkeypatch):
    """The fit's counters: Adam's steps of the theta start equal
    init_num_iters; the hyperparameters' Adam steps equal
    hparam_num_iters, or L-BFGS's iterations LbfgsResult.num_iters, with
    one read of the device per evaluation."""
    results = []
    real = hparams_mod.lbfgs_minimize

    def spy(*a, **k):
        results.append(real(*a, **k))
        return results[-1]

    monkeypatch.setattr(hparams_mod, "lbfgs_minimize", spy)
    m = seir_model(hparam_optimizer=optimizer, hparam_num_iters=30,
                   init_num_iters=40)
    fit = m.fit_trace["spans"]
    (hp,) = by_name(fit, "hparam_mle")
    (theta,) = by_name(fit, "theta_init")
    assert theta["attrs"]["counts"] == {"adam_steps": 40}
    assert hp["attrs"]["optimizer"] == optimizer
    c = hp["attrs"]["counts"]
    if optimizer == "adam":
        assert c == {"adam_steps": 30} and not results
    else:
        (res,) = results
        assert c["lbfgs_iters"] == res.num_iters > 0
        assert c["lbfgs_evals"] == c["lbfgs_reads"] >= res.num_iters
    assert m.fit_trace["counts"]["adam_steps"] == 40 + (
        30 if optimizer == "adam" else 0)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device markers are CUDA "
                    "events")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", list(ALGORITHMS))
def test_device_markers_split_the_sample_wall(card, algorithm):
    """On the card every transition and doubling of the warmup and
    sample phases carries both markers, every gap is >= 0, and in the
    sample phase the transitions' own time, less the read stalls, plus
    the read stalls and the time between transitions make the span's wall
    within 2%."""
    m = seir_model(card, dtype=torch.float32)
    kw = dict(PREDICT, num_chains=64, num_burnin_steps=10, num_results=40,
              **ALGORITHMS[algorithm])
    m.predict(**kw)
    res = m.predict(profile_timings=True, **kw)
    spans = res["timings"]["trace"]["spans"]
    (sampling,) = by_name(spans, "sampling")
    (sample,) = by_name(spans, "sample", sampling)
    kids = children(spans)
    for phase in (by_name(spans, "warmup", sampling)[0], sample):
        gaps = marker_gaps(spans, phase)
        assert gaps is not None and min(gaps.values()) >= 0
        trans = [t for b in by_name(spans, "block", phase)
                 for t in by_name(kids[b["id"]], "transition")]
        marks = [t["attrs"] for t in trans]
        for a in marks:
            assert phase["t0_ns"] <= a["dev_t0_ns"] <= a["dev_t1_ns"]
            assert a["dev_t1_ns"] <= phase["t1_ns"]
        assert all(b["dev_t0_ns"] >= a["dev_t1_ns"]
                   for a, b in zip(marks, marks[1:]))
        for t in trans:
            dbl = [d["attrs"] for d in by_name(kids.get(t["id"], []),
                                               "doubling")]
            assert (len(dbl) > 0) == (algorithm == "nuts")
            for a, b in zip(dbl, dbl[1:]):
                assert a["dev_t0_ns"] <= a["dev_t1_ns"] <= b["dev_t0_ns"]
    gaps = marker_gaps(spans, sample)
    inside = gaps["transitions"] - gaps["read_stalls"]
    total = inside + gaps["read_stalls"] + gaps["between"]
    assert total == pytest.approx(gaps["wall"], rel=0.02)
    for s in by_name(spans, "sample") + by_name(spans, "sampling"):
        assert 0 < s["attrs"]["mem_bytes"] <= s["attrs"]["mem_peak_bytes"]


@pytest.mark.cuda
def test_markers_make_no_event(card, monkeypatch):
    """``anchor(n)`` makes the markers' events: n markers then make none,
    and ``resolve_marks`` puts each one's time on the host clock, in the
    order the card passed them."""
    rec = PhaseTimer(card, trace=True)
    rec.anchor(3)
    monkeypatch.setattr(torch.cuda, "Event", None)
    s = rec.open("transition")
    rec.mark(s, "dev_t0_ns")
    torch.cuda._sleep(1000)
    rec.mark(s, "mid_ns")
    rec.mark(s, "dev_t1_ns")
    rec.close(s)
    torch.cuda.synchronize()
    rec.resolve_marks()
    a = s.attrs
    assert s.t0_ns - 10**6 < a["dev_t0_ns"] < a["mid_ns"] <= a["dev_t1_ns"]
    assert a["dev_t1_ns"] < s.t1_ns + 10**7


def test_traced_sampling_phases_hold_the_collector_off(model, monkeypatch):
    """A traced predict's transitions (in its warmup and sample spans) run
    with Python's garbage collector held off, and the predict leaves it
    on; an untraced predict never turns it off."""
    import gc

    import magi_v2_tpu_torch.sampler.hmc as hmc_mod

    seen = []
    real = hmc_mod.run_step

    def spy(bound, name):
        seen.append(gc.isenabled())
        real(bound, name)

    monkeypatch.setattr(hmc_mod, "run_step", spy)
    kw = {**PREDICT, **ALGORITHMS["hmc"]}
    for traced in (True, False):
        seen.clear()
        model.predict(profile_timings=traced, **kw)
        assert gc.isenabled() and seen
        assert set(seen) == {not traced}
