"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped): a sound run
comes out correct, and each fault the cells can have, planted in the
port's timed path (``harness/faults.py``), comes out not correct; the
control, the reference computed in the precision below the
configuration's in the program's place, fails the target's, the orbit's
and the draws' limits."""

import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import control
from port_bench.harness import core, faults, judge, manifest, report

DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((DATA / "bench.json").read_text())
SEED = 2**31 + 12345


def run(cell, fault=None, seconds=0.5):
    import contextlib

    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        r, numbers, limits = core.run_cell(cell, SEED, seconds, False,
                                           device="cpu", bench=BENCH,
                                           base=DATA)
    return r, numbers, limits


@pytest.mark.parametrize("cell", ["small-hmc", "small-nuts"])
def test_sound_run_is_correct(cell):
    r, numbers, limits = run(cell)
    assert r.failed == 0 and r.calls
    assert report.is_correct(r, numbers, limits), numbers
    line = report.result(r, numbers, limits, "cpu", 1)
    assert list(line)[-1] == "checked"
    assert set(line["checked"]) == set(judge.NUMBERS)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["small-hmc", "small-nuts"])
def test_fault_is_not_correct(cell, fault):
    r, numbers, limits = run(cell, fault)
    assert not report.is_correct(r, numbers, limits), (fault, numbers)


@pytest.mark.parametrize("cell", ["small-hmc", "small-nuts"])
def test_control_fails_the_limits(cell):
    """The control reads over the limits of the target (lp),
    the orbit and the draws, where a sound call reads under them."""
    out = control.readings(cell, 1, "cpu", BENCH, DATA, faults=())
    limits = manifest.Cell(cell, BENCH, DATA).limits
    for k in ("lp_gap", "orbit_gap", "draw_gap"):
        assert out["sound"][k] <= limits[k] < out["control"][k], k


def test_a_failed_call_is_counted():
    """A window's call that raises counts as failed and the run is not
    correct (the warm predict of the set-up goes through)."""
    from magi_v2_tpu_torch import api

    orig = api.unwhiten_draws
    calls = []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return orig(*a, **k)

    api.unwhiten_draws = broken
    try:
        r, numbers, limits = run("small-hmc")
    finally:
        api.unwhiten_draws = orig
    assert r.failed == r.attempted >= 1
    assert not report.is_correct(r, numbers, limits)


def test_call_seeds_are_distinct_and_large_seeds_work():
    seeds = {core.call_seed(2**31 + 7, i) for i in range(100)}
    assert len(seeds) == 100 and all(0 <= s < 2**31 for s in seeds)
    assert core.call_seed(-5, 0) >= 0
    assert np.isfinite(core.call_seed(2**40, 3))


def test_reference_gradient_matches_the_objective():
    """The reference's hyperparameter gradient equals autograd through the
    port's own objective, at the objective's start and at a fit."""
    import torch
    import torch.nn.functional as F

    from magi_v2_tpu_torch.hparams import fourier_prior, make_hparam_objective
    from port_bench.reference.magi_ref import hparam_gradient

    cfg = manifest.config("seir-small", DATA)
    ts, X = core.observations(cfg)
    prior = fourier_prior(X, t_range=float(ts[-1] - ts[0]))
    f, p0 = make_hparam_objective(ts.reshape(-1, 1), X, prior, 2.01,
                                  jitter=1e-6, device="cpu")
    x = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    f(x).backward()
    port = max(float(v.grad.abs().max()) for v in x.values())
    sp = lambda k: F.softplus(p0[k]).numpy()
    ref = hparam_gradient(ts, X, sp("phi1_pre"), sp("phi2_pre"),
                          sp("sigma_sq_pre"))
    assert ref == pytest.approx(port, rel=1e-9)
