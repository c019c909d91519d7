"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped), in dense
storage and in hybrid storage (a banded GN factor around the exact
operators, sigma known): a sound run comes out correct, and each fault
the cells can have, planted in the port's timed path
(``harness/faults.py``), comes out not correct; the control, the
reference computed in the precision below the configuration's in the
program's place, fails the target's, the orbit's and the draws' limits
(hybrid: and S's). The banded factor's frame reproduces the port's
draws, and banded storage is refused."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import control
from port_bench.harness import core, faults, judge, manifest, report

DATA = Path(__file__).resolve().parent / "data"
BENCH = json.loads((DATA / "bench.json").read_text())
SEED = 2**31 + 12345
CELLS = ["small-hmc", "small-nuts", "small-hybrid"]


def storage(cell):
    return manifest.Cell(cell, BENCH, DATA).recipe().get("storage", "dense")


def run(cell, fault=None, seconds=0.5):
    import contextlib

    planted = faults.for_storage(storage(cell))
    with planted[fault]() if fault else contextlib.nullcontext():
        r, numbers, limits = core.run_cell(cell, SEED, seconds, False,
                                           device="cpu", bench=BENCH,
                                           base=DATA)
    return r, numbers, limits


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r, numbers, limits = run(cell)
    assert r.failed == 0 and r.calls
    assert report.is_correct(r, numbers, limits), numbers
    line = report.result(r, numbers, limits, "cpu", 1)
    assert list(line)[-1] == "checked"
    assert set(line["checked"]) == set(judge.numbers(r.cell))


@pytest.mark.parametrize("cell, fault", [
    pytest.param(c, f, id=f"{c}-{f}") for c in CELLS
    for f in sorted(faults.for_storage(storage(c)))])
def test_fault_is_not_correct(cell, fault):
    r, numbers, limits = run(cell, fault)
    assert not report.is_correct(r, numbers, limits), (fault, numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The control reads over the limits of the target (lp), the orbit and
    the draws (and, in hybrid storage, S), where a sound call reads under
    them."""
    out = control.readings(cell, 1, "cpu", BENCH, DATA, faults=())
    limits = manifest.Cell(cell, BENCH, DATA).limits
    for k in ("lp_gap", "orbit_gap", "draw_gap", "k_gap"):
        if k in limits:
            assert out["sound"][k] <= limits[k] < out["control"][k], k


def test_the_banded_frame_reproduces_the_draws():
    """x0 + F (z - z0), with F = U^{-1} worked out by the reference from the
    tiles of the call's factor, gives the trajectories predict returned,
    and the factor's bandwidth is the precision's (4 D b)."""
    cell = manifest.Cell("small-hybrid", BENCH, DATA)
    cfg, recipe = cell.config, cell.recipe()
    ts, X_obs = core.observations(cfg)
    model = core.fit(cfg, ts, X_obs, "cpu", [])
    N, D = model.mag_I, model.D
    ref = judge.reference(cell, core.fit_outputs(cfg, ts, X_obs, model),
                          "cpu")
    capture = judge.Capture(judge.picks(SEED, 0, 1))
    with capture.installed(), capture.call_of(0):
        res = model.predict(seed=3, **dict(recipe, num_burnin_steps=4,
                                           num_results=6))
    kept = judge.keep(res, N, D, capture.factors[0])
    (t,) = capture.taken
    assert t["factor"] is kept["factor"]
    F = ref.factor_inverse(kept["factor"])
    f = t["frame"]
    z = torch.as_tensor(kept["z"]).reshape(-1, N * D)
    X = f["x0"].reshape(-1) + (z - f["z0"]) @ F.mT
    gap = (X.reshape(kept["X"].shape) - torch.as_tensor(kept["X"])).abs()
    assert float(gap.max()) < 1e-10
    assert judge.factor_bandwidth(kept["factor"], N * D) == min(
        N * D - 1, 4 * D * cfg["bandsize"])


def test_the_reference_reads_the_ports_tile_layout():
    """``upper_from_tiles`` gives back the banded upper matrix that the
    port's storage functions tiled, and its bandwidth."""
    from magi_v2_tpu_torch.ops.banded import (banded_to_blocks_upper,
                                              dense_to_banded)
    from port_bench.reference.magi_ref import upper_from_tiles

    n, w = 300, 150
    g = torch.Generator().manual_seed(5)
    U = torch.triu(torch.rand((n, n), generator=g, dtype=torch.float64))
    U = U - torch.triu(U, w + 1)
    tiles = banded_to_blocks_upper(dense_to_banded(U, w))
    assert torch.equal(upper_from_tiles(tiles, n), U)
    assert judge.factor_bandwidth(tiles, n) == w


def test_banded_storage_is_not_judged():
    from types import SimpleNamespace

    cell = SimpleNamespace(recipe=lambda: {"storage": "banded"})
    with pytest.raises(NotImplementedError, match="band-truncated"):
        judge.reference(cell, {}, "cpu")


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
