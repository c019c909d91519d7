"""The port's ``map_estimate`` (magi_v2_tpu_torch/map_laplace.py) against
the JAX package's on a small SEIR fit (21 observations on [0, 2],
discretization 0: N_I = 21), in float64 on the CPU: the MAP with sigma
pinned in both preconditionings, their agreement, the Laplace sds and the
joint draws (the starts predict(init_states=...) takes), the profiled
sigma, and a banded model's exact operators. The port's model is built
from the JAX fit's arrays; Adam is cut to 200 steps on both sides."""

import numpy as np
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

TRUE = np.array([6.0, 0.6, 1.8])
SIGMA = 0.005 ** 2
ADAM = 200


def _fit(bandsize=None):
    ts, X_obs, X_true = simulate_ode(
        jseir, x0=np.array([0.1, 0.05, 0.0]), thetas=TRUE, t_max=2.0,
        n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X_obs, bandsize, jseir, J.MagiConfig().replace(
        hparam_num_iters=100, init_num_iters=200))
    jm.initial_fit(discretization=0)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(
        arrays, tseir, 3, bandsize=bandsize, config=MagiConfig(device="cpu"),
        exact_operators=None if bandsize is None else jm._exact_operators())
    return jm, tm, X_true


@pytest.fixture(scope="module")
def fitted():
    return _fit()


_RUNS = {}


def _runs(fitted, precondition, **kw):
    """(JAX result, port result) of one map_estimate call, made once."""
    key = (precondition, tuple(sorted(kw.items())))
    if key not in _RUNS:
        jm, tm, _ = fitted
        kw = dict(kw, adam_steps=ADAM, precondition=precondition)
        _RUNS[key] = (jm.map_estimate(**kw), tm.map_estimate(**kw))
    return _RUNS[key]


@pytest.mark.parametrize("precondition", ["gn", "prior"])
def test_map_matches_jax(fitted, precondition):
    """theta_map and X_map to 1e-5 relative, the objective and the Laplace
    sds alike; the same result keys."""
    rj, rt = _runs(fitted, precondition, sigma_sqs_fixed=SIGMA)
    assert set(rt) == set(rj)
    assert rt["converged"] and rt["hessian_spd"]
    assert rt["precondition"] == precondition
    np.testing.assert_allclose(rt["theta_map"], rj["theta_map"], rtol=1e-5)
    np.testing.assert_allclose(rt["X_map"], rj["X_map"], rtol=1e-5,
                               atol=1e-5 * np.abs(rj["X_map"]).max())
    np.testing.assert_allclose(rt["neg_logpost"], rj["neg_logpost"],
                               rtol=1e-9)
    np.testing.assert_allclose(rt["theta_sd"], rj["theta_sd"], rtol=1e-4)
    np.testing.assert_allclose(rt["theta_cov"], rj["theta_cov"], rtol=1e-4,
                               atol=1e-4 * np.abs(rj["theta_cov"]).max())
    np.testing.assert_allclose(rt["X_sd"], rj["X_sd"], rtol=1e-4,
                               atol=1e-4 * rj["X_sd"].max())
    np.testing.assert_array_equal(rt["sigma_sqs_map"], rj["sigma_sqs_map"])


def test_gn_and_prior_reach_the_same_map(fitted):
    """A linear change of coordinates: the same MAP and Laplace
    pushforward whichever whitening conditions the optimizer."""
    _, r_gn = _runs(fitted, "gn", sigma_sqs_fixed=SIGMA)
    _, r_pr = _runs(fitted, "prior", sigma_sqs_fixed=SIGMA)
    np.testing.assert_allclose(r_gn["theta_map"], r_pr["theta_map"],
                               rtol=1e-3)
    np.testing.assert_allclose(r_gn["neg_logpost"], r_pr["neg_logpost"],
                               rtol=1e-6)
    np.testing.assert_allclose(r_gn["X_map"], r_pr["X_map"], atol=1e-4)
    np.testing.assert_allclose(r_gn["theta_sd"], r_pr["theta_sd"], rtol=0.02)
    np.testing.assert_allclose(r_gn["X_sd"], r_pr["X_sd"], rtol=0.05,
                               atol=1e-6)


def test_map_recovers_theta(fitted):
    _, _, X_true = fitted
    _, r = _runs(fitted, "gn", sigma_sqs_fixed=SIGMA)
    np.testing.assert_array_less(np.abs(r["theta_map"] - TRUE),
                                 2.0 * r["theta_sd"] + 0.05 * TRUE)
    assert np.sqrt(((r["X_map"] - X_true) ** 2).mean()) < 0.02
    assert np.all(r["X_sd"] > 0) and not r["band_truncation_bypassed"]


def test_laplace_draws_disperse_around_map(fitted):
    """Joint draws from the Laplace approximation, the normals from
    default_rng(draws_seed) as in JAX: centered on the MAP, spread on the
    Laplace sds' scale, scaled by draws_scale, theta clipped at 1e-8;
    their spread matches JAX's draws of the same seed."""
    jm, _, _ = fitted
    n = 64
    rj, r = _runs(fitted, "gn", sigma_sqs_fixed=SIGMA, laplace_draws=n,
                  draws_seed=1)
    assert r["X_draws"].shape == (n, jm.mag_I, jm.D)
    assert r["theta_draws"].shape == (n, jm.D_thetas)
    assert np.all(np.isfinite(r["X_draws"]))
    assert np.all(r["theta_draws"] >= 1e-8)
    th_se = r["theta_draws"].std(axis=0) / np.sqrt(n)
    np.testing.assert_array_less(
        np.abs(r["theta_draws"].mean(axis=0) - r["theta_map"]),
        4.0 * th_se + 1e-9)
    assert np.all(r["theta_draws"].std(axis=0) / r["theta_sd"] < 1.5)
    x_spread = r["X_draws"].std(axis=0)
    assert np.median(x_spread / np.maximum(r["X_sd"], 1e-12)) < 1.5
    np.testing.assert_allclose(r["theta_draws"].std(axis=0),
                               rj["theta_draws"].std(axis=0), rtol=0.05)
    _, r2 = _runs(fitted, "gn", sigma_sqs_fixed=SIGMA, laplace_draws=n,
                  draws_seed=1, draws_scale=0.1)
    np.testing.assert_allclose(r2["theta_draws"].std(axis=0),
                               0.1 * r["theta_draws"].std(axis=0), rtol=0.2)


def test_free_sigma_matches_jax(fitted):
    """sigma^2 profiled in closed form: at this tiny noise it sits at the
    lower bound for some components, and the projected gradient handles
    the active bounds."""
    rj, rt = _runs(fitted, "gn", laplace=False)
    assert rt["converged"] or rt["grad_norm"] < 1e-2 * abs(rt["neg_logpost"])
    assert "theta_sd" not in rt
    np.testing.assert_allclose(rt["theta_map"], rj["theta_map"], rtol=1e-5)
    np.testing.assert_allclose(rt["sigma_sqs_map"], rj["sigma_sqs_map"],
                               rtol=1e-5)
    np.testing.assert_allclose(rt["theta_map"], TRUE, rtol=0.08)


def test_map_of_a_banded_model_uses_the_exact_operators():
    jm, tm, _ = _fit(bandsize=5)
    kw = dict(sigma_sqs_fixed=SIGMA, laplace=False, adam_steps=ADAM)
    rj, rt = jm.map_estimate(**kw), tm.map_estimate(**kw)
    assert rt["band_truncation_bypassed"] and "theta_sd" not in rt
    np.testing.assert_allclose(rt["theta_map"], rj["theta_map"], rtol=1e-5)
    with pytest.raises(ValueError, match="precondition"):
        tm.map_estimate(precondition="newton")
