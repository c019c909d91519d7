"""Parity of the port's forecasting (``MAGI_v2.update_kernel_matrices``,
``extend_for_forecast``) with the JAX package, on one SEIR fit carried
across packages with ``from_fit_arrays`` (float64, CPU)."""

import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

TINY_J = J.MagiConfig().replace(hparam_num_iters=50, init_num_iters=100)
TINY_T = T.MagiConfig(device="cpu").replace(hparam_num_iters=50,
                                             init_num_iters=100)
# each operator relative to its own largest entry: C^{-1} and m agree to
# ~5e-11; K^{-1} is the pinv of K = K'' - K' C^{-1} K'^T, a cancellation
# that amplifies last-bit differences of the two packages' Gram matrices:
# ~2e-8 measured here, on the fit's own grid as on the extended ones (the
# build's parity, which test_torch_setup.py holds in action at 1e-6)
OPS_REL = {"C_d_invs": 1e-10, "m_ds": 1e-10, "K_d_invs": 1e-7}


@pytest.fixture(scope="module")
def fit_arrays():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, TINY_J)
    jm.initial_fit(discretization=1)
    return {f: np.array(getattr(jm, f)) for f in FIT_FIELDS}


def _pair(fit_arrays):
    """A fresh JAX model and port model on the same fitted arrays."""
    jm = J.MAGI_v2(3, fit_arrays["ts_obs"], fit_arrays["X_obs"], 20, jseir,
                   TINY_J)
    for f in FIT_FIELDS:
        setattr(jm, f, np.array(fit_arrays[f]))
    jm.mag_I = jm.I.shape[0]
    jm.beta = (jm.D * jm.mag_I) / jm.N_ds.sum()
    from magi_v2_tpu import preprocess
    jm.obs_index = preprocess.build_observation_index(jm.X_obs_discret)
    tm = from_fit_arrays(fit_arrays, tseir, 3, bandsize=20, config=TINY_T)
    return jm, tm


def _assert_same_state(jm, tm):
    assert tm.mag_I == jm.mag_I
    np.testing.assert_allclose(tm.beta, jm.beta, rtol=1e-15)
    for name in ("I", "X_obs_discret", "Xhat_init", "thetas_init",
                 "sigma_sqs_init", "phi1s", "phi2s"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    for f in ("not_nan_idxs", "not_nan_cols", "y_observed", "N_ds"):
        np.testing.assert_array_equal(getattr(tm.obs_index, f),
                                      getattr(jm.obs_index, f), err_msg=f)
    for name in ("C_d_invs", "m_ds", "K_d_invs"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert a.shape == b.shape == (3, jm.mag_I, jm.mag_I)
        for d in range(3):
            scale = np.abs(b[d]).max()
            assert np.abs(a[d] - b[d]).max() <= OPS_REL[name] * scale, (
                name, d)
    assert tm.band_truncation.keys() == jm.band_truncation.keys()


def test_update_kernel_matrices_forward_and_back(fit_arrays):
    """Five more grid points and back (tests/test_api.py's round trip)."""
    jm, tm = _pair(fit_arrays)
    old_NI = tm.mag_I
    C_old = tm.C_d_invs.copy()
    dt = tm.I[1, 0] - tm.I[0, 0]
    I_new = np.arange(tm.I[0, 0], tm.I[-1, 0] + 5 * dt + dt / 2, dt)
    for m in (jm, tm):
        m.update_kernel_matrices(I_new, m.phi1s, m.phi2s)
    assert tm.mag_I == old_NI + 5
    np.testing.assert_allclose(tm.beta, 3 * tm.mag_I / tm.N_ds.sum())
    _assert_same_state(jm, tm)
    for m in (jm, tm):
        m.update_kernel_matrices(I_new[:old_NI], m.phi1s, m.phi2s)
    _assert_same_state(jm, tm)
    assert np.abs(tm.C_d_invs - C_old).max() <= (
        OPS_REL["C_d_invs"] * np.abs(C_old).max())


@pytest.mark.parametrize("with_results", [False, True])
def test_extend_for_forecast_matches_jax(fit_arrays, with_results):
    """The NaN padding, the observation index, the warm start (from a
    prior predict's results, meaned over draws and chains) and the
    rebuilt operators; then a short CPU predict on the extended grid."""
    jm, tm = _pair(fit_arrays)
    old_NI = tm.mag_I
    results = None
    if with_results:
        results = tm.predict(num_results=10, num_burnin_steps=10,
                             num_chains=2, algorithm="hmc",
                             hmc_num_leapfrogs=4, seed=0)
    for m in (jm, tm):
        m.extend_for_forecast(2.5, results=results)
    assert tm.mag_I == old_NI + 10
    assert np.all(np.isnan(tm.X_obs_discret[old_NI:]))
    assert tm.Xhat_init.shape == (tm.mag_I, 3)
    np.testing.assert_array_equal(tm.Xhat_init[old_NI:],
                                  np.repeat(tm.Xhat_init[old_NI - 1:old_NI],
                                            10, axis=0))
    if with_results:
        np.testing.assert_allclose(
            tm.thetas_init, results["thetas_samps"].reshape(-1, 3).mean(0))
    _assert_same_state(jm, tm)
    res = tm.predict(num_results=5, num_burnin_steps=5, num_chains=2,
                     algorithm="hmc", hmc_num_leapfrogs=4, seed=1)
    assert res["X_samps"].shape == (5, 2, tm.mag_I, 3)
    assert np.all(np.isfinite(res["X_samps"]))
    assert np.all(np.isfinite(res["thetas_samps"]))


def test_extend_for_forecast_refuses_non_uniform_grid(fit_arrays):
    """The guard fires before any state is touched."""
    _, tm = _pair(fit_arrays)
    tm.update_kernel_matrices(np.asarray(tm.I[:, 0]) ** 1.5, tm.phi1s,
                              tm.phi2s)
    before = {name: np.array(getattr(tm, name)) for name in
              ("I", "X_obs_discret", "Xhat_init", "C_d_invs")}
    with pytest.raises(ValueError, match="uniform fit grid"):
        tm.extend_for_forecast(tm.I[-1, 0] * 2.0)
    for name, a in before.items():
        np.testing.assert_array_equal(getattr(tm, name), a)
    with pytest.raises(ValueError, match="extend beyond"):
        _pair(fit_arrays)[1].extend_for_forecast(1.0)
