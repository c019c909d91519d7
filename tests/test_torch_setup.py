"""Parity of the port's float64 setup with the JAX package on the same SEIR
data: the hyperparameter MAP objective, ``initial_fit`` (phi1, phi2,
sigma^2, theta and the three operator stacks), the Gauss-Newton whitening,
and a fit carried across packages through ``save_fit``/``load_fit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu import hparams as jhp
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler import precond as jpc
from magi_v2_tpu.utils.checkpoint import save_fit
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import hparams as thp
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops.linalg import sym_sqrt
from magi_v2_tpu_torch.sampler import precond as tpc
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, load_fit

torch.set_num_threads(2)

TINY_J = J.MagiConfig().replace(hparam_num_iters=50, init_num_iters=100)
TINY_T = T.MagiConfig(device="cpu").replace(hparam_num_iters=50,
                                             init_num_iters=100)


@pytest.fixture(scope="module")
def seir_data():
    return simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                        thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                        n_obs=21, noise_sd=0.005, substeps=20)


@pytest.fixture(scope="module")
def fits(seir_data):
    ts, X, _ = seir_data
    jm = J.MAGI_v2(3, ts, X, 20, jseir, TINY_J)
    jm.initial_fit(discretization=1)
    tm = T.MAGI_v2(3, ts, X, 20, tseir, TINY_T)
    tm.initial_fit(discretization=1)
    return jm, tm


def test_hparam_objective_and_gradient_match_jax(seir_data):
    ts, X, _ = seir_data
    prior_j = jhp.fourier_prior(X, t_range=2.0)
    prior_t = thp.fourier_prior(X, t_range=2.0)
    for a, b in zip(prior_j, prior_t):
        np.testing.assert_array_equal(b, a)
    fj, pj = jhp.make_hparam_objective(ts, X, prior_j, 2.01)
    ft, pt = thp.make_hparam_objective(ts, X, prior_t, 2.01, device="cpu")
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-14)
    vj, gj = jax.value_and_grad(fj)(pj)
    p = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    vt = ft(p)
    vt.backward()
    # a sum of three Cholesky log-likelihoods: a few ulps of |value|
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-12)
    for k in gj:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(gj[k]),
                                   rtol=1e-9)


def test_initial_fit_scalars_match_jax(fits):
    jm, tm = fits
    assert tm.mag_I == jm.mag_I == 41
    np.testing.assert_allclose(tm.beta, jm.beta, rtol=0)
    # 50 Adam steps on identical float64 objectives: agreement far below
    # the stated 1e-6; theta's 100 steps go through the pinv'd operators
    for name in ("phi1s", "phi2s", "sigma_sqs_init", "thetas_init"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-6, err_msg=name)
    for name in ("mu_ds", "Xhat_init", "X_obs_discret", "I"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert set(tm.band_truncation) == set(jm.band_truncation)
    # mass fractions dropped by the band; the off-band part of K^{-1} is
    # at the level of pinv noise (~1e-8), so compare absolutely
    for k in jm.band_truncation:
        np.testing.assert_allclose(tm.band_truncation[k],
                                   jm.band_truncation[k], rtol=0, atol=1e-6)


def test_initial_fit_operators_match_jax_in_action(fits):
    """The operators pass through pinv of ill-conditioned matrices, which
    amplifies last-bit differences; compare their action on the
    centered initial trajectories, relative to the result's scale."""
    jm, tm = fits
    xc = (jm.Xhat_init - jm.mu_ds).T
    for name in ("C_d_invs", "m_ds", "K_d_invs"):
        a = np.einsum("dnm,dm->dn", getattr(jm, name), xc)
        b = np.einsum("dnm,dm->dn", getattr(tm, name), xc)
        assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max(), name


def test_gn_whitening_matches_jax(fits):
    jm, _ = fits
    from magi_v2_tpu.ops.linalg import sym_sqrt as jsqrt

    R64 = np.asarray(jsqrt(jnp.asarray(jm.C_d_invs)))
    S64 = np.asarray(jsqrt(jnp.asarray(jm.K_d_invs)))
    Jj = np.asarray(jpc.pointwise_ode_jacobian(jseir, jm.I, jm.Xhat_init,
                                               jm.thetas_init))
    t = lambda a: torch.tensor(np.asarray(a, np.float64))
    Jt = tpc.pointwise_ode_jacobian(tseir, t(jm.I), t(jm.Xhat_init),
                                    t(jm.thetas_init))
    np.testing.assert_allclose(Jt.numpy(), Jj, rtol=1e-14, atol=1e-15)
    obs = (~np.isnan(jm.X_obs_discret)).astype(np.float64)
    lam_j = np.asarray(jpc.gauss_newton_precision(
        jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.beta, obs, jm.sigma_sqs_init,
        Jj, C_inv_sqrts=R64, K_inv_sqrts=S64))
    lam_t = tpc.gauss_newton_precision(
        t(jm.C_d_invs), t(jm.m_ds), t(jm.K_d_invs), jm.beta, t(obs),
        t(jm.sigma_sqs_init), Jt, C_inv_sqrts=t(R64),
        K_inv_sqrts=t(S64)).numpy()
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-10,
                               atol=1e-12 * np.abs(lam_j).max())
    # factors: compare the whitened curvature L' Lambda L = I they produce
    L_t, L_inv_t = tpc.factor_precision(t(lam_j))
    eye = L_t.numpy().T @ lam_j @ L_t.numpy()
    L_j, _ = jpc.factor_precision(jnp.asarray(lam_j))
    eye_j = np.asarray(L_j).T @ lam_j @ np.asarray(L_j)
    assert np.abs(eye - eye_j).max() < 1e-8
    np.testing.assert_allclose((L_inv_t @ L_t).numpy(), np.eye(len(lam_j)),
                               atol=1e-8)


def test_sym_sqrt_of_fit_operators_matches_jax(fits):
    jm, _ = fits
    from magi_v2_tpu.ops.linalg import sym_sqrt as jsqrt

    for name in ("C_d_invs", "K_d_invs"):
        A = getattr(jm, name)
        a = np.asarray(jsqrt(jnp.asarray(A)))
        b = sym_sqrt(torch.as_tensor(A)).numpy()
        # R'R reproduces the clamped operator on both sides
        ra = np.einsum("dmn,dmk->dnk", a, a)
        rb = np.einsum("dmn,dmk->dnk", b, b)
        assert np.abs(rb - ra).max() <= 1e-8 * np.abs(ra).max(), name


def test_fit_carried_across_packages(fits, tmp_path):
    jm, _ = fits
    path = str(tmp_path / "fit.npz")
    save_fit(jm, path)
    tm = load_fit(path, tseir, TINY_T)
    for f in FIT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert tm.BANDSIZE == jm.BANDSIZE == 20
    assert tm.mag_I == jm.mag_I and tm.beta == jm.beta
    for f in ("not_nan_idxs", "not_nan_cols", "y_observed", "N_ds"):
        np.testing.assert_array_equal(getattr(tm.obs_index, f),
                                      getattr(jm.obs_index, f))


def test_initial_fit_takes_a_theta_start(seir_data, fits):
    """initial_fit(thetas_init=...) skips the theta fit and leaves every
    other result of the fit as it was; a malformed start is refused."""
    ts, X, _ = seir_data
    _, tm = fits
    start = np.array([5.0, 0.5, 2.0])
    tm2 = T.MAGI_v2(3, ts, X, 20, tseir, TINY_T)
    tm2.initial_fit(discretization=1, thetas_init=start)
    np.testing.assert_array_equal(tm2.thetas_init, start)
    for f in FIT_FIELDS:
        if f != "thetas_init":
            np.testing.assert_array_equal(getattr(tm2, f), getattr(tm, f))
    for bad in (np.ones(2), np.array([1.0, np.nan, 1.0])):
        with pytest.raises(ValueError, match="thetas_init"):
            T.MAGI_v2(3, ts, X, 20, tseir, TINY_T).initial_fit(
                1, thetas_init=bad)


def test_unported_branches_raise(seir_data):
    ts, X, _ = seir_data
    X = X.copy()
    X[:, 1] = np.nan
    # a partially observed system fits theta jointly with its unobserved
    # trajectories (gradient matching): it takes no theta start
    with pytest.raises(ValueError, match="thetas_init"):
        T.MAGI_v2(3, ts, X, None, tseir, TINY_T).initial_fit(
            1, thetas_init=np.ones(3))
    # L-BFGS is ported; an unknown optimizer is refused as in JAX
    with pytest.raises(ValueError, match="optimizer must be 'adam' or "
                       "'lbfgs'"):
        thp.fit_kernel_hparams(ts, X[:, :1], optimizer="sgd",
                               device="cpu")
    # NUTS's tree depth defaults to the JAX package's and reaches the
    # sampler's config
    assert T.MagiConfig().max_tree_depth == 10
    seen = {}

    def record(target, q0, seed, config, timer=None):
        seen["config"] = config
        raise StopIteration

    tm = T.MAGI_v2(3, ts, seir_data[1], 20, tseir,
                   TINY_T.replace(max_tree_depth=4))
    tm.initial_fit(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T.api, "run_chains", record)
        with pytest.raises(StopIteration):
            tm.predict(num_results=2, num_burnin_steps=2)
    assert seen["config"].algorithm == "nuts"
    assert seen["config"].max_tree_depth == 4


def test_config_defaults_to_the_card():
    assert T.MagiConfig().device == "cuda"
    assert T.MagiConfig().torch_device.type == "cuda"
    assert TINY_T.torch_device.type == "cpu"


def test_default_config_does_not_fall_back_to_the_cpu(seir_data):
    """Nothing probes for a card: without one, a model made with the
    default config fails at its first tensor with PyTorch's own error."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card, so the default config runs")
    ts, X, _ = seir_data
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        T.MAGI_v2(3, ts, X, 20, tseir).initial_fit(1)
