"""The port's partially observed path against the JAX package's, on the
Hes1 data of examples/hes1.py (P and M observed on the log scale, H never):
the gradient-matching init, ``initial_fit`` with an unobserved component,
the centered target of a fit carried across, a short centered predict and
one centered NUTS step under the noise JAX draws. Float64 on the CPU,
where every kernel wrapper takes its plain version. The fits are cut to
100 hyperparameter and 300 gradient-matching steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu import init as jinit
from magi_v2_tpu import preprocess as jpre
from magi_v2_tpu.models import MODEL_REGISTRY
from magi_v2_tpu.models import hes1_log_f_vec as jhes1
from magi_v2_tpu.sampler.nuts import NutsConfig as JNutsConfig
from magi_v2_tpu.sampler.nuts import nuts_step as jnuts_step
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import init as tinit
from magi_v2_tpu_torch.models import hes1_log_f_vec as thes1
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays
from test_torch_nuts import _assert_matches_jax, _masses, jax_noise

torch.set_num_threads(2)

F64 = torch.float64
HP_ITERS, GM_ITERS = 100, 300
SIGMA_FIXED = 0.15 ** 2
TINY_J = J.MagiConfig().replace(hparam_num_iters=HP_ITERS,
                                 init_num_iters=GM_ITERS)
TINY_T = T.MagiConfig(device="cpu").replace(hparam_num_iters=HP_ITERS,
                                             init_num_iters=GM_ITERS)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def hes1_data():
    ts, _, X_true = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec, x0=np.array([1.439, 2.037, 17.904]),
        thetas=np.array(MODEL_REGISTRY["hes1"].true_thetas), t_max=240.0,
        n_obs=33, noise_sd=0.0, substeps=200)
    rng = np.random.default_rng(0)
    X = np.log(X_true) + 0.15 * rng.standard_normal(X_true.shape)
    X[:, 2] = np.nan
    return ts, X


def jax_starts(num_starts, N_I, D_unobserved, D_thetas, X_obs_smoothed,
               seed=0):
    """The starts magi_v2_tpu.init.fit_unobserved_gradient_matching draws
    from PRNGKey(seed), as the port's gradient_matching_starts returns
    them."""
    X = np.asarray(X_obs_smoothed.cpu() if isinstance(X_obs_smoothed,
                                                      torch.Tensor)
                   else X_obs_smoothed, np.float64)
    mu, sd = X.mean(), np.sqrt((X.std(axis=0) ** 2).mean())
    k_x, k_t = jax.random.split(jax.random.PRNGKey(seed))
    X0 = mu + sd * jax.random.normal(k_x, (num_starts, N_I, D_unobserved),
                                     jnp.float64)
    th0 = jnp.concatenate([
        jnp.full((1, D_thetas), float(np.log(np.expm1(1.0))), jnp.float64),
        1.5 * jax.random.normal(k_t, (num_starts - 1, D_thetas), jnp.float64),
    ])
    return _t(X0), _t(th0)


@pytest.fixture(scope="module")
def fits(hes1_data):
    ts, X = hes1_data
    jm = J.MAGI_v2(7, ts, X, None, jhes1, TINY_J)
    jm.initial_fit(discretization=2)
    tm = T.MAGI_v2(7, ts, X, None, thes1, TINY_T)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinit, "gradient_matching_starts", jax_starts)
        tm.initial_fit(discretization=2)
    return jm, tm


def _gm_inputs(jm):
    """The gradient-matching fit's inputs as initial_fit makes them, from
    the JAX model's fit of the observed components."""
    obs = jm.observed_indicators
    X_s = jpre.cv_cubic_smoother(jm.I, jm.X_interp_obs)
    return dict(I=jm.I, X_obs_smoothed=X_s, proper_order=jm.proper_order,
                observed_components=jm.observed_components,
                m_ds_obs=jm.m_ds[obs], K_invs_obs=jm.K_d_invs[obs],
                mu_obs=jm.mu_ds[obs])


def test_gradient_matching_matches_jax(fits):
    """Every start's Adam run, batched on a leading axis, against JAX's
    vmapped runs from JAX's starts: the winner's trajectory, theta and loss
    trace, and the winner itself (the start whose trace is JAX's)."""
    jm, _ = fits
    a = _gm_inputs(jm)
    Xj, thj, lj = jinit.fit_unobserved_gradient_matching(
        jhes1, a["I"], a["X_obs_smoothed"], a["proper_order"], 1, 7,
        learning_rate=0.01, num_iters=GM_ITERS,
        observed_components=a["observed_components"], m_ds_obs=a["m_ds_obs"],
        K_invs_obs=a["K_invs_obs"], mu_obs=a["mu_obs"])
    ops = dict(observed_components=a["observed_components"],
               m_ds_obs=_t(a["m_ds_obs"]), K_invs_obs=_t(a["K_invs_obs"]),
               mu_obs=_t(a["mu_obs"]))
    starts = jax_starts(8, jm.mag_I, 1, 7, a["X_obs_smoothed"])
    Xs, ths, losses, scores = tinit.run_gradient_matching(
        thes1, _t(a["I"]), _t(a["X_obs_smoothed"]), a["proper_order"],
        *starts, learning_rate=0.01, num_iters=GM_ITERS, **ops)
    assert losses.shape == (GM_ITERS, 8) and scores.shape == (8,)
    best = int(torch.argmin(scores))
    same = [j for j in range(8)
            if np.allclose(losses[:, j].numpy(), lj, rtol=1e-6, atol=0)]
    assert same == [best], (same, best, scores)
    Xt, tht, lt = tinit.fit_unobserved_gradient_matching(
        thes1, _t(a["I"]), _t(a["X_obs_smoothed"]), a["proper_order"], 1, 7,
        learning_rate=0.01, num_iters=GM_ITERS, starts=starts, **ops)
    np.testing.assert_array_equal(Xt, Xs[best].numpy())
    np.testing.assert_allclose(Xt, Xj, rtol=1e-6)
    np.testing.assert_allclose(tht, thj, rtol=1e-6)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)


def test_initial_fit_matches_jax(fits):
    jm, tm = fits
    assert tm.mag_I == jm.mag_I == 129
    assert tm.beta == jm.beta
    np.testing.assert_array_equal(tm.proper_order, jm.proper_order)
    np.testing.assert_array_equal(tm.unobserved_components, [2])
    assert set(tm.fit_timings) >= {"hparam_mle", "gradient_matching",
                                   "hparam_mle_unobserved", "cv_smoother"}
    # Adam on identical float64 objectives, the unobserved components'
    # hyperparameters through the gradient-matching trajectories
    for name in ("phi1s", "phi2s", "sigma_sqs_init", "thetas_init",
                 "mu_ds", "Xhat_init", "X_interp_obs"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-6, err_msg=name)
    for name in ("X_obs_discret", "I"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    # the operators through pinv of ill-conditioned matrices: in action on
    # the centered trajectories, relative to the result's scale (as
    # tests/test_torch_setup.py holds the fully observed fit)
    xc = (jm.Xhat_init - jm.mu_ds).T
    for name in ("C_d_invs", "m_ds", "K_d_invs"):
        a = np.einsum("dnm,dm->dn", getattr(jm, name), xc)
        b = np.einsum("dnm,dm->dn", getattr(tm, name), xc)
        assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max(), name


def test_theta_start_is_refused_with_unobserved_components(hes1_data):
    ts, X = hes1_data
    tm = T.MAGI_v2(7, ts, X, None, thes1, TINY_T)
    with pytest.raises(ValueError, match="thetas_init"):
        tm.initial_fit(2, thetas_init=np.ones(7))


@pytest.fixture(scope="module")
def centered(fits):
    """The JAX fit carried into the port (from_fit_arrays) with beta = 1,
    and both packages' centered targets with sigma pinned, as in the
    recipe."""
    jm, _ = fits
    jm.beta = 1.0
    jmode, *_ = jm._build_sampling_setup("centered", "dense", jnp.float64,
                                         sigma_sqs_fixed=SIGMA_FIXED)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, thes1, 7, config=T.MagiConfig(device="cpu"))
    tm.beta = 1.0
    tmode, _, _ = tm._build_sampling_setup("centered", "dense", F64,
                                           sigma_sqs_fixed=SIGMA_FIXED)
    pre_fix = tm._sigma_bounds(None, SIGMA_FIXED)[2]
    q0 = np.concatenate([jm.Xhat_init.ravel(), pre_fix,
                         np.log(np.expm1(jm.thetas_init))])
    return jm, tm, jmode, tmode, q0


@pytest.mark.parametrize("beta_temp", [1.0, 0.37])
def test_centered_target_of_a_carried_fit_matches_jax(centered, beta_temp):
    """The port's centered target evaluates relative to the fit's point
    and JAX's is the absolute log-posterior: the gradients agree, and so
    do the differences of lp between states."""
    jm, tm, jmode, tmode, q0 = centered
    np.testing.assert_array_equal(tm.proper_order, jm.proper_order)
    np.testing.assert_array_equal(tmode.X0.numpy(), jm.Xhat_init)
    rng = np.random.default_rng(4)
    qs = q0 + 0.02 * rng.standard_normal((4, q0.size))
    vj, gj = jax.vmap(lambda q: jmode.logp_grad(q, jnp.asarray(beta_temp)))(
        jnp.asarray(qs))
    vt, gt = tmode.logp_grad(_t(qs), torch.tensor(beta_temp, dtype=F64))
    vj, gj = np.asarray(vj), np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 1e-9 * np.abs(gj).max()
    dj, dt = vj[1:] - vj[0], vt.numpy()[1:] - vt.numpy()[0]
    assert np.abs(dt - dj).max() <= 1e-9 * np.abs(vj).max(), (dt, dj)


def test_centered_predict_on_cpu(fits):
    """A short centered predict of the port's own fit, as the recipe runs
    it (beta = 1, sigma pinned, no annealing), trees cut to depth 4: finite
    draws with JAX's result keys and shapes."""
    jm, tm = fits
    kw = dict(num_chains=4, num_results=30, num_burnin_steps=30,
              init_jitter=0.02, seed=0, reparam="centered",
              use_annealing=False, sigma_sqs_fixed=SIGMA_FIXED)
    tm.config = tm.config.replace(max_tree_depth=4)
    tm.beta = 1.0
    rt = tm.predict(**kw)
    jm2 = J.MAGI_v2(7, jm.ts_obs, jm.X_obs, None, jhes1,
                    TINY_J.replace(max_tree_depth=4))
    for f in FIT_FIELDS:
        setattr(jm2, f, getattr(jm, f))
    jm2.mag_I, jm2.obs_index, jm2.beta = jm.mag_I, jm.obs_index, 1.0
    rj = jm2.predict(**dict(kw, num_results=2, num_burnin_steps=2))
    assert set(rt) == set(rj)
    assert set(rt["kernel_results"]) == set(rj["kernel_results"])
    for k in ("X_samps", "thetas_samps", "sigma_sqs_samps", "sample_results"):
        assert np.shape(rt[k])[1:] == np.shape(rj[k])[1:], k
        assert np.shape(rt[k])[0] == 30, k
    assert np.all(np.isfinite(rt["X_samps"]))
    assert np.all(rt["thetas_samps"] > 0)
    np.testing.assert_array_equal(rt["sigma_sqs_samps"], SIGMA_FIXED)
    # centered draws are the trajectories themselves
    np.testing.assert_array_equal(
        rt["X_samps"].reshape(30, 4, -1),
        rt["sample_results"][..., :tm.mag_I * tm.D])


@pytest.mark.parametrize("step_size", [0.002, 0.01])
def test_centered_nuts_step_matches_jax(centered, step_size):
    """One NUTS transition of 8 chains in centered coordinates, the port's
    against JAX's vmapped nuts_step, with the noise JAX draws."""
    _, _, jmode, tmode, q0 = centered
    depth, C, dim = 6, 8, q0.size
    rng = np.random.default_rng(3)
    qs = q0 + 0.01 * rng.standard_normal((C, dim))
    jmass, tmass = _masses(dim, dense=False)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    one = jnp.asarray(1.0, jnp.float64)
    qj, info = jax.vmap(lambda k, q: jnuts_step(
        lambda r: jmode.logp_grad(r, one), k, q,
        jnp.asarray(step_size, jnp.float64), jmass,
        JNutsConfig(max_tree_depth=depth)))(keys, jnp.asarray(qs))
    from magi_v2_tpu_torch.sampler import nuts as tnuts

    one_t = torch.tensor(1.0, dtype=F64)
    qt, tinfo = tnuts.nuts_step(
        lambda r: tmode.logp_grad(r, one_t), _t(qs),
        torch.tensor(step_size, dtype=F64), tmass,
        jax_noise(keys, dim, depth), tnuts.NutsConfig(depth))
    _assert_matches_jax((qj, info), qt, tinfo)
