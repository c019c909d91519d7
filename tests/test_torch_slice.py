"""End to end: the port's SEIR slice (initial_fit, then dense-metric HMC
predict with the bench recipe) against the JAX package's on the same fit,
at a small size on the CPU in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler.precond import unwhiten_Z_full
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.sampler.modes import unwhiten_draws
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays
from magi_v2_tpu_torch.utils.diagnostics import effective_sample_size

torch.set_num_threads(2)

# the bench recipe (bench.py), cut to a small run
RECIPE = dict(
    num_chains=8, seed=0, init_jitter=0.01, algorithm="hmc",
    hmc_num_leapfrogs=24, mass_matrix="dense", anneal_mode="reference",
    dense_shrinkage=0.2, mass_window=(0.25, 0.45),
    mass_window2=(0.50, 0.72), mass_window1_diag=True,
)
STEPS = 200


@pytest.fixture(scope="module")
def fitted():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, bandsize=20,
                         config=MagiConfig(device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def runs(fitted):
    jm, tm = fitted
    rj = jm.predict(num_results=STEPS, num_burnin_steps=STEPS, **RECIPE)
    rt = tm.predict(num_results=STEPS, num_burnin_steps=STEPS, **RECIPE)
    return rj, rt


def test_results_dict_matches_jax(runs):
    rj, rt = runs
    assert set(rt) == set(rj)
    assert set(rt["kernel_results"]) == set(rj["kernel_results"])
    for k in ("X_samps", "thetas_samps", "sigma_sqs_samps", "sample_results"):
        assert np.asarray(rt[k]).shape == np.asarray(rj[k]).shape, k
    for k, v in rj["kernel_results"].items():
        assert np.shape(rt["kernel_results"][k]) == np.shape(v), k
    for k in ("phi1s", "phi2s", "Xhat_init", "sigma_sqs_init", "thetas_init",
              "I"):
        np.testing.assert_array_equal(rt[k], rj[k])
    assert np.all(np.isfinite(rt["X_samps"]))
    assert np.all(rt["thetas_samps"] > 0)


def test_theta_posterior_means_agree_with_jax(runs):
    """Different random streams, same posterior: the pooled theta means
    agree within 5 combined Monte-Carlo standard errors (sd / sqrt(ESS)
    per package)."""
    rj, rt = runs
    for p in range(3):
        a, b = rj["thetas_samps"][..., p], rt["thetas_samps"][..., p]
        se = np.hypot(a.std() / np.sqrt(effective_sample_size(a)),
                      b.std() / np.sqrt(effective_sample_size(b)))
        assert abs(a.mean() - b.mean()) <= 5.0 * se, (p, a.mean(), b.mean(),
                                                      se)
    assert rt["kernel_results"]["accept_probs"].mean() > 0.5
    assert rt["kernel_results"]["divergences"].mean() < 0.01


def test_trajectory_draws_agree_with_jax(runs):
    rj, rt = runs
    xj, xt = rj["X_samps"].mean(axis=(0, 1)), rt["X_samps"].mean(axis=(0, 1))
    sd = rj["X_samps"].std(axis=(0, 1))
    assert np.abs(xj - xt).max() <= 0.5 * sd.max() + 1e-4


def test_unwhiten_draws_matches_jax(fitted):
    jm, tm = fitted
    mode, data, _ = tm._build_sampling_setup("precond", "dense",
                                             torch.float64)
    Z = np.random.default_rng(2).standard_normal((5, 3, tm.mag_I, tm.D))
    xj = np.asarray(unwhiten_Z_full(jnp.asarray(Z), jnp.asarray(tm.mu_ds),
                                    jnp.asarray(mode.factor.numpy())))
    for max_bytes in (1 << 30, 1):     # one chunk, and one draw per chunk
        xt = unwhiten_draws(mode, torch.as_tensor(Z), data.mu_ds,
                            max_bytes=max_bytes).numpy()
        np.testing.assert_allclose(xt, xj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("override,exc", [
    ({"algorithm": "slice"}, ValueError),
    # the storage x reparam combinations the JAX package refuses
    ({"reparam": "whitened", "storage": "banded"}, ValueError),
    ({"reparam": "whitened", "storage": "hybrid"}, ValueError),
    ({"reparam": "centered", "storage": "hybrid"}, ValueError),
    # the refresh is ported; the JAX package refuses it in dense storage
    ({"precond_refresh_steps": 10}, ValueError),
    ({"init_states": {"theta": np.ones(3)}}, ValueError),
    # parallel tempering is ported; the refusal left is the JAX package's
    ({"pt_betas": (1.0, 0.5), "anneal_mode": "reference"}, ValueError),
    # and an unknown restart of the refresh in banded storage
    ({"precond_refresh_steps": 10, "storage": "banded",
      "precond_refresh_restart": "bogus"}, ValueError),
    ({"matmul_precision": "high"}, ValueError),
])
def test_unported_predict_options_raise(fitted, override, exc):
    _, tm = fitted
    kw = dict(RECIPE, **override)
    with pytest.raises(exc):
        tm.predict(num_results=2, num_burnin_steps=2, **kw)


def test_single_chain_results_are_squeezed(fitted):
    _, tm = fitted
    kw = dict(RECIPE, num_chains=1, hmc_num_leapfrogs=4)
    res = tm.predict(num_results=20, num_burnin_steps=20, **kw)
    assert res["X_samps"].shape == (20, tm.mag_I, tm.D)
    assert res["thetas_samps"].shape == (20, 3)
    assert res["sigma_sqs_samps"].shape == (20, 3)
