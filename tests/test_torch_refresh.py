"""The port's mid-warmup Gauss-Newton re-anchoring (predict's
``precond_refresh_steps``: ``SamplingMode.rebuild``, ``refresh_gn_anchor``
and its post-stage-A step ``reanchor``) against the JAX package, on a
small SEIR fit (21 observations, discretization 2: N_I = 81, two 128-row
tiles of the 243-long X block, bandsize 20), in float64 on the CPU, where
every kernel wrapper takes its plain version. The port's model is built
from the JAX fit's arrays.

The port's targets evaluate relative to a reference point, JAX's
absolutely, so lp is compared through its differences between states."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu.sampler.run as jrun
import magi_v2_tpu_torch.api as tapi
import magi_v2_tpu_torch.sampler.run as trun
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler.modes import refresh_gn_anchor as jrefresh
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.sampler.modes import refresh_gn_anchor as trefresh
from magi_v2_tpu_torch.sampler.run import SamplerConfig
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays
from magi_v2_tpu_torch.utils.profiling import untimed

torch.set_num_threads(2)

F64 = torch.float64
BETA_TEMP = 0.37
TRUTH = np.array([6.0, 0.6, 1.8])
SIGMA_FIXED = 0.01
# short HMC runs: the JAX test's NUTS at depth 10 costs minutes here
FAST = dict(algorithm="hmc", hmc_num_leapfrogs=16)


@pytest.fixture(scope="module")
def fitted():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=TRUTH, t_max=2.0, n_obs=21,
                            noise_sd=0.005)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=100, init_num_iters=200))
    jm.initial_fit(discretization=2)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, bandsize=20,
                         config=MagiConfig(device="cpu"),
                         exact_operators=jm._exact_operators())
    return jm, tm


_MODES = {}


def _modes(fitted, storage, **kw):
    """(JAX mode, port mode) of one storage in float64, built once."""
    key = (storage, tuple(sorted(kw)))
    if key not in _MODES:
        jm, tm = fitted
        jmode = jm._build_sampling_setup("precond", storage, jnp.float64,
                                         **kw)[0]
        tmode = tm._build_sampling_setup("precond", storage, F64, **kw)[0]
        _MODES[key] = (jmode, tmode)
    return _MODES[key]


def _anchor(tm, seed=0):
    """A perturbed anchor, as stage A would find one."""
    rng = np.random.default_rng(seed)
    X = np.asarray(tm.Xhat_init) + 0.01 * rng.standard_normal(
        tm.Xhat_init.shape)
    return X, np.asarray(tm.thetas_init) * 1.1


def _states(mode_X0, n, seed, sig=(-1.5, -1.4, -1.3), scale=0.3):
    rng = np.random.default_rng(seed)
    z0 = np.asarray(mode_X0, np.float64).ravel()
    q0 = np.concatenate([z0, sig, [1.8, -0.5, 0.6]])
    return q0 + scale * rng.standard_normal((n, q0.size))


def _evals(jmode, tmode, qs):
    f = jax.vmap(lambda q: jmode.logp_grad(q, jnp.asarray(BETA_TEMP)))
    vj, gj = (np.asarray(a) for a in f(jnp.asarray(qs)))
    vt, gt = tmode.logp_grad(torch.as_tensor(qs), torch.tensor(BETA_TEMP,
                                                               dtype=F64))
    return vj, gj, vt.numpy(), gt.numpy()


def _assert_targets_match(jmode, tmode, qs):
    vj, gj, vt, gt = _evals(jmode, tmode, qs)
    dj, dt = vj - vj[0], vt - vt[0]
    assert np.abs(dt - dj).max() <= 1e-10 * np.abs(dj).max()
    assert np.abs(gt - gj).max() <= 1e-10 * np.abs(gj).max()


@pytest.mark.parametrize("storage", ["banded", "hybrid"])
def test_rebuild_matches_jax(fitted, storage):
    """``rebuild`` at a perturbed anchor: the new start z0, the factor's
    tiles and the target at 4 states, against JAX's ``mode.rebuild``."""
    jm, tm = fitted
    jmode, tmode = _modes(fitted, storage)
    aX, ath = _anchor(tm)
    j2, t2 = jmode.rebuild(aX, ath), tmode.rebuild(aX, ath)
    z_j = np.asarray(j2.X0)
    assert np.abs(t2.X0.numpy() - z_j).max() <= 1e-10 * np.abs(z_j).max()
    U_j = np.asarray(j2.gn["U_blocks"])
    assert np.abs(t2.gn["U_blocks"].numpy() - U_j).max() <= (
        1e-10 * np.abs(U_j).max())
    # the anchor moved the factor
    assert np.abs(t2.gn["U_blocks"].numpy()
                  - tmode.gn["U_blocks"].numpy()).max() > 1e-8 * np.abs(
                      U_j).max()
    assert t2.rebuild is not None and t2.storage == storage
    _assert_targets_match(j2, t2, _states(z_j, 4, seed=1))


@pytest.mark.parametrize("storage", ["banded", "hybrid"])
def test_rebuild_keeps_sigma_pinning(fitted, storage):
    """The rebuilt target is pinned as the first: flat in the sigma_pre
    block, with a zero gradient there, and equal to JAX's rebuilt one."""
    jm, tm = fitted
    jmode, tmode = _modes(fitted, storage, sigma_sqs_fixed=SIGMA_FIXED)
    aX, ath = _anchor(tm, seed=2)
    j2, t2 = jmode.rebuild(aX, ath), tmode.rebuild(aX, ath)
    qs = _states(np.asarray(j2.X0), 4, seed=3)
    _assert_targets_match(j2, t2, qs)
    ND = tm.mag_I * tm.D
    q2 = qs.copy()
    q2[:, ND:ND + tm.D] += 3.0
    beta = torch.tensor(BETA_TEMP, dtype=F64)
    va, ga = t2.logp_grad(torch.as_tensor(qs), beta)
    vb, gb = t2.logp_grad(torch.as_tensor(q2), beta)
    assert torch.equal(va, vb)
    assert torch.all(ga[:, ND:ND + tm.D] == 0.0)
    assert torch.all(gb[:, ND:ND + tm.D] == 0.0)


@pytest.mark.parametrize("restart", ["remap", "laplace"])
@pytest.mark.parametrize("storage", ["banded", "hybrid"])
def test_post_stage_a_matches_jax(fitted, monkeypatch, storage, restart):
    """Both packages' stage-A runners return the same states; the anchor,
    the rebuilt mode and the stage-B starts then agree."""
    jm, tm = fitted
    jmode, tmode = _modes(fitted, storage)
    C = 6
    # stage-A chain states (C, dim) as a warmup might leave them
    qs_a = _states(np.asarray(tmode.X0), C, seed=5, scale=0.05)
    calls = []

    def jax_stage_a(lp, q0, key, cfg):
        calls.append(("jax", cfg))
        return jnp.asarray(qs_a)[None], None

    def port_stage_a(lp, q0, seed, cfg, timer=None):
        calls.append(("port", cfg, seed))
        return torch.as_tensor(qs_a)[None], None

    monkeypatch.setattr(jrun, "run_nuts_chains", jax_stage_a)
    monkeypatch.setattr(trun, "run_chains", port_stage_a)
    q0 = np.zeros((C, qs_a.shape[1]))
    jcfg = jrun.SamplerConfig(num_results=50, num_burnin_steps=50)
    tcfg = SamplerConfig(num_results=50, num_burnin_steps=50)
    with pytest.warns(UserWarning, match="HARMFUL"):
        j2, qj = jrefresh(jmode, jm, q0, C, jcfg, jnp.float64, 4, 20,
                          restart=restart, restart_scatter=0.1)
    with pytest.warns(UserWarning, match="HARMFUL"):
        t2, qt = trefresh(tmode, tm, q0, C, tcfg, F64, 4, 20,
                          restart=restart, restart_scatter=0.1)
    # stage A: one result after precond_refresh_steps warmup transitions
    port_cfg, port_seed = calls[1][1], calls[1][2]
    assert (port_cfg.num_results, port_cfg.num_burnin_steps) == (1, 20)
    assert port_cfg.thin == 1 and port_seed == 4 + 1000
    qj = np.asarray(qj, np.float64)
    assert qt.shape == qj.shape == (C, qs_a.shape[1])
    assert np.abs(qt - qj).max() <= 1e-10 * np.abs(qj).max()
    z_j = np.asarray(j2.X0)
    assert np.abs(t2.X0.numpy() - z_j).max() <= 1e-10 * np.abs(z_j).max()
    _assert_targets_match(j2, t2, qj[:4])


def test_refresh_refusals_and_warning(fitted):
    _, tm = fitted
    dense = tm._build_sampling_setup("precond", "dense", F64)[0]
    assert dense.rebuild is None
    q0 = np.zeros((2, 3 * tm.mag_I + 6))
    cfg = SamplerConfig(num_results=2, num_burnin_steps=2)
    with pytest.raises(ValueError, match="storage='banded'"):
        trefresh(dense, tm, q0, 2, cfg, F64, 0, 2)
    _, banded = _modes(fitted, "banded")
    with pytest.raises(ValueError, match="unknown refresh restart mode"):
        trefresh(banded, tm, q0, 2, cfg, F64, 0, 2, restart="bogus")
    with pytest.raises(ValueError, match="storage='banded'"):
        tm.predict(num_results=2, num_burnin_steps=2, num_chains=2,
                   storage="dense", precond_refresh_steps=2, **FAST)


@pytest.mark.parametrize("restart", ["remap", "laplace"])
def test_predict_banded_precond_refresh(fitted, restart):
    """The counterpart of tests/test_gn_banded.py's refresh test, with
    short HMC: the mechanics at small scale, both restarts."""
    _, tm = fitted
    with pytest.warns(UserWarning, match="HARMFUL"):
        res = tm.predict(num_results=40, num_burnin_steps=40, num_chains=2,
                         seed=0, storage="banded", reparam="precond",
                         precond_refresh_steps=20,
                         precond_refresh_restart=restart, **FAST)
    th = res["thetas_samps"].reshape(-1, 3)
    assert np.all(np.isfinite(th))
    assert np.all(np.isfinite(res["X_samps"]))
    assert np.abs(np.median(th, axis=0) - TRUTH).max() < 2.0
    assert {"refresh_stage_a", "refresh_rebuild"} <= set(tm.predict_timings)


def test_fixed_sigma_with_refresh_end_to_end(fitted):
    """The counterpart of tests/test_modes.py's: known sigma with a
    refresh reports the fixed values, and theta stays sane."""
    _, tm = fitted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = tm.predict(num_results=20, num_burnin_steps=20, num_chains=2,
                         seed=0, storage="banded", reparam="precond",
                         sigma_sqs_fixed=SIGMA_FIXED, precond_refresh_steps=10,
                         mass_matrix="tail_dense", **FAST)
    assert np.all(res["sigma_sqs_samps"] == SIGMA_FIXED)
    assert np.all(np.isfinite(res["thetas_samps"]))


@pytest.mark.parametrize("anneal_mode,stage_b_annealed", [
    ("warmup_only", False), ("reference", True)])
def test_stage_b_annealing(fitted, monkeypatch, anneal_mode,
                           stage_b_annealed):
    """Under warmup_only the ramp runs in stage A and stage B samples
    unannealed; under the reference schedule both anneal."""
    _, tm = fitted
    seen = []
    real = trun.run_chains

    def recording(lp, q0, seed, cfg, shards=None, timer=untimed):
        seen.append(cfg)
        return real(lp, q0, seed, cfg, shards, timer)

    monkeypatch.setattr(trun, "run_chains", recording)
    monkeypatch.setattr(tapi, "run_chains", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tm.predict(num_results=4, num_burnin_steps=4, num_chains=2, seed=1,
                   storage="hybrid", precond_refresh_steps=4,
                   anneal_mode=anneal_mode, hmc_num_leapfrogs=4,
                   algorithm="hmc")
    stage_a, stage_b = seen
    assert stage_a.use_annealing and stage_a.num_burnin_steps == 4
    assert stage_a.num_results == 1
    assert stage_b.use_annealing == stage_b_annealed
    assert stage_b.num_results == 4
