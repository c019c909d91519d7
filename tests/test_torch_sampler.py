"""Parity of the port's HMC sampler with the JAX package: one transition
with injected noise, the mass helpers, dual averaging, Welford moments and
the temperature schedule in float64; distributional checks of whole runs
on Gaussian targets; and the float32-matmul pin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler import mass as jmass
from magi_v2_tpu.sampler import run as jrun
from magi_v2_tpu.sampler.hmc import make_hmc_step
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.sampler import mass as tmass
from magi_v2_tpu_torch.sampler import run as trun
from magi_v2_tpu_torch.sampler.hmc import BoundTransition, hmc_step
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _spd(k, seed, cond=20.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    return (Q * np.geomspace(1.0, 1.0 / cond, k)) @ Q.T


@pytest.mark.parametrize("k", [0, 4, 9])
def test_mass_helpers_match_jax(k):
    dim = 9
    rng = np.random.default_rng(k)
    var = rng.uniform(0.5, 2.0, dim)
    p = rng.standard_normal((3, dim))
    if k == 0:
        jm, tm = jnp.asarray(var), _t(var)
    else:
        cov = _spd(k, k)
        jm = jmass.mass_from_moments(jnp.asarray(var), jnp.asarray(cov))
        tm = tmass.mass_from_moments(_t(var), _t(cov))
        for a, b in zip(jm, tm):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-14)
    np.testing.assert_allclose(tmass.mass_vel(tm, _t(p)).numpy(),
                               np.asarray(jmass.mass_vel(jm, jnp.asarray(p))),
                               rtol=1e-13)
    np.testing.assert_allclose(
        tmass.mass_kinetic(tm, _t(p)).numpy(),
        np.asarray(jmass.mass_kinetic(jm, jnp.asarray(p))), rtol=1e-13)
    # momenta from the same standard normals JAX draws for a key
    key = jax.random.PRNGKey(k)
    pj = np.asarray(jmass.mass_sample_momentum(jm, key, (3, dim),
                                               jnp.float64))
    z = np.asarray(jax.random.normal(key, (3, dim), jnp.float64))
    np.testing.assert_allclose(tmass.momentum_from_normal(tm, _t(z)).numpy(),
                               pj, rtol=1e-12, atol=1e-14)
    idj = jmass.identity_mass(dim, k, jnp.float64)
    idt = tmass.identity_mass(dim, k, torch.float64, "cpu")
    np.testing.assert_array_equal(tmass.mass_diag(idt).numpy(),
                                  np.asarray(jmass.mass_diag(idj)))


@pytest.fixture(scope="module")
def magi_targets():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, None, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    jmode, *_ = jm._build_sampling_setup("precond", "dense", jnp.float64)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, config=MagiConfig(device="cpu"))
    tmode, _, _ = tm._build_sampling_setup("precond", "dense", torch.float64)
    q0 = np.concatenate([np.asarray(jmode.X0).ravel(), [-10.5, -9.0, -9.5],
                         np.log(np.expm1(jm.thetas_init))])
    return jmode, tmode, q0


def _jax_transition_and_noise(magi_targets, step_size):
    """One JAX transition of 4 chains on the MAGI target with a full dense
    metric, and what the port needs to repeat it: (JAX outputs, the
    states, the port's mass, the momenta's normals and the accept
    uniforms the JAX step draws from its keys (hmc.py: split, normal,
    uniform), the step count)."""
    jmode, tmode, q0 = magi_targets
    dim, C, L = q0.size, 4, 7
    rng = np.random.default_rng(1)
    qs = q0 + 0.05 * rng.standard_normal((C, dim))
    var = rng.uniform(0.5, 1.5, dim)
    cov = np.diag(var) + 0.05 * _spd(dim, 2)
    jm = jmass.mass_from_moments(jnp.asarray(var), jnp.asarray(cov))
    tm = tmass.mass_from_moments(_t(var), _t(cov))

    keys = jax.random.split(jax.random.PRNGKey(3), C)
    one = jnp.asarray(1.0, jnp.float64)
    step = make_hmc_step(L)
    qj, info = jax.vmap(lambda k, q: step(
        lambda r: jmode.logp_grad(r, one), k, q,
        jnp.asarray(step_size, jnp.float64), jm, L))(keys, jnp.asarray(qs))
    normals, uniforms = [], []
    for k in keys:
        key_mom, key_acc = jax.random.split(k)
        normals.append(np.asarray(jax.random.normal(key_mom, (dim,),
                                                    jnp.float64)))
        uniforms.append(float(jax.random.uniform(key_acc,
                                                 dtype=jnp.float64)))
    return (qj, info), qs, tm, _t(np.stack(normals)), _t(uniforms), L


def _assert_matches_jax(jax_out, qt, tinfo):
    qj, info = jax_out
    np.testing.assert_allclose(tinfo.accept_prob.numpy(),
                               np.asarray(info.accept_prob), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(tinfo.diverging.numpy(),
                                  np.asarray(info.diverging))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("step_size", [0.05, 0.6])
def test_hmc_transition_matches_jax_with_injected_noise(magi_targets,
                                                        step_size):
    """One transition of 4 chains on the MAGI target with a full dense
    metric. The momenta and accept uniforms are the ones the JAX step
    draws from its keys, fed to the port; the two transitions then agree
    in float64."""
    jax_out, qs, tm, normals, uniforms, L = _jax_transition_and_noise(
        magi_targets, step_size)
    tmode = magi_targets[1]
    one_t = torch.tensor(1.0, dtype=torch.float64)
    qt, tinfo = hmc_step(
        lambda r: tmode.logp_grad(r, one_t), _t(qs),
        torch.tensor(step_size, dtype=torch.float64), tm, L, normals,
        uniforms,
    )
    _assert_matches_jax(jax_out, qt, tinfo)


@pytest.mark.parametrize("step_size", [0.05, 0.6])
def test_bound_transition_matches_jax_with_injected_noise(magi_targets,
                                                          step_size):
    """The same transition through the sampler's bound transition (the
    target's bound evaluation on fixed buffers; CUDA graphs on the card)."""
    jax_out, qs, tm, normals, uniforms, L = _jax_transition_and_noise(
        magi_targets, step_size)
    tmode = magi_targets[1]
    one_t = torch.tensor(1.0, dtype=torch.float64)
    bound = BoundTransition(tmode.logp_grad, _t(qs), tm)
    qt, tinfo = bound(_t(qs), torch.tensor(step_size, dtype=torch.float64),
                      tm, one_t, L, normals, uniforms)
    _assert_matches_jax(jax_out, qt, tinfo)


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(0)
    sj = jrun._da_init(0.3, jnp.float64)
    st = trun.da_init(torch.tensor(0.3, dtype=torch.float64))
    for a in rng.uniform(0.0, 1.0, 50):
        sj = jrun._da_update(sj, jnp.asarray(a), 0.75)
        st = trun.da_update(st, torch.tensor(a, dtype=torch.float64), 0.75)
    for f in ("log_step", "log_step_avg", "h_bar", "mu", "count"):
        np.testing.assert_allclose(float(getattr(st, f)),
                                   float(getattr(sj, f)), rtol=1e-13)


@pytest.mark.parametrize("shrinkage", [0.0, 0.2])
def test_welford_moments_match_jax(shrinkage):
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((8, 6)) * [1, 2, 3, 4, 5, 6] + 1.0
               for _ in range(5)]
    wj, wt = jrun._welford_init(6, jnp.float64), \
        trun.welford_init(6, torch.float64, "cpu")
    cj, ct = jrun._welford_cov_init(4, jnp.float64), \
        trun.welford_cov_init(4, torch.float64, "cpu")
    for b in batches:
        wj = jrun._welford_add_batch(wj, jnp.asarray(b))
        wt = trun.welford_add_batch(wt, _t(b))
        cj = jrun._welford_cov_add_batch(cj, jnp.asarray(b[:, -4:]))
        ct = trun.welford_cov_add_batch(ct, _t(b[:, -4:]))
    np.testing.assert_allclose(trun.welford_variance(wt).numpy(),
                               np.asarray(jrun._welford_variance(wj)),
                               rtol=1e-13)
    covj = np.asarray(jrun._welford_covariance(cj, shrinkage))
    covt = trun.welford_covariance(ct, shrinkage).numpy()
    np.testing.assert_allclose(covt, covj, rtol=1e-13, atol=1e-15)
    var = trun.welford_variance(wt)
    for a, b in zip(jmass.mass_from_moments(jnp.asarray(var.numpy()),
                                            jnp.asarray(covj)),
                    tmass.mass_from_moments(var, _t(covt))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-14)


def test_temperature_schedule_matches_jax():
    steps = np.arange(0, 3000, 7)
    np.testing.assert_allclose(
        trun.log_temperature_schedule(steps, 0.1),
        np.asarray(jrun.log_temperature_schedule(jnp.asarray(steps), 0.1)),
        rtol=1e-15)


def _gaussian_target(cov):
    prec = torch.as_tensor(np.linalg.inv(cov))

    def lp(q, beta_temp):
        g = -(q @ prec.to(q.dtype)) * beta_temp
        return 0.5 * torch.sum(q * g, dim=-1), g

    return lp


@pytest.mark.parametrize("dense", [False, True])
def test_hmc_run_samples_anisotropic_gaussian(dense):
    """Whole runs (warmup adaptation + sampling) on a correlated, badly
    scaled Gaussian, as tests/test_sampler.py does for the JAX sampler."""
    sd = np.array([1.0, 10.0, 0.3])
    corr = np.array([[1.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 1.0]])
    cov = corr * np.outer(sd, sd)
    cfg = trun.SamplerConfig(
        num_results=1500, num_burnin_steps=800, use_annealing=False,
        algorithm="hmc", hmc_num_leapfrogs=16, dense_tail_size=3 if dense else 0,
        mass_window_begin=0.2, mass_window_end=0.4,
        mass_window2_begin=0.45, mass_window2_end=0.75,
        mass_window1_diag=dense,
    )
    q0 = torch.zeros((16, 3), dtype=torch.float64)
    samples, stats = trun.run_chains(_gaussian_target(cov), q0, 4, cfg)
    flat = samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.15 * sd.max())
    np.testing.assert_allclose(flat.std(axis=0), sd, rtol=0.12)
    np.testing.assert_allclose(np.corrcoef(flat.T), corr, atol=0.1)
    np.testing.assert_allclose(stats.inv_mass.numpy(), sd ** 2, rtol=0.5)
    assert stats.accept_probs.numpy().mean() > 0.5
    assert not stats.divergences.numpy().any()
    if dense:
        tail = stats.tail_inv_mass.numpy()
        np.testing.assert_allclose(tail / np.outer(sd, sd), corr, atol=0.25)


def test_warmup_only_annealing_samples_true_posterior():
    """anneal_mode='warmup_only': the draws follow the beta=1 target."""
    cfg = trun.SamplerConfig(num_results=800, num_burnin_steps=400,
                             anneal_mode="warmup_only", algorithm="hmc",
                             hmc_num_leapfrogs=8)
    q0 = torch.zeros((8, 2), dtype=torch.float64)
    samples, _ = trun.run_chains(_gaussian_target(np.eye(2)), q0, 5, cfg)
    np.testing.assert_allclose(samples.reshape(-1, 2).numpy().var(axis=0),
                               1.0, atol=0.15)


def test_reference_annealing_samples_tempered_target():
    """anneal_mode='reference': the schedule runs through sampling, so the
    draws follow the tempered target (variance 1/beta_temp ~ 7.6 at
    steps ~2000, as in the JAX package)."""
    cfg = trun.SamplerConfig(num_results=600, num_burnin_steps=1400,
                             anneal_mode="reference", algorithm="hmc",
                             hmc_num_leapfrogs=8,
                             adapt_mass_matrix=False)
    q0 = torch.zeros((8, 1), dtype=torch.float64)
    samples, _ = trun.run_chains(_gaussian_target(np.eye(1)), q0, 6, cfg)
    expected = 1.0 / trun.log_temperature_schedule(np.arange(1400, 2000),
                                                   0.1).mean()
    np.testing.assert_allclose(samples.numpy().var(), expected, rtol=0.2)


def test_sampler_pins_full_float32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        cfg = trun.SamplerConfig(num_results=2, num_burnin_steps=2,
                                 algorithm="hmc", hmc_num_leapfrogs=2,
                                 adapt_mass_matrix=False)
        trun.run_chains(_gaussian_target(np.eye(2)),
                            torch.zeros((2, 2), dtype=torch.float32), 0, cfg)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        trun.pin_full_float32_matmuls()


def _steps(*ranges):
    return {s for lo, hi in ranges for s in range(lo, hi)}


# (SamplerConfig fields, C) -> what the schedule holds: the mass windows
# and their closes, the re-seat boundaries and summed steps, the blocks
SCHEDULES = {
    "defaults": (dict(), 4, dict(
        B=1000, num_adapt=800, windows=((450, 700),),
        closes={700: False}, reseat_at={450: 400, 800: 750},
        summed=_steps((400, 450), (750, 800)), transitions=2000,
        warmup_blocks=[(0, 1000)], sample_blocks=[(0, 1000)])),
    # the seir-hmc cell's recipe, in blocks of 50 transitions, thinned
    "two windows": (dict(num_burnin_steps=200, num_results=200,
                         mass_window_begin=0.25, mass_window_end=0.45,
                         mass_window2_begin=0.5, mass_window2_end=0.72,
                         mass_window1_diag=True, dispatch_block_steps=50,
                         thin=2), 4, dict(
        num_adapt=160, windows=((50, 90), (100, 144)),
        closes={90: True, 144: False},
        reseat_at={50: 40, 100: 90, 160: 150},
        summed=_steps((40, 50), (90, 100), (150, 160)), transitions=600,
        warmup_blocks=[(s, 50) for s in range(0, 200, 50)],
        sample_blocks=[(s, 25) for s in range(0, 200, 25)])),
    "no mass": (dict(num_burnin_steps=100, num_results=10,
                     adapt_mass_matrix=False), 4, dict(
        windows=(), closes={}, reseat_at={80: 75}, summed=_steps((75, 80)))),
    "no re-seat": (dict(num_burnin_steps=100, num_results=10,
                        reseat_accept_below=0.0), 4, dict(
        windows=((45, 70),), reseat_at={}, summed=set())),
    "ladder": (dict(num_burnin_steps=20, num_results=10,
                    pt_betas=(1.0, 0.5), use_annealing=False), 4, dict(
        betas=(1.0, 0.5), reseat_at={9: 8, 16: 15})),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_alone(case):
    """The schedule from the config and the chain count alone: its windows,
    closes, re-seat boundaries, temperatures and blocks."""
    fields, C, want = SCHEDULES[case]
    config = trun.SamplerConfig(**fields)
    sched = trun.Schedule(config, C)
    for name, value in want.items():
        assert getattr(sched, name) == value, name
    steps = np.arange(sched.transitions)
    temps = (np.ones(steps.size) if not config.use_annealing
             else trun.log_temperature_schedule(steps, 0.1))
    np.testing.assert_array_equal(sched.temps, temps)
    assert sched.betas is None or case == "ladder"


def test_schedule_ramp_and_refusals():
    """warmup_only annealing ramps up to the first window's start, and the
    schedule refuses what run_chains refuses, with the same messages."""
    cfg = trun.SamplerConfig(num_burnin_steps=100, num_results=10,
                             anneal_mode="warmup_only")
    steps = np.arange(110)
    np.testing.assert_array_equal(
        trun.Schedule(cfg, 2).temps,
        np.maximum(trun.log_temperature_schedule(steps, 0.1),
                   np.clip(steps / 45, 0.0, 1.0)))
    bad = [(dict(mass_window_begin=0.5, mass_window_end=0.5,
                 mass_window2_begin=0.6, mass_window2_end=0.7),
            "requires a valid first window"),
           (dict(mass_window2_begin=0.6, mass_window2_end=0.7),
            "must start at or after"),
           (dict(mass_window2_begin=0.7, mass_window2_end=0.9),
            "before step-size adaptation does"),
           (dict(anneal_mode="later"), "unknown anneal_mode"),
           (dict(pt_betas=(1.0, 0.5), use_annealing=False),
            "must divide by the PT ladder")]
    for fields, message in bad:
        with pytest.raises(ValueError, match=message):
            trun.Schedule(trun.SamplerConfig(num_burnin_steps=100, **fields),
                          3)


def test_two_window_validation_matches_jax():
    cfg = trun.SamplerConfig(num_results=2, num_burnin_steps=100,
                             mass_window_begin=0.1, mass_window_end=0.5,
                             mass_window2_begin=0.4, mass_window2_end=0.6)
    with pytest.raises(ValueError, match="must start at or after"):
        trun.run_chains(_gaussian_target(np.eye(2)),
                            torch.zeros((2, 2), dtype=torch.float64), 0, cfg)
