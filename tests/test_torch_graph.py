"""The sampler's bound transition (``hmc.BoundTransition``: fixed buffers,
on the card replayed CUDA graphs) against the eager ``hmc_step``, the
targets' bound evaluations against their calls, and K2's plain version
with the full dense metric against the JAX mass helpers. Float64 on the
CPU, where the bound transition runs its steps eagerly: the same
operations on the same buffers, so the draws agree bit for bit.

The graph replay itself runs on the card only: ``tests/test_torch_kernels.py``
(``-m cuda``) and ``chip_smoke.py`` hold it against the eager path there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu_torch as T
from magi_v2_tpu.sampler import mass as jmass
from magi_v2_tpu_torch.models import lorenz_f_vec, seir_f_vec
from magi_v2_tpu_torch.sampler import hmc
from magi_v2_tpu_torch.sampler import run as trun
from magi_v2_tpu_torch.sampler.mass import mass_from_moments
from magi_v2_tpu_torch.utils.data import simulate_ode

torch.set_num_threads(2)

F64 = torch.float64
SIGMA_FIXED = 0.25
# (model, storage): the SEIR bench grid (N_I = 161, flat state 489) in
# dense storage, a small Lorenz grid (N_I = 65, bandsize 4) in the two
# large-grid storages
CASES = [("seir", "dense"), ("lorenz", "hybrid"), ("lorenz", "banded")]


@pytest.fixture(scope="module")
def models():
    cfg = T.MagiConfig(device="cpu", dtype=F64, hparam_num_iters=30,
                       init_num_iters=50)
    ts, X, _ = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=4.0,
                            n_obs=81, noise_sd=0.005)
    seir = T.MAGI_v2(3, ts, X, None, seir_f_vec, cfg)
    seir.initial_fit(1)
    ts, X, _ = simulate_ode(lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]),
                            thetas=np.array([10.0, 28.0, 8.0 / 3.0]),
                            t_max=2.0, n_obs=17, noise_sd=0.5, substeps=20)
    lorenz = T.MAGI_v2(3, ts, X, 4, lorenz_f_vec, cfg)
    lorenz.initial_fit(2, thetas_init=np.array([10.0, 28.0, 8.0 / 3.0]))
    return {"seir": seir, "lorenz": lorenz}


_SETUPS = {}


def _setup(models, name, storage, pinned=False, C=4, seed=0):
    """(target, states (C, dim)) of one case: the whitened start plus
    noise, with sigma_pre and theta_pre near the fit."""
    key = (name, storage, pinned)
    if key not in _SETUPS:
        model = models[name]
        kw = {"sigma_sqs_fixed": SIGMA_FIXED} if pinned else {}
        mode, _, _ = model._build_sampling_setup("precond", storage, F64,
                                                 **kw)
        tail = ([-10.5] * 3 + [1.8, -0.5, 0.6] if name == "seir"
                else [-1.5] * 3 + [10.0, 28.0, 2.6])
        q0 = torch.cat([mode.X0.reshape(-1), torch.tensor(tail, dtype=F64)])
        _SETUPS[key] = (mode.logp_grad, q0)
    target, q0 = _SETUPS[key]
    g = torch.Generator().manual_seed(seed)
    return target, q0 + 0.01 * torch.randn((C, q0.numel()), generator=g,
                                           dtype=F64)


def _mass(dim, form, seed=0):
    rng = np.random.default_rng(seed)
    var = torch.as_tensor(rng.uniform(0.5, 1.5, dim))
    if form == "diag":
        return var
    k = 3 if form == "tail_dense" else dim
    a = rng.standard_normal((k, k))
    cov = torch.as_tensor(np.diag(var.numpy()[-k:]) + 0.02 * a @ a.T / k)
    return mass_from_moments(var, cov)


@pytest.mark.parametrize("form", ["diag", "tail_dense", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_bound_transition_is_hmc_step_bit_for_bit(models, case, form):
    """Transitions of L = 0, 1 and 5 leapfrogs, and one after the mass
    changed, through the bound transition and through ``hmc_step`` from
    the same state with the same normals and uniforms."""
    target, qs = _setup(models, *case)
    C, dim = qs.shape
    rng = np.random.default_rng(3)
    eps = torch.tensor(0.02, dtype=F64)
    bt = torch.tensor(0.7, dtype=F64)
    mass = _mass(dim, form)
    bound = hmc.BoundTransition(target, qs, mass)
    for L, m in ((0, mass), (1, mass), (5, mass), (3, _mass(dim, form, 1))):
        normals = torch.as_tensor(rng.standard_normal((C, dim)))
        uniforms = torch.as_tensor(rng.uniform(size=C))
        q_e, info_e = hmc.hmc_step(lambda r: target(r, bt), qs, eps, m, L,
                                   normals, uniforms)
        q_b, info_b = bound(qs, eps, m, bt, L, normals, uniforms)
        assert torch.equal(q_b, q_e)
        assert torch.equal(info_b.accept_prob, info_e.accept_prob)
        assert torch.equal(info_b.diverging, info_e.diverging)
        assert info_b.num_leapfrogs == info_e.num_leapfrogs == L
        qs = q_b
    # the bound transition is made for one mass form
    with pytest.raises(ValueError, match="dense block"):
        bound(qs, eps, _mass(dim, "diag" if form != "diag" else "dense"), bt,
              1, normals, uniforms)


@pytest.mark.parametrize("case", CASES)
def test_bound_warmup_across_mass_windows_is_the_eager_one(models, case):
    """A short run whose warmup closes two mass windows (a diagonal one,
    then a dense one) and adapts the step size: the target as given is
    bound to the bound transition, the same target behind a plain callable
    evaluated eagerly into it, and every draw, acceptance, step size and
    mass agree bit for bit. The Lorenz cases pin sigma (the PinnedSigma
    wrapper)."""
    name, storage = case
    pinned = name == "lorenz"
    target, qs = _setup(models, name, storage, pinned=pinned)
    dim = qs.shape[1]
    cfg = trun.SamplerConfig(
        num_results=4, num_burnin_steps=20, algorithm="hmc",
        hmc_num_leapfrogs=4, mass_window_begin=0.1, mass_window_end=0.3,
        mass_window2_begin=0.35, mass_window2_end=0.6, mass_window1_diag=True,
        dense_tail_size=dim if name == "seir" else 3, anneal_mode="reference")
    bound = trun.run_chains(target, qs, 5, cfg)
    eager = trun.run_chains(lambda q, b: target(q, b), qs, 5, cfg)
    for a, b in zip(bound, eager):
        for x, y in (zip(a, b) if isinstance(a, tuple) else ((a, b),)):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pt", [False, True])
def test_plain_callable_hmc_run_is_hmc_step(monkeypatch, pt):
    """An HMC run on a plain callable (no ``bind``) takes the bound
    transition with its eager adapter: each transition, from the mass
    windows' closes (a dense tail) to the tempered sampling, equals
    ``hmc_step`` on the same arguments bit for bit."""
    prec = torch.tensor([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 0.5]],
                        dtype=F64)

    def target(q, beta_temp):
        b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
        g = -(q @ prec)
        return 0.5 * beta_temp * torch.sum(q * g, dim=-1), b * g

    seen, real = [], hmc.BoundTransition.__call__

    def spy(bound, *args):
        out = real(bound, *args)
        seen.append(([a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args], out))
        return out

    monkeypatch.setattr(hmc.BoundTransition, "__call__", spy)
    cfg = trun.SamplerConfig(
        num_results=6, num_burnin_steps=20, algorithm="hmc",
        hmc_num_leapfrogs=5, dense_tail_size=2, mass_window_begin=0.2,
        mass_window_end=0.5, dispatch_block_steps=7,
        **(dict(pt_betas=(1.0, 0.5), use_annealing=False) if pt else {}))
    q0 = torch.randn((4, 3), dtype=F64,
                     generator=torch.Generator().manual_seed(3))
    trun.run_chains(target, q0, 5, cfg)
    assert len(seen) == 26
    for (q, eps, mass, beta, L, normals, uniforms, med), (q1, info) in seen:
        q_ref, ref = hmc.hmc_step(lambda r: target(r, beta), q, eps, mass, L,
                                  normals, uniforms, med)
        assert torch.equal(q1, q_ref)
        assert torch.equal(info.accept_prob, ref.accept_prob)
        assert torch.equal(info.diverging, ref.diverging)
        assert info.num_leapfrogs == ref.num_leapfrogs == L


@pytest.mark.parametrize("case,pinned", [(c, False) for c in CASES]
                         + [(c, True) for c in CASES[1:]])
def test_bound_evaluation_equals_the_call(models, case, pinned):
    """``target.bind(q, beta_temp, lp, grad)()`` writes what ``target(q,
    beta_temp)`` returns, reading the buffers at each call; with sigma
    pinned too (the PinnedSigma wrapper)."""
    target, qs = _setup(models, *case, pinned=pinned)
    C, dim = qs.shape
    q, lp, grad = torch.empty_like(qs), torch.empty(C, dtype=F64), \
        torch.empty_like(qs)
    bt = torch.tensor(0.0, dtype=F64)
    evaluate = target.bind(q, bt, lp, grad)
    for i, temp in enumerate((0.4, 1.0)):
        states = qs + 0.01 * i
        q.copy_(states)
        bt.fill_(temp)
        evaluate()
        lp_c, grad_c = target(states, torch.tensor(temp, dtype=F64))
        assert torch.equal(lp, lp_c) and torch.equal(grad, grad_c)


def test_bound_evaluation_checks_its_buffers(models):
    target, qs = _setup(models, "lorenz", "banded")
    C, dim = qs.shape
    bt = torch.tensor(1.0, dtype=F64)
    lp, grad = torch.empty(C, dtype=F64), torch.empty_like(qs)
    with pytest.raises(TypeError, match="grad"):
        target.bind(qs, bt, lp, grad[:, :-1])
    with pytest.raises(TypeError, match="beta_temp"):
        target.bind(qs, bt.float(), lp, grad)
    with pytest.raises(ValueError, match="contiguous"):
        target.bind(qs, bt, torch.empty(2 * C, dtype=F64)[::2], grad)


@pytest.mark.parametrize("dim,k", [(489, 489), (9, 4), (9, 0), (30, 30)])
def test_plain_leapfrog_matches_jax_mass_helpers(dim, k):
    """K2's plain version (two kicks, the velocity, the drift, the kinetic
    energy) against the JAX package's mass_vel and mass_kinetic, for the
    full dense metric of the SEIR recipe (k = dim = 489), a dense tail and
    a diagonal."""
    rng = np.random.default_rng(dim + k)
    C = 5
    q, p, g = (rng.standard_normal((C, dim)) for _ in range(3))
    var = rng.uniform(0.5, 1.5, dim)
    eps = 0.03
    if k:
        a = rng.standard_normal((k, k))
        cov = np.diag(var[-k:]) + 0.1 * a @ a.T / k
        jm = jmass.mass_from_moments(jnp.asarray(var), jnp.asarray(cov))
        tm = mass_from_moments(torch.as_tensor(var), torch.as_tensor(cov))
    else:
        jm, tm = jnp.asarray(var), torch.as_tensor(var)
    qt, pt, gt = (torch.as_tensor(x.copy()) for x in (q, p, g))
    kin = hmc.leapfrog_update_plain(qt, pt, gt, torch.tensor(eps, dtype=F64),
                                    tm, 2, True, True)
    pj = jnp.asarray(p) + 0.5 * eps * jnp.asarray(g)
    pj = pj + 0.5 * eps * jnp.asarray(g)
    qj = jnp.asarray(q) + eps * jmass.mass_vel(jm, pj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-13,
                               atol=1e-14)
    np.testing.assert_allclose(kin.numpy(),
                               np.asarray(jmass.mass_kinetic(jm, pj)),
                               rtol=1e-13)


def test_cpu_leapfrog_wrapper_takes_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    q, p, g = (torch.as_tensor(rng.standard_normal((3, 12))) for _ in range(3))
    mass = _mass(12, "tail_dense")
    eps = torch.tensor(0.1, dtype=F64)
    hmc.reset_launch_counts()
    q2, p2 = q.clone(), p.clone()
    kin = hmc.leapfrog_update(q, p, g, eps, mass, 2, True, True)
    ref = hmc.leapfrog_update_plain(q2, p2, g, eps, mass, 2, True, True)
    assert torch.equal(q, q2) and torch.equal(p, p2) and torch.equal(kin, ref)
    assert hmc.launch_counts() == {"leapfrog_update": 0}


def test_bind_leapfrog_checks_its_arguments():
    q = torch.zeros((3, 12), dtype=F64)
    eps = torch.tensor(0.1, dtype=F64)
    with pytest.raises(TypeError, match="g must be"):
        hmc.bind_leapfrog(q, q.clone(), q.float(), eps, torch.ones(12,
                          dtype=F64), 1, True)
    with pytest.raises(ValueError, match="inverse mass"):
        hmc.bind_leapfrog(q, q.clone(), q.clone(), eps,
                          torch.ones(11, dtype=F64), 1, True)
    with pytest.raises(ValueError, match="kinetic"):
        hmc.bind_leapfrog(q, q.clone(), q.clone(), eps,
                          torch.ones(12, dtype=F64), 0, False,
                          torch.empty(4, dtype=F64))


def test_kinetic_partials_follow_the_kernel_layout():
    """One partial sum per 1024-element stream CTA of a row's diagonal
    head and one per CTA of the dense block's cluster (64 columns a CTA up
    to 8 CTAs, then 128, 256, 512)."""
    assert hmc.kinetic_partials(3081, 0) == 4
    assert hmc.kinetic_partials(3081, 3) == 4 + 1
    assert hmc.kinetic_partials(489, 489) == 8
    assert hmc.kinetic_partials(600, 600) == 5
    assert hmc.kinetic_partials(3081, 3081) == 7
    assert hmc.kinetic_partials(1021, 0) == 1
    assert hmc.kinetic_partials(1022, 0) == 2


def test_predict_takes_the_bound_transition(models, monkeypatch):
    """Every target that predict builds has a bound evaluation, so its
    sampler never takes the eager adapter."""
    real = hmc.BoundBuffers._evaluation

    def bound_only(bound, target):
        assert hasattr(target, "bind"), "predict took the eager adapter"
        return real(bound, target)

    monkeypatch.setattr(hmc.BoundBuffers, "_evaluation", bound_only)
    for name, storage, kw in (("seir", "dense", {}),
                              ("lorenz", "banded",
                               {"sigma_sqs_fixed": SIGMA_FIXED})):
        res = models[name].predict(
            num_results=3, num_burnin_steps=3, num_chains=2,
            algorithm="hmc", hmc_num_leapfrogs=3, storage=storage,
            mass_matrix="diag", **kw)
        assert np.all(np.isfinite(res["X_samps"]))
    assert hmc.graph_counts()["captures"] == 0
