"""Parity of the port's posterior and of the fused sampler target K1 with
the JAX package.

K1 here is the port's ``make_tempered_logp_grad_gn`` composed from the
plain PyTorch versions of its three kernels (what a CPU tensor runs). It
is held against ``magi_v2_tpu.sampler.precond.make_tempered_logp_grad_gn``
as built by the JAX ``_build_sampling_setup``, from the same fit, and
against autograd of the port's plain ``log_posterior_given_t1``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu import posterior as jpo
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler import magi_state as jms
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import posterior as tpo
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops import manifold as mf
from magi_v2_tpu_torch.sampler import magi_state as tms
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

BETA_TEMP = 0.37


@pytest.fixture(scope="module")
def jax_fit():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    return jm


def _targets(jm, jdt, tdt):
    jmode, *_ = jm._build_sampling_setup("precond", "dense", jdt)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, bandsize=jm.BANDSIZE,
                         config=T.MagiConfig(dtype=tdt, device="cpu"))
    tmode, tdata, _ = tm._build_sampling_setup("precond", "dense", tdt)
    return jmode, tmode, tm, tdata


def _states(jmode, n=8, seed=0, scale=0.3):
    """Chain states around the init: whitened X block, sigma and theta
    pre-images near the fit's."""
    rng = np.random.default_rng(seed)
    z0 = np.asarray(jmode.X0, np.float64).ravel()
    q0 = np.concatenate([z0, [-10.5, -9.0, -9.5], [1.8, -0.3, 1.5]])
    return q0 + scale * rng.standard_normal((n, q0.size))


def _jax_eval(jmode, qs, dt):
    f = jax.vmap(lambda q: jmode.logp_grad(q, jnp.asarray(BETA_TEMP, dt)))
    v, g = f(jnp.asarray(qs, dt))
    return np.asarray(v, np.float64), np.asarray(g, np.float64)


def _port_eval(tmode, qs, dt):
    v, g = tmode.logp_grad(torch.as_tensor(qs, dtype=dt),
                           torch.tensor(BETA_TEMP, dtype=dt))
    return v.double().numpy(), g.double().numpy()


# float64: same math, different summation order through the whitening GEMM
# (a 129 x 129 factor with entries spanning ~1e4): ~1e-13 relative measured.
# float32: one rounding of each of ~500-term sums; the energy sums cancel
# against the RefPoint, so the error is relative to the value's scale.
@pytest.mark.parametrize("jdt,tdt,tol", [
    (jnp.float64, torch.float64, 1e-9),
    (jnp.float32, torch.float32, 2e-5),
])
def test_k1_value_and_gradient_match_jax(jax_fit, jdt, tdt, tol):
    jmode, tmode, _, _ = _targets(jax_fit, jdt, tdt)
    np.testing.assert_allclose(tmode.X0.double().numpy(),
                               np.asarray(jmode.X0, np.float64),
                               rtol=tol, atol=tol)
    qs = _states(jmode)
    vj, gj = _jax_eval(jmode, qs, jdt)
    vt, gt = _port_eval(tmode, qs, tdt)
    np.testing.assert_allclose(vt, vj, rtol=tol)
    assert np.abs(gt - gj).max() <= tol * np.abs(gj).max()


def test_k1_matches_autograd_of_plain_log_posterior(jax_fit):
    """The analytic gradient the three kernels assemble against autograd
    of the port's plain log_posterior_given_t1 (float64)."""
    _, tmode, tm, data = _targets(jax_fit, jnp.float64, torch.float64)
    target = tmode.logp_grad
    N, D, P = tm.mag_I, tm.D, tm.D_thetas
    R = data.C_inv_sqrts
    L = tmode.factor
    ref = tpo.make_ref_point(tm.I, tm.Xhat_init, tm.mu_ds, tm.thetas_init,
                             tseir, R, data.K_inv_sqrts, data.m_ds,
                             torch.float64, device="cpu")
    z0 = tmode.X0.reshape(-1)

    def lp(q):
        Z, sp, tp = tms.unflatten_state(q, N, D, P)
        delta = (L @ (Z.reshape(-1) - z0)).reshape(N, D)
        Rd = torch.einsum("dnm,dm->dn", R, delta.T)
        t1 = torch.sum(Rd * (Rd + 2.0 * ref.a0))
        return tpo.log_posterior_given_t1(
            data, tseir, ref.x0 + delta, sp, tp, torch.tensor(BETA_TEMP,
                                                              dtype=torch.float64),
            t1, ref=ref, delta=delta,
        )

    qs = torch.as_tensor(_states(_targets(jax_fit, jnp.float64,
                                          torch.float64)[0]))
    v_ref = torch.stack([lp(q) for q in qs])
    g_ref = torch.stack([torch.func.grad(lp)(q) for q in qs])
    v, g = target(qs, torch.tensor(BETA_TEMP, dtype=torch.float64))
    torch.testing.assert_close(v, v_ref, rtol=1e-10, atol=0)
    assert float((g - g_ref).abs().max()) <= 1e-10 * float(g_ref.abs().max())


def test_log_posterior_given_t1_matches_jax(jax_fit):
    """Both branches of the port's plain posterior against JAX, batched
    over chains on the port side."""
    jm = jax_fit
    _, _, tm, data = _targets(jm, jnp.float64, torch.float64)
    jdata = jpo.make_posterior_data(
        jm.I, jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.mu_ds, jm.beta,
        jm.obs_index, data.sigma_sqs_LB.numpy(), jnp.float64,
        C_inv_sqrts=data.C_inv_sqrts.numpy(),
        K_inv_sqrts=data.K_inv_sqrts.numpy(),
    )
    jref = jpo.make_ref_point(jm.I, jm.Xhat_init, jm.mu_ds, jm.thetas_init,
                              jseir, data.C_inv_sqrts.numpy(),
                              data.K_inv_sqrts.numpy(), jm.m_ds, jnp.float64)
    tref = tpo.make_ref_point(jm.I, jm.Xhat_init, jm.mu_ds, jm.thetas_init,
                              tseir, data.C_inv_sqrts, data.K_inv_sqrts,
                              data.m_ds, torch.float64, device="cpu")
    for a, b in zip(jref, tref):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(a)).max())
    rng = np.random.default_rng(5)
    X = jm.Xhat_init[None] + 0.01 * rng.standard_normal((4,) + jm.Xhat_init.shape)
    sp = -10.0 + 0.1 * rng.standard_normal((4, 3))
    tp = np.log(np.expm1(jm.thetas_init)) + 0.1 * rng.standard_normal((4, 3))
    t1 = rng.uniform(0.0, 100.0, 4)
    for ref_j, ref_t in ((None, None), (jref, tref)):
        vj = np.array([float(jpo.log_posterior_given_t1(
            jdata, jseir, jnp.asarray(X[c]), jnp.asarray(sp[c]),
            jnp.asarray(tp[c]), BETA_TEMP, t1[c], ref=ref_j))
            for c in range(4)])
        vt = tpo.log_posterior_given_t1(
            data, tseir, torch.as_tensor(X), torch.as_tensor(sp),
            torch.as_tensor(tp), BETA_TEMP, torch.as_tensor(t1), ref=ref_t,
        ).numpy()
        np.testing.assert_allclose(vt, vj, rtol=1e-10)


def test_softplus_helpers_match_jax():
    y = np.geomspace(1e-8, 50.0, 40)
    np.testing.assert_allclose(
        tpo.softplus_inverse(torch.as_tensor(y)).numpy(),
        np.asarray(jpo.softplus_inverse(jnp.asarray(y))), rtol=1e-12)
    x = np.linspace(-30.0, 15.0, 40)
    np.testing.assert_allclose(tpo.softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jpo.softplus(jnp.asarray(x))),
                               rtol=1e-14)


def test_flat_state_packing_matches_jax():
    rng = np.random.default_rng(6)
    X, s, t = rng.standard_normal((7, 3)), rng.standard_normal(3), \
        rng.standard_normal(2)
    qj = np.asarray(jms.flatten_state(jnp.asarray(X), jnp.asarray(s),
                                      jnp.asarray(t)))
    qt = tms.flatten_state(torch.as_tensor(X), torch.as_tensor(s),
                           torch.as_tensor(t)).numpy()
    np.testing.assert_array_equal(qt, qj)
    for a, b in zip(jms.unflatten_state(jnp.asarray(qj), 7, 3, 2),
                    tms.unflatten_state(torch.as_tensor(qt), 7, 3, 2)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    draws = rng.standard_normal((5, 4, qj.size))
    for a, b in zip(jms.unflatten_samples(draws, 7, 3, 2),
                    tms.unflatten_samples(torch.as_tensor(draws), 7, 3, 2)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_kernel_wrappers_check_their_arguments():
    x = {k: v for k, v in _wrapper_inputs(torch.float64).items()}
    args = lambda **o: tuple(o.get(k, x[k]) for k in (
        "f", "I", "delta", "RmD", "q", "x0T", "a0", "f0", "mask", "y",
        "sigma_lb", "beta_temp")) + (2.0,)
    mf.manifold_fwd(*args())
    with pytest.raises(TypeError, match="dtype"):
        mf.manifold_fwd(*args(a0=x["a0"].float()))
    with pytest.raises(ValueError, match="shape"):
        mf.manifold_fwd(*args(RmD=x["RmD"][..., :-1]))
    with pytest.raises(ValueError, match="contiguous"):
        mf.manifold_fwd(*args(x0T=x["x0T"].T.contiguous().T))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mf.manifold_fwd(*args(**{k: x[k].to("meta") for k in x
                                 if isinstance(x[k], torch.Tensor)
                                 and k != "I"}))


def _wrapper_inputs(dt, C=4, N=5, D=3, P=3):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, dtype=dt)
    return dict(f=tseir, I=torch.zeros(N, 1, dtype=dt), delta=r(C, D, N),
                RmD=r(D, C, 2 * N), q=r(C, N * D + D + P), x0T=r(D, N),
                a0=r(D, N), f0=r(D, N), mask=torch.ones(D, N, dtype=dt),
                y=r(D, N), sigma_lb=torch.full((D,), 1e-3, dtype=dt),
                beta_temp=torch.tensor(0.5, dtype=dt))


def test_plain_versions_keep_the_kernels_layout_contract():
    """Each plain output has the kernel's shape and is contiguous, so the
    three wrappers chain (fwd -> energy -> bwd) on the CPU as on the card."""
    x = _wrapper_inputs(torch.float64)
    C, D, N = x["delta"].shape
    dr, gcat, t14 = mf.manifold_fwd(x["f"], x["I"], x["delta"], x["RmD"],
                                    x["q"], x["x0T"], x["a0"], x["f0"],
                                    x["mask"], x["y"], x["sigma_lb"],
                                    x["beta_temp"], 2.0)
    n_ds = torch.full((D,), 3.0, dtype=torch.float64)
    lp, gDs = mf.manifold_energy(x["f"], dr, x["f0"], t14, x["q"],
                                 x["sigma_lb"], n_ds, x["beta_temp"], 2.0)
    grad = torch.zeros_like(x["q"])
    gpart = mf.manifold_bwd(x["f"], x["I"], gDs, x["delta"], x["q"],
                            x["x0T"], x["mask"], x["y"], x["sigma_lb"], n_ds,
                            x["beta_temp"], gcat, grad)
    for t, shape in ((dr, (D, C, N)), (gcat, (D, C, 2 * N)), (t14, (C, 2)),
                     (lp, (C,)), (gDs, (D, C, N)), (gpart, (D, C, N))):
        assert tuple(t.shape) == shape and t.is_contiguous()
    torch.testing.assert_close(gcat[..., N:], gDs, rtol=0, atol=0)
    assert torch.isfinite(grad[:, N * D:]).all()


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    x = _wrapper_inputs(torch.float64)
    mf.reset_launch_counts()
    a = mf.manifold_fwd(x["f"], x["I"], x["delta"], x["RmD"], x["q"],
                        x["x0T"], x["a0"], x["f0"], x["mask"], x["y"],
                        x["sigma_lb"], x["beta_temp"], 2.0)
    b = mf.manifold_fwd_plain(x["f"], x["I"], x["delta"], x["RmD"], x["q"],
                              x["x0T"], x["a0"], x["f0"], x["mask"], x["y"],
                              x["sigma_lb"], x["beta_temp"], 2.0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    assert mf.launch_counts() == {k: 0 for k in mf.KERNELS}


def check_results_are_not_reused(target, qs, dt):
    """Two calls in a row on different states: the first call's lp and grad
    keep their values after the second (the sampler holds them while it
    evaluates the proposal), share no memory with the second's, and the
    intermediates, which are reused, change nothing: a fresh target gives
    the same numbers."""
    bt = torch.tensor(BETA_TEMP, dtype=dt)
    q1 = torch.as_tensor(qs[:4], dtype=dt)
    q2 = torch.as_tensor(qs[4:8], dtype=dt)
    lp1, g1 = target(q1, bt)
    keep = lp1.clone(), g1.clone()
    lp2, g2 = target(q2, bt)
    assert torch.equal(lp1, keep[0]) and torch.equal(g1, keep[1])
    assert lp1.data_ptr() != lp2.data_ptr()
    assert g1.data_ptr() != g2.data_ptr()
    assert not torch.equal(lp1, lp2)
    fresh = target.to("cpu")
    assert fresh._workspaces == {} and len(target._workspaces) == 1
    lp2f, g2f = fresh(q2, bt)
    assert torch.equal(lp2, lp2f) and torch.equal(g2, g2f)
    # another chain count gets its own workspace
    lp3, g3 = target(q1[:1], bt)
    torch.testing.assert_close(lp3, lp1[:1], rtol=1e-4, atol=0)
    assert sorted(target._workspaces) == [1, 4]


@pytest.mark.parametrize("jdt,tdt", [(jnp.float64, torch.float64),
                                     (jnp.float32, torch.float32)])
def test_dense_target_never_overwrites_what_it_returned(jax_fit, jdt, tdt):
    jmode, tmode, _, _ = _targets(jax_fit, jdt, tdt)
    check_results_are_not_reused(tmode.logp_grad, _states(jmode), tdt)


def test_target_checks_its_state_at_each_call(jax_fit):
    jmode, tmode, _, _ = _targets(jax_fit, jnp.float64, torch.float64)
    target = tmode.logp_grad
    qs = torch.as_tensor(_states(jmode))
    bt = torch.tensor(BETA_TEMP, dtype=torch.float64)
    target(qs, bt)
    with pytest.raises(TypeError, match="q must be"):
        target(qs.float(), bt)
    with pytest.raises(ValueError, match="shape"):
        target(qs[:, :-1], bt)
    with pytest.raises(TypeError, match="beta_temp must be"):
        target(qs, BETA_TEMP)
    with pytest.raises(TypeError, match="beta_temp must be"):
        target(qs, bt.float())
    # a state that is a strided view is copied, not refused
    wide = torch.zeros((qs.shape[0], qs.shape[1] + 3), dtype=torch.float64)
    wide[:, :-3] = qs
    lp, g = target(wide[:, :-3], bt)
    lp0, g0 = target(qs, bt)
    assert torch.equal(lp, lp0) and torch.equal(g, g0)


def test_manifold_plan_checks_once_and_reuses_its_buffers():
    """ManifoldPlan on the CPU: the constants and buffers are checked when
    it is made; its calls write the buffers they were given and the
    caller's lp and grad, and agree with the one-shot wrappers."""
    x = _wrapper_inputs(torch.float64)
    C, D, N = x["delta"].shape
    dim = x["q"].shape[1]
    n_ds = torch.full((D,), 3.0, dtype=torch.float64)
    consts = dict(x0T=x["x0T"], a0=x["a0"], f0=x["f0"], s0=x["f0"],
                  mask=x["mask"], y=x["y"], sigma_lb=x["sigma_lb"], n_ds=n_ds)
    new = lambda *s: torch.full(s, float("nan"), dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    bufs = dict(delta=x["delta"], RmD=x["RmD"], gcat=new(D, C, 2 * N),
                t14=new(C, 2), dr=new(D, C, N), gDs=new(D, C, N),
                gpart=new(D, C, N),
                Ds=torch.randn((D, C, N), generator=g, dtype=torch.float64),
                gdr=torch.randn((D, C, N), generator=g, dtype=torch.float64))
    plan = mf.ManifoldPlan(x["f"], x["I"], consts, 2.0, dim, bufs)
    q, bt = x["q"], x["beta_temp"]
    mf.reset_launch_counts()
    plan.fwd(q, bt, 0)
    dr, gcat, t14 = mf.manifold_fwd(x["f"], x["I"], x["delta"], x["RmD"], q,
                                    x["x0T"], x["a0"], x["f0"], x["mask"],
                                    x["y"], x["sigma_lb"], bt, 2.0)
    assert torch.equal(bufs["dr"], dr) and torch.equal(bufs["t14"], t14)
    assert torch.equal(bufs["gcat"][..., :N], gcat[..., :N])
    lp = new(C)
    plan.energy(q, bt, lp, 0)
    lp_, gDs = mf.manifold_energy(x["f"], bufs["Ds"], x["f0"], t14, q,
                                  x["sigma_lb"], n_ds, bt, 2.0)
    assert torch.equal(lp, lp_) and torch.equal(bufs["gDs"], gDs)
    grad, grad_ = torch.zeros_like(q), torch.zeros_like(q)
    plan.bwd(q, bt, grad, 0)
    gpart = mf.manifold_bwd(x["f"], x["I"], bufs["gdr"], x["delta"], q,
                            x["x0T"], x["mask"], x["y"], x["sigma_lb"], n_ds,
                            bt, gcat, grad_)
    assert torch.equal(bufs["gpart"], gpart) and torch.equal(grad, grad_)
    assert torch.equal(bufs["gcat"], gcat)
    assert mf.launch_counts() == {k: 0 for k in mf.KERNELS}
    with pytest.raises(TypeError, match="dtype"):
        mf.ManifoldPlan(x["f"], x["I"], dict(consts, a0=x["a0"].float()),
                        2.0, dim, bufs)
    with pytest.raises(ValueError, match="shape"):
        mf.ManifoldPlan(x["f"], x["I"], consts, 2.0, dim,
                        dict(bufs, dr=new(D, C, N + 1)))
    with pytest.raises(ValueError, match="does not hold"):
        mf.ManifoldPlan(x["f"], x["I"], consts, 2.0, N * D, bufs)


# the four branches of the natural-coordinate log_posterior: dense and
# block-banded storage, each in the factored ||R x||^2 form and the raw
# x'C^{-1}x form
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("factored", [True, False])
def test_log_posterior_and_value_and_grad_match_jax(jax_fit, banded,
                                                    factored):
    """``log_posterior``/``make_log_posterior``/``make_value_and_grad``
    against the JAX functions (float64): values within 1e-12 and each
    gradient within 1e-10 of its largest entry."""
    jm = jax_fit
    _, _, tm, data = _targets(jm, jnp.float64, torch.float64)
    R64, S64 = data.C_inv_sqrts.numpy(), data.K_inv_sqrts.numpy()
    sq = dict(C_inv_sqrts=R64, K_inv_sqrts=S64) if factored and not banded \
        else {}
    jdata = jpo.make_posterior_data(
        jm.I, jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.mu_ds, jm.beta,
        jm.obs_index, data.sigma_sqs_LB.numpy(), jnp.float64, **sq)
    tdata = tpo.make_posterior_data(
        jm.I, jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.mu_ds, jm.beta,
        jm.obs_index, data.sigma_sqs_LB, torch.float64, device="cpu",
        **{k: torch.as_tensor(v) for k, v in sq.items()})
    if banded:
        fac = dict(C_inv_sqrts_f64=R64, K_inv_sqrts_f64=S64) if factored \
            else {}
        jdata = jpo.to_banded_data(jdata, jm.BANDSIZE, **fac)
        tdata = tpo.to_banded_data(tdata, jm.BANDSIZE, **fac)
        assert (tdata.C_sqrt_blocks is not None) == factored
        assert tdata.C_blocks is not None
    rng = np.random.default_rng(11)
    jvg = jpo.make_value_and_grad(jdata, jseir)
    tvg = tpo.make_value_and_grad(tdata, tseir)
    tlp = tpo.make_log_posterior(tdata, tseir)
    for _ in range(3):
        X = jm.Xhat_init + 0.01 * rng.standard_normal(jm.Xhat_init.shape)
        sp = -10.0 + 0.1 * rng.standard_normal(3)
        tp = np.log(np.expm1(jm.thetas_init)) + 0.1 * rng.standard_normal(3)
        vj, gj = jvg(jnp.asarray(X), jnp.asarray(sp), jnp.asarray(tp),
                     BETA_TEMP)
        args = [torch.as_tensor(a) for a in (X, sp, tp)]
        vt, gt = tvg(*args, BETA_TEMP)
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
        np.testing.assert_allclose(float(tlp(*args, BETA_TEMP)), float(vj),
                                   rtol=1e-12)
        for a, b in zip(gt, gj):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()
