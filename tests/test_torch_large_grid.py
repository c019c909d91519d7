"""The large-grid sampling path of the port (storage="hybrid" and
"banded", sigma pinning, gn_anchor) against the JAX package, on the
Lorenz fixture of tests/test_hybrid.py (N_I = 65, bandsize 4: two 128-row
tiles of the 195-long state, with a band truncation that drops real
operator mass), in float64 and float32 on the CPU.

The port's model is built from the JAX fit's arrays (and its exact
operators), so that the comparison is not confounded by two Adam runs."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu.models import lorenz_f_vec as jlorenz
from magi_v2_tpu.ops.linalg import sym_sqrt as jsqrt
from magi_v2_tpu.sampler import precond as jpc
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch.models import lorenz_f_vec as tlorenz
from magi_v2_tpu_torch.sampler import modes as tmodes
from magi_v2_tpu_torch.sampler import precond as tpc
from magi_v2_tpu_torch.sampler.hmc import hmc_step
from magi_v2_tpu_torch.sampler.mass import (
    TailDenseMass,
    mass_kinetic,
    mass_vel,
    momentum_from_normal,
)
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

BETA_TEMP = 0.37
SIGMA_FIXED = 0.25


@pytest.fixture(scope="module")
def jax_fit():
    ts, X, _ = simulate_ode(jlorenz, x0=np.array([-8.0, 7.0, 27.0]),
                            thetas=np.array([10.0, 28.0, 8.0 / 3.0]),
                            t_max=2.0, n_obs=17, noise_sd=0.5, substeps=20)
    jm = J.MAGI_v2(D_thetas=3, ts_obs=ts, X_obs=X, bandsize=4,
                   f_vec=jlorenz,
                   config=J.MagiConfig().replace(dtype=jnp.float64))
    jm.initial_fit(discretization=2)
    return jm


def _port(jm, dtype=torch.float64, **kw):
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    return from_fit_arrays(arrays, tlorenz, 3, bandsize=jm.BANDSIZE,
                           config=T.MagiConfig(dtype=dtype, device="cpu"),
                           exact_operators=jm._exact_operators(), **kw)


_MODES = {}


def _modes(jm, storage, tdt, **kw):
    """(JAX mode, port mode) for one storage/dtype/options, built once."""
    key = (storage, tdt, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _MODES:
        jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
        jmode = jm._build_sampling_setup("precond", storage, jdt, **kw)[0]
        tmode = _port(jm, tdt)._build_sampling_setup("precond", storage, tdt,
                                                     **kw)[0]
        _MODES[key] = (jmode, tmode)
    return _MODES[key]


def _states(jmode, n=6, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    z0 = np.asarray(jmode.X0, np.float64).ravel()
    q0 = np.concatenate([z0, [-1.5, -1.4, -1.3], [2.3, 3.3, 0.9]])
    return q0 + scale * rng.standard_normal((n, q0.size))


def _evals(jmode, tmode, qs, tdt):
    jdt = jnp.float64 if tdt == torch.float64 else jnp.float32
    f = jax.vmap(lambda q: jmode.logp_grad(q, jnp.asarray(BETA_TEMP, jdt)))
    vj, gj = (np.asarray(a, np.float64) for a in f(jnp.asarray(qs, jdt)))
    vt, gt = tmode.logp_grad(torch.as_tensor(qs, dtype=tdt),
                             torch.tensor(BETA_TEMP, dtype=tdt))
    return vj, gj, vt.double().numpy(), gt.double().numpy()


def test_lorenz_f_vec_matches_jax():
    rng = np.random.default_rng(0)
    X = 10.0 * rng.standard_normal((4, 7, 3))
    th = rng.uniform(1.0, 30.0, (4, 3))
    t = np.zeros((7, 1))
    ft = tlorenz(torch.as_tensor(t), torch.as_tensor(X),
                 torch.as_tensor(th)).numpy()
    for c in range(4):
        fj = np.asarray(jlorenz(jnp.asarray(t), jnp.asarray(X[c]),
                                jnp.asarray(th[c])))
        np.testing.assert_allclose(ft[c], fj, rtol=1e-15, atol=0)


def test_gn_precision_band_and_cholesky_match_jax(jax_fit):
    jm = jax_fit
    C_ex, m_ex, K_ex = jm._exact_operators()
    R64 = np.asarray(jsqrt(jnp.asarray(C_ex)))
    S64 = np.asarray(jsqrt(jnp.asarray(K_ex)))
    J_ = np.asarray(jpc.pointwise_ode_jacobian(jlorenz, jm.I, jm.Xhat_init,
                                               jm.thetas_init))
    obs = (~np.isnan(jm.X_obs_discret)).astype(np.float64)
    args = (jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.beta, obs,
            jm.sigma_sqs_init, J_, 48)
    kw = dict(comp_bandwidth=4, C_inv_sqrts=R64, K_inv_sqrts=S64)
    lam_j = jpc.gauss_newton_precision_band(*args, **kw)
    lam_t = tpc.gauss_newton_precision_band(*args, **kw)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0,
                               atol=1e-13 * np.abs(lam_j).max())
    tm = _port(jm)
    U_j, info_j = jpc.build_gn_cholesky_banded(jm, C_inv_sqrts=R64,
                                               K_inv_sqrts=S64)
    U_t, info_t = tpc.build_gn_cholesky_banded(tm, C_inv_sqrts=R64,
                                               K_inv_sqrts=S64)
    assert info_t == info_j
    np.testing.assert_allclose(U_t, U_j, rtol=0,
                               atol=1e-12 * np.abs(U_j).max())


@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("storage", ["hybrid", "banded"])
def test_sampling_mode_start_matches_jax(jax_fit, storage, anchored):
    """The whitened start X0 (= z0, the whitened anchor) and the GN factor
    of both modes, at the default and at a given gn_anchor."""
    jm = jax_fit
    kw = {}
    if anchored:
        rng = np.random.default_rng(7)
        kw["gn_anchor"] = {
            "X": np.asarray(jm.Xhat_init) + 0.1 * rng.standard_normal(
                jm.Xhat_init.shape),
            "thetas": np.asarray(jm.thetas_init) * 1.2}
    jmode, tmode = _modes(jm, storage, torch.float64, **kw)
    z_j = np.asarray(jmode.X0)
    assert np.abs(tmode.X0.numpy() - z_j).max() <= 1e-10 * np.abs(z_j).max()
    np.testing.assert_allclose(tmode.gn["z0"].numpy(),
                               np.asarray(jmode.gn["z0"]), rtol=0,
                               atol=1e-10 * np.abs(z_j).max())
    U_j = np.asarray(jmode.gn["U_blocks"])
    assert np.abs(tmode.gn["U_blocks"].numpy() - U_j).max() <= (
        1e-10 * np.abs(U_j).max())


# float64: the same sums in another order (~1e-15 measured); float32: one
# rounding of each relative-energy sum, against the value's own scale
@pytest.mark.parametrize("tdt,tol", [(torch.float64, 1e-10),
                                     (torch.float32, 2e-5)])
@pytest.mark.parametrize("storage", ["hybrid", "banded"])
def test_targets_match_jax(jax_fit, storage, tdt, tol):
    jmode, tmode = _modes(jax_fit, storage, tdt)
    vj, gj, vt, gt = _evals(jmode, tmode, _states(jmode), tdt)
    np.testing.assert_allclose(vt, vj, rtol=tol)
    assert np.abs(gt - gj).max() <= tol * np.abs(gj).max()


@pytest.mark.parametrize("storage", ["hybrid", "banded"])
def test_sigma_pinning_matches_jax(jax_fit, storage):
    """sigma_sqs_fixed substitutes the fixed pre-images and zeroes their
    gradient, for a batch of chains as for one."""
    jm = jax_fit
    jmode, tmode = _modes(jm, storage, torch.float64,
                          sigma_sqs_fixed=SIGMA_FIXED)
    qs = _states(jmode, seed=3)
    vj, gj, vt, gt = _evals(jmode, tmode, qs, torch.float64)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    assert np.abs(gt - gj).max() <= 1e-10 * np.abs(gj).max()
    ND = jm.mag_I * jm.D
    assert np.all(gt[:, ND:ND + jm.D] == 0.0)
    # the pinned coordinates carry no potential
    q2 = qs.copy()
    q2[:, ND:ND + jm.D] += 3.0
    v2, _ = tmode.logp_grad(torch.as_tensor(q2), torch.tensor(BETA_TEMP,
                                                              dtype=torch.float64))
    np.testing.assert_array_equal(v2.numpy(), vt)


def _reference_hmc_step(logp_grad, q, step_size, inv_mass, num_leapfrogs,
                        normals, uniforms, max_energy_diff=1000.0):
    """The leapfrog loop as the port ran it before K2 (and as the JAX
    loop body reads): one kick, drift, kick per leapfrog."""
    half = 0.5 * step_size
    logp0, grad0 = logp_grad(q)
    p0 = momentum_from_normal(inv_mass, normals)
    H0 = -logp0 + mass_kinetic(inv_mass, p0)
    qc, pc, gc, logp = q, p0, grad0, logp0
    for _ in range(num_leapfrogs):
        p_half = torch.addcmul(pc, gc, half)
        qc = torch.addcmul(qc, mass_vel(inv_mass, p_half), step_size)
        logp, gc = logp_grad(qc)
        pc = torch.addcmul(p_half, gc, half)
    H1 = -logp + mass_kinetic(inv_mass, pc)
    dH = H1 - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH, float("inf")))
    accept_prob = torch.exp(torch.clamp(-dH, max=0.0))
    diverging = dH > max_energy_diff
    accept = (uniforms < accept_prob) & ~diverging
    return torch.where(accept[:, None], qc, q), accept_prob, diverging


@pytest.mark.parametrize("mass", ["diag", "tail_dense", "dense"])
def test_k2_plain_path_is_identical_to_the_reference_leapfrog(jax_fit, mass):
    """hmc_step through K2's plain version (two kicks fused into one
    update, q and p in place) against the kick-drift-kick loop, with the
    momenta and uniforms injected: bit for bit."""
    _, tmode = _modes(jax_fit, "hybrid", torch.float64,
                      sigma_sqs_fixed=SIGMA_FIXED)
    qs = torch.as_tensor(_states(_modes(jax_fit, "hybrid", torch.float64,
                                        sigma_sqs_fixed=SIGMA_FIXED)[0],
                                 n=4, seed=5, scale=0.05))
    C, dim = qs.shape
    rng = np.random.default_rng(6)
    normals = torch.as_tensor(rng.standard_normal((C, dim)))
    uniforms = torch.as_tensor(rng.uniform(size=C))
    diag = torch.as_tensor(rng.uniform(0.5, 1.5, dim))
    if mass == "diag":
        inv_mass = diag
    else:
        k = 3 if mass == "tail_dense" else dim
        a = torch.as_tensor(rng.standard_normal((k, k)))
        tail = a @ a.T / k + torch.eye(k, dtype=torch.float64)
        inv_mass = TailDenseMass(diag, tail, torch.linalg.cholesky(
            torch.linalg.inv(tail)))
    eps = torch.tensor(0.01, dtype=torch.float64)
    bt = torch.tensor(0.8, dtype=torch.float64)
    target = lambda q: tmode.logp_grad(q, bt)
    for L in (0, 1, 5):
        q_ref, a_ref, d_ref = _reference_hmc_step(
            target, qs, eps, inv_mass, L, normals, uniforms)
        q_new, info = hmc_step(target, qs, eps, inv_mass, L, normals,
                               uniforms)
        assert torch.equal(q_new, q_ref)
        assert torch.equal(info.accept_prob,
                           torch.where(d_ref, torch.zeros_like(a_ref), a_ref))


@pytest.mark.parametrize("storage", ["hybrid", "banded"])
def test_predict_runs(jax_fit, storage):
    tm = _port(jax_fit)
    res = tm.predict(num_results=20, num_burnin_steps=20, num_chains=4,
                     seed=0, init_jitter=0.01, algorithm="hmc",
                     hmc_num_leapfrogs=8, storage=storage,
                     sigma_sqs_fixed=SIGMA_FIXED, mass_matrix="diag",
                     anneal_mode="reference")
    assert res["X_samps"].shape == (20, 4, tm.mag_I, tm.D)
    assert np.all(np.isfinite(res["X_samps"]))
    # the phases of the call, on the host's clock: the parts of the
    # sampling setup, then sampling and unwhitening
    parts = ["setup_operator_sqrt", "setup_posterior_data",
             "setup_gn_jacobian", "setup_gn_precision", "setup_gn_cholesky",
             "setup_factor_tiles", "setup_ref_point", "setup_fold_factor",
             "setup_target", "setup_rest"]
    if storage == "hybrid":
        parts.insert(0, "setup_exact_operators")
    assert list(tm.predict_timings) == parts + ["sampling", "unwhiten"]
    assert all(t > 0.0 for t in tm.predict_timings.values())
    assert np.all(np.isfinite(res["thetas_samps"]))
    np.testing.assert_array_equal(res["sigma_sqs_samps"],
                                  np.full((20, 4, 3), SIGMA_FIXED))


def test_validation_errors_match_jax(jax_fit):
    jm = jax_fit
    tm = _port(jm)
    # hybrid without a bandsize: no GN band to whiten with
    j_nob, t_nob = copy.copy(jm), _port(jm)
    j_nob.BANDSIZE = t_nob.BANDSIZE = None
    with pytest.raises(ValueError, match="bandsize"):
        j_nob._build_sampling_setup("precond", "hybrid", jnp.float64)
    with pytest.raises(ValueError, match="bandsize"):
        t_nob._build_sampling_setup("precond", "hybrid", torch.float64)
    # the full dense metric with pinned sigma
    with pytest.raises(ValueError, match="sigma_sqs_fixed"):
        jm._dense_tail_size("dense", SIGMA_FIXED)
    with pytest.raises(ValueError, match="sigma_sqs_fixed"):
        tm.predict(num_results=2, num_burnin_steps=2, num_chains=2,
                   algorithm="hmc", storage="hybrid", mass_matrix="dense",
                   sigma_sqs_fixed=SIGMA_FIXED)
    assert tm._dense_tail_size("tail_dense", SIGMA_FIXED) == (
        jm._dense_tail_size("tail_dense", SIGMA_FIXED)) == 3
    assert tm._dense_tail_size("auto", SIGMA_FIXED) == (
        jm._dense_tail_size("auto", SIGMA_FIXED))
    with pytest.raises(ValueError, match="finite and > 0"):
        tm._build_sampling_setup("precond", "hybrid", torch.float64,
                                 sigma_sqs_fixed=0.0)
    for bad, match in (({"bogus": 1}, "unknown keys"),
                       ({"X": np.zeros((3, 3))}, "shape")):
        with pytest.raises(ValueError, match=match):
            jm._build_sampling_setup("precond", "hybrid", jnp.float64,
                                     gn_anchor=bad)
        with pytest.raises(ValueError, match=match):
            tm._build_sampling_setup("precond", "hybrid", torch.float64,
                                     gn_anchor=bad)
    with pytest.raises(ValueError, match="banded-GN"):
        tm._build_sampling_setup("precond", "dense", torch.float64,
                                 gn_anchor={"thetas": jm.thetas_init})


def test_dense_float32_warning(jax_fit, monkeypatch):
    """The JAX package's warning for float32 dense-precond sampling on
    dense grids, copied into the port's build_sampling_mode."""
    tm = _port(jax_fit, torch.float32)
    monkeypatch.setattr(tmodes, "DENSE_FLOAT32_WARN_N_I", tm.mag_I)
    with pytest.warns(UserWarning, match="storage='hybrid'"):
        tm._build_sampling_setup("precond", "dense", torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _port(jax_fit)._build_sampling_setup("precond", "dense",
                                             torch.float64)
        tm._build_sampling_setup("precond", "hybrid", torch.float32)


def test_band_truncation_warning_names_hybrid(jax_fit):
    """Truncating the exact operators to a one-wide band drops most of
    their mass: both packages warn and point to storage='hybrid'."""
    jm, tm = copy.copy(jax_fit), _port(jax_fit)
    for m in (jm, tm):
        m.BANDSIZE = 1
        m.C_d_invs, m.m_ds, m.K_d_invs = (np.array(a) for a in
                                          jax_fit._exact_operators())
        with pytest.warns(UserWarning,
                          match=r"predict\(storage='hybrid'\)"):
            m._apply_band_truncation()
    np.testing.assert_allclose(
        [tm.band_truncation[k] for k in ("C_d_invs", "K_d_invs", "m_ds")],
        [jm.band_truncation[k] for k in ("C_d_invs", "K_d_invs", "m_ds")],
        rtol=1e-12)


def test_exact_operators_carried_and_rebuilt(jax_fit):
    jm = jax_fit
    ops_j = jm._exact_operators()
    tm = _port(jm)
    for a, b in zip(tm._exact_operators(), ops_j):
        np.testing.assert_array_equal(a, b)
    assert tm._exact_operators()[0] is tm._exact_operators()[0]
    rebuilt = from_fit_arrays({f: np.asarray(getattr(jm, f))
                               for f in FIT_FIELDS}, tlorenz, 3,
                              bandsize=4, config=T.MagiConfig(device="cpu")
                              )._exact_operators()
    xc = (jm.Xhat_init - jm.mu_ds).T
    for a, b in zip(rebuilt, ops_j):
        ra, rb = np.einsum("dnm,dm->dn", a, xc), np.einsum("dnm,dm->dn", b, xc)
        assert np.abs(ra - rb).max() <= 1e-6 * np.abs(rb).max()
    assert not np.allclose(ops_j[0], tm.C_d_invs)


@pytest.mark.parametrize("branch", ["relative", "factored", "raw"])
def test_banded_log_posterior_given_t1_matches_jax(jax_fit, branch):
    """The banded branches of the plain posterior: t2 relative to a
    RefPoint, as ||band(S) r||^2, and as r'band(K^{-1})r."""
    from magi_v2_tpu import posterior as jpo
    from magi_v2_tpu_torch import posterior as tpo

    jm = jax_fit
    b = jm.BANDSIZE
    R64 = np.asarray(jsqrt(jnp.asarray(jm.C_d_invs)))
    S64 = np.asarray(jsqrt(jnp.asarray(jm.K_d_invs)))
    lb = np.full(3, 1e-3)
    sqrts = {} if branch == "raw" else dict(C_inv_sqrts_f64=R64,
                                            K_inv_sqrts_f64=S64)
    jdata = jpo.to_banded_data(jpo.make_posterior_data(
        jm.I, jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.mu_ds, jm.beta,
        jm.obs_index, lb, jnp.float64), b, **sqrts)
    tdata = tpo.to_banded_data(tpo.make_posterior_data(
        jm.I, jm.C_d_invs, jm.m_ds, jm.K_d_invs, jm.mu_ds, jm.beta,
        jm.obs_index, lb, torch.float64, device="cpu"), b, **sqrts)
    ref_j = ref_t = None
    if branch == "relative":
        i = np.arange(jm.mag_I)
        band = (np.abs(i[:, None] - i[None, :]) <= b)[None]
        ops = (np.where(band, R64, 0.0), np.where(band, S64, 0.0), jm.m_ds)
        args = (jm.I, jm.Xhat_init, jm.mu_ds, jm.thetas_init)
        ref_j = jpo.make_ref_point(*args, jlorenz, *ops, jnp.float64)
        ref_t = tpo.make_ref_point(*args, tlorenz, *ops, torch.float64,
                                   device="cpu")
    rng = np.random.default_rng(9)
    X = jm.Xhat_init[None] + 0.05 * rng.standard_normal(
        (3,) + jm.Xhat_init.shape)
    sp = -1.5 + 0.1 * rng.standard_normal((3, 3))
    tp = np.log(np.expm1(jm.thetas_init)) + 0.1 * rng.standard_normal((3, 3))
    t1 = rng.uniform(0.0, 100.0, 3)
    vj = np.array([float(jpo.log_posterior_given_t1(
        jdata, jlorenz, jnp.asarray(X[c]), jnp.asarray(sp[c]),
        jnp.asarray(tp[c]), BETA_TEMP, t1[c], ref=ref_j)) for c in range(3)])
    vt = tpo.log_posterior_given_t1(
        tdata, tlorenz, torch.as_tensor(X), torch.as_tensor(sp),
        torch.as_tensor(tp), BETA_TEMP, torch.as_tensor(t1), ref=ref_t,
    ).numpy()
    np.testing.assert_allclose(vt, vj, rtol=1e-10)


def test_unwhiten_draws_banded_matches_jax(jax_fit):
    jm = jax_fit
    jmode, tmode = _modes(jm, "hybrid", torch.float64)
    Z = np.random.default_rng(8).standard_normal((3, 2, jm.mag_I, jm.D))
    U_j, dinv_j = jmode.factor
    xj = np.asarray(jpc.unwhiten_Z_banded(jnp.asarray(Z),
                                          jnp.asarray(jm.mu_ds), U_j,
                                          diag_inv=dinv_j))
    mu = torch.as_tensor(jm.mu_ds)
    for max_bytes in (1 << 30, 1):
        xt = tmodes.unwhiten_draws(tmode, torch.as_tensor(Z), mu,
                                   max_bytes=max_bytes).numpy()
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


@pytest.mark.parametrize("tdt", [torch.float64, torch.float32])
@pytest.mark.parametrize("storage", ["hybrid", "banded"])
def test_target_never_overwrites_what_it_returned(jax_fit, storage, tdt):
    """Two calls in a row through the target's workspace: the first
    call's lp and grad are not touched by the second, whose intermediates
    overwrite the first's (see tests/test_torch_posterior.py for dense
    storage)."""
    jmode, tmode = _modes(jax_fit, storage, tdt)
    target = tmode.logp_grad
    qs = _states(jmode, n=6, seed=3)
    bt = torch.tensor(BETA_TEMP, dtype=tdt)
    q1, q2 = (torch.as_tensor(q, dtype=tdt) for q in (qs[:3], qs[3:]))
    lp1, g1 = target(q1, bt)
    keep = lp1.clone(), g1.clone()
    lp2, g2 = target(q2, bt)
    assert torch.equal(lp1, keep[0]) and torch.equal(g1, keep[1])
    assert lp1.data_ptr() != lp2.data_ptr()
    assert g1.data_ptr() != g2.data_ptr()
    fresh = target.to("cpu")
    assert fresh._workspaces == {}
    lp2f, g2f = fresh(q2, bt)
    assert torch.equal(lp2, lp2f) and torch.equal(g2, g2f)
    lp1f, g1f = fresh(q1, bt)
    assert torch.equal(lp1, lp1f) and torch.equal(g1, g1f)


def test_banded_target_launches_k3_through_pairs(jax_fit, monkeypatch):
    """The banded target's operator stage binds four K3 calls per
    evaluation: S dr, S' g_Ds, and the pairs [R; m] delta and
    [R' | -m'] gcat."""
    from magi_v2_tpu_torch.ops import banded as tb

    _, tmode = _modes(jax_fit, "banded", torch.float64)
    target = tmode.logp_grad.to("cpu")
    seen = []
    bind = tb.bind_matvec

    def spy(ops, xs, ys, adjoint=False, **kw):
        seen.append((len(ops), len(xs), len(ys), adjoint))
        return bind(ops, xs, ys, adjoint=adjoint, **kw)

    monkeypatch.setattr(tpc, "bind_matvec", spy)
    jmode, _ = _modes(jax_fit, "banded", torch.float64)
    qs = torch.as_tensor(_states(jmode, n=2))
    bt = torch.tensor(BETA_TEMP, dtype=torch.float64)
    target(qs, bt)
    target(qs, bt)
    assert sorted(seen) == sorted([(2, 1, 2, False), (1, 1, 1, False),
                                   (1, 1, 1, True), (2, 2, 1, True)])


def test_hybrid_target_and_leapfrog_match_the_plain_reference(jax_fit):
    """The port's hybrid target (float64, sigma^2 known) and one leapfrog
    from it against the benchmark's plain reference
    (port_bench/reference/magi_ref.py: the exact operators worked out
    again from the fit's hyperparameters, and the frame's factor F =
    U^{-1} from the tiles of the target's own banded GN factor): lp
    differences between states, gradients, and the point one leapfrog
    reaches. The reference is plain PyTorch, NumPy and SciPy: a fresh
    interpreter that imports it has loaded neither JAX nor anything of
    either package, the port's kernels included."""
    import json
    import subprocess
    import sys

    from port_bench.reference.fields.lorenz import f_vec as plain_lorenz
    from port_bench.reference.magi_ref import Mass, Reference

    code = ("import sys, json, port_bench.reference.magi_ref, "
            "port_bench.reference.fields.lorenz\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not set(json.loads(out.stdout)) & {
        "jax", "jaxlib", "magi_v2_tpu", "magi_v2_tpu_torch"}

    jm = jax_fit
    jmode, tmode = _modes(jm, "hybrid", torch.float64,
                          sigma_sqs_fixed=SIGMA_FIXED)
    gn = tmode.logp_grad.logp_grad          # the GN target under the pin
    setup = {"ts_obs": jm.ts_obs, "X_obs": jm.X_obs, "discretization": 2,
             "bandsize": jm.BANDSIZE,
             **{k: np.asarray(getattr(jm, k)) for k in (
                 "phi1s", "phi2s", "sigma_sqs_init", "thetas_init",
                 "Xhat_init")}}
    ref = Reference(setup, plain_lorenz, "cpu", exact=True,
                    sigma_fixed=SIGMA_FIXED)
    assert (ref.N, ref.D) == (jm.mag_I, jm.D)
    frame = ref.frame(gn.x0T.T, gn.z0,
                      ref.factor_inverse(gn.whitening.factor.tiles))
    qs = torch.as_tensor(_states(jmode, n=6, seed=3, scale=0.05))
    bt = torch.tensor(BETA_TEMP, dtype=torch.float64)
    lp, grad = tmode.logp_grad(qs, bt)
    lp_ref, grad_ref = ref.log_posterior(qs, bt, frame)
    # the port's lp is relative to its reference point: differences
    centred = lambda a: a - a.mean()
    scale = float(lp_ref.abs().max())
    np.testing.assert_allclose(centred(lp).numpy(), centred(lp_ref).numpy(),
                               rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=1e-8,
                               atol=1e-8 * float(grad_ref.abs().max()))

    # one leapfrog, accepted (uniforms 0), from the same momenta
    rng = np.random.default_rng(4)
    C, dim = qs.shape
    diag = torch.as_tensor(rng.uniform(0.5, 1.5, dim))
    normals = torch.as_tensor(rng.standard_normal((C, dim)))
    eps = torch.tensor(0.002, dtype=torch.float64)
    q1, info = hmc_step(lambda q: tmode.logp_grad(q, bt), qs, eps, diag, 1,
                        normals, torch.zeros(C, dtype=torch.float64))
    assert not bool(info.diverging.any())
    mass = Mass(diag)
    (q1_ref,) = ref.orbits(qs, mass.momentum(normals), eps.expand(C),
                           mass.velocity, frame, bt, 1)
    step = (q1_ref - qs).norm(dim=1)
    gap = (q1 - q1_ref).norm(dim=1)
    assert float((gap / step).max()) < 1e-9
