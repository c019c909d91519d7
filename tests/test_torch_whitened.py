"""The port's GP-prior whitened mode (reparam="whitened"), centered
coordinates in banded storage, user starts (predict's ``init_states``),
``map_warmstart_iters`` and the storage x reparam errors, against the JAX
package on a small SEIR fit (21 observations, N_I = 41, bandsize 20), in
float64 on the CPU, where every kernel wrapper takes its plain version.
The port's model is built from the JAX fit's arrays. K1's whitened fwd
kernel is held against its plain version on the card by
tests/test_torch_kernels.py (cuda-marked).

The port's targets evaluate relative to a reference point, JAX's
absolutely, so lp is compared through its differences between states
(tests/test_torch_partial.py does the same for centered coordinates)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler import magi_state as jms
from magi_v2_tpu.sampler.modes import apply_init_states as japply
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.api import map_warmstart
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops import manifold as mf
from magi_v2_tpu_torch.posterior import softplus
from magi_v2_tpu_torch.sampler import magi_state as tms
from magi_v2_tpu_torch.sampler.modes import apply_init_states as tapply
from magi_v2_tpu_torch.sampler.modes import unwhiten_draws
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

F64 = torch.float64
BETA_TEMP = 0.37
# every reparam x storage the port samples
MODES = [
    ("centered", "dense"),
    ("centered", "banded"),
    ("whitened", "dense"),
    ("precond", "dense"),
    ("precond", "banded"),
    ("precond", "hybrid"),
]


@pytest.fixture(scope="module")
def fitted():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=100, init_num_iters=200))
    jm.initial_fit(discretization=1)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, bandsize=20,
                         config=MagiConfig(device="cpu"),
                         exact_operators=jm._exact_operators())
    return jm, tm


_MODES = {}


def _modes(fitted, reparam, storage, dtype=F64):
    """(JAX setup, port setup) of one mode, built once: (mode, data,
    sigma_sqs_LB, ...)."""
    key = (reparam, storage, dtype)
    if key not in _MODES:
        jm, tm = fitted
        jdt = jnp.float64 if dtype == F64 else jnp.float32
        _MODES[key] = (jm._build_sampling_setup(reparam, storage, jdt),
                       tm._build_sampling_setup(reparam, storage, dtype))
    return _MODES[key]


def _states(jmode, n=5, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    q0 = np.concatenate([np.asarray(jmode.X0, np.float64).ravel(),
                         [-10.5, -10.5, -10.5], [1.8, -0.5, 0.6]])
    return q0 + scale * rng.standard_normal((n, q0.size))


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


def test_gp_sqrt_factors_and_maps_match_jax(fitted):
    jm, _ = fitted
    Cinv = np.asarray(jm.C_d_invs, np.float64)
    Lj, Lij = (np.asarray(a) for a in jms.gp_sqrt_factors(jnp.asarray(Cinv)))
    Lt, Lit = (a.numpy() for a in tms.gp_sqrt_factors(torch.tensor(Cinv)))
    assert _rel(Lj, Lt) < 1e-10 and _rel(Lij, Lit) < 1e-10
    X = np.asarray(jm.Xhat_init, np.float64)
    mu = np.asarray(jm.mu_ds, np.float64)
    zj = np.asarray(jms.whiten_X(jnp.asarray(X), jnp.asarray(mu),
                                 jnp.asarray(Lij)))
    zt = tms.whiten_X(torch.as_tensor(X), torch.as_tensor(mu),
                      torch.as_tensor(Lit)).numpy()
    assert _rel(zj, zt) < 1e-10
    Z = np.random.default_rng(1).standard_normal((2, 3) + X.shape)
    xj = np.asarray(jms.unwhiten_Z(jnp.asarray(Z), jnp.asarray(mu),
                                   jnp.asarray(Lj)))
    xt = tms.unwhiten_Z(torch.as_tensor(Z), torch.as_tensor(mu),
                        torch.as_tensor(Lt)).numpy()
    assert _rel(xj, xt) < 1e-10


@pytest.mark.parametrize("reparam,storage", [("whitened", "dense"),
                                             ("centered", "banded")])
def test_targets_match_jax(fitted, reparam, storage):
    """The composed target against JAX's (make_tempered_logp_grad_whitened;
    the centered log_posterior on banded data): lp differences between
    states and full gradients, 1e-9 relative; the starts X0 alike."""
    (jmode, *_), (tmode, *_) = _modes(fitted, reparam, storage)
    assert _rel(np.asarray(jmode.X0), tmode.X0.numpy()) < 1e-9
    qs = _states(jmode)
    vj, gj = (np.asarray(a) for a in jax.vmap(
        lambda q: jmode.logp_grad(q, jnp.asarray(BETA_TEMP)))(
            jnp.asarray(qs)))
    vt, gt = tmode.logp_grad(torch.as_tensor(qs),
                             torch.tensor(BETA_TEMP, dtype=F64))
    assert _rel(vj - vj[0], vt.numpy() - vt.numpy()[0]) < 1e-9
    assert _rel(gj, gt.numpy()) < 1e-9


def test_whitened_fwd_plain_is_the_closed_form():
    """K1's plain fwd in the whitened form: t1 = sum dz (dz + 2 z0) over
    the chain, the seed -(beta_T/beta)(dz + z0), dr and t4 as in the GN
    form, and RmD's first half never read."""
    g = torch.Generator().manual_seed(0)
    C, D, N, P = 3, 3, 7, 3
    r = lambda *s: torch.randn(s, generator=g, dtype=F64)
    delta, dz, z0 = r(C, D, N), r(C, D, N), r(D, N)
    RmD = r(D, C, 2 * N)
    q = r(C, N * D + D + P)
    x0T, f0, y = r(D, N), r(D, N), r(D, N)
    mask = (torch.rand((D, N), generator=g) < 0.5).to(F64)
    lb = torch.full((D,), 1e-3, dtype=F64)
    bt, beta = torch.tensor(0.3, dtype=F64), 2.5
    I = torch.zeros((N, 1), dtype=F64)
    args = (tseir, I, delta, RmD, q, x0T, z0, f0, mask, y, lb, bt, beta)
    dr, gcat, t14 = mf.manifold_fwd_plain(*args, dz=dz)
    t1 = torch.sum(dz * (dz + 2 * z0), dim=(1, 2))
    torch.testing.assert_close(t14[:, 0], t1, rtol=1e-14, atol=0)
    seed = -(bt / beta) * (dz + z0).transpose(0, 1)
    torch.testing.assert_close(gcat[..., :N], seed, rtol=1e-14, atol=0)
    RmD2 = RmD.clone()
    RmD2[..., :N] = float("nan")
    dr2, _, t142 = mf.manifold_fwd_plain(*args[:3], RmD2, *args[4:], dz=dz)
    assert torch.equal(dr2, dr) and torch.equal(t142, t14)
    # the GN form with R delta = dz and a0 = z0 is the same arithmetic
    RmD3 = RmD.clone()
    RmD3[..., :N] = dz.transpose(0, 1)
    dr3, gcat3, t143 = mf.manifold_fwd_plain(*args[:3], RmD3, *args[4:])
    assert torch.equal(dr3, dr)
    torch.testing.assert_close(t143, t14, rtol=1e-14, atol=0)
    torch.testing.assert_close(gcat3[..., :N], gcat[..., :N], rtol=1e-14,
                               atol=0)


@pytest.mark.parametrize("reparam,storage", MODES)
def test_apply_init_states_matches_jax(fitted, reparam, storage):
    """Per-chain X, theta and sigma starts through both packages' maps,
    from the same q0, in float64."""
    jm, tm = fitted
    (jmode, _, jlb, *_), (tmode, _, tlb) = _modes(fitted, reparam, storage)
    np.testing.assert_array_equal(np.asarray(jlb), tlb)
    rng = np.random.default_rng(2)
    C, N, D, P = 3, jm.mag_I, jm.D, jm.D_thetas
    init = {"X": np.asarray(jm.Xhat_init)[None]
            + 0.01 * rng.standard_normal((C, N, D)),
            "thetas": np.abs(jm.thetas_init * (1 + 0.2 * rng.standard_normal(
                (C, P)))),
            # one value at the bound: the -5.0 floor
            "sigma_sqs": np.concatenate([np.asarray(jlb)[None],
                                         np.full((C - 1, D), 1e-3)])}
    q0 = rng.standard_normal((C, N * D + D + P))
    qj = japply(q0.copy(), init, jmode, jm, jlb, None)
    qt = tapply(q0.copy(), init, tmode, tm, tlb, None)
    assert np.all(qt[0, N * D: N * D + D] == -5.0)
    np.testing.assert_allclose(qt, qj, rtol=1e-9,
                               atol=1e-9 * np.abs(qj).max())


@pytest.mark.parametrize("reparam,storage", MODES)
def test_roundtrip_matches_default_init(fitted, reparam, storage):
    """The model's own (Xhat_init, thetas_init, sigma_sqs_init) through
    init_states lands on the default start: the same float64 maps."""
    jm, tm = fitted
    _, (mode, _, lb) = _modes(fitted, reparam, storage, torch.float32)
    N, D, P = tm.mag_I, tm.D, tm.D_thetas
    q0 = np.zeros((2, N * D + D + P), np.float32)
    q0 = tapply(q0, {"X": tm.Xhat_init, "thetas": tm.thetas_init,
                     "sigma_sqs": tm.sigma_sqs_init}, mode, tm, lb, None)
    for c in range(2):
        np.testing.assert_allclose(q0[c, :N * D], mode.X0.numpy().ravel(),
                                   rtol=1e-5, atol=1e-5)
    th = softplus(torch.as_tensor(q0[0, N * D + D:], dtype=F64)).numpy()
    np.testing.assert_allclose(th, tm.thetas_init, rtol=1e-5, atol=1e-6)
    sig = softplus(torch.as_tensor(q0[0, N * D: N * D + D],
                                   dtype=F64)).numpy() + lb
    keep = tm.sigma_sqs_init > lb
    np.testing.assert_allclose(sig[keep], tm.sigma_sqs_init[keep], rtol=1e-4)


KW = dict(num_results=3, num_burnin_steps=3, num_chains=2, seed=0,
          algorithm="hmc", hmc_num_leapfrogs=2, use_annealing=False)


def test_predict_identical_to_default_when_fed_defaults(fitted):
    _, tm = fitted
    r0 = tm.predict(reparam="centered", **KW)
    r1 = tm.predict(reparam="centered", init_states={
        "X": tm.Xhat_init, "thetas": tm.thetas_init,
        "sigma_sqs": tm.sigma_sqs_init}, **KW)
    np.testing.assert_array_equal(r0["thetas_samps"], r1["thetas_samps"])
    np.testing.assert_array_equal(r0["X_samps"], r1["X_samps"])


@pytest.mark.parametrize("reparam,storage", [("precond", "dense"),
                                             ("whitened", "dense"),
                                             ("centered", "banded")])
def test_predict_per_chain_scatter_runs(fitted, reparam, storage):
    """Scattered per-chain starts map chain by chain and sample finitely;
    init_jitter leaves the overridden block alone."""
    _, tm = fitted
    rng = np.random.default_rng(0)
    Xs = tm.Xhat_init[None] + 0.05 * rng.standard_normal(
        (2,) + tm.Xhat_init.shape)
    ths = np.abs(tm.thetas_init[None] * (1 + 0.2 * rng.standard_normal(
        (2, 3))))
    res = tm.predict(reparam=reparam, storage=storage, init_jitter=0.1,
                     init_states={"X": Xs, "thetas": ths},
                     **dict(KW, num_results=1, num_burnin_steps=0))
    assert np.all(np.isfinite(res["thetas_samps"]))
    assert np.all(np.isfinite(res["X_samps"]))


def test_init_states_validation_errors(fitted):
    _, tm = fitted
    mode, _, lb = _modes(fitted, "centered", "dense")[1]
    N, D, P = tm.mag_I, tm.D, tm.D_thetas
    q0 = np.zeros((2, N * D + D + P), np.float64)
    with pytest.raises(ValueError, match="unknown keys"):
        tapply(q0, {"bogus": 1}, mode, tm, lb, None)
    with pytest.raises(ValueError, match="shape"):
        tapply(q0, {"thetas": np.ones((3, P))}, mode, tm, lb, None)
    bad = tm.Xhat_init.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        tapply(q0, {"X": bad}, mode, tm, lb, None)
    with pytest.raises(ValueError, match="sigma_sqs_fixed"):
        tapply(q0, {"sigma_sqs": np.full(D, 0.01)}, mode, tm, lb, 0.01)


@pytest.mark.parametrize("reparam,storage,match", [
    ("whitened", "banded", "GP-prior whitening factors are dense"),
    ("centered", "hybrid", "requires reparam='precond'"),
    ("whitened", "hybrid", "requires reparam='precond'"),
])
def test_storage_reparam_errors_match_jax(fitted, reparam, storage, match):
    jm, tm = fitted
    with pytest.raises(ValueError, match=match):
        jm._build_sampling_setup(reparam, storage, jnp.float64)
    with pytest.raises(ValueError, match=match):
        tm._build_sampling_setup(reparam, storage, F64)
    with pytest.raises(ValueError, match=match):
        tm.predict(reparam=reparam, storage=storage, **KW)


def test_whitened_predict_and_unwhitening(fitted):
    """A short whitened NUTS predict samples finitely, and the draws'
    unwhitening x_d = mu_d + L_d z_d matches JAX's unwhiten_Z, chunked."""
    jm, tm = fitted
    res = tm.predict(reparam="whitened", num_results=4, num_burnin_steps=4,
                     num_chains=2, seed=0)
    assert np.all(np.isfinite(res["X_samps"]))
    assert res["X_samps"].shape == (4, 2, tm.mag_I, tm.D)
    (jmode, jdata, *_), (tmode, tdata, _) = _modes(fitted, "whitened",
                                                   "dense")
    Z = np.random.default_rng(3).standard_normal((5, 2, tm.mag_I, tm.D))
    xj = np.asarray(jms.unwhiten_Z(jnp.asarray(Z), jdata.mu_ds,
                                   jmode.factor))
    xt = unwhiten_draws(tmode, torch.as_tensor(Z), tdata.mu_ds,
                        max_bytes=3 * Z[0].nbytes).numpy()
    assert _rel(xj, xt) < 1e-10


@pytest.mark.parametrize("reparam", ["precond", "whitened"])
def test_map_warmstart_matches_jax(fitted, reparam):
    """predict's MAP polish: 20 Adam steps (eps 1e-7) ascending the
    sampler's own target at beta 1 from the default start, against the
    JAX package's optax loop on its target (api.py's map_warmstart_iters
    branch); then a predict that takes it runs."""
    jm, tm = fitted
    (jmode, *_), (tmode, *_) = _modes(fitted, reparam, "dense")
    q0 = _states(jmode, n=1, scale=0.0)[0]
    opt = optax.adam(tm.config.init_learning_rate, eps=1e-7)
    q, st, vj = jnp.asarray(q0), None, []
    st = opt.init(q)
    for _ in range(20):
        v, g = jmode.logp_grad(q, jnp.asarray(1.0))
        upd, st = opt.update(jax.tree.map(jnp.negative, g), st)
        q = optax.apply_updates(q, upd)
        vj.append(float(v))
    qt, vt = map_warmstart(tmode.logp_grad, q0, 20,
                           tm.config.init_learning_rate, F64, "cpu")
    np.testing.assert_allclose(qt, np.asarray(q), rtol=1e-9,
                               atol=1e-9 * np.abs(q0).max())
    np.testing.assert_allclose(np.diff(vt), np.diff(vj), rtol=1e-7,
                               atol=1e-9 * abs(vj[0]))
    assert vt[-1] > vt[0]
    res = tm.predict(reparam=reparam, map_warmstart_iters=5, **KW)
    assert "map_warmstart" in tm.predict_timings
    assert np.all(np.isfinite(res["thetas_samps"]))
