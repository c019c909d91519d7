"""Parity of the PyTorch port's building blocks with the JAX package, on
the CPU in float64: ODE field, Bessel K_nu, Matern kernel matrices, linear
algebra, and the modules copied from the JAX package (preprocess,
diagnostics, the data simulator)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_v2_tpu import preprocess as jpre
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.ops import bessel as jb
from magi_v2_tpu.ops import kernels as jk
from magi_v2_tpu.ops import linalg as jl
from magi_v2_tpu.utils import diagnostics as jdiag
from magi_v2_tpu.utils.data import simulate_ode as jsim
from magi_v2_tpu_torch import preprocess as tpre
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops import bessel as tb
from magi_v2_tpu_torch.ops import kernels as tk
from magi_v2_tpu_torch.ops import linalg as tl
from magi_v2_tpu_torch.utils import diagnostics as tdiag
from magi_v2_tpu_torch.utils.data import simulate_ode as tsim

torch.set_num_threads(2)

# float64 throughout: both sides run the same algorithm in the same order
# up to library kernels, so agreement is at a few ulps; 1e-10 leaves room
# for the Bessel recurrences' condition numbers
RTOL = 1e-10
Z = np.geomspace(1e-3, 40.0, 300)   # spans the series/CF2 boundary at z=2


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_seir_field_matches_jax_pointwise():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 0.5, (50, 3))
    th = rng.uniform(0.1, 7.0, 3)
    a = np.asarray(jseir(jnp.zeros((50, 1)), jnp.asarray(X), jnp.asarray(th)))
    b = tseir(torch.zeros(50, 1, dtype=torch.float64), _t(X), _t(th)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-15)


def test_seir_field_broadcasts_over_chains():
    rng = np.random.default_rng(1)
    X = _t(rng.uniform(0.0, 0.5, (4, 7, 3)))
    th = _t(rng.uniform(0.1, 7.0, (4, 3)))
    batched = tseir(None, X, th)
    for c in range(4):
        torch.testing.assert_close(batched[c], tseir(None, X[c], th[c]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("mu,n", [(0.01, 3), (0.5, 2), (0.99, 1)])
def test_kv_ladder_matches_jax(mu, n):
    a = np.asarray(jb.kv_ladder(jnp.asarray(Z), mu, n))
    b = tb.kv_ladder(_t(Z), mu, n).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_kvp_matches_jax(order):
    a = np.asarray(jb.kvp(2.01, jnp.asarray(Z), order))
    b = tb.kvp(2.01, _t(Z), order).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL)


def test_kv_gradient_matches_jax_custom_jvp():
    """KvLadder's backward replaces the JAX custom JVP."""
    g = np.asarray(jax.grad(lambda z: jnp.sum(jb.kv(2.01, z)))(jnp.asarray(Z)))
    zt = _t(Z).requires_grad_(True)
    tb.kv(2.01, zt).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), g, rtol=RTOL)


def test_kv_second_derivative_matches_jax():
    """A backward that is itself differentiated re-enters the ladder."""
    f = lambda z: jnp.sum(jax.grad(lambda y: jnp.sum(jb.kv(2.01, y)))(z))
    h = np.asarray(jax.grad(f)(jnp.asarray(Z)))
    zt = _t(Z).requires_grad_(True)
    (g,) = torch.autograd.grad(tb.kv(2.01, zt).sum(), zt, create_graph=True)
    (ht,) = torch.autograd.grad(g.sum(), zt)
    np.testing.assert_allclose(ht.numpy(), h, rtol=RTOL)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("phi1,phi2", [(0.003, 0.6), (0.01, 0.4)])
def test_kernel_matrices_match_jax(uniform, phi1, phi2):
    I = np.linspace(0.0, 2.0, 41)
    assert tk.uniform_spacing(I) == jk.uniform_spacing(I)
    sp = jk.uniform_spacing(I) if uniform else None
    raw_j = jk.matern_derivative_matrices(jnp.asarray(I), phi1, phi2)
    # Python-number hyperparameters, as in the JAX call: float64 on both sides
    raw_t = tk.matern_derivative_matrices(_t(I), phi1, phi2)
    for a, b in zip(raw_j, raw_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=1e-14 * np.abs(a).max())
    Cj, mj, Kj = jk.magi_kernel_matrices(jnp.asarray(I), phi1, phi2,
                                         spacing=sp)
    Ct, mt, Kt = tk.magi_kernel_matrices(_t(I), phi1, phi2, spacing=sp)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=RTOL)
    # m and K pass through the pseudo-inverse of the ill-conditioned Gram
    # matrix (cond ~1e11), whose last bits differ between eigh
    # implementations: compare relative to each operator's scale
    for a, b in ((mj, mt), (Kj, Kt)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-8 * np.abs(a).max()


def test_kernel_matrices_batch_over_components():
    """The batched (C, m, K) against one component at a time. C (kappa) is
    built elementwise and agrees to the last bits. m = kappa' kappa^+ and
    K pass through the pseudo-inverse of kappa, whose condition number
    here is about 1.4e5 (eigenvalues 1.16e-6 .. 0.164 for component 1),
    so a last-bit difference between the batched and the single LAPACK/
    BLAS calls grows to about cond * eps ~ 3e-11 of each matrix's scale
    (a gap of 4e-12 of max |m| was reproduced on one host): they are held
    to 1e-10 of their largest entry."""
    I = _t(np.linspace(0.0, 2.0, 41))
    phi1, phi2 = _t([0.003, 0.01]), _t([0.6, 0.4])
    batched = tk.magi_kernel_matrices(I, phi1, phi2, spacing=0.05)
    for d in range(2):
        single = tk.magi_kernel_matrices(I, phi1[d], phi2[d], spacing=0.05)
        torch.testing.assert_close(batched[0][d], single[0], rtol=1e-12,
                                   atol=0)
        for a, b in zip(batched[1:], single[1:]):
            scale = float(b.abs().max())
            torch.testing.assert_close(a[d], b, rtol=0, atol=1e-10 * scale)


def _spd(n, seed, cond=1e4):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.geomspace(1.0, 1.0 / cond, n)) @ Q.T


def test_linalg_matches_jax():
    A = _spd(30, 0)
    B = np.stack([A, _spd(30, 1)])
    b = np.random.default_rng(2).standard_normal(30)
    np.testing.assert_allclose(tl.sym_pinv(_t(B)).numpy(),
                               np.asarray(jl.sym_pinv(jnp.asarray(B))),
                               rtol=1e-9)
    np.testing.assert_allclose(tl.sym_sqrt(_t(B)).numpy(),
                               np.asarray(jl.sym_sqrt(jnp.asarray(B))),
                               rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(
        tl.solve_psd(_t(A), _t(b), jitter=1e-6).numpy(),
        np.asarray(jl.solve_psd(jnp.asarray(A), jnp.asarray(b), 1e-6)),
        rtol=1e-9,
    )
    for lo, hi in ((3, 3), (0, 5), (-1, 2)):
        np.testing.assert_array_equal(
            tl.band_part(_t(B), lo, hi).numpy(),
            np.asarray(jl.band_part(jnp.asarray(B), lo, hi)),
        )


def test_simulate_ode_matches_jax():
    kw = dict(x0=np.array([0.1, 0.05, 0.0]), thetas=np.array([6.0, 0.6, 1.8]),
              t_max=2.0, n_obs=21, noise_sd=0.005, substeps=20,
              comp_obs=[True, False, True])
    a, b = jsim(jseir, **kw), tsim(tseir, **kw)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_allclose(b[2], a[2], rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(b[1], a[1], rtol=1e-13, atol=1e-15)


def test_preprocess_copy_gives_identical_outputs():
    rng = np.random.default_rng(3)
    ts = np.linspace(0.0, 2.0, 21)
    X = rng.standard_normal((21, 3))
    X[3, 1] = np.nan
    Ia, Xa = jpre.discretize(ts, X, 2)
    Ib, Xb = tpre.discretize(ts, X, 2)
    np.testing.assert_array_equal(Ib, Ia)
    np.testing.assert_array_equal(Xb, Xa)
    np.testing.assert_array_equal(tpre.linear_interpolate(Xa),
                                  jpre.linear_interpolate(Xa))
    ia, ib = jpre.build_observation_index(Xa), tpre.build_observation_index(Xa)
    for f in ("not_nan_idxs", "not_nan_cols", "y_observed", "N_ds"):
        np.testing.assert_array_equal(getattr(ib, f), getattr(ia, f))
    Xf = jpre.linear_interpolate(Xa)
    np.testing.assert_array_equal(tpre.cv_cubic_smoother(Ia, Xf),
                                  jpre.cv_cubic_smoother(Ia, Xf))


def test_diagnostics_copy_gives_identical_outputs():
    rng = np.random.default_rng(4)
    draws = np.cumsum(rng.standard_normal((200, 4, 3)), axis=0) * 0.1
    draws += rng.standard_normal((200, 4, 3))
    assert tdiag.summarize_chains(draws, 2.0) == jdiag.summarize_chains(draws,
                                                                        2.0)


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys, magi_v2_tpu_torch, magi_v2_tpu_torch.api, "
        "magi_v2_tpu_torch.utils, magi_v2_tpu_torch.ops.manifold, "
        "magi_v2_tpu_torch.ops._build; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'optax' or m.startswith('magi_v2_tpu.') "
        "or m == 'magi_v2_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
