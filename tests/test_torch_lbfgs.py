"""Parity of the port's L-BFGS (ops/lbfgs.py) and of the hyperparameter fit
it drives with the JAX package, in float64 on the CPU.

Both minimizers take the same decisions (the strong-Wolfe bracket and
zoom, the ring buffer, the pair test, the fallbacks), so they walk the
same iterates: the tests require equal iteration counts, parameters
within 1e-8 relative and loss traces within 1e-8 of their scale (the
largest |loss|: the traces of a converging run end near 0, where a
relative comparison would measure rounding alone)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
from magi_v2_tpu import hparams as jhp
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.ops.kernels import matern_gram
from magi_v2_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import hparams as thp
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops.lbfgs import lbfgs_minimize

torch.set_num_threads(2)

REL = 1e-8


def _flat(params):
    if isinstance(params, dict):
        return np.concatenate([np.ravel(np.asarray(params[k]))
                               for k in sorted(params)])
    return np.ravel(np.asarray(params))


def _assert_same_walk(rj, rt):
    assert rt.num_iters == int(rj.num_iters)
    assert rt.converged == bool(rj.converged)
    pj, pt = _flat(rj.params), _flat({k: v.numpy() for k, v in
                                      rt.params.items()}
                                     if isinstance(rt.params, dict)
                                     else rt.params.numpy())
    np.testing.assert_allclose(pt, pj, rtol=REL,
                               atol=REL * np.abs(pj).max())
    lj, lt = np.asarray(rj.losses), rt.losses.numpy()
    assert lt.shape == lj.shape
    assert np.abs(lt - lj).max() <= REL * np.abs(lj).max()
    np.testing.assert_allclose(float(rt.loss), float(rj.loss), rtol=REL,
                               atol=REL * np.abs(lj).max())


def _both(jfun, tfun, x0, **kw):
    """(JAX result, port result) from the same NumPy start."""
    jx0 = ({k: jnp.asarray(v) for k, v in x0.items()}
           if isinstance(x0, dict) else jnp.asarray(x0))
    tx0 = ({k: torch.as_tensor(v) for k, v in x0.items()}
           if isinstance(x0, dict) else torch.as_tensor(x0))
    return jax_lbfgs(jfun, jx0, **kw), lbfgs_minimize(tfun, tx0, **kw)


def test_quadratic_matches_jax():
    """0.5 x'Ax - b'x (n = 12): the same iterates, and the linear solve's
    minimizer."""
    rng = np.random.default_rng(0)
    n = 12
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.as_tensor(A), \
        torch.as_tensor(b)
    rj, rt = _both(lambda x: 0.5 * x @ Aj @ x - bj @ x,
                   lambda x: 0.5 * x @ At @ x - bt @ x, np.zeros(n),
                   num_iters=100)
    _assert_same_walk(rj, rt)
    assert rt.converged and rt.num_iters <= 40
    np.testing.assert_allclose(rt.params.numpy(), np.linalg.solve(A, b),
                               atol=1e-7)


def test_rosenbrock_matches_jax():
    def rosen(p):
        return (1.0 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2

    rj, rt = _both(rosen, rosen, np.array([-1.2, 1.0]), num_iters=200,
                   tol=1e-10)
    _assert_same_walk(rj, rt)
    assert rt.converged
    np.testing.assert_allclose(rt.params.numpy(), [1.0, 1.0], atol=1e-6)


def test_dict_params_match_jax():
    """A dict of parameters, flattened in sorted key order as
    ``ravel_pytree`` does; the loss trace is non-increasing and its frozen
    tail repeats the final loss."""
    rj, rt = _both(
        lambda p: jnp.sum((p["a"] - 3.0) ** 2) + jnp.sum((p["b"] + 1.0) ** 4),
        lambda p: (torch.sum((p["a"] - 3.0) ** 2)
                   + torch.sum((p["b"] + 1.0) ** 4)),
        {"b": np.zeros((2, 2)), "a": np.zeros(3)}, num_iters=150)
    _assert_same_walk(rj, rt)
    assert rt.params["b"].shape == (2, 2)
    losses = rt.losses.numpy()
    assert losses.shape == (150,)
    assert np.all(np.diff(losses) <= 1e-12)
    assert np.all(losses[rt.num_iters:] == float(rt.loss))


def test_line_search_failure_matches_jax():
    """A cusp approached from afar: the search fails and the run stops at
    a finite iterate, in both packages at the same iteration."""
    rj, rt = _both(lambda x: jnp.sum(jnp.sqrt(jnp.abs(x) + 1e-12)),
                   lambda x: torch.sum(torch.sqrt(torch.abs(x) + 1e-12)),
                   np.array([4.0]), num_iters=60)
    _assert_same_walk(rj, rt)
    assert not rt.converged
    assert np.isfinite(float(rt.loss))
    assert np.all(np.isfinite(rt.params.numpy()))


@pytest.fixture(scope="module")
def gp_data():
    """tests/test_lbfgs.py's two GP components on 81 points."""
    rng = np.random.default_rng(1)
    I = np.linspace(0.0, 4.0, 81)
    X = np.zeros((len(I), 2))
    for d, (p1, p2, ssq) in enumerate([(1.5, 0.8, 0.01), (0.8, 0.5, 0.02)]):
        K = np.asarray(matern_gram(jnp.asarray(I), p1, p2))
        L = np.linalg.cholesky(K + 1e-10 * np.eye(len(I)))
        X[:, d] = (L @ rng.standard_normal(len(I))
                   + rng.standard_normal(len(I)) * np.sqrt(ssq))
    return I, X


def test_hparam_objective_walk_matches_jax(gp_data):
    """The SEIR hparam MAP objective: the same iterations as JAX's
    (``fit_kernel_hparams``' settings: 200 iterations, tol 1e-5)."""
    I, X = gp_data
    prior = jhp.fourier_prior(X, t_range=4.0)
    fj, pj = jhp.make_hparam_objective(I, X, prior, 2.01)
    ft, pt = thp.make_hparam_objective(I, X, thp.fourier_prior(X, 4.0),
                                       2.01, device="cpu")
    rj = jax.jit(lambda p: jax_lbfgs(fj, p, num_iters=200, tol=1e-5))(pj)
    rt = lbfgs_minimize(ft, pt, num_iters=200, tol=1e-5)
    _assert_same_walk(rj, rt)
    assert rt.converged and rt.num_iters < 40


def test_fit_kernel_hparams_lbfgs_matches_jax(gp_data):
    """optimizer="lbfgs" against JAX's, and at or below the objective of
    Adam-1000's fit (JAX's bound, tests/test_lbfgs.py; JAX's Adam, the
    same update as the port's, runs as one scan)."""
    I, X = gp_data
    fj = jhp.fit_kernel_hparams(I, X, optimizer="lbfgs")
    ft = thp.fit_kernel_hparams(I, X, optimizer="lbfgs", device="cpu")
    for k in ("phi1s", "phi2s", "sigma_sqs", "losses"):
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, err_msg=k)
    adam = jhp.fit_kernel_hparams(I, X, optimizer="adam")
    neg_map, _ = thp.make_hparam_objective(I, X, ft["prior"], 2.01,
                                           device="cpu")

    def objective(fit):
        return float(neg_map({
            k: thp.softplus_inverse(torch.as_tensor(fit[name]))
            for k, name in (("phi1_pre", "phi1s"), ("phi2_pre", "phi2s"),
                            ("sigma_sq_pre", "sigma_sqs"))}))

    assert objective(ft) <= objective(adam) + 1e-3


@pytest.mark.parametrize("optimizer", ["sgd", "LBFGS"])
def test_unknown_optimizer_raises(gp_data, optimizer):
    I, X = gp_data
    with pytest.raises(ValueError, match="optimizer must be 'adam' or "
                       "'lbfgs'"):
        thp.fit_kernel_hparams(I, X, optimizer=optimizer, device="cpu")


def test_initial_fit_with_lbfgs_matches_jax():
    """MagiConfig(hparam_optimizer="lbfgs") reaches the fit of a small SEIR
    model as in JAX (test_torch_setup.py's tolerance)."""
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    kw = dict(hparam_optimizer="lbfgs", hparam_num_iters=50,
              init_num_iters=100)
    jm = J.MAGI_v2(3, ts, X, None, jseir, J.MagiConfig().replace(**kw))
    jm.initial_fit(discretization=1)
    tm = T.MAGI_v2(3, ts, X, None, tseir, T.MagiConfig(device="cpu", **kw))
    tm.initial_fit(discretization=1)
    for name in ("phi1s", "phi2s", "sigma_sqs_init", "thetas_init"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name),
                                   rtol=1e-6, err_msg=name)
    assert np.all(np.isfinite(tm.thetas_init))
