"""The port's ODE fields (magi_v2_tpu_torch/models/odes.py) against the JAX
package's: pointwise at random states and parameters, over a leading chain
axis against a loop over chains, and the registry's metadata. Float64 on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_v2_tpu import models as jmodels
from magi_v2_tpu_torch import models as tmodels

torch.set_num_threads(2)

FIELDS = ("seir", "sirw", "fitzhugh_nagumo", "hes1", "hes1_log",
          "lotka_volterra", "protein_transduction", "lorenz")


def _inputs(name, shape, seed):
    """States and parameters at the field's scale: positive where the
    field divides by a component or a parameter (Hes1, FitzHugh-Nagumo's
    c, protein transduction's Km + R_pp), log-scale states of order one."""
    m = jmodels.MODEL_REGISTRY[name]
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.1, 2.0, shape + (m.D,))
    if name == "hes1_log":
        X = rng.normal(0.5, 1.0, shape + (m.D,))
    th = rng.uniform(0.2, 2.0, shape[:-1] + (m.D_thetas,))
    return X, th


@pytest.mark.parametrize("name", FIELDS)
def test_field_matches_jax_pointwise(name):
    X, th = _inputs(name, (40,), seed=FIELDS.index(name))
    t = np.linspace(0.0, 1.0, 40).reshape(-1, 1)
    want = np.asarray(jmodels.MODEL_REGISTRY[name].f_vec(
        jnp.asarray(t), jnp.asarray(X), jnp.asarray(th)))
    got = tmodels.MODEL_REGISTRY[name].f_vec(
        torch.as_tensor(t), torch.as_tensor(X), torch.as_tensor(th)).numpy()
    assert got.shape == want.shape == X.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", FIELDS)
def test_field_over_a_chain_axis_matches_a_loop(name):
    X, th = _inputs(name, (5, 30), seed=100 + FIELDS.index(name))
    f = tmodels.MODEL_REGISTRY[name].f_vec
    t = torch.zeros((30, 1), dtype=torch.float64)
    batched = f(t, torch.as_tensor(X), torch.as_tensor(th)).numpy()
    looped = np.stack([f(t, torch.as_tensor(X[c]), torch.as_tensor(th[c]))
                       .numpy() for c in range(5)])
    np.testing.assert_array_equal(batched, looped)


def test_registry_matches_jax():
    jreg, treg = jmodels.MODEL_REGISTRY, tmodels.MODEL_REGISTRY
    assert set(treg) == set(jreg) == set(FIELDS)
    for name, jm in jreg.items():
        tm = treg[name]
        assert (tm.name, tm.D, tm.D_thetas, tm.theta_names, tm.true_thetas) \
            == (jm.name, jm.D, jm.D_thetas, jm.theta_names, jm.true_thetas)
        assert tm.f_vec is getattr(tmodels, jm.f_vec.__name__)
        # every registered field has its CUDA functor, so K1 never takes
        # its given kernels for it
        assert tmodels.cuda_model_of(tm.f_vec) == tm.cuda_model == name
