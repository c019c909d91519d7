"""ODE vector fields in PyTorch (counterpart of magi_v2_tpu/models/odes.py).

Contract: ``f_vec(t (N,1), X (N,D), thetas (D_thetas,)) -> (N,D)``, as in
the JAX package. The port's fields also broadcast over leading batch axes —
``X (..., N, D)`` with ``thetas (..., D_thetas)`` — so the sampler evaluates
all chains in one call.

``OdeModel.cuda_model`` names the model functor in the hand-written CUDA
kernels (csrc/manifold.cu); the fused sampler path needs one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def seir_f_vec(t, X, thetas):
    """Reduced SEIR: X = (E, I, R), S = 1 - E - I - R implicit, N_pop = 1.

    thetas = (beta, gamma, sigma):
        dE/dt = beta*S*I - sigma*E
        dI/dt = sigma*E - gamma*I
        dR/dt = gamma*I
    """
    E, I, R = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    beta = thetas[..., None, 0:1]
    gamma = thetas[..., None, 1:2]
    sigma = thetas[..., None, 2:3]
    S = 1.0 - torch.sum(X, dim=-1, keepdim=True)
    return torch.cat(
        [beta * S * I - sigma * E, sigma * E - gamma * I, gamma * I], dim=-1
    )


def lorenz_f_vec(t, X, thetas):
    """Lorenz system, X = (x, y, z), thetas = (sigma, rho, beta):
        dx/dt = sigma * (y - x)
        dy/dt = x * (rho - z) - y
        dz/dt = x*y - beta*z
    """
    x, y, z = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    sigma = thetas[..., None, 0:1]
    rho = thetas[..., None, 1:2]
    beta = thetas[..., None, 2:3]
    return torch.cat(
        [sigma * (y - x), x * (rho - z) - y, x * y - beta * z], dim=-1
    )


@dataclasses.dataclass(frozen=True)
class OdeModel:
    name: str
    f_vec: Callable
    D: int
    D_thetas: int
    theta_names: tuple
    true_thetas: tuple | None = None
    # model functor of the CUDA manifold kernels, or None
    cuda_model: str | None = None


MODEL_REGISTRY = {
    "seir": OdeModel(
        name="seir",
        f_vec=seir_f_vec,
        D=3,
        D_thetas=3,
        theta_names=("beta", "gamma", "sigma"),
        true_thetas=(6.0, 0.6, 1.8),
        cuda_model="seir",
    ),
    "lorenz": OdeModel(
        name="lorenz",
        f_vec=lorenz_f_vec,
        D=3,
        D_thetas=3,
        theta_names=("sigma", "rho", "beta"),
        true_thetas=(10.0, 28.0, 8.0 / 3.0),
        cuda_model="lorenz",
    ),
}


def cuda_model_of(f_vec) -> str | None:
    """The CUDA model functor registered for ``f_vec``, or None."""
    for m in MODEL_REGISTRY.values():
        if m.f_vec is f_vec:
            return m.cuda_model
    return None
