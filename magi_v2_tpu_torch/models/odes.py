"""ODE vector fields in PyTorch (counterpart of magi_v2_tpu/models/odes.py:
SEIR, SIRW, FitzHugh-Nagumo, Hes1 and its log-scale form, Lotka-Volterra,
protein transduction and Lorenz).

Contract: ``f_vec(t (N,1), X (N,D), thetas (D_thetas,)) -> (N,D)``, as in
the JAX package. The port's fields also broadcast over leading batch axes —
``X (..., N, D)`` with ``thetas (..., D_thetas)`` — so the sampler evaluates
all chains in one call.

``OdeModel.cuda_model`` names the model functor in the hand-written CUDA
kernels (csrc/manifold.cu); a field with none takes K1's ``given`` kernels.
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


def _thetas(thetas, k):
    """The first k parameters, each (..., 1, 1) against X (..., N, 1)."""
    return tuple(thetas[..., None, i:i + 1] for i in range(k))


def sirw_f_vec(t, X, thetas):
    """SIRW with waning immunity: X = (S, I, R, W),
    thetas = (beta, phi, xi, chi, kappa):
        dS/dt = -beta*S*I + kappa*W
        dI/dt =  beta*S*I - phi*I
        dR/dt =  phi*I - xi*R + chi*I*W
        dW/dt =  xi*R - chi*I*W - kappa*W
    """
    S, I, R, W = (X[..., i:i + 1] for i in range(4))
    beta, phi, xi, chi, kappa = _thetas(thetas, 5)
    return torch.cat(
        [
            -beta * S * I + kappa * W,
            beta * S * I - phi * I,
            phi * I - xi * R + chi * I * W,
            xi * R - chi * I * W - kappa * W,
        ],
        dim=-1,
    )


def fitzhugh_nagumo_f_vec(t, X, thetas):
    """FitzHugh-Nagumo, X = (V, R), thetas = (a, b, c):
        dV/dt = c * (V - V^3/3 + R)
        dR/dt = -(V - a + b*R) / c
    """
    V, R = X[..., 0:1], X[..., 1:2]
    a, b, c = _thetas(thetas, 3)
    return torch.cat([c * (V - V ** 3 / 3.0 + R), -(V - a + b * R) / c],
                     dim=-1)


def hes1_f_vec(t, X, thetas):
    """Hes1 oscillator, X = (P, M, H), thetas = (a, b, c, d, e, f, g):
        dP/dt = -a*P*H + b*M - c*P
        dM/dt = -d*M + e / (1 + P^2)
        dH/dt = -a*P*H + f / (1 + P^2) - g*H
    """
    P, M, H = (X[..., i:i + 1] for i in range(3))
    a, b, c, d, e, f, g = _thetas(thetas, 7)
    return torch.cat(
        [
            -a * P * H + b * M - c * P,
            -d * M + e / (1.0 + P ** 2),
            -a * P * H + f / (1.0 + P ** 2) - g * H,
        ],
        dim=-1,
    )


def hes1_log_f_vec(t, X, thetas):
    """Hes1 on the log scale, X = (log P, log M, log H): with Y = log X
    componentwise, dY/dt = (dX/dt) / X."""
    P, M, H = (torch.exp(X[..., i:i + 1]) for i in range(3))
    a, b, c, d, e, f, g = _thetas(thetas, 7)
    return torch.cat(
        [
            -a * H + b * M / P - c,
            -d + e / (1.0 + P ** 2) / M,
            -a * P + f / ((1.0 + P ** 2) * H) - g,
        ],
        dim=-1,
    )


def lotka_volterra_f_vec(t, X, thetas):
    """Lotka-Volterra, X = (u, v) prey and predator, thetas = (a, b, c, d):
        du/dt = a*u - b*u*v
        dv/dt = c*u*v - d*v
    """
    u, v = X[..., 0:1], X[..., 1:2]
    a, b, c, d = _thetas(thetas, 4)
    return torch.cat([a * u - b * u * v, c * u * v - d * v], dim=-1)


def protein_transduction_f_vec(t, X, thetas):
    """Protein signalling transduction (Vyshemirsky & Girolami 2008),
    X = (S, S_d, R, S_R, R_pp), thetas = (k1, k2, k3, k4, V, Km):
        dS/dt    = -k1*S - k2*S*R + k3*S_R
        dS_d/dt  =  k1*S
        dR/dt    = -k2*S*R + k3*S_R + V*R_pp / (Km + R_pp)
        dS_R/dt  =  k2*S*R - k3*S_R - k4*S_R
        dR_pp/dt =  k4*S_R - V*R_pp / (Km + R_pp)
    """
    S, S_d, R, S_R, R_pp = (X[..., i:i + 1] for i in range(5))
    k1, k2, k3, k4, V, Km = _thetas(thetas, 6)
    mm = V * R_pp / (Km + R_pp)
    return torch.cat(
        [
            -k1 * S - k2 * S * R + k3 * S_R,
            k1 * S,
            -k2 * S * R + k3 * S_R + mm,
            k2 * S * R - (k3 + k4) * S_R,
            k4 * S_R - mm,
        ],
        dim=-1,
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
    "sirw": OdeModel(
        name="sirw",
        f_vec=sirw_f_vec,
        D=4,
        D_thetas=5,
        theta_names=("beta", "phi", "xi", "chi", "kappa"),
        cuda_model="sirw",
    ),
    "fitzhugh_nagumo": OdeModel(
        name="fitzhugh_nagumo",
        f_vec=fitzhugh_nagumo_f_vec,
        D=2,
        D_thetas=3,
        theta_names=("a", "b", "c"),
        true_thetas=(0.2, 0.2, 3.0),
        cuda_model="fitzhugh_nagumo",
    ),
    "hes1": OdeModel(
        name="hes1",
        f_vec=hes1_f_vec,
        D=3,
        D_thetas=7,
        theta_names=("a", "b", "c", "d", "e", "f", "g"),
        true_thetas=(0.022, 0.3, 0.031, 0.028, 0.5, 20.0, 0.3),
        cuda_model="hes1",
    ),
    "hes1_log": OdeModel(
        name="hes1_log",
        f_vec=hes1_log_f_vec,
        D=3,
        D_thetas=7,
        theta_names=("a", "b", "c", "d", "e", "f", "g"),
        true_thetas=(0.022, 0.3, 0.031, 0.028, 0.5, 20.0, 0.3),
        cuda_model="hes1_log",
    ),
    "lotka_volterra": OdeModel(
        name="lotka_volterra",
        f_vec=lotka_volterra_f_vec,
        D=2,
        D_thetas=4,
        theta_names=("a", "b", "c", "d"),
        true_thetas=(1.5, 1.0, 1.0, 3.0),
        cuda_model="lotka_volterra",
    ),
    "protein_transduction": OdeModel(
        name="protein_transduction",
        f_vec=protein_transduction_f_vec,
        D=5,
        D_thetas=6,
        theta_names=("k1", "k2", "k3", "k4", "V", "Km"),
        # Vyshemirsky & Girolami (2008) model-1 generating values
        true_thetas=(0.07, 0.6, 0.05, 0.3, 0.017, 0.3),
        cuda_model="protein_transduction",
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
