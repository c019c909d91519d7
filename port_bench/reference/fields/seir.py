"""The reduced SEIR field (Yang, Wong & Kou, PNAS 2021): X = (E, I, R),
S = 1 - E - I - R, thetas = (beta, gamma, sigma).

    dE/dt = beta S I - sigma E
    dI/dt = sigma E - gamma I
    dR/dt = gamma I
"""

import torch


def f_vec(t, X, thetas):
    """f(t (N, 1), X (..., N, 3), thetas (..., 3)) -> (..., N, 3)."""
    E, I, R = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    beta, gamma, sigma = (thetas[..., None, i:i + 1] for i in range(3))
    S = 1.0 - E - I - R
    return torch.cat([beta * S * I - sigma * E, sigma * E - gamma * I,
                      gamma * I], dim=-1)
