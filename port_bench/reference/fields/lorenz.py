"""The Lorenz field (Lorenz, J. Atmos. Sci. 20:130, 1963): X = (x, y, z),
thetas = (sigma, rho, beta).

    dx/dt = sigma (y - x)
    dy/dt = x (rho - z) - y
    dz/dt = x y - beta z
"""

import torch


def f_vec(t, X, thetas):
    """f(t (N, 1), X (..., N, 3), thetas (..., 3)) -> (..., N, 3)."""
    x, y, z = X[..., 0:1], X[..., 1:2], X[..., 2:3]
    sigma, rho, beta = (thetas[..., None, i:i + 1] for i in range(3))
    return torch.cat([sigma * (y - x), x * (rho - z) - y, x * y - beta * z],
                     dim=-1)
