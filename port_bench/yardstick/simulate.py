"""The benchmark's observations: RK4 integration plus Gaussian noise.

Copied from magi_v2_tpu_torch/utils/data.py:simulate_ode as it stood when
the benchmark was defined: the same steps in the same order, so the same
field, start, parameters and seed give the same arrays. The field is a
plain one from ``port_bench/reference/fields``; the port gets only the
arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def simulate_ode(f_vec, x0, thetas, t_max: float, n_obs: int, noise_sd,
                 seed: int = 0, substeps: int = 100):
    """Integrate dX/dt = f_vec(t, X, thetas) with RK4 and add noise drawn
    from ``np.random.default_rng(seed)``. Returns (ts (n_obs,), X_obs
    (n_obs, D) noisy, X_true)."""
    x0 = np.asarray(x0, np.float64)
    D = x0.shape[0]
    ts = np.linspace(0.0, t_max, n_obs)
    h = (t_max / (n_obs - 1)) / substeps
    th = torch.as_tensor(np.asarray(thetas, np.float64))

    def f(t, x):
        tt = torch.full((1, 1), t, dtype=torch.float64)
        return f_vec(tt, x[None, :], th)[0]

    x = torch.as_tensor(x0)
    rows = [x0]
    with torch.no_grad():
        for t0 in ts[:-1]:
            for i in range(substeps):
                t = t0 + h * i
                k1 = f(t, x)
                k2 = f(t + h / 2, x + h / 2 * k1)
                k3 = f(t + h / 2, x + h / 2 * k2)
                k4 = f(t + h, x + h * k3)
                x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            rows.append(x.numpy().copy())
    X_true = np.stack(rows, axis=0)

    rng = np.random.default_rng(seed)
    noise_sd = np.broadcast_to(np.asarray(noise_sd, np.float64), (D,))
    X_obs = X_true + rng.standard_normal(X_true.shape) * noise_sd
    return ts, X_obs, X_true
