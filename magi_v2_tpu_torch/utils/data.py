"""Dataset utilities (counterpart of magi_v2_tpu/utils/data.py): the
reference SEIR CSV loader and the ODE simulator.

``simulate_ode`` integrates with RK4 at fixed substeps in float64 on the
CPU, then adds iid Gaussian noise from ``numpy.random.default_rng(seed)``:
the same integrator and the same noise draws as the JAX version, so both
give the same data. The reference's SEIR CSVs (columns t, {S,E,I,R}_obs,
{S,E,I,R}_true; 10001 rows over t in [0, 10]) are thinned as its
vignette does (vignette.ipynb cell 5).
"""

from __future__ import annotations

import csv

import numpy as np
import torch


def load_seir_csv(
    path: str | None = None,
    d_obs: int = 20,
    t_max: float = 4.0,
    comp_obs=(True, True, True),
):
    """Load and thin a reference SEIR CSV like vignette.ipynb cell 5: keep
    t <= t_max, then d_obs observations per unit time. Returns (ts_obs
    (N,), X_obs (N, 3) with NaN for unobserved components, raw dict with
    the true trajectories for evaluation). ``path`` is the CSV's, e.g. the
    reference repository's ``data/SEIR_seed=0.csv``; the port assumes no
    location for it."""
    if path is None:
        raise ValueError("load_seir_csv needs the CSV's path, e.g. the "
                         "reference repository's data/SEIR_seed=0.csv")
    with open(path) as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = np.array([[float(v) for v in row] for row in reader])
    col = {name: i for i, name in enumerate(header)}

    t = rows[:, col["t"]]
    keep = t <= t_max
    rows = rows[keep]
    t = t[keep]

    stride = int((rows.shape[0] - 1) / (d_obs * t_max))
    obs = rows[::stride]
    ts_obs = obs[:, col["t"]].astype(np.float64)
    X_obs = obs[:, [col["E_obs"], col["I_obs"], col["R_obs"]]].astype(
        np.float64)
    X_obs[X_obs < 0.0] = 0.0
    for i, is_obs in enumerate(comp_obs):
        if not is_obs:
            X_obs[:, i] = np.nan

    raw = {
        "t": t,
        "X_true": rows[:, [col["E_true"], col["I_true"], col["R_true"]]],
    }
    return ts_obs, X_obs, raw


def simulate_ode(
    f_vec,
    x0: np.ndarray,
    thetas: np.ndarray,
    t_max: float,
    n_obs: int,
    noise_sd,
    seed: int = 0,
    substeps: int = 100,
    comp_obs=None,
):
    """Integrate dX/dt = f_vec(t, X, thetas) with RK4 and add noise.

    Returns (ts (n_obs,), X_obs (n_obs, D) noisy [NaN for unobserved
    components], X_true).
    """
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
    if comp_obs is not None:
        for d, is_obs in enumerate(comp_obs):
            if not is_obs:
                X_obs[:, d] = np.nan
    return ts, X_obs, X_true
