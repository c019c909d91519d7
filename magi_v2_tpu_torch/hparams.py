"""GP hyperparameter fitting (counterpart of magi_v2_tpu/hparams.py):
Matern (phi1, phi2) + noise sigma^2 MAP with Fourier-informed priors,
optimized in softplus pre-space by Adam (the default) or L-BFGS.

``torch.optim.Adam(eps=1e-7)`` performs the same update as the JAX
package's ``optax.adam(lr, eps=1e-7)``:
p -= lr * m_hat / (sqrt(v_hat) + eps). ``optimizer="lbfgs"`` runs
``ops/lbfgs.py:lbfgs_minimize``, which takes the JAX minimizer's decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from magi_v2_tpu_torch.ops.kernels import (
    matern_gram,
    matern_gram_uniform,
    uniform_spacing,
)
from magi_v2_tpu_torch.init import adam_minimize
from magi_v2_tpu_torch.ops.lbfgs import lbfgs_minimize
from magi_v2_tpu_torch.posterior import softplus_inverse
from magi_v2_tpu_torch.utils.profiling import untimed


class FourierPrior(NamedTuple):
    mu_ds: np.ndarray
    mu_phi2s: np.ndarray
    sd_phi2s: np.ndarray


def fourier_prior(X_filled: np.ndarray, t_range: float = 1.0) -> FourierPrior:
    """Spectral-mass-weighted mean frequency -> phi2 prior; the same
    resolution-gated rule as magi_v2_tpu.hparams.fourier_prior (see its
    docstring for why)."""
    X_filled = np.asarray(X_filled)
    t_range = float(t_range) if t_range else 1.0
    n = X_filled.shape[0]
    spacing = t_range / max(n - 1, 1)
    mu_ds, mu_phi2s, sd_phi2s = [], [], []
    for d in range(X_filled.shape[1]):
        zmod = np.abs(np.fft.fft(X_filled[:, d]))
        zmod_eff_sq = zmod[1: (len(zmod) - 1) // 2 + 1] ** 2
        idxs = np.linspace(1, len(zmod_eff_sq), len(zmod_eff_sq))
        freq = np.sum(idxs * zmod_eff_sq) / np.sum(zmod_eff_sq)
        mu_ref = 0.5 / freq
        if mu_ref >= 2.0 * spacing:
            mu_phi2 = mu_ref
            sd = (1.0 - mu_ref) / 3.0 if mu_ref < 1.0 else mu_ref / 2.0
        else:
            mu_phi2 = 0.25 * t_range / freq
            sd = mu_phi2 / 2.0
        mu_ds.append(X_filled[:, d].mean())
        mu_phi2s.append(mu_phi2)
        sd_phi2s.append(sd)
    return FourierPrior(np.array(mu_ds), np.array(mu_phi2s), np.array(sd_phi2s))


def make_hparam_objective(I, X_filled, prior: FourierPrior, nu: float,
                          jitter: float = 1e-6, *, device):
    """Negative MAP objective over softplus pre-space (phi1, sigma^2, phi2),
    all D components batched: y_d ~ N(mu_d, phi1_d Matern_{phi2_d} +
    sigma_d^2 I) plus TruncatedNormal priors (unnormalized)."""
    I_np = np.asarray(I, np.float64).reshape(-1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    I_t = t(I_np)
    X = t(X_filled)
    n = I_np.shape[0]
    mu_ds, mu_phi2s, sd_phi2s = t(prior.mu_ds), t(prior.mu_phi2s), t(prior.sd_phi2s)
    sigma_sq_loc = t((np.asarray(X_filled).std(axis=0) * 0.1) ** 2)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    h = uniform_spacing(I_np)
    y = (X - mu_ds[None, :]).T                       # (D, n)

    def tn(x, loc, scale):
        return -0.5 * ((x - loc) / scale) ** 2

    def neg_map(params):
        phi1s = F.softplus(params["phi1_pre"])
        phi2s = F.softplus(params["phi2_pre"])
        sigma_sqs = F.softplus(params["sigma_sq_pre"])
        if h is not None:
            gram = matern_gram_uniform(n, h, phi1s, phi2s, nu)
        else:
            gram = matern_gram(I_t, phi1s, phi2s, nu)
        cov = gram + (sigma_sqs + jitter)[:, None, None] * eye
        chol = torch.linalg.cholesky(cov)
        alpha = torch.cholesky_solve(y[..., None], chol)[..., 0]
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1
        )
        lls = -0.5 * (torch.sum(y * alpha, dim=-1) + logdet
                      + n * np.log(2.0 * np.pi))
        lp = (
            torch.sum(tn(phi1s, 1e-4, 1000.0))
            + torch.sum(tn(sigma_sqs, sigma_sq_loc, 1000.0))
            + torch.sum(tn(phi2s, mu_phi2s, sd_phi2s))
        )
        return -(torch.sum(lls) + lp)

    init_params = {
        "phi1_pre": softplus_inverse(t(np.asarray(X_filled).std(axis=0) ** 2)),
        "phi2_pre": softplus_inverse(mu_phi2s),
        "sigma_sq_pre": softplus_inverse(sigma_sq_loc),
    }
    return neg_map, init_params


def fit_kernel_hparams(
    I,
    X_filled,
    nu: float = 2.01,
    learning_rate: float = 0.01,
    num_iters: int = 1000,
    cholesky_jitter: float = 1e-6,
    optimizer: str = "adam",
    *,
    device,
    timer=untimed,
):
    """Fit (phi1s, phi2s, sigma_sqs) for each column of X_filled, in
    float64 on ``device``: Adam at ``learning_rate`` for ``num_iters``
    steps, or with ``optimizer="lbfgs"`` L-BFGS for at most
    min(num_iters, 200) iterations to a gradient sup-norm of 1e-5 (the
    objective's gradient is O(n) nats; ``learning_rate`` is then unused).
    Returns host NumPy arrays like the JAX version; the optimizer counts
    its steps in ``timer`` (``utils.profiling.PhaseTimer``)."""
    if optimizer not in ("adam", "lbfgs"):
        raise ValueError(
            f"optimizer must be 'adam' or 'lbfgs', got {optimizer!r}"
        )
    _I = np.asarray(I).reshape(-1)
    prior = fourier_prior(X_filled, t_range=float(_I[-1] - _I[0]))
    neg_map, params = make_hparam_objective(
        I, X_filled, prior, nu, jitter=cholesky_jitter, device=device
    )
    if optimizer == "lbfgs":
        res = lbfgs_minimize(neg_map, params,
                             num_iters=min(num_iters, 200), tol=1e-5,
                             timer=timer)
        params, losses = res.params, res.losses
    else:
        params, losses = adam_minimize(neg_map, params, learning_rate,
                                       num_iters, timer)
    out = lambda p: F.softplus(p).cpu().numpy()
    return {
        "phi1s": out(params["phi1_pre"]),
        "phi2s": out(params["phi2_pre"]),
        "sigma_sqs": out(params["sigma_sq_pre"]),
        "losses": losses.cpu().numpy(),
        "prior": prior,
    }
