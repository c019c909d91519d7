"""Initialization of theta (and unobserved trajectories) before sampling
(counterpart of magi_v2_tpu/init.py), both branches:

- fully observed: minimize the manifold-constraint term t2 over theta with
  X fixed at the interpolated trajectories;
- partially observed: point-estimate (X_unobs, theta) jointly by gradient
  matching against central differences on the uniform grid, from several
  starts, the winner chosen by the observed-manifold score.

Theta goes through softplus (theta > 0, the sampler's support); Adam with
eps=1e-7 (the JAX package's optax settings) minimizes.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from magi_v2_tpu_torch.utils.profiling import untimed


def adam_minimize(loss_fn, params: dict, learning_rate: float, num_iters: int,
                  timer=untimed):
    """``num_iters`` Adam steps (eps=1e-7, the update of
    ``optax.adam(lr, eps=1e-7)``) on a dict of tensors; returns
    (params, losses (num_iters, ...) tensor). ``loss_fn`` may return a
    tensor of independent losses (one per start of a batch whose starts
    share no parameter): Adam minimizes their sum, which, Adam being
    elementwise, is each start's own Adam, and each is recorded. The loop
    reads nothing back from the device. Each step taken adds one to
    ``timer``'s counter "adam_steps" (``utils.profiling.PhaseTimer``)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate, eps=1e-7)
    losses = None
    for i in range(num_iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.sum().backward()
        opt.step()
        timer.count("adam_steps")
        if losses is None:
            losses = loss.new_empty((num_iters,) + loss.shape)
        losses[i] = loss.detach()
    return {k: v.detach() for k, v in params.items()}, losses


def fit_theta_fully_observed(
    f_vec: Callable,
    I,
    Xhat_init,
    mu_ds,
    m_ds,
    K_invs,
    D_thetas: int,
    learning_rate: float = 0.01,
    num_iters: int = 10000,
    timer=untimed,
):
    """theta MAP with X fixed: minimizes
    sum_d ||f_d(I, Xhat, theta) - m_d (x_d - mu_d)||^2_{K_d^{-1}}.
    Tensor inputs (float64, on the device to run on); returns
    (thetas, losses) as host NumPy arrays like the JAX version; Adam's
    steps are counted in ``timer``."""
    X_cent = (Xhat_init - mu_ds[None, :]).T                     # (D, N)
    m_prod = torch.einsum("dnm,dm->dn", m_ds, X_cent)

    def loss(p):
        resid = f_vec(I, Xhat_init, F.softplus(p["th"])).T - m_prod
        return torch.einsum("dn,dnm,dm->", resid, K_invs, resid)

    theta0 = torch.full((D_thetas,), math.log(math.expm1(1.0)),
                        dtype=Xhat_init.dtype, device=Xhat_init.device)
    p, losses = adam_minimize(loss, {"th": theta0}, learning_rate, num_iters,
                              timer)
    return F.softplus(p["th"]).cpu().numpy(), losses.cpu().numpy()


def gradient_matching_starts(num_starts: int, N_I: int, D_unobserved: int,
                             D_thetas: int, X_obs_smoothed, seed: int = 0):
    """The starts of ``fit_unobserved_gradient_matching``: X_unobs0
    (num_starts, N_I, D_unobserved) from the observed components' moments
    and theta_pre0 (num_starts, D_thetas), start 0 at theta = ones, the
    rest wide normals; drawn from a ``torch.Generator`` seeded by ``seed``
    on the CPU (the JAX package draws from ``PRNGKey(seed)``: the same
    distributions, other numbers)."""
    X = np.asarray(X_obs_smoothed.cpu() if isinstance(X_obs_smoothed,
                                                      torch.Tensor)
                   else X_obs_smoothed, np.float64)
    mu_init = float(X.mean())
    sd_init = float(np.sqrt((X.std(axis=0) ** 2).mean()))
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    X_unobs0 = mu_init + sd_init * torch.randn(
        (num_starts, N_I, D_unobserved), generator=g, dtype=f64)
    th_pre0 = torch.cat([
        torch.full((1, D_thetas), math.log(math.expm1(1.0)), dtype=f64),
        1.5 * torch.randn((num_starts - 1, D_thetas), generator=g, dtype=f64),
    ])
    return X_unobs0, th_pre0


def run_gradient_matching(f_vec, I, X_obs_smoothed, proper_order, X_unobs0,
                          th_pre0, learning_rate: float, num_iters: int,
                          observed_components=None, m_ds_obs=None,
                          K_invs_obs=None, mu_obs=None, timer=untimed):
    """Every start of the gradient-matching fit at once, on a leading
    axis: one Adam over the stacked (X_unobs, theta_pre) with the losses
    summed over starts. Returns (X_unobs (S, N, D_unobs), thetas (S, P),
    losses (num_iters, S), scores (S,)) as tensors; a start's score is its
    observed-manifold score sum_d ||f_d - m_d (x_d - mu_d)||^2_{K_d^{-1}}
    over the observed components when their operators are given, else its
    final gradient-matching loss. Adam's steps are counted in ``timer``."""
    dev, dt = X_obs_smoothed.device, X_obs_smoothed.dtype
    order = torch.as_tensor(np.asarray(proper_order), dtype=torch.long,
                            device=dev)
    h = I[1, 0] - I[0, 0]

    def x_full_of(X_unobs):
        X_obs = X_obs_smoothed.expand(X_unobs.shape[:1]
                                      + X_obs_smoothed.shape)
        return torch.cat([X_obs, X_unobs], dim=-1)[..., order]

    def loss(p):
        X_full = x_full_of(p["X_unobs"])
        f_vals = f_vec(I, X_full, F.softplus(p["th_pre"]))
        f_diff = (X_full[:, 2:, :] - X_full[:, :-2, :]) / (2.0 * h)
        return torch.sum((f_vals[:, 1:-1] - f_diff) ** 2, dim=(1, 2))

    start = {"X_unobs": X_unobs0.to(device=dev, dtype=dt),
             "th_pre": th_pre0.to(device=dev, dtype=dt)}
    p, losses = adam_minimize(loss, start, learning_rate, num_iters, timer)
    with torch.no_grad():
        if m_ds_obs is not None and K_invs_obs is not None \
                and mu_obs is not None and observed_components is not None:
            cols = torch.as_tensor(np.asarray(observed_components),
                                   dtype=torch.long, device=dev)
            m_prod = torch.einsum("dnm,dm->dn", m_ds_obs,
                                  (X_obs_smoothed - mu_obs[None, :]).T)
            X_full = x_full_of(p["X_unobs"])
            f_vals = f_vec(I, X_full, F.softplus(p["th_pre"]))
            resid = f_vals[..., cols].transpose(1, 2) - m_prod
            scores = torch.einsum("sdn,dnm,sdm->s", resid, K_invs_obs, resid)
        else:
            scores = loss(p)
    return p["X_unobs"], F.softplus(p["th_pre"]), losses, scores


def fit_unobserved_gradient_matching(
    f_vec: Callable,
    I,
    X_obs_smoothed,
    proper_order,
    D_unobserved: int,
    D_thetas: int,
    seed: int = 0,
    learning_rate: float = 0.01,
    num_iters: int = 10000,
    num_starts: int = 8,
    observed_components=None,
    m_ds_obs=None,
    K_invs_obs=None,
    mu_obs=None,
    starts=None,
    timer=untimed,
):
    """Joint (X_unobs, theta) gradient-matching init of a partially
    observed system (magi_v2_tpu/init.py:fit_unobserved_gradient_matching):
    ``num_starts`` Adam runs on the L2 gap between f(X_full, theta) and the
    central differences of X_full, the observed components fixed at
    ``X_obs_smoothed`` (N_I, D_observed), then the winner by the
    observed-manifold score (with ``observed_components``, ``m_ds_obs``,
    ``K_invs_obs`` (D_obs, N, N) and ``mu_obs``) or else the loss; see the
    JAX function for why. Tensor inputs (float64, on the device to run on);
    ``starts`` (X_unobs0, theta_pre0) replaces the drawn starts
    (``gradient_matching_starts``). Returns (X_unobs (N_I, D_unobserved),
    thetas, losses (num_iters,)) as host NumPy arrays, like the JAX
    version; Adam's steps are counted in ``timer``."""
    if starts is None:
        starts = gradient_matching_starts(num_starts, X_obs_smoothed.shape[0],
                                          D_unobserved, D_thetas,
                                          X_obs_smoothed, seed)
    X_unobs, thetas, losses, scores = run_gradient_matching(
        f_vec, I, X_obs_smoothed, proper_order, *starts,
        learning_rate=learning_rate, num_iters=num_iters,
        observed_components=observed_components, m_ds_obs=m_ds_obs,
        K_invs_obs=K_invs_obs, mu_obs=mu_obs, timer=timer)
    best = int(torch.argmin(scores))
    return (X_unobs[best].cpu().numpy(), thetas[best].cpu().numpy(),
            losses[:, best].cpu().numpy())
