"""Initialization of theta before sampling (counterpart of
magi_v2_tpu/init.py, fully-observed branch only).

Minimizes the manifold-constraint term t2 over theta with X fixed at the
interpolated trajectories, through softplus (theta > 0, the sampler's
support), by Adam(eps=1e-7) from theta = ones. The partially-observed
branch (gradient matching) is ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def adam_minimize(loss_fn, params: dict, learning_rate: float, num_iters: int):
    """``num_iters`` Adam steps (eps=1e-7, the update of
    ``optax.adam(lr, eps=1e-7)``) on a dict of tensors; returns
    (params, losses (num_iters,) tensor). The loop reads nothing back from
    the device."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate, eps=1e-7)
    first = next(iter(params.values()))
    losses = torch.empty(num_iters, dtype=first.dtype, device=first.device)
    for i in range(num_iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
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
):
    """theta MAP with X fixed: minimizes
    sum_d ||f_d(I, Xhat, theta) - m_d (x_d - mu_d)||^2_{K_d^{-1}}.
    Tensor inputs (float64, on the device to run on); returns
    (thetas, losses) as host NumPy arrays like the JAX version."""
    X_cent = (Xhat_init - mu_ds[None, :]).T                     # (D, N)
    m_prod = torch.einsum("dnm,dm->dn", m_ds, X_cent)

    def loss(p):
        resid = f_vec(I, Xhat_init, F.softplus(p["th"])).T - m_prod
        return torch.einsum("dn,dnm,dm->", resid, K_invs, resid)

    theta0 = torch.full((D_thetas,), math.log(math.expm1(1.0)),
                        dtype=Xhat_init.dtype, device=Xhat_init.device)
    p, losses = adam_minimize(loss, {"th": theta0}, learning_rate, num_iters)
    return F.softplus(p["th"]).cpu().numpy(), losses.cpu().numpy()
