"""The tempered MAGI log-posterior in PyTorch (counterpart of
magi_v2_tpu/posterior.py).

    log p ∝ beta_temp * [ -1/2 ( (1/beta)(t1 + t2) + t3 + t4 )
                          + logJac(sigma^2) + logJac(theta) ]

``log_posterior_given_t1`` is the plain reference of the fused sampler
target: the hand-written kernels of ops/manifold.py compute the same value
and its gradient, and the tests hold them against it. ``log_posterior``
(with ``make_log_posterior`` and ``make_value_and_grad``) is the
user-facing absolute log density in natural coordinates (X, sigma_pre,
theta_pre): setup-side, plain PyTorch, meant for float64. Quadratic forms use
the factored ||R x||^2 forms and the ``RefPoint`` relative energies, which
keep float32 energies accurate (see the JAX module for the measurements).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class PosteriorData(NamedTuple):
    """Static (per-fit) tensors consumed by the log-posterior."""

    I: torch.Tensor            # (N_I, 1)
    C_invs: torch.Tensor       # (D, N_I, N_I)
    m_ds: torch.Tensor         # (D, N_I, N_I)
    K_invs: torch.Tensor       # (D, N_I, N_I)
    mu_ds: torch.Tensor        # (D,)
    beta: torch.Tensor         # scalar
    N_ds: torch.Tensor         # (D,)
    not_nan_idxs: torch.Tensor  # (M,) flat indices into X.ravel()
    not_nan_cols: torch.Tensor  # (M,)
    y_observed: torch.Tensor   # (M,)
    sigma_sqs_LB: torch.Tensor  # (D,)
    C_inv_sqrts: torch.Tensor = None   # (D, N_I, N_I) R = C^{-1/2}
    K_inv_sqrts: torch.Tensor = None   # (D, N_I, N_I) S = K^{-1/2}


class RefPoint(NamedTuple):
    """Zero point for relative energy evaluation (see the JAX RefPoint)."""

    x0: torch.Tensor    # (N, D)
    a0: torch.Tensor    # (D, N)  R (x0 - mu)
    f0: torch.Tensor    # (D, N)  f(I, x0, theta0)^T
    mx0: torch.Tensor   # (D, N)  m (x0 - mu)
    s0: torch.Tensor    # (D, N)  S (f0 - mx0)


def _f64(a, device):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def make_ref_point(I, x0, mu_ds, thetas0, f_vec, R64, S64, m64, dtype, *,
                   device):
    """Build a RefPoint in float64 on ``device`` and cast to ``dtype``."""
    x0, mu = _f64(x0, device), _f64(mu_ds, device)
    R64, S64, m64 = _f64(R64, device), _f64(S64, device), _f64(m64, device)
    xc = (x0 - mu[None, :]).T
    a0 = torch.einsum("dnm,dm->dn", R64, xc)
    f0 = f_vec(_f64(I, device), x0, _f64(thetas0, device)).T
    mx0 = torch.einsum("dnm,dm->dn", m64, xc)
    s0 = torch.einsum("dnm,dm->dn", S64, f0 - mx0)
    c = lambda a: a.to(dtype).contiguous()
    return RefPoint(x0=c(x0), a0=c(a0), f0=c(f0), mx0=c(mx0), s0=c(s0))


def make_posterior_data(
    I, C_invs, m_ds, K_invs, mu_ds, beta, obs_index, sigma_sqs_LB, dtype,
    C_inv_sqrts=None, K_inv_sqrts=None, *, device,
) -> PosteriorData:
    """Assemble PosteriorData on ``device`` in ``dtype``."""
    asd = lambda x: _f64(x, device).to(dtype)
    idx = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.long,
                                    device=device)
    return PosteriorData(
        I=asd(I),
        C_invs=asd(C_invs),
        m_ds=asd(m_ds),
        K_invs=asd(K_invs),
        mu_ds=asd(mu_ds),
        beta=asd(beta),
        N_ds=asd(obs_index.N_ds),
        not_nan_idxs=idx(obs_index.not_nan_idxs),
        not_nan_cols=idx(obs_index.not_nan_cols),
        y_observed=asd(obs_index.y_observed),
        sigma_sqs_LB=asd(sigma_sqs_LB),
        C_inv_sqrts=None if C_inv_sqrts is None else asd(C_inv_sqrts),
        K_inv_sqrts=None if K_inv_sqrts is None else asd(K_inv_sqrts),
    )


class BandedPosteriorData(NamedTuple):
    """PosteriorData with the operators in block-banded storage
    (D, nb, nw, 128, 128) (ops/banded.py), for the O(N_I*b) large-grid
    target (storage="banded"). ``C_blocks``, the tiles of C^{-1} itself,
    serves ``log_posterior``'s raw t1 = x'C^{-1}x (the JAX type holds it
    first; here it is last, as the port builds the type by keyword)."""

    I: torch.Tensor
    m_blocks: torch.Tensor     # (D, nb, nw, T, T)
    K_blocks: torch.Tensor
    mu_ds: torch.Tensor
    beta: torch.Tensor
    N_ds: torch.Tensor
    not_nan_idxs: torch.Tensor
    not_nan_cols: torch.Tensor
    y_observed: torch.Tensor
    sigma_sqs_LB: torch.Tensor
    # band truncations of the float64 square roots R = C^{-1/2},
    # S = K^{-1/2}: t1/t2 evaluate as ||band(R) x||^2, ||band(S) r||^2
    C_sqrt_blocks: torch.Tensor = None
    K_sqrt_blocks: torch.Tensor = None
    C_blocks: torch.Tensor = None


def to_banded_data(data: PosteriorData, bandwidth: int, C_inv_sqrts_f64=None,
                   K_inv_sqrts_f64=None) -> BandedPosteriorData:
    """Dense PosteriorData -> block-banded storage at half-bandwidth b.

    With the float64 square roots of the (band-truncated) operators, their
    band truncations are stored too, so the quadratic forms evaluate in the
    factored float32-safe form (the JAX function says why a banded Cholesky
    of the truncated operators is not an option)."""
    from magi_v2_tpu_torch.ops.banded import banded_to_blocks, dense_to_banded

    def to_blocks(A, b=bandwidth):
        return banded_to_blocks(dense_to_banded(A, b))

    def factor_blocks(S_f64):
        # float64 band of the factor (the band clamped to the matrix, as the
        # JAX package's host conversion does), cast after the gather
        if S_f64 is None:
            return None
        S_f64 = _f64(S_f64, data.I.device)
        return to_blocks(S_f64, min(bandwidth, S_f64.shape[-1] - 1)).to(
            data.I.dtype)

    return BandedPosteriorData(
        I=data.I,
        m_blocks=to_blocks(data.m_ds),
        K_blocks=to_blocks(data.K_invs),
        mu_ds=data.mu_ds,
        beta=data.beta,
        N_ds=data.N_ds,
        not_nan_idxs=data.not_nan_idxs,
        not_nan_cols=data.not_nan_cols,
        y_observed=data.y_observed,
        sigma_sqs_LB=data.sigma_sqs_LB,
        C_sqrt_blocks=factor_blocks(C_inv_sqrts_f64),
        K_sqrt_blocks=factor_blocks(K_inv_sqrts_f64),
        C_blocks=to_blocks(data.C_invs),
    )


def softplus(x):
    return F.softplus(x)


def softplus_inverse(y):
    """log(exp(y) - 1), stable for small and large y."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


def _banded_matvec(tiles, x):
    """The plain block-banded product of symmetric-window tiles
    (D, nb, nw, T, T) with x (..., D, N): PyTorch's own ops, differentiable
    by autograd, on any device."""
    from magi_v2_tpu_torch.ops.banded import block_banded_matvec_plain

    hw = (tiles.shape[-3] - 1) // 2
    return block_banded_matvec_plain(tiles, x, hw, hw)


def log_posterior_given_t1(
    data: PosteriorData,
    f_vec: Callable,
    X,
    sigma_sqs_pre,
    thetas_pre,
    beta_temp,
    t1,
    ref: RefPoint = None,
    delta=None,
):
    """Tempered log-posterior with the GP-prior quadratic ``t1`` supplied,
    for dense ``PosteriorData`` or ``BandedPosteriorData`` (through the
    plain block-banded products of ops/banded.py). Leading batch axes are
    allowed: X (..., N, D), sigma_sqs_pre (..., D), thetas_pre
    (..., D_thetas), t1 (...).

    With ``ref``, t2 is evaluated relative to the reference point and the
    caller supplies a relative t1; ``delta`` (..., N, D) is x - x0 computed
    in the caller's own coordinates."""
    sigma_sqs = softplus(sigma_sqs_pre) + data.sigma_sqs_LB
    thetas = softplus(thetas_pre)
    log_jac_sigma = torch.sum(F.logsigmoid(sigma_sqs_pre), dim=-1)
    log_jac_theta = torch.sum(F.logsigmoid(thetas_pre), dim=-1)
    if isinstance(beta_temp, torch.Tensor):
        beta_temp = beta_temp.detach()

    f_vals = f_vec(data.I, X, thetas).transpose(-1, -2)       # (..., D, N)
    banded = isinstance(data, BandedPosteriorData)
    if ref is not None:
        delta = (X - ref.x0) if delta is None else delta
        delta = delta.transpose(-1, -2)
        if banded:
            if data.K_sqrt_blocks is None:
                raise ValueError("relative t2 needs the banded sqrt factors")
            dr = (f_vals - ref.f0) - _banded_matvec(data.m_blocks, delta)
            Ds = _banded_matvec(data.K_sqrt_blocks, dr)
        else:
            if data.K_inv_sqrts is None:
                raise ValueError("relative t2 needs K_inv_sqrts")
            dr = (f_vals - ref.f0) - torch.einsum("dnm,...dm->...dn",
                                                  data.m_ds, delta)
            Ds = torch.einsum("dnm,...dm->...dn", data.K_inv_sqrts, dr)
        t2 = torch.sum(Ds * (Ds + 2.0 * ref.s0), dim=(-2, -1))
    elif banded:
        X_cent = (X - data.mu_ds).transpose(-1, -2)
        resid = f_vals - _banded_matvec(data.m_blocks, X_cent)
        if data.K_sqrt_blocks is not None:
            t2 = torch.sum(_banded_matvec(data.K_sqrt_blocks, resid) ** 2,
                           dim=(-2, -1))
        else:
            t2 = torch.sum(resid * _banded_matvec(data.K_blocks, resid),
                           dim=(-2, -1))
    else:
        X_cent = (X - data.mu_ds).transpose(-1, -2)
        resid = f_vals - torch.einsum("dnm,...dm->...dn", data.m_ds, X_cent)
        if data.K_inv_sqrts is not None:
            t2 = torch.sum(
                torch.einsum("dnm,...dm->...dn", data.K_inv_sqrts, resid) ** 2,
                dim=(-2, -1),
            )
        else:
            t2 = torch.einsum("...dn,dnm,...dm->...", resid, data.K_invs, resid)

    t3 = torch.sum(data.N_ds * torch.log(2.0 * math.pi * sigma_sqs), dim=-1)
    X_obs = X.reshape(X.shape[:-2] + (-1,))[..., data.not_nan_idxs]
    inv_var = (1.0 / sigma_sqs)[..., data.not_nan_cols]
    t4 = torch.sum((X_obs - data.y_observed) ** 2 * inv_var, dim=-1)
    return beta_temp * (
        -0.5 * ((t1 + t2) / data.beta + t3 + t4) + log_jac_sigma + log_jac_theta
    )


def log_posterior(data, f_vec: Callable, X, sigma_sqs_pre, thetas_pre,
                  beta_temp):
    """The tempered log-posterior (reference magi_v2.py:308-348) at X
    (..., N_I, D), sigma_sqs_pre (..., D), thetas_pre (..., D_thetas):
    t1 = sum_d ||x_d - mu_d||^2 in C_d^{-1}, through the factored
    ||R x||^2 form where ``data`` holds the square roots (dense
    ``C_inv_sqrts`` or banded ``C_sqrt_blocks``), else the raw x'C^{-1}x;
    t2 to t4 as ``log_posterior_given_t1``. The banded products are the
    plain ones of ops/banded.py. ``beta_temp`` is not differentiated."""
    X_cent = (X - data.mu_ds).transpose(-1, -2)               # (..., D, N)
    if isinstance(data, BandedPosteriorData):
        if data.C_sqrt_blocks is not None:
            t1 = torch.sum(_banded_matvec(data.C_sqrt_blocks, X_cent) ** 2,
                           dim=(-2, -1))
        elif data.C_blocks is not None:
            t1 = torch.sum(X_cent * _banded_matvec(data.C_blocks, X_cent),
                           dim=(-2, -1))
        else:
            raise ValueError("banded log_posterior needs C_sqrt_blocks or "
                             "C_blocks (to_banded_data fills both)")
    elif data.C_inv_sqrts is not None:
        t1 = torch.sum(
            torch.einsum("dnm,...dm->...dn", data.C_inv_sqrts, X_cent) ** 2,
            dim=(-2, -1))
    else:
        t1 = torch.einsum("...dn,dnm,...dm->...", X_cent, data.C_invs, X_cent)
    return log_posterior_given_t1(data, f_vec, X, sigma_sqs_pre, thetas_pre,
                                  beta_temp, t1)


def make_log_posterior(data, f_vec: Callable):
    """lp(X, sigma_sqs_pre, thetas_pre, beta_temp) over the static data."""

    def lp(X, sigma_sqs_pre, thetas_pre, beta_temp):
        return log_posterior(data, f_vec, X, sigma_sqs_pre, thetas_pre,
                             beta_temp)

    return lp


def make_value_and_grad(data, f_vec: Callable):
    """(X, sigma_sqs_pre, thetas_pre, beta_temp) -> (lp, (dX, dsigma_pre,
    dtheta_pre)), as ``jax.value_and_grad(lp, argnums=(0, 1, 2))``; the
    arguments are tensors on the data's device. With leading batch axes
    each element's gradient is its own lp's."""
    lp = make_log_posterior(data, f_vec)

    def value_and_grad(X, sigma_sqs_pre, thetas_pre, beta_temp):
        args = [a.detach().requires_grad_(True)
                for a in (X, sigma_sqs_pre, thetas_pre)]
        with torch.enable_grad():
            value = lp(*args, beta_temp)
            grads = torch.autograd.grad(value.sum(), args)
        return value.detach(), grads

    return value_and_grad
