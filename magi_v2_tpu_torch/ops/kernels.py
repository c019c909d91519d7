"""Matern GP kernel matrices and their derivative cross-covariances in
PyTorch (counterpart of magi_v2_tpu/ops/kernels.py; see its docstring for
the closed forms).

Per component d: C = Kappa, 'C = dKappa/ds, C'' = d2Kappa/dsdt,
m = 'C C^{-1}, K = C'' + 'C C^{-1} 'C. Uniform grids take the Toeplitz path
(one Bessel row per component, then gathers); other grids the pairwise
build. Differentiable in (phi1, phi2) through ``KvLadder``. Every function
broadcasts over a leading component axis when phi1/phi2 are (D,) tensors.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.special import gamma as _scipy_gamma

from magi_v2_tpu_torch.ops.bessel import _split_order, kv_ladder


def _amp(v: float) -> float:
    return 2.0 ** (1.0 - v) / _scipy_gamma(v)


def _param(p):
    """A hyperparameter as a tensor; Python numbers become float64."""
    return p if isinstance(p, torch.Tensor) else torch.tensor(
        p, dtype=torch.float64)


def _expand(p, ndim: int):
    """phi (...,) -> (..., 1, ..., 1) with ``ndim`` trailing unit axes."""
    p = _param(p)
    return p.reshape(p.shape + (1,) * ndim)


def _matern_parts(r, off, phi1, phi2, v: float):
    """(kappa, dkappa/ds, kappa_pp) over signed differences ``r``; entries
    where ``off`` is False get the analytic diagonal limits. phi1/phi2 are
    scalars or (D,) (then the outputs gain a leading D axis)."""
    mu, k = _split_order(v)
    if k < 2:
        raise ValueError("magi kernel matrices require v > 2 (reference: v=2.01)")
    A = _amp(v)
    nd = r.dim()
    phi1 = _expand(phi1, nd)
    phi2 = _expand(phi2, nd)
    c = np.sqrt(2.0 * v) / phi2
    ell = torch.abs(torch.where(off, r, torch.ones_like(r)))
    u = c * ell
    ladder = kv_ladder(u, mu, k + 1)
    k_vm2, k_vm1, k_v = ladder[k - 2], ladder[k - 1], ladder[k]
    u_pow_v = torch.pow(u, v)
    kappa = torch.where(off, phi1 * A * u_pow_v * k_v, phi1 * torch.ones_like(u))
    dk = torch.where(off, -phi1 * A * c * torch.sign(r) * u_pow_v * k_vm1,
                     torch.zeros_like(u))
    diag_pp = v * phi1 / (phi2 ** 2 * (v - 1.0))
    kpp = torch.where(
        off,
        phi1 * A * c ** 2 * (torch.pow(u, v - 1.0) * k_vm1 - u_pow_v * k_vm2),
        diag_pp * torch.ones_like(u),
    )
    return kappa, dk, kpp


def _pairwise(I):
    s = torch.as_tensor(I).reshape(-1)
    r = s[:, None] - s[None, :]
    off = ~torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    return r, off


def matern_gram(I, phi1, phi2, v: float = 2.01):
    """Matern Gram matrix Kappa over grid I (pairwise build)."""
    r, off = _pairwise(I)
    return _matern_parts(r, off, phi1, phi2, v)[0]


def matern_derivative_matrices(I, phi1, phi2, v: float = 2.01):
    """(Kappa, dKappa/ds, d2Kappa/dsdt) over grid I (pairwise build)."""
    r, off = _pairwise(I)
    return _matern_parts(r, off, phi1, phi2, v)


def uniform_spacing(I) -> float | None:
    """Return the spacing h if grid I is uniform, else None (host check)."""
    s = np.asarray(I, dtype=np.float64).reshape(-1)
    if s.size < 2:
        return None
    d = np.diff(s)
    h = float(d.mean())
    return h if np.allclose(d, h, rtol=1e-9, atol=1e-12) else None


def matern_rows(dists, phi1, phi2, v: float = 2.01):
    """(kappa, dkappa/ds at r = +dist, kappa_pp) on nonnegative distances."""
    dists = torch.as_tensor(dists)
    return _matern_parts(dists, dists > 0, phi1, phi2, v)


def _toeplitz(row, sign_row: bool = False):
    n = row.shape[-1]
    i = torch.arange(n, device=row.device)[:, None]
    j = torch.arange(n, device=row.device)[None, :]
    out = row[..., torch.abs(i - j)]
    if sign_row:
        out = out * torch.sign(i - j).to(row.dtype)
    return out


def _grid_distances(n, h, like):
    return h * torch.arange(n, dtype=like.dtype, device=like.device)


def matern_gram_uniform(n: int, h, phi1, phi2, v: float = 2.01):
    """Matern Gram on a uniform grid of n points with spacing h (Toeplitz)."""
    phi2 = _param(phi2)
    kr, _, _ = matern_rows(_grid_distances(n, h, phi2), phi1, phi2, v)
    return _toeplitz(kr)


def matern_derivative_matrices_uniform(n: int, h, phi1, phi2, v: float = 2.01):
    """(Kappa, dKappa/ds, d2Kappa/dsdt) on a uniform grid (Toeplitz)."""
    phi2 = _param(phi2)
    kr, dr, pr = matern_rows(_grid_distances(n, h, phi2), phi1, phi2, v)
    return _toeplitz(kr), _toeplitz(dr, sign_row=True), _toeplitz(pr)


def magi_kernel_matrices(I, phi1, phi2, v: float = 2.01,
                         spacing: float | None = None):
    """(C, m, K) — the MAGI conditioning matrices, batched over components
    when phi1/phi2 are (D,). Pass ``spacing`` (from uniform_spacing) for the
    Toeplitz build; a grid that is not uniform takes the pairwise build,
    which costs ~N_I times more Bessel evaluations."""
    from magi_v2_tpu_torch.ops.linalg import sym_pinv

    I = torch.as_tensor(I).reshape(-1)
    if spacing is not None:
        kappa, dk, kpp = matern_derivative_matrices_uniform(
            I.shape[0], spacing, phi1, phi2, v
        )
    else:
        if I.shape[0] >= 256:
            warnings.warn(
                f"magi_kernel_matrices: grid of {I.shape[0]} points is not "
                "uniform, so the pairwise Bessel build runs (about N_I times "
                "the Toeplitz cost)",
                stacklevel=2,
            )
        kappa, dk, kpp = matern_derivative_matrices(I, phi1, phi2, v)
    kappa_inv = sym_pinv(kappa)
    m = dk @ kappa_inv
    K = kpp + m @ dk
    return kappa, m, K
