"""Matern GP kernel matrices and their derivative cross-covariances in
PyTorch (counterpart of magi_v2_tpu/ops/kernels.py; see its docstring for
the closed forms).

Per component d: C = Kappa, 'C = dKappa/ds, C'' = d2Kappa/dsdt,
m = 'C C^{-1}, K = C'' + 'C C^{-1} 'C. Uniform grids take the Toeplitz path
(one Bessel row per component, then gathers); other grids the pairwise
build, in row tiles from ``ROW_BLOCK_THRESHOLD`` points up. Differentiable
in (phi1, phi2) through ``KvLadder``. Every function broadcasts over a
leading component axis when phi1/phi2 are (D,) tensors.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.special import gamma as _scipy_gamma

from magi_v2_tpu_torch.ops.bessel import _split_order, kv_ladder


def _amp(v: float) -> float:
    return 2.0 ** (1.0 - v) / _scipy_gamma(v)


def _param(p, device=None):
    """A hyperparameter as a tensor; Python numbers become float64 (on
    ``device``)."""
    return p if isinstance(p, torch.Tensor) else torch.tensor(
        p, dtype=torch.float64, device=device)


def _expand(p, ndim: int, device=None):
    """phi (...,) -> (..., 1, ..., 1) with ``ndim`` trailing unit axes."""
    p = _param(p, device)
    return p.reshape(p.shape + (1,) * ndim)


def _matern_parts(r, off, phi1, phi2, v: float):
    """(kappa, dkappa/ds, kappa_pp) over a block of signed differences
    ``r``; entries where ``off`` is False get the analytic diagonal limits.
    phi1/phi2 are scalars or (D,) (then the outputs gain a leading D axis).
    Shared by the direct pairwise build, the row tiles of the large-grid
    build and the Toeplitz rows."""
    mu, k = _split_order(v)
    if k < 2:
        raise ValueError("magi kernel matrices require v > 2 (reference: v=2.01)")
    A = _amp(v)
    nd = r.dim()
    phi1 = _expand(phi1, nd, r.device)
    phi2 = _expand(phi2, nd, r.device)
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


# From this many grid points the pairwise build runs in row tiles: the
# Bessel ladder holds ~15 N x N temporaries at once, the memory cliff of a
# large non-uniform grid (its O(N^2) Bessel evaluations are unavoidable
# off the Toeplitz path).
ROW_BLOCK_THRESHOLD = 1024
ROW_BLOCK = 512


def _rowblocked(fn_block, I, phi1, phi2, v: float, row_block: int):
    """``fn_block`` (a tuple of blocks) over row tiles of the pairwise
    difference matrix, each written into preallocated (..., N, N) outputs:
    peak temporary memory O(row_block * N) instead of O(N^2). The rows are
    padded to a tile multiple with strictly increasing dummy times (u > 0
    keeps the Bessel ladder finite there) and the padded rows dropped.
    Differentiable in phi1/phi2: each tile's write is recorded."""
    s = torch.as_tensor(I).reshape(-1)
    N = s.shape[0]
    nb = -(-N // row_block)
    pad = nb * row_block - N
    s_rows = s
    if pad:
        step = (s[-1] - s[0]) / max(N - 1, 1)
        extra = torch.arange(1, pad + 1, dtype=s.dtype, device=s.device)
        s_rows = torch.cat([s, s[-1] + step * extra])
    cols = torch.arange(N, device=s.device)
    outs = None
    for b in range(nb):
        lo = b * row_block
        rows = torch.arange(lo, lo + row_block, device=s.device)
        r = s_rows[lo: lo + row_block, None] - s[None, :]
        tile = fn_block(r, rows[:, None] != cols[None, :], phi1, phi2, v)
        if outs is None:
            outs = tuple(t.new_empty(t.shape[:-2] + (N, N)) for t in tile)
        n = min(row_block, N - lo)
        for out, t in zip(outs, tile):
            out[..., lo: lo + n, :] = t[..., :n, :]
    return outs


def _pairwise(I):
    s = torch.as_tensor(I).reshape(-1)
    r = s[:, None] - s[None, :]
    off = ~torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    return r, off


def matern_derivative_matrices(I, phi1, phi2, v: float = 2.01):
    """(Kappa, dKappa/ds, d2Kappa/dsdt) over grid I (pairwise build; in
    row tiles from ``ROW_BLOCK_THRESHOLD`` points up, see _rowblocked)."""
    s = torch.as_tensor(I).reshape(-1)
    if s.shape[0] >= ROW_BLOCK_THRESHOLD:
        return _rowblocked(_matern_parts, s, phi1, phi2, v, ROW_BLOCK)
    return _matern_parts(*_pairwise(s), phi1, phi2, v)


def matern_gram(I, phi1, phi2, v: float = 2.01):
    """Matern Gram matrix Kappa over grid I (pairwise build, row-tiled as
    ``matern_derivative_matrices``)."""
    return matern_derivative_matrices(I, phi1, phi2, v)[0]


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
