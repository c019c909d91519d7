"""Linear-algebra helpers (counterpart of magi_v2_tpu/ops/linalg.py):
symmetric pseudo-inverse, PSD square root, band truncation, PSD solve.

Setup-time math: callers pass float64 tensors (float32 eigh of the stiff
kernel matrices is garbage).
"""

from __future__ import annotations

import torch


def _sym_eigh(a):
    return torch.linalg.eigh((a + a.transpose(-1, -2)) / 2.0)


def sym_pinv(a, rcond: float | None = None):
    """Moore-Penrose pseudo-inverse of a symmetric matrix via eigh
    (numpy.linalg.pinv semantics for symmetric input)."""
    if rcond is None:
        rcond = a.shape[-1] * torch.finfo(a.dtype).eps
    w, v = _sym_eigh(a)
    cutoff = rcond * torch.amax(torch.abs(w), dim=-1, keepdim=True)
    keep = torch.abs(w) > cutoff
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    return (v * w_inv[..., None, :]) @ v.transpose(-1, -2)


def band_part(a, num_lower: int, num_upper: int):
    """Zero out everything outside a band (tf.linalg.band_part semantics).
    Negative num keeps the full triangle."""
    n, m = a.shape[-2], a.shape[-1]
    i = torch.arange(n, device=a.device)[:, None]
    j = torch.arange(m, device=a.device)[None, :]
    in_band = torch.ones((n, m), dtype=torch.bool, device=a.device)
    if num_lower >= 0:
        in_band &= (i - j) <= num_lower
    if num_upper >= 0:
        in_band &= (j - i) <= num_upper
    return torch.where(in_band, a, torch.zeros_like(a))


def sym_sqrt(a, floor_ratio: float = 0.0):
    """Symmetric PSD square root via eigh; negative eigenvalues clamped to 0."""
    w, v = _sym_eigh(a)
    w = torch.maximum(w, floor_ratio * torch.amax(w, dim=-1, keepdim=True))
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[..., None, :]) @ v.transpose(-1, -2)


def solve_psd(a, b, jitter: float = 0.0):
    """Solve a x = b for symmetric PSD a via Cholesky."""
    if jitter:
        a = a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol = torch.linalg.cholesky(a)
    if b.dim() == a.dim() - 1:
        return torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.cholesky_solve(b, chol)
