"""Host-side (NumPy/SciPy, float64) banded linear algebra for setup: a copy
of magi_v2_tpu/ops/banded_host.py, which cannot be imported from here
because the JAX package's __init__ imports jax.

These run once per fit on the host (banded Cholesky factorization and
storage conversions) and produce the operators the sampler applies per
leapfrog through the block-banded matvec (K3) and triangular solve (K4)
of ops/banded.py. Factorizations stay in float64: float32 factorization
of the ill-conditioned MAGI precision operators is unreliable, while
float32 application of well-conditioned factored forms is safe.

Banded storage convention throughout (matching ops/banded.py):
``band[b + k, i] = A[i, i + k]`` for k in [-b, b], zero-padded outside the
matrix. Upper-triangular operators use the same storage with the k < 0
rows zero.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def dense_to_banded_np(A: np.ndarray, bandwidth: int) -> np.ndarray:
    """NumPy twin of ops.banded.dense_to_banded for host-side f64 setup:
    (N, N) dense -> (2b+1, N), band[b + k, i] = A[i, i + k]."""
    A = np.asarray(A)
    N = A.shape[-1]
    b = int(min(bandwidth, N - 1))
    band = np.zeros((2 * b + 1, N), A.dtype)
    for k in range(-b, b + 1):
        diag = np.diagonal(A, offset=k)
        if k >= 0:
            band[b + k, : N - k] = diag
        else:
            # diag[j] = A[j - k, j]; entry i = j - k of the band row
            band[b + k, -k:] = diag
    return band


def band_to_scipy_upper(band: np.ndarray) -> np.ndarray:
    """Our symmetric banded storage -> scipy upper 'ab' form.

    scipy wants ``ab[u + i - j, j] = A[i, j]`` for the u superdiagonals of
    a symmetric matrix (cholesky_banded / solveh_banded input). Only the
    upper half of ``band`` is read.
    """
    band = np.asarray(band)
    two_b1, N = band.shape
    b = (two_b1 - 1) // 2
    ab = np.zeros((b + 1, N), band.dtype)
    for k in range(0, b + 1):
        # ab[u - k, j] = A[j - k, j] = band[b + k, j - k]
        if k == 0:
            ab[b, :] = band[b, :]
        else:
            ab[b - k, k:] = band[b + k, : N - k]
    return ab


def scipy_upper_to_band(ab: np.ndarray) -> np.ndarray:
    """scipy upper 'ab' factor (u+1, N) -> our storage (2u+1, N), lower zero."""
    ab = np.asarray(ab)
    u1, N = ab.shape
    b = u1 - 1
    band = np.zeros((2 * b + 1, N), ab.dtype)
    for k in range(0, b + 1):
        if k == 0:
            band[b, :] = ab[b, :]
        else:
            band[b + k, : N - k] = ab[b - k, k:]
    return band


def banded_cholesky_upper(band: np.ndarray, max_tries: int = 16):
    """Cholesky A = U' U of a symmetric banded matrix, escalating jitter.

    ``band`` is our symmetric storage. Band-truncated MAGI operators can be
    indefinite — truncation does not preserve PSD-ness — so on
    factorization failure a diagonal jitter relative to the mean diagonal
    is added and escalated tenfold (from 1e-12, up to ~100x the diagonal:
    the intended consumer is the Gauss-Newton PRECONDITIONER, where any
    SPD repair only affects mixing quality, never the sampled posterior).
    Do NOT use this to factor the band-truncated C^{-1}/K^{-1} that define
    the target — measured on Lorenz N_I=1025/bandsize=100, those need
    jitter beyond the diagonal scale; use band-truncated sym_sqrt factors
    instead (posterior.to_banded_data).

    Returns (U_band in our storage with zero lower rows, jitter_used).
    """
    band = np.asarray(band, np.float64)
    ab = band_to_scipy_upper(band)
    N = band.shape[1]
    scale = float(np.mean(np.abs(ab[-1, :]))) or 1.0
    jitter = 0.0
    for attempt in range(max_tries):
        ab_j = ab.copy()
        ab_j[-1, :] += jitter
        try:
            U_ab = scipy.linalg.cholesky_banded(ab_j, lower=False)
            if np.all(np.isfinite(U_ab)):
                return scipy_upper_to_band(U_ab), jitter
        except scipy.linalg.LinAlgError:
            pass
        jitter = scale * 1e-12 * (10.0 ** attempt)
    raise np.linalg.LinAlgError(
        f"banded Cholesky failed after {max_tries} jitter escalations "
        f"(final jitter {jitter:.2e}, diag scale {scale:.2e})"
    )
