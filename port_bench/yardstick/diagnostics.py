"""Effective sample size and split R-hat, frozen for the benchmark.

Copied from magi_v2_tpu_torch/utils/diagnostics.py as it stood when the
benchmark was defined (NumPy only): per-chain autocorrelation via FFT,
Geyer initial positive-sequence truncation, combined across chains
(Stan/ArviZ "bulk ESS" on the raw values). A later change to the
program does not move these numbers."""

from __future__ import annotations

import numpy as np


def _autocovariance_fft(x):
    """Biased autocovariance of a 1-D series via FFT (length-n normalizer)."""
    n = len(x)
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conjugate(f), nfft)[:n].real
    return acov / n


def effective_sample_size(chains: np.ndarray) -> float:
    """ESS of draws with shape (T,) or (T, C) (C chains), scalar parameter.

    Multi-chain version of Geyer's initial monotone sequence estimator
    (Vehtari et al. 2021 / Stan reference implementation).
    """
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    T, C = x.shape
    if T < 4:
        return float(T * C)

    acovs = np.stack([_autocovariance_fft(x[:, c]) for c in range(C)], axis=1)
    chain_var = acovs[0] * T / (T - 1.0)      # per-chain variance
    mean_var = chain_var.mean()
    var_plus = mean_var * (T - 1.0) / T
    if C > 1:
        var_plus += x.mean(axis=0).var(ddof=1)

    # Geyer paired sums rho_{2t} + rho_{2t+1}
    rho_hat = np.zeros(T)
    rho_hat[0] = 1.0
    rho_hat_even = 1.0
    rho_hat_odd = 1.0 - (mean_var - acovs[1].mean()) / var_plus
    rho_hat[1] = rho_hat_odd
    t = 1
    while t < T - 2 and (rho_hat_even + rho_hat_odd) > 0:
        rho_hat_even = 1.0 - (mean_var - acovs[t + 1].mean()) / var_plus
        rho_hat_odd = 1.0 - (mean_var - acovs[t + 2].mean()) / var_plus
        if rho_hat_even + rho_hat_odd >= 0:
            rho_hat[t + 1] = rho_hat_even
            rho_hat[t + 2] = rho_hat_odd
        t += 2

    max_t = t
    # Geyer initial monotone sequence
    t = 1
    while t <= max_t - 2:
        pair = rho_hat[t + 1] + rho_hat[t + 2]
        prev = rho_hat[t - 1] + rho_hat[t]
        if pair > prev:
            rho_hat[t + 1] = prev / 2.0
            rho_hat[t + 2] = prev / 2.0
        t += 2

    tau = 1.0 + 2.0 * rho_hat[1 : max_t + 1].sum()
    return float(min(C * T / max(tau, 1e-12), C * T))


def potential_scale_reduction(chains: np.ndarray) -> float:
    """Split R-hat for draws of shape (T, C)."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    T, C = x.shape
    half = T // 2
    splits = np.concatenate([x[:half], x[half : 2 * half]], axis=1)  # (half, 2C)
    m = splits.shape[1]
    n = splits.shape[0]
    chain_means = splits.mean(axis=0)
    chain_vars = splits.var(axis=0, ddof=1)
    W = chain_vars.mean()
    B = n * chain_means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / max(W, 1e-300)))


def summarize_chains(samples: np.ndarray, wall_seconds: float | None = None):
    """Summary over (T, C, ...) sample arrays: pooled ESS per flat parameter,
    min/mean ESS, worst R-hat, ESS/sec."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    T, C = x.shape[:2]
    flat = x.reshape(T, C, -1)
    P = flat.shape[-1]
    esss = np.array([effective_sample_size(flat[:, :, p]) for p in range(P)])
    rhats = np.array([potential_scale_reduction(flat[:, :, p]) for p in range(P)])
    out = {
        "ess_min": float(esss.min()),
        "ess_mean": float(esss.mean()),
        "rhat_max": float(rhats.max()),
        "num_draws": T * C,
    }
    if wall_seconds is not None:
        out["ess_per_sec_min"] = out["ess_min"] / wall_seconds
        out["ess_per_sec_mean"] = out["ess_mean"] / wall_seconds
    return out
