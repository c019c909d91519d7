"""Flat-vector packing of the MAGI sampler state (counterpart of
magi_v2_tpu/sampler/magi_state.py): (X (N_I, D), sigma_sqs_pre (D,),
thetas_pre (D_thetas,)) in that order. Leading batch axes pass through."""

from __future__ import annotations

import torch


def flatten_state(X, sigma_sqs_pre, thetas_pre):
    lead = X.shape[:-2]
    return torch.cat([X.reshape(lead + (-1,)), sigma_sqs_pre, thetas_pre],
                     dim=-1)


def unflatten_state(q, N_I: int, D: int, D_thetas: int):
    X = q[..., : N_I * D].reshape(q.shape[:-1] + (N_I, D))
    return X, q[..., N_I * D: N_I * D + D], q[..., N_I * D + D:]


def unflatten_samples(samples, N_I: int, D: int, D_thetas: int):
    """(T, C, dim) -> (X (T,C,N_I,D), sigma_pre (T,C,D), theta_pre (T,C,Dθ))."""
    T, C = samples.shape[:2]
    X = samples[..., : N_I * D].reshape(T, C, N_I, D)
    return X, samples[..., N_I * D: N_I * D + D], samples[..., N_I * D + D:]


# --------------------------------------------------------------------------
# the GP-prior whitened coordinates (reparam="whitened")
# --------------------------------------------------------------------------
#
# X = mu + L z with L = C^{1/2} per component turns the GP prior's
# quadratic x'C^{-1}x, whose curvature reaches ~1e8 on the SEIR grid, into
# ||z||^2 (see the JAX module). The map is linear, so the posterior over X
# is the same; only the sampler's geometry changes.


def gp_sqrt_factors(C_invs):
    """Per-component (L, L_inv) with L = C^{1/2}, L_inv = C^{-1/2}, from
    one eigh of C^{-1} (D, N, N), in the dtype and on the device of
    ``C_invs`` (float64 for setup). C = pinv(C^{-1}): eigenvalues at or
    below the pinv cutoff n * eps * max|w| map to 0 in both factors (those
    directions carry no prior mass and stay at mu)."""
    w, V = torch.linalg.eigh((C_invs + C_invs.transpose(-1, -2)) / 2.0)
    n = C_invs.shape[-1]
    cutoff = n * torch.finfo(C_invs.dtype).eps * torch.amax(
        torch.abs(w), dim=-1, keepdim=True)
    ok = w > cutoff
    safe = torch.where(ok, w, torch.ones_like(w))
    zero = torch.zeros_like(w)
    inv_sqrt_w = torch.where(ok, torch.rsqrt(safe), zero)
    sqrt_w = torch.where(ok, torch.sqrt(safe), zero)
    Vt = V.transpose(-1, -2)
    return (V * inv_sqrt_w[..., None, :]) @ Vt, (V * sqrt_w[..., None, :]) @ Vt


def whiten_X(X, mu_ds, L_inv):
    """z (..., N, D) from X (..., N, D): z_d = L_inv_d (x_d - mu_d)."""
    return torch.einsum("dnm,...md->...nd", L_inv, X - mu_ds)


def unwhiten_Z(Z, mu_ds, L):
    """X (..., N, D) from z (..., N, D): x_d = mu_d + L_d z_d."""
    return torch.einsum("dnm,...md->...nd", L, Z) + mu_ds
