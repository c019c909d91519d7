"""Mass-matrix helpers (counterpart of magi_v2_tpu/sampler/mass.py):
a plain (dim,) inverse-mass diagonal, or ``TailDenseMass`` — a diagonal
plus a dense inverse-mass block over the last k coordinates (k = dim is
Stan's full dense metric, the bench recipe). See the JAX module for the
measurements behind the design.

Momenta come from an explicit ``torch.Generator`` (or are passed in by the
caller), since torch's generator gives other numbers than jax.random.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TailDenseMass(NamedTuple):
    """diag (dim,): inverse-mass diagonal (tail entries are marginals, for
    reporting); tail_inv (k, k): dense inverse mass of the tail;
    tail_msqrt (k, k): A with A A^T = tail_inv^{-1}."""

    diag: torch.Tensor
    tail_inv: torch.Tensor
    tail_msqrt: torch.Tensor

    @property
    def k(self) -> int:
        return self.tail_inv.shape[-1]


def identity_mass(dim: int, dense_tail_size: int, dtype, device):
    diag = torch.ones(dim, dtype=dtype, device=device)
    if dense_tail_size <= 0:
        return diag
    k = int(dense_tail_size)
    if k > dim:
        raise ValueError(f"dense_tail_size {k} exceeds state dim {dim}")
    eye = torch.eye(k, dtype=dtype, device=device)
    return TailDenseMass(diag=diag, tail_inv=eye, tail_msqrt=eye.clone())


def mass_from_moments(var, tail_cov):
    """TailDenseMass from the Welford window's pooled moments, factored
    through the correlation matrix (Sigma = S R S) in the sampling dtype."""
    k = tail_cov.shape[-1]
    tail_diag = torch.diagonal(tail_cov)
    diag = torch.cat([var[:-k], tail_diag]) if k < var.shape[0] else tail_diag
    sd = torch.sqrt(tail_diag)
    R = tail_cov / torch.outer(sd, sd)
    L = torch.linalg.cholesky(R)
    eye = torch.eye(k, dtype=tail_cov.dtype, device=tail_cov.device)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    msqrt = L_inv.T / sd[:, None]
    return TailDenseMass(diag=diag.clone(), tail_inv=tail_cov,
                         tail_msqrt=msqrt)


def mass_vel(inv_mass, p):
    """Velocity v = M^{-1} p over the last axis of ``p``."""
    if not isinstance(inv_mass, TailDenseMass):
        return p * inv_mass
    k = inv_mass.k
    if k == p.shape[-1]:
        return p @ inv_mass.tail_inv
    head = p[..., :-k] * inv_mass.diag[:-k]
    return torch.cat([head, p[..., -k:] @ inv_mass.tail_inv], dim=-1)


def mass_kinetic(inv_mass, p):
    """0.5 * p^T M^{-1} p (sum over the last axis)."""
    return 0.5 * torch.sum(p * mass_vel(inv_mass, p), dim=-1)


def momentum_from_normal(inv_mass, z):
    """p ~ N(0, M) from standard normals z (same shape)."""
    if not isinstance(inv_mass, TailDenseMass):
        return z / torch.sqrt(inv_mass)
    k = inv_mass.k
    tail = z[..., -k:] @ inv_mass.tail_msqrt.T
    if k == z.shape[-1]:
        return tail
    head = z[..., :-k] / torch.sqrt(inv_mass.diag[:-k])
    return torch.cat([head, tail], dim=-1)


def mass_sample_momentum(inv_mass, generator, shape, dtype, device):
    """Draw p ~ N(0, M). ``shape`` must end in (dim,)."""
    z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return momentum_from_normal(inv_mass, z)


def mass_diag(inv_mass):
    return inv_mass.diag if isinstance(inv_mass, TailDenseMass) else inv_mass


def mass_tail_inv(inv_mass):
    return inv_mass.tail_inv if isinstance(inv_mass, TailDenseMass) else None
