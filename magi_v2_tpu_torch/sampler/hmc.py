"""Fixed-length (jittered) HMC transition for all chains at once
(counterpart of magi_v2_tpu/sampler/hmc.py).

Chains are the leading axis of ``q`` (C, dim); every chain runs exactly
``num_leapfrogs`` leapfrogs, a Python int drawn on the host by the caller,
so the loop needs no device value. Step size and mass stay on the device:
nothing in the transition waits for the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from magi_v2_tpu_torch.sampler.mass import (
    mass_kinetic,
    mass_vel,
    momentum_from_normal,
)


class HmcInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,)
    num_leapfrogs: int
    diverging: torch.Tensor     # (C,) bool


def hmc_step(logp_grad: Callable, q, step_size, inv_mass, num_leapfrogs: int,
             normals, uniforms, max_energy_diff: float = 1000.0):
    """One Metropolis-corrected HMC transition of every chain.

    ``logp_grad(q (C, dim)) -> (logp (C,), grad (C, dim))``;
    ``step_size`` a 0-dim tensor; ``normals`` (C, dim) standard normals for
    the momenta and ``uniforms`` (C,) for the accept test — drawn by the
    caller, so a test can feed the numbers another sampler drew.
    """
    half = 0.5 * step_size
    logp0, grad0 = logp_grad(q)
    p0 = momentum_from_normal(inv_mass, normals)
    H0 = -logp0 + mass_kinetic(inv_mass, p0)

    qc, pc, gc, logp = q, p0, grad0, logp0
    for _ in range(int(num_leapfrogs)):
        p_half = torch.addcmul(pc, gc, half)
        qc = torch.addcmul(qc, mass_vel(inv_mass, p_half), step_size)
        logp, gc = logp_grad(qc)
        pc = torch.addcmul(p_half, gc, half)

    H1 = -logp + mass_kinetic(inv_mass, pc)
    dH = H1 - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH, float("inf")))
    accept_prob = torch.exp(torch.clamp(-dH, max=0.0))
    diverging = dH > max_energy_diff
    accept = (uniforms < accept_prob) & ~diverging
    q_out = torch.where(accept[:, None], qc, q)
    info = HmcInfo(
        accept_prob=torch.where(diverging, torch.zeros_like(accept_prob),
                                accept_prob),
        num_leapfrogs=int(num_leapfrogs),
        diverging=diverging,
    )
    return q_out, info
