"""Fixed-length (jittered) HMC transition for all chains at once
(counterpart of magi_v2_tpu/sampler/hmc.py), with the leapfrog update as
kernel K2 (csrc/leapfrog.cu).

Chains are the leading axis of ``q`` (C, dim); every chain runs exactly
``num_leapfrogs`` leapfrogs, a Python int drawn on the host by the caller,
so the loop needs no device value. Step size and mass stay on the device:
nothing in the transition waits for the card.

``leapfrog_update`` is K2's wrapper: for a CPU tensor it runs the plain
version (``leapfrog_update_plain``, the same operations in the same order
as the JAX loop body, so a transition is reproducible bit for bit); for a
CUDA tensor it launches the kernel or raises. It updates q and p in place,
so a transition allocates its two state copies once instead of three
tensors per leapfrog. ``LAUNCH_COUNTS`` counts kernel launches only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from magi_v2_tpu_torch.sampler.mass import (
    TailDenseMass,
    mass_vel,
    momentum_from_normal,
)

KERNELS = ("leapfrog_update",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS}
# widest dense inverse-mass tail the kernel multiplies in-kernel; a wider
# block (the full dense metric) gets its velocity from one cuBLAS GEMM
MAX_KERNEL_TAIL = 8


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


class HmcInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,)
    num_leapfrogs: int
    diverging: torch.Tensor     # (C,) bool


def leapfrog_update_plain(q, p, g, step_size, inv_mass, nkick: int,
                          drift: bool, kinetic: bool):
    """K2's plain version: p <- p + (eps/2) g ``nkick`` times; v = M^{-1} p;
    q <- q + eps v when ``drift``; returns 0.5 p.v per chain when
    ``kinetic``, else None."""
    half = 0.5 * step_size
    for _ in range(nkick):
        torch.addcmul(p, g, half, out=p)
    if not (drift or kinetic):
        return None
    vel = mass_vel(inv_mass, p)
    if drift:
        torch.addcmul(q, vel, step_size, out=q)
    return 0.5 * torch.sum(p * vel, dim=-1) if kinetic else None


def _mass_parts(inv_mass):
    """(diag, tail_inv or None, k) of a mass the kernel multiplies
    in-kernel, or None for a dense block wider than MAX_KERNEL_TAIL."""
    if not isinstance(inv_mass, TailDenseMass):
        return inv_mass, None, 0
    if inv_mass.k > MAX_KERNEL_TAIL:
        return None
    return inv_mass.diag, inv_mass.tail_inv, inv_mass.k


_ENTRIES = {}


def _launch(q, p, g, step_size, vel, diag, tail_inv, k, nkick, drift,
            kinetic):
    dt = q.dtype
    fn = _ENTRIES.get(dt)
    if fn is None:
        from magi_v2_tpu_torch.ops._build import load_library

        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"leapfrog_update takes float32 or float64, "
                            f"not {dt}")
        suffix = "f32" if dt == torch.float32 else "f64"
        fn = _ENTRIES[dt] = load_library().entry(
            f"magi_leapfrog_update_{suffix}", "leapfrog_update")
    C, dim = q.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(q.data_ptr(), p.data_ptr(), g.data_ptr(), ptr(vel), ptr(diag),
             ptr(tail_inv), step_size.data_ptr(), k, C, dim, nkick,
             int(drift), ptr(kinetic),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of leapfrog_update failed: error "
                           f"{err}")
    LAUNCH_COUNTS["leapfrog_update"] += 1


def leapfrog_update(q, p, g, step_size, inv_mass, nkick: int, drift: bool,
                    kinetic: bool):
    """K2: the kicks, velocity, drift and kinetic energy of one leapfrog
    for every chain, q and p (C, dim) updated in place; ``step_size`` a
    0-dim tensor. Returns the kinetic energies (C,) when ``kinetic``."""
    dev, dt = q.device, q.dtype
    C, dim = q.shape
    for name, t in (("p", p), ("g", g), ("step_size", step_size)):
        if not (isinstance(t, torch.Tensor) and t.dtype == dt
                and t.device == dev):
            raise TypeError(f"{name} must be a {dt} tensor on {dev}")
    if p.shape != (C, dim) or g.shape != (C, dim) or step_size.dim() != 0:
        raise ValueError("q, p, g must be (C, dim) and step_size 0-dim")
    if dev.type == "cpu":
        return leapfrog_update_plain(q, p, g, step_size, inv_mass, nkick,
                                     drift, kinetic)
    if dev.type != "cuda":
        raise ValueError(f"leapfrog_update runs on cpu or cuda, not {dev}")
    if not (q.is_contiguous() and p.is_contiguous() and g.is_contiguous()):
        raise ValueError("q, p and g must be contiguous")
    kin = torch.empty((C,), dtype=dt, device=dev) if kinetic else None
    parts = _mass_parts(inv_mass)
    if parts is None and (drift or kinetic):
        # the full dense metric: kick, one GEMM for the velocity, drift
        if nkick:
            _launch(q, p, g, step_size, None, None, None, 0, nkick, False,
                    None)
        vel = mass_vel(inv_mass, p).contiguous()
        _launch(q, p, g, step_size, vel, None, None, 0, 0, drift, kin)
        return kin
    diag, tail_inv, k = parts if parts is not None else (None, None, 0)
    if diag is not None and (diag.shape != (dim,) or diag.dtype != dt):
        raise ValueError(f"the inverse-mass diagonal must be ({dim},) {dt}")
    tail_inv = None if tail_inv is None else tail_inv.contiguous()
    _launch(q, p, g, step_size, None, diag.contiguous()
            if diag is not None else None, tail_inv, k, nkick, drift, kin)
    return kin


def hmc_step(logp_grad: Callable, q, step_size, inv_mass, num_leapfrogs: int,
             normals, uniforms, max_energy_diff: float = 1000.0):
    """One Metropolis-corrected HMC transition of every chain.

    ``logp_grad(q (C, dim)) -> (logp (C,), grad (C, dim))``;
    ``step_size`` a 0-dim tensor; ``normals`` (C, dim) standard normals for
    the momenta and ``uniforms`` (C,) for the accept test — drawn by the
    caller, so a test can feed the numbers another sampler drew.

    The closing half-kick of one leapfrog and the opening half-kick of the
    next are one K2 launch (rounded in that order, as two kicks).
    """
    L = int(num_leapfrogs)
    logp0, grad0 = logp_grad(q)
    pc = momentum_from_normal(inv_mass, normals).contiguous()
    kin0 = leapfrog_update(q, pc, grad0, step_size, inv_mass, nkick=0,
                           drift=False, kinetic=True)
    H0 = -logp0 + kin0

    qc, gc, logp = q.clone(), grad0, logp0
    for i in range(L):
        leapfrog_update(qc, pc, gc, step_size, inv_mass,
                        nkick=1 if i == 0 else 2, drift=True, kinetic=False)
        logp, gc = logp_grad(qc)
    kin1 = leapfrog_update(qc, pc, gc, step_size, inv_mass,
                           nkick=1 if L else 0, drift=False, kinetic=True)

    H1 = -logp + kin1
    dH = H1 - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH, float("inf")))
    accept_prob = torch.exp(torch.clamp(-dH, max=0.0))
    diverging = dH > max_energy_diff
    accept = (uniforms < accept_prob) & ~diverging
    q_out = torch.where(accept[:, None], qc, q)
    info = HmcInfo(
        accept_prob=torch.where(diverging, torch.zeros_like(accept_prob),
                                accept_prob),
        num_leapfrogs=L,
        diverging=diverging,
    )
    return q_out, info
