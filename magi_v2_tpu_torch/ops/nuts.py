"""Kernel K5, the NUTS leaf epilogue (csrc/nuts.cu), and its plain PyTorch
version.

K5 is the part of a NUTS leaf after its leapfrog (the leapfrog is K2's
NUTS form, sampler/hmc.py): the energy error and divergence, the
multinomial weight and proposal, the checkpoint store and the U-turn
checks against the checkpoint slots, for every chain in masked lockstep
(the body of magi_v2_tpu/sampler/nuts.py:_build_subtree after
``_leapfrog``). ``nuts_leaf`` checks its arguments and takes the plain
version for tensors on the CPU; on CUDA tensors it launches the kernel or
raises. ``bind_nuts_leaf`` is the same, checked and converted once, for
the sampler's CUDA graph of a leaf. ``LAUNCH_COUNTS`` counts kernel
launches only.

State, per chain (C chains, dim coordinates, D = max tree depth):
q, v (C, dim) the leaf's state and velocity M^{-1} p; lp, kin (C,) its
log-density and kinetic energy; H0 (C,) the trajectory's initial energy;
eps (C,) the signed step (its sign is the direction); leaf_u (C, 2^D - 1)
one uniform per leaf of a trajectory, leaf n of doubling d at column
2^d - 1 + n; ctr (2,) int32 (d, n). Updated for active chains: lsw,
sum_alpha (C,), prop_q (C, dim), the slots ckpt_q, ckpt_v (D, C, dim),
active, turning, diverging (C,) bool, n_leaves (C,) int32.
"""

from __future__ import annotations

import torch

KERNELS = ("nuts_leaf",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


def trailing_ones(n: int) -> int:
    m = n + 1
    return bin((m & -m) - 1).count("1")


def nuts_leaf_plain(q, v, lp, kin, H0, eps, leaf_u, ctr, lsw, sum_alpha,
                    prop_q, ckpt_q, ckpt_v, active, turning, diverging,
                    n_leaves, max_energy_diff: float) -> None:
    """K5's plain version: the same updates, in place, with PyTorch
    operations (the JAX leaf's order of operations). Reads the leaf index
    from ``ctr`` on the host."""
    d, n = (int(x) for x in ctr.tolist())
    on = active.clone()
    dH = (-lp + kin) - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH,
                                                             float("inf")))
    div = dH > max_energy_diff
    lw = -dH
    sa = sum_alpha + torch.exp(torch.clamp(-dH, max=0.0))
    lsw_new = torch.logaddexp(lsw, lw)
    take = torch.log(leaf_u[:, (1 << d) - 1 + n]) < lw - lsw_new
    torch.where((on & take)[:, None], q, prop_q, out=prop_q)
    pc = bin(n).count("1")
    turn = torch.zeros_like(on)
    if n % 2 == 0:
        torch.where(on[:, None], q, ckpt_q[pc], out=ckpt_q[pc])
        torch.where(on[:, None], v, ckpt_v[pc], out=ckpt_v[pc])
    else:
        sign = torch.sign(eps)[:, None]
        for s in range(pc - trailing_ones(n), pc):
            dq = sign * (q - ckpt_q[s])
            turn |= ((torch.sum(dq * ckpt_v[s], dim=-1) < 0.0)
                     | (torch.sum(dq * v, dim=-1) < 0.0))
    torch.where(on, lsw_new, lsw, out=lsw)
    torch.where(on, sa, sum_alpha, out=sum_alpha)
    n_leaves += on.to(n_leaves.dtype)
    torch.where(on, turn, turning, out=turning)
    torch.where(on, div, diverging, out=diverging)
    active &= ~(turn | div)


def _takes_plain(device) -> bool:
    """Whether a call on ``device`` runs the plain version: on the CPU
    only."""
    return device.type == "cpu"


_ENTRIES = {}


def _entry(dt):
    fn = _ENTRIES.get(dt)
    if fn is None:
        from magi_v2_tpu_torch.ops._build import load_library

        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"nuts_leaf takes float32 or float64, not {dt}")
        suffix = "f32" if dt == torch.float32 else "f64"
        fn = _ENTRIES[dt] = load_library().entry(f"magi_nuts_leaf_{suffix}",
                                                 "nuts_leaf")
    return fn


def bind_nuts_leaf(q, v, lp, kin, H0, eps, leaf_u, ctr, lsw, sum_alpha,
                   prop_q, ckpt_q, ckpt_v, active, turning, diverging,
                   n_leaves, max_energy_diff: float):
    """K5 bound to its operands (see the module's docstring), checked here
    once: a callable of the stream that runs one leaf's epilogue on the
    tensors given now (on the CPU the plain version)."""
    dev, dt = q.device, q.dtype
    if q.dim() != 2:
        raise ValueError("q must be (C, dim)")
    C, dim = q.shape
    D = ckpt_q.shape[0] if ckpt_q.dim() == 3 else 0
    U = (1 << D) - 1
    shapes = (("v", v, (C, dim), dt), ("lp", lp, (C,), dt),
              ("kin", kin, (C,), dt), ("H0", H0, (C,), dt),
              ("eps", eps, (C,), dt), ("leaf_u", leaf_u, (C, U), dt),
              ("ctr", ctr, (2,), torch.int32), ("lsw", lsw, (C,), dt),
              ("sum_alpha", sum_alpha, (C,), dt),
              ("prop_q", prop_q, (C, dim), dt),
              ("ckpt_q", ckpt_q, (D, C, dim), dt),
              ("ckpt_v", ckpt_v, (D, C, dim), dt),
              ("active", active, (C,), torch.bool),
              ("turning", turning, (C,), torch.bool),
              ("diverging", diverging, (C,), torch.bool),
              ("n_leaves", n_leaves, (C,), torch.int32))
    if D < 1:
        raise ValueError("ckpt_q must be (max_depth, C, dim)")
    for name, t, shape, want in shapes:
        if not (isinstance(t, torch.Tensor) and t.dtype == want
                and t.device == dev and t.shape == shape):
            raise TypeError(f"{name} must be a {shape} {want} tensor on "
                            f"{dev}")
    if _takes_plain(dev):
        args = (q, v, lp, kin, H0, eps, leaf_u, ctr, lsw, sum_alpha, prop_q,
                ckpt_q, ckpt_v, active, turning, diverging, n_leaves,
                float(max_energy_diff))
        return lambda stream=None: nuts_leaf_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"nuts_leaf runs on cpu or cuda, not {dev}")
    for name, t, _, _ in (("q", q, 0, 0),) + shapes:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from magi_v2_tpu_torch.ops._build import Launch

    return Launch(_entry(dt),
                  [q, v, lp, kin, H0, eps, leaf_u, U, ctr, lsw, sum_alpha,
                   prop_q, ckpt_q, ckpt_v, active, turning, diverging,
                   n_leaves, float(max_energy_diff), D, C, dim],
                  LAUNCH_COUNTS, "nuts_leaf")


def nuts_leaf(*args, max_energy_diff: float = 1000.0) -> None:
    """K5 on the current stream: ``bind_nuts_leaf``'s arguments, run once."""
    from magi_v2_tpu_torch.ops.banded import launch_stream

    bind_nuts_leaf(*args, max_energy_diff)(launch_stream(args[0].device))
