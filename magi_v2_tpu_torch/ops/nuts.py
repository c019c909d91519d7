"""The NUTS leaf (kernel ``nuts_leaf``, csrc/nuts.cu) and its plain PyTorch
version.

After a leaf's evaluation, one launch for every chain in masked lockstep:
the leaf's closing half-kick, its velocity and kinetic energy; the leaf's
epilogue (the energy error and divergence, the multinomial weight and
proposal, the checkpoint store and the U-turn checks against the
checkpoint slots: the body of magi_v2_tpu/sampler/nuts.py:_build_subtree
after ``_leapfrog``); the leaf counter; and, unless the leaf is its
doubling's last, the next leaf's opening half-kick and drift.
``nuts_leaf`` checks its arguments and takes the plain version for tensors
on the CPU; on CUDA tensors it launches the kernel or raises.
``bind_nuts_leaf`` is the same, checked and converted once, for the
sampler's CUDA graph of a leaf. ``LAUNCH_COUNTS`` counts kernel launches
only.

State, per chain (C chains, dim coordinates, D = max tree depth):
q, p, g (C, dim) the leaf's position, momentum (after its opening
half-kick) and gradient; lp (C,) its log-density; H0 (C,) the trajectory's
initial energy; eps (C,) the signed step (its sign is the direction);
``inv_mass`` a diagonal or a ``TailDenseMass``; leaf_u (C, 2^D - 1) one
uniform per leaf of a trajectory, leaf n of doubling d at column
2^d - 1 + n; ctr (2,) int32 (d, n). Updated for the chains active at the
start: lsw, sum_alpha (C,), prop_q (C, dim), the slots ckpt_q, ckpt_v
(D, C, dim), active, turning, diverging (C,) bool, n_leaves (C,) int32,
vel (C, dim) <- v_end = M^{-1} p_end, and p, q: p <- p_half and q drifted
(the next leaf opened), or at the doubling's last leaf (n + 1 = 2^d)
p <- p_end and q as it was. ctr[1] advances by one.

Drift, then decide: a chain active at the start is opened whether or not
this leaf stops it (turning or diverging), so such a chain's q, p hold the
next leaf's opening. Nothing reads them: the doubling's epilogue copies the
trajectory's ends only for chains that neither turned nor diverged, and
the proposal is the leaf's own q. The chains inactive at the start are
left untouched.
"""

from __future__ import annotations

import torch

KERNELS = ("nuts_leaf",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS}
# csrc/nuts.cu: the deepest tree a launch takes
MAX_DEPTH = 16


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


def trailing_ones(n: int) -> int:
    m = n + 1
    return bin((m & -m) - 1).count("1")


def nuts_leaf_plain(q, p, g, lp, H0, eps, inv_mass, leaf_u, ctr, lsw,
                    sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning,
                    diverging, n_leaves, vel, max_energy_diff: float) -> None:
    """The kernel's plain version: the same updates, in place, with PyTorch
    operations in the JAX leaf's order (the closing kick, then the
    epilogue, then the opening kick and drift). Reads the leaf index from
    ``ctr`` on the host."""
    from magi_v2_tpu_torch.sampler.mass import mass_vel

    d, n = (int(x) for x in ctr.tolist())
    on = active.clone()
    rows = on[:, None]
    half = 0.5 * eps[:, None]
    p_end = torch.addcmul(p, g, half)
    v_end = mass_vel(inv_mass, p_end)
    kin = 0.5 * torch.sum(p_end * v_end, dim=-1)
    dH = (-lp + kin) - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH,
                                                             float("inf")))
    div = dH > max_energy_diff
    lw = -dH
    sa = sum_alpha + torch.exp(torch.clamp(-dH, max=0.0))
    lsw_new = torch.logaddexp(lsw, lw)
    take = torch.log(leaf_u[:, (1 << d) - 1 + n]) < lw - lsw_new
    torch.where(rows & take[:, None], q, prop_q, out=prop_q)
    pc = bin(n).count("1")
    turn = torch.zeros_like(on)
    if n % 2 == 0:
        torch.where(rows, q, ckpt_q[pc], out=ckpt_q[pc])
        torch.where(rows, v_end, ckpt_v[pc], out=ckpt_v[pc])
    else:
        sign = torch.sign(eps)[:, None]
        for s in range(pc - trailing_ones(n), pc):
            dq = sign * (q - ckpt_q[s])
            turn |= ((torch.sum(dq * ckpt_v[s], dim=-1) < 0.0)
                     | (torch.sum(dq * v_end, dim=-1) < 0.0))
    torch.where(on, lsw_new, lsw, out=lsw)
    torch.where(on, sa, sum_alpha, out=sum_alpha)
    n_leaves += on.to(n_leaves.dtype)
    torch.where(on, turn, turning, out=turning)
    torch.where(on, div, diverging, out=diverging)
    active &= ~(turn | div)
    torch.where(rows, v_end, vel, out=vel)
    if n + 1 < (1 << d):
        p_half = torch.addcmul(p_end, g, half)
        v_half = mass_vel(inv_mass, p_half)
        torch.where(rows, torch.addcmul(q, v_half, eps[:, None]), q, out=q)
        torch.where(rows, p_half, p, out=p)
    else:
        torch.where(rows, p_end, p, out=p)
    ctr[1:] += 1


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


def bind_nuts_leaf(q, p, g, lp, H0, eps, inv_mass, leaf_u, ctr, lsw,
                   sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning,
                   diverging, n_leaves, vel, max_energy_diff: float):
    """The leaf kernel bound to its operands (see the module's docstring),
    checked here once: a callable of the stream that runs one leaf's close,
    epilogue and next opening on the tensors given now (on the CPU the
    plain version). ``inv_mass`` is a diagonal or a ``TailDenseMass`` whose
    tensors are read at each call, on the card only if its dense block is
    in K2's padded layout (``sampler.hmc.padded_tail``): another block is
    copied into it here."""
    from magi_v2_tpu_torch.sampler.hmc import (
        _mass_parts,
        kinetic_partials,
        padded_tail,
        tail_stride,
    )

    dev, dt = q.device, q.dtype
    if q.dim() != 2:
        raise ValueError("q must be (C, dim)")
    C, dim = q.shape
    D = ckpt_q.shape[0] if ckpt_q.dim() == 3 else 0
    if D < 1:
        raise ValueError("ckpt_q must be (max_depth, C, dim)")
    U = (1 << D) - 1
    diag, tail_inv, k = _mass_parts(inv_mass)
    shapes = (("p", p, (C, dim), dt), ("g", g, (C, dim), dt),
              ("lp", lp, (C,), dt), ("H0", H0, (C,), dt),
              ("eps", eps, (C,), dt), ("diag", diag, (dim,), dt),
              ("leaf_u", leaf_u, (C, U), dt),
              ("ctr", ctr, (2,), torch.int32), ("lsw", lsw, (C,), dt),
              ("sum_alpha", sum_alpha, (C,), dt),
              ("prop_q", prop_q, (C, dim), dt),
              ("ckpt_q", ckpt_q, (D, C, dim), dt),
              ("ckpt_v", ckpt_v, (D, C, dim), dt),
              ("active", active, (C,), torch.bool),
              ("turning", turning, (C,), torch.bool),
              ("diverging", diverging, (C,), torch.bool),
              ("n_leaves", n_leaves, (C,), torch.int32),
              ("vel", vel, (C, dim), dt))
    if k:
        shapes += (("tail_inv", tail_inv, (k, k), dt),)
    for name, t, shape, want in shapes:
        if not (isinstance(t, torch.Tensor) and t.dtype == want
                and t.device == dev and t.shape == shape):
            raise TypeError(f"{name} must be a {shape} {want} tensor on "
                            f"{dev}")
    if _takes_plain(dev):
        args = (q, p, g, lp, H0, eps, inv_mass, leaf_u, ctr, lsw, sum_alpha,
                prop_q, ckpt_q, ckpt_v, active, turning, diverging, n_leaves,
                vel, float(max_energy_diff))
        return lambda stream=None: nuts_leaf_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"nuts_leaf runs on cpu or cuda, not {dev}")
    if D > MAX_DEPTH:
        raise ValueError(f"nuts_leaf takes trees up to depth {MAX_DEPTH}, "
                         f"not {D}")
    for name, t, _, _ in (("q", q, 0, 0),) + shapes:
        if name == "tail_inv":
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("p", p), ("g", g), ("vel", vel)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ld = tail_stride(k) if k else 0
    if k and (tail_inv.stride() != (ld, 1) or tail_inv.data_ptr() % 16):
        tail_inv = padded_tail(tail_inv)
    from magi_v2_tpu_torch.ops._build import Launch

    # scratch: q_end and (for the dense block) p_end of each row, each
    # chain's partial sums (its CTAs x (kinetic, two dots a slot)) and
    # tickets, the grid's ticket
    W = kinetic_partials(dim, k) * (1 + 2 * D)
    qe = torch.empty((C, dim), dtype=dt, device=dev)
    pe = torch.zeros((C, dim), dtype=dt, device=dev) if k else None
    part = torch.empty((C, W), dtype=dt, device=dev)
    ticket = torch.zeros((C + 1,), dtype=torch.int32, device=dev)
    return Launch(_entry(dt),
                  [q, p, g, diag, tail_inv, eps, lp, H0, leaf_u, U, ctr, lsw,
                   sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning,
                   diverging, n_leaves, vel, qe, pe, part, W, ticket[:C],
                   ticket[C:], float(max_energy_diff), D, k, ld, C, dim],
                  LAUNCH_COUNTS, "nuts_leaf")


def nuts_leaf(*args, max_energy_diff: float = 1000.0) -> None:
    """The leaf kernel on the current stream: ``bind_nuts_leaf``'s
    arguments, run once."""
    from magi_v2_tpu_torch.ops.banded import launch_stream

    bind_nuts_leaf(*args, max_energy_diff)(launch_stream(args[0].device))
