"""Wrappers of the K1 manifold kernels and their plain PyTorch versions.

K1 is the sampler's fused tempered log-posterior plus gradient
(magi_v2_tpu/sampler/precond.py:make_tempered_logp_grad_gn, relative
branch). Its six matrix products are GEMMs issued by the caller
(sampler/precond.py:GNTarget); the pointwise and per-chain work between
them is three kernels, each here as a wrapper:

- ``manifold_fwd``: X = x0 + delta, f, dr = (f - f0) - m delta, the t1
  seed g_Rd, per-chain t1 and t4;
- ``manifold_energy``: t2, t3, log-Jacobians, the tempered log-posterior
  and the seed g_Ds;
- ``manifold_bwd``: J_f^T g_dr plus the t4 term, the sigma_pre/theta_pre
  gradients, g_dr copied beside g_Rd.

Each wrapper checks its arguments, takes the plain version (``*_plain``)
for tensors on the CPU, and on a CUDA tensor launches the hand-written
kernel of csrc/manifold.cu or raises: there is no fallback on the card.
``LAUNCH_COUNTS`` counts kernel launches only.

What is checked when, and which buffers are reused. The three wrapper
functions check every argument on every call and allocate their outputs
(and the kernels' scratch) anew. ``ManifoldPlan`` is the sampler's form:
it checks the target's constants and one chain count's buffers once, when
it is made, and keeps the three launches with their argument lists
converted (``_build.Launch``); a call then fills in what changes (the
pointers of q and beta_temp, of lp or grad, and the stream) and checks
nothing. Its intermediates (dr, gcat, t14, gDs, gpart and the scratch)
are the buffers it was given and are overwritten by every call; lp and
grad belong to the caller and are never kept. On the CPU the plan runs
the plain versions into the same buffers.

The kernels give a chain of more than 256 points up to ceil(N / 128) CTAs
(csrc/manifold.cu: chunks_of); a chain's sums pass through ``part`` (one
row of partials per CTA) and are added in a fixed order by the CTA that
draws the last of the chain's ``ticket``s (an integer atomic), so results
do not depend on scheduling. ``ticket`` must be zero before a launch and
is left zero.

Layouts: delta (C, D, N); RmD, gcat (D, C, 2N); dr, Ds, gDs, gdr, gpart
(D, C, N); q, grad (C, dim), dim = N*D + D + P; x0T, a0, f0, s0, mask, y
(D, N); sigma_lb, n_ds (D,); beta_temp a 0-dim tensor; beta a float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magi_v2_tpu_torch.models.odes import cuda_model_of

KERNELS = ("manifold_fwd", "manifold_energy", "manifold_bwd")
LAUNCH_COUNTS = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


# --------------------------------------------------------------------------
# plain versions (the CPU path and the oracle of the kernels)
# --------------------------------------------------------------------------


def _split_q(q, N, D):
    """(sigma_pre (C, D), theta_pre (C, P)) from the flat states."""
    ND = N * D
    return q[:, ND: ND + D], q[:, ND + D:]


def manifold_fwd_plain(f_vec, I, delta, RmD, q, x0T, a0, f0, mask, y,
                       sigma_lb, beta_temp, beta):
    C, D, N = delta.shape
    sp, tp = _split_q(q, N, D)
    X = (x0T[None] + delta).transpose(1, 2)                  # (C, N, D)
    f = f_vec(I, X, F.softplus(tp)).permute(2, 0, 1)         # (D, C, N)
    Rd, md = RmD[..., :N], RmD[..., N:]
    dr = (f - f0[:, None, :]) - md
    scale = beta_temp / beta
    gcat = torch.empty_like(RmD)
    gcat[..., :N] = -scale * (Rd + a0[:, None, :])
    t1 = torch.sum(Rd * (Rd + 2.0 * a0[:, None, :]), dim=(0, 2))
    inv_var = 1.0 / (F.softplus(sp) + sigma_lb)               # (C, D)
    r = x0T[None] + delta - y[None]                           # (C, D, N)
    t4 = torch.sum(torch.sum(mask * r * r, dim=-1) * inv_var, dim=-1)
    return dr.contiguous(), gcat, torch.stack([t1, t4], dim=-1)


def manifold_energy_plain(f_vec, Ds, s0, t14, q, sigma_lb, n_ds, beta_temp,
                          beta):
    D, C, N = Ds.shape
    sp, tp = _split_q(q, N, D)
    t2 = torch.sum(Ds * (Ds + 2.0 * s0[:, None, :]), dim=(0, 2))
    sig2 = F.softplus(sp) + sigma_lb
    t3 = torch.sum(n_ds * torch.log(2.0 * torch.pi * sig2), dim=-1)
    lj = (torch.sum(F.logsigmoid(sp), dim=-1)
          + torch.sum(F.logsigmoid(tp), dim=-1))
    lp = beta_temp * (-0.5 * ((t14[:, 0] + t2) / beta + t3 + t14[:, 1]) + lj)
    gDs = -(beta_temp / beta) * (Ds + s0[:, None, :])
    return lp, gDs


def manifold_bwd_plain(f_vec, I, gdr, delta, q, x0T, mask, y, sigma_lb, n_ds,
                       beta_temp, gcat, grad):
    C, D, N = delta.shape
    ND = N * D
    sp, tp = _split_q(q, N, D)
    X = (x0T[None] + delta).transpose(1, 2)                  # (C, N, D)
    _, vjp = torch.func.vjp(lambda X_, th_: f_vec(I, X_, th_), X,
                            F.softplus(tp))
    gX, gth = vjp(gdr.permute(1, 2, 0))                      # (C,N,D), (C,P)
    gcat[..., N:] = gdr
    sig2 = F.softplus(sp) + sigma_lb                          # (C, D)
    r = x0T[None] + delta - y[None]                           # (C, D, N)
    ssr = torch.sum(mask * r * r, dim=-1)
    gpart = (gX.transpose(1, 2)
             - beta_temp * mask * r / sig2[..., None]).transpose(0, 1)
    g_s2 = -0.5 * beta_temp * (n_ds / sig2 - ssr / (sig2 * sig2))
    grad[:, ND: ND + D] = (g_s2 * torch.sigmoid(sp)
                           + beta_temp * torch.sigmoid(-sp))
    grad[:, ND + D:] = gth * torch.sigmoid(tp) + beta_temp * torch.sigmoid(-tp)
    return gpart.contiguous()


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_all(args, dtype, device):
    """``_check`` over (name, tensor, shape) triples: one cheap test per
    tensor on the launch path, the detailed check only on a mismatch."""
    for name, t, shape in args:
        if not (isinstance(t, torch.Tensor) and t.dtype == dtype
                and t.shape == shape and t.device == device
                and t.is_contiguous()):
            _check(name, t, shape, dtype, device)


# ctypes entry points by (kernel, f_vec, dtype), resolved on first launch
_ENTRIES = {}

# points of a chain per CTA (csrc/manifold.cu: kThreads) and the widest row
# of per-CTA partial sums (manifold_bwd: P + D values, at most _PART_WIDTH)
_CHUNK = 128
_PART_WIDTH = 8


def _entry(kernel, f_vec, dtype):
    fn = _ENTRIES.get((kernel, f_vec, dtype))
    if fn is not None:
        return fn
    from magi_v2_tpu_torch.ops._build import load_library

    model = cuda_model_of(f_vec)
    if model is None:
        raise NotImplementedError(
            "no CUDA manifold kernel is registered for this ODE model "
            "(OdeModel.cuda_model); SEIR and Lorenz are ported"
        )
    if dtype == torch.float32:
        suffix = "f32"
    elif dtype == torch.float64:
        suffix = "f64"
    else:
        raise TypeError(f"manifold kernels take float32 or float64, not {dtype}")
    fn = _ENTRIES[(kernel, f_vec, dtype)] = load_library().entry(
        f"magi_manifold_{kernel}_{model}_{suffix}", f"manifold_{kernel}")
    return fn


def _takes_plain(device) -> bool:
    """Whether a call on ``device`` runs the plain version: on the CPU
    only."""
    return device.type == "cpu"


def make_scratch(C: int, N: int, dtype, device):
    """(part (C, G, _PART_WIDTH), ticket (C,) int32 zeros), G the most CTAs
    a chain gets: what the kernels pass a chain's partial sums through."""
    G = -(-N // _CHUNK)
    return (torch.empty((C, G, _PART_WIDTH), dtype=dtype, device=device),
            torch.zeros((C,), dtype=torch.int32, device=device))


def _prepare(kernel, f_vec, dtype, args):
    from magi_v2_tpu_torch.ops._build import Launch

    return Launch(_entry(kernel, f_vec, dtype), args, LAUNCH_COUNTS,
                  f"manifold_{kernel}")


def _launch(kernel, f_vec, dtype, args):
    _prepare(kernel, f_vec, dtype, args)(
        torch.cuda.current_stream(args[0].device).cuda_stream)


def manifold_fwd(f_vec, I, delta, RmD, q, x0T, a0, f0, mask, y, sigma_lb,
                 beta_temp, beta: float):
    """-> dr (D, C, N), gcat (D, C, 2N) with the first half set, t14 (C, 2)."""
    C, D, N = delta.shape
    dev, dt = delta.device, delta.dtype
    dim = q.shape[1]
    _check_all((
        ("delta", delta, (C, D, N)), ("RmD", RmD, (D, C, 2 * N)),
        ("q", q, (C, dim)), ("x0T", x0T, (D, N)), ("a0", a0, (D, N)),
        ("f0", f0, (D, N)), ("mask", mask, (D, N)), ("y", y, (D, N)),
        ("sigma_lb", sigma_lb, (D,)), ("beta_temp", beta_temp, ()),
    ), dt, dev)
    if dev.type == "cpu":
        return manifold_fwd_plain(f_vec, I, delta, RmD, q, x0T, a0, f0, mask,
                                  y, sigma_lb, beta_temp, beta)
    if dev.type != "cuda":
        raise ValueError(f"manifold_fwd runs on cpu or cuda, not {dev}")
    dr = torch.empty((D, C, N), dtype=dt, device=dev)
    gcat = torch.empty((D, C, 2 * N), dtype=dt, device=dev)
    t14 = torch.empty((C, 2), dtype=dt, device=dev)
    _launch("fwd", f_vec, dt,
            [delta, RmD, q, x0T, a0, f0, mask, y, sigma_lb, beta_temp,
             float(beta), C, N, dim, dr, gcat, t14,
             *make_scratch(C, N, dt, dev)])
    return dr, gcat, t14


def manifold_energy(f_vec, Ds, s0, t14, q, sigma_lb, n_ds, beta_temp,
                    beta: float):
    """-> lp (C,), gDs (D, C, N)."""
    D, C, N = Ds.shape
    dev, dt = Ds.device, Ds.dtype
    dim = q.shape[1]
    _check_all((
        ("Ds", Ds, (D, C, N)), ("s0", s0, (D, N)), ("t14", t14, (C, 2)),
        ("q", q, (C, dim)), ("sigma_lb", sigma_lb, (D,)),
        ("n_ds", n_ds, (D,)), ("beta_temp", beta_temp, ()),
    ), dt, dev)
    if dev.type == "cpu":
        return manifold_energy_plain(f_vec, Ds, s0, t14, q, sigma_lb, n_ds,
                                     beta_temp, beta)
    if dev.type != "cuda":
        raise ValueError(f"manifold_energy runs on cpu or cuda, not {dev}")
    lp = torch.empty((C,), dtype=dt, device=dev)
    gDs = torch.empty((D, C, N), dtype=dt, device=dev)
    _launch("energy", f_vec, dt,
            [Ds, s0, t14, q, sigma_lb, n_ds, beta_temp, float(beta), C, N,
             dim, lp, gDs, *make_scratch(C, N, dt, dev)])
    return lp, gDs


def manifold_bwd(f_vec, I, gdr, delta, q, x0T, mask, y, sigma_lb, n_ds,
                 beta_temp, gcat, grad):
    """Writes gcat[..., N:] and grad[:, N*D:]; -> gpart (D, C, N)."""
    C, D, N = delta.shape
    dev, dt = delta.device, delta.dtype
    dim = q.shape[1]
    _check_all((
        ("gdr", gdr, (D, C, N)), ("delta", delta, (C, D, N)),
        ("q", q, (C, dim)), ("x0T", x0T, (D, N)), ("mask", mask, (D, N)),
        ("y", y, (D, N)), ("sigma_lb", sigma_lb, (D,)), ("n_ds", n_ds, (D,)),
        ("beta_temp", beta_temp, ()), ("gcat", gcat, (D, C, 2 * N)),
        ("grad", grad, (C, dim)),
    ), dt, dev)
    if dev.type == "cpu":
        return manifold_bwd_plain(f_vec, I, gdr, delta, q, x0T, mask, y,
                                  sigma_lb, n_ds, beta_temp, gcat, grad)
    if dev.type != "cuda":
        raise ValueError(f"manifold_bwd runs on cpu or cuda, not {dev}")
    gpart = torch.empty((D, C, N), dtype=dt, device=dev)
    _launch("bwd", f_vec, dt,
            [gdr, delta, q, x0T, mask, y, sigma_lb, n_ds, beta_temp, C, N,
             dim, gcat, gpart, grad, *make_scratch(C, N, dt, dev)])
    return gpart


class ManifoldPlan:
    """The three K1 kernels bound to a target's constants and to the
    buffers of one chain count.

    ``consts``: x0T, a0, f0, s0, mask, y (D, N), sigma_lb, n_ds (D,).
    ``bufs``: delta (C, D, N), RmD, gcat (D, C, 2N), dr, Ds, gDs, gdr,
    gpart (D, C, N), t14 (C, 2); the operator stages around the kernels
    write delta, RmD, Ds and gdr, the kernels the rest. Everything is
    checked here, once. ``fwd``, ``energy`` and ``bwd`` then take the
    state q (C, dim), the 0-dim beta_temp, the output that belongs to the
    caller (lp (C,), grad (C, dim)) and the stream, trust them (the
    caller checks q once per evaluation), and overwrite the buffers."""

    def __init__(self, f_vec, I, consts: dict, beta: float, dim: int,
                 bufs: dict):
        delta = bufs["delta"]
        C, D, N = delta.shape
        dev, dt = delta.device, delta.dtype
        row, blk = (D, N), (D, C, N)
        _check_all(
            tuple((k, consts[k], row)
                  for k in ("x0T", "a0", "f0", "s0", "mask", "y"))
            + tuple((k, consts[k], (D,)) for k in ("sigma_lb", "n_ds"))
            + (("delta", delta, (C, D, N)), ("t14", bufs["t14"], (C, 2)))
            + tuple((k, bufs[k], (D, C, 2 * N)) for k in ("RmD", "gcat"))
            + tuple((k, bufs[k], blk)
                    for k in ("dr", "Ds", "gDs", "gdr", "gpart")),
            dt, dev)
        if dim < N * D + D:
            raise ValueError(f"a state of {dim} entries does not hold "
                             f"{N} x {D} points and {D} noise levels")
        self.f_vec, self.I, self.beta = f_vec, I, float(beta)
        self.consts, self.bufs = dict(consts), dict(bufs)
        self.plain = _takes_plain(dev)
        if self.plain:
            return
        if dev.type != "cuda":
            raise ValueError(f"the manifold kernels run on cpu or cuda, not "
                             f"{dev}")
        c, b = self.consts, self.bufs
        self.scratch = make_scratch(C, N, dt, dev)
        # q and beta_temp (and lp, grad) are bound at each call: the
        # pointers given here stand in for them
        q0 = bt0 = out0 = delta
        self._fwd = _prepare("fwd", f_vec, dt, [
            delta, b["RmD"], q0, c["x0T"], c["a0"], c["f0"], c["mask"],
            c["y"], c["sigma_lb"], bt0, self.beta, C, N, dim, b["dr"],
            b["gcat"], b["t14"], *self.scratch])
        self._energy = _prepare("energy", f_vec, dt, [
            b["Ds"], c["s0"], b["t14"], q0, c["sigma_lb"], c["n_ds"], bt0,
            self.beta, C, N, dim, out0, b["gDs"], *self.scratch])
        self._bwd = _prepare("bwd", f_vec, dt, [
            b["gdr"], delta, q0, c["x0T"], c["mask"], c["y"], c["sigma_lb"],
            c["n_ds"], bt0, C, N, dim, b["gcat"], b["gpart"], out0,
            *self.scratch])

    def fwd(self, q, beta_temp, stream) -> None:
        """dr, gcat[..., :N] and t14 from delta and RmD."""
        if self.plain:
            c, b = self.consts, self.bufs
            dr, gcat, t14 = manifold_fwd_plain(
                self.f_vec, self.I, b["delta"], b["RmD"], q, c["x0T"],
                c["a0"], c["f0"], c["mask"], c["y"], c["sigma_lb"],
                beta_temp, self.beta)
            N = dr.shape[-1]
            b["dr"].copy_(dr)
            b["gcat"][..., :N].copy_(gcat[..., :N])
            b["t14"].copy_(t14)
            return
        launch = self._fwd
        launch.rebind(2, q)
        launch.rebind(9, beta_temp)
        launch(stream)

    def energy(self, q, beta_temp, lp, stream) -> None:
        """lp (the caller's) and gDs from Ds and t14."""
        if self.plain:
            c, b = self.consts, self.bufs
            lp_, gDs = manifold_energy_plain(
                self.f_vec, b["Ds"], c["s0"], b["t14"], q, c["sigma_lb"],
                c["n_ds"], beta_temp, self.beta)
            lp.copy_(lp_)
            b["gDs"].copy_(gDs)
            return
        launch = self._energy
        launch.rebind(3, q)
        launch.rebind(6, beta_temp)
        launch.rebind(11, lp)
        launch(stream)

    def bwd(self, q, beta_temp, grad, stream) -> None:
        """gpart, gcat[..., N:] and grad[:, N*D:] (the caller's) from gdr
        and delta."""
        if self.plain:
            c, b = self.consts, self.bufs
            b["gpart"].copy_(manifold_bwd_plain(
                self.f_vec, self.I, b["gdr"], b["delta"], q, c["x0T"],
                c["mask"], c["y"], c["sigma_lb"], c["n_ds"], beta_temp,
                b["gcat"], grad))
            return
        launch = self._bwd
        launch.rebind(2, q)
        launch.rebind(8, beta_temp)
        launch.rebind(14, grad)
        launch(stream)
