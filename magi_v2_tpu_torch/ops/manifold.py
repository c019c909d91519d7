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


def _launch(kernel, f_vec, dtype, args):
    fn = _entry(kernel, f_vec, dtype)
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of manifold_{kernel} failed: error {err}")
    LAUNCH_COUNTS[f"manifold_{kernel}"] += 1


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
             float(beta), C, N, dim, dr, gcat, t14])
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
             dim, lp, gDs])
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
             dim, gcat, gpart, grad])
    return gpart
