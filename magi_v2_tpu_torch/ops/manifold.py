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

The whitened target (reparam="whitened", X = mu + L z with L = C^{1/2})
takes ``manifold_fwd`` in its whitened form: given dz = z - z0 (C, D, N)
and z0 (D, N) in place of R delta and a0, t1 = sum dz (dz + 2 z0) and the
seed -(beta_T/beta)(dz + z0) is the gradient of t1 in z itself (the target
adds L' g_delta onto it). The form is fixed when the plan is made
(``whitened=True``); its launches count under "manifold_fwd" and under
"manifold_fwd_whitened_<functor>".

Each wrapper checks its arguments, takes the plain version (``*_plain``)
for tensors on the CPU, and on a CUDA tensor launches the hand-written
kernel of csrc/manifold.cu or raises: there is no fallback on the card.
A model with a CUDA functor (``models.odes.cuda_model_of``) has kernels
that evaluate the field themselves. Any other field takes the ``given``
kernels of the same file: PyTorch evaluates the field (before the fwd
kernel) and its VJPs (before the bwd kernel) on the card's tensors, and
the kernels do the rest; a CUDA graph captures both. Which kernels a field
takes is fixed by the field; a launch that fails raises either way.
``LAUNCH_COUNTS`` counts kernel launches only, under the three names
whichever kernels they are (``launch_counts``), and again under the name
and the functor (``functor_launch_counts``: "manifold_fwd_hes1_log", ...;
"manifold_fwd_given" for the given kernels), and a launch with a
temperature per chain a third time, with "_pt" after the functor
("manifold_fwd_hes1_log_pt").

The temperature beta_temp is a 0-dim tensor (one for all chains) or one
per chain, (C,) (parallel tempering: chain c at its rung's beta). The
kernels read it at beta_temp[c * stride], the stride 0 or 1 by its shape;
the plain versions broadcast it over the chain axis.

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
(D, N); sigma_lb, n_ds (D,); beta_temp 0-dim or (C,); beta a float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magi_v2_tpu_torch.models.odes import MODEL_REGISTRY, cuda_model_of

KERNELS = ("manifold_fwd", "manifold_energy", "manifold_bwd")
# the kernels' model functors (csrc/manifold.cu), and "given"
FUNCTORS = tuple(m.cuda_model for m in MODEL_REGISTRY.values()
                 if m.cuda_model) + ("given",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS
                 + tuple(f"{k}_{m}{pt}"
                         for k in KERNELS + ("manifold_fwd_whitened",)
                         for m in FUNCTORS for pt in ("", "_pt"))}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    """Launches by kernel, whichever functor."""
    return {k: LAUNCH_COUNTS[k] for k in KERNELS}


def functor_launch_counts() -> dict:
    """Launches by kernel and functor ("manifold_fwd_hes1_log", ...; the
    whitened form's as "manifold_fwd_whitened_seir", ...), and those with a
    temperature per chain again with "_pt" after the functor."""
    return {k: n for k, n in LAUNCH_COUNTS.items() if k not in KERNELS}


# --------------------------------------------------------------------------
# plain versions (the CPU path and the oracle of the kernels)
# --------------------------------------------------------------------------


def _softplus(x):
    """log(1 + e^x) to the last bit at any x, as the kernels and
    jax.nn.softplus compute it (F.softplus returns x itself above 20,
    which is e^-20 off: 1e-10 of theta = 20, Hes1's f)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _chains(beta_temp, ndim: int, axis: int):
    """beta_temp shaped to broadcast over a tensor of ``ndim`` dimensions
    whose chain axis is ``axis``: as it is when 0-dim, else (C,) viewed
    with ones around the chain axis."""
    if beta_temp.dim() == 0:
        return beta_temp
    shape = [1] * ndim
    shape[axis] = -1
    return beta_temp.view(shape)


def _split_q(q, N, D):
    """(sigma_pre (C, D), theta_pre (C, P)) from the flat states."""
    ND = N * D
    return q[:, ND: ND + D], q[:, ND + D:]


def field_values(f_vec, I, delta, q, x0T):
    """f(X, softplus theta) (C, N, D) at X = x0 + delta: the field's values
    that the plain fwd and the given fwd kernel take."""
    C, D, N = delta.shape
    X = (x0T[None] + delta).transpose(1, 2)                  # (C, N, D)
    return f_vec(I, X, _softplus(_split_q(q, N, D)[1]))


def field_vjp(f_vec, I, gdr, delta, q, x0T):
    """(J_x^T g (C, N, D), J_theta^T g (C, P) summed over the points) of
    the field at X = x0 + delta for g = gdr (D, C, N): what the plain bwd
    and the given bwd kernel take."""
    C, D, N = delta.shape
    X = (x0T[None] + delta).transpose(1, 2)                  # (C, N, D)
    _, vjp = torch.func.vjp(lambda X_, th_: f_vec(I, X_, th_), X,
                            _softplus(_split_q(q, N, D)[1]))
    return vjp(gdr.permute(1, 2, 0))


def manifold_fwd_plain(f_vec, I, delta, RmD, q, x0T, a0, f0, mask, y,
                       sigma_lb, beta_temp, beta, dz=None):
    """With ``dz`` (C, D, N), the whitened form: dz is t1's operand in
    place of R delta (the first half of RmD, then not read) and ``a0`` is
    z0."""
    C, D, N = delta.shape
    sp, tp = _split_q(q, N, D)
    f = field_values(f_vec, I, delta, q, x0T).permute(2, 0, 1)  # (D, C, N)
    Rd = RmD[..., :N] if dz is None else dz.transpose(0, 1)
    md = RmD[..., N:]
    dr = (f - f0[:, None, :]) - md
    scale = _chains(beta_temp / beta, 3, 1)
    gcat = torch.empty_like(RmD)
    gcat[..., :N] = -scale * (Rd + a0[:, None, :])
    t1 = torch.sum(Rd * (Rd + 2.0 * a0[:, None, :]), dim=(0, 2))
    inv_var = 1.0 / (_softplus(sp) + sigma_lb)               # (C, D)
    r = x0T[None] + delta - y[None]                           # (C, D, N)
    t4 = torch.sum(torch.sum(mask * r * r, dim=-1) * inv_var, dim=-1)
    return dr.contiguous(), gcat, torch.stack([t1, t4], dim=-1)


def manifold_energy_plain(f_vec, Ds, s0, t14, q, sigma_lb, n_ds, beta_temp,
                          beta):
    D, C, N = Ds.shape
    sp, tp = _split_q(q, N, D)
    t2 = torch.sum(Ds * (Ds + 2.0 * s0[:, None, :]), dim=(0, 2))
    sig2 = _softplus(sp) + sigma_lb
    t3 = torch.sum(n_ds * torch.log(2.0 * torch.pi * sig2), dim=-1)
    lj = (torch.sum(F.logsigmoid(sp), dim=-1)
          + torch.sum(F.logsigmoid(tp), dim=-1))
    lp = beta_temp * (-0.5 * ((t14[:, 0] + t2) / beta + t3 + t14[:, 1]) + lj)
    gDs = -_chains(beta_temp / beta, 3, 1) * (Ds + s0[:, None, :])
    return lp, gDs


def manifold_bwd_plain(f_vec, I, gdr, delta, q, x0T, mask, y, sigma_lb, n_ds,
                       beta_temp, gcat, grad):
    C, D, N = delta.shape
    ND = N * D
    sp, tp = _split_q(q, N, D)
    gX, gth = field_vjp(f_vec, I, gdr, delta, q, x0T)        # (C,N,D), (C,P)
    gcat[..., N:] = gdr
    sig2 = _softplus(sp) + sigma_lb                          # (C, D)
    r = x0T[None] + delta - y[None]                           # (C, D, N)
    ssr = torch.sum(mask * r * r, dim=-1)
    bt3, bt2 = _chains(beta_temp, 3, 0), _chains(beta_temp, 2, 0)
    gpart = (gX.transpose(1, 2)
             - bt3 * mask * r / sig2[..., None]).transpose(0, 1)
    g_s2 = -0.5 * bt2 * (n_ds / sig2 - ssr / (sig2 * sig2))
    grad[:, ND: ND + D] = (g_s2 * torch.sigmoid(sp)
                           + bt2 * torch.sigmoid(-sp))
    grad[:, ND + D:] = gth * torch.sigmoid(tp) + bt2 * torch.sigmoid(-tp)
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
# of per-CTA partial sums (manifold_bwd: P + D values for a functor's
# model, 11 at most among the registered fields; kMaxD = 8 for a given
# field; at most _PART_WIDTH)
_CHUNK = 128
_PART_WIDTH = 16
# the most components a field with no functor may have (csrc/manifold.cu:
# kMaxD)
_GIVEN_MAX_D = 8


def _given(f_vec) -> bool:
    """Whether K1 takes its ``given`` kernels for ``f_vec`` on the card:
    for a field with no CUDA functor."""
    return cuda_model_of(f_vec) is None


def _entry(kernel, f_vec, dtype):
    fn = _ENTRIES.get((kernel, f_vec, dtype))
    if fn is not None:
        return fn
    from magi_v2_tpu_torch.ops._build import load_library

    if dtype == torch.float32:
        suffix = "f32"
    elif dtype == torch.float64:
        suffix = "f64"
    else:
        raise TypeError(f"manifold kernels take float32 or float64, not {dtype}")
    family = f"manifold_{kernel}" + ("_given" if _given(f_vec) else "")
    model = cuda_model_of(f_vec) or "given"
    fn = _ENTRIES[(kernel, f_vec, dtype)] = load_library().entry(
        f"magi_manifold_{kernel}_{model}_{suffix}", family)
    return fn


def _takes_plain(device) -> bool:
    """Whether a call on ``device`` runs the plain version: on the CPU
    only."""
    return device.type == "cpu"


def _check_width(f_vec, D: int, P: int) -> None:
    """The per-chain sums the kernels pass for this model fit a row of
    ``part``."""
    if _given(f_vec):
        if D > _GIVEN_MAX_D:
            raise ValueError(
                f"the CUDA manifold kernels take a field of at most "
                f"{_GIVEN_MAX_D} components, not {D}; widen kMaxD in "
                "csrc/manifold.cu and _GIVEN_MAX_D here")
    elif P + D > _PART_WIDTH:
        raise ValueError(
            f"the CUDA manifold kernels pass at most {_PART_WIDTH} per-chain "
            f"sums of a model (theta and sigma gradients: P + D = {P} + {D}); "
            "widen _PART_WIDTH in ops/manifold.py for this model")


def make_scratch(C: int, N: int, dtype, device):
    """(part (C, G, _PART_WIDTH), ticket (C,) int32 zeros), G the most CTAs
    a chain gets: what the kernels pass a chain's partial sums through."""
    G = -(-N // _CHUNK)
    return (torch.empty((C, G, _PART_WIDTH), dtype=dtype, device=device),
            torch.zeros((C,), dtype=torch.int32, device=device))


def _given_values(f_vec, I, delta, q, x0T):
    """The field's values for the given fwd kernel, checked."""
    C, D, N = delta.shape
    fv = field_values(f_vec, I, delta, q, x0T).contiguous()
    _check_all((("f_vec's values", fv, (C, N, D)),), delta.dtype,
               delta.device)
    return fv


def _given_vjp(f_vec, I, gdr, delta, q, x0T):
    """The field's VJPs for the given bwd kernel, checked."""
    C, D, N = delta.shape
    gx, gth = (t.contiguous() for t in field_vjp(f_vec, I, gdr, delta, q,
                                                 x0T))
    _check_all((("J_x^T g", gx, (C, N, D)),
                ("J_theta^T g", gth, (C, q.shape[1] - N * D - D))),
               delta.dtype, delta.device)
    return gx, gth


# The kernels' argument lists. beta_temp's stride follows it (0: one
# temperature for all chains, 1: one per chain). A given field's kernels
# take the field's values (fwd) or VJPs (bwd) after the stride and D after
# N; ``_AT`` holds where each per-call argument stands.
def _fwd_args(given, delta, RmD, q, x0T, a0, f0, mask, y, sigma_lb,
              beta_temp, fv, beta, C, N, D, dim, dr, gcat, t14, scratch,
              dz=None, beta_stride=0):
    return ([delta, RmD] + ([] if dz is None else [dz])
            + [q, x0T, a0, f0, mask, y, sigma_lb, beta_temp, beta_stride]
            + ([fv] if given else []) + [float(beta), C, N]
            + ([D] if given else []) + [dim, dr, gcat, t14, *scratch])


def _energy_args(given, Ds, s0, t14, q, sigma_lb, n_ds, beta_temp, beta, C,
                 N, D, dim, lp, gDs, scratch, beta_stride=0):
    return ([Ds, s0, t14, q, sigma_lb, n_ds, beta_temp, beta_stride,
             float(beta), C, N]
            + ([D] if given else []) + [dim, lp, gDs, *scratch])


def _bwd_args(given, gdr, delta, q, x0T, mask, y, sigma_lb, n_ds, beta_temp,
              vjp, C, N, D, dim, gcat, gpart, grad, scratch, beta_stride=0):
    return ([gdr, delta, q, x0T, mask, y, sigma_lb, n_ds, beta_temp,
             beta_stride]
            + (list(vjp) if given else []) + [C, N]
            + ([D] if given else []) + [dim, gcat, gpart, grad, *scratch])


_AT = {False: dict(fwd=dict(q=2, beta_temp=9),
                   fwd_whitened=dict(q=3, beta_temp=10),
                   energy=dict(q=3, beta_temp=6, lp=12),
                   bwd=dict(q=2, beta_temp=8, grad=15)),
       True: dict(fwd=dict(q=2, beta_temp=9, fv=11),
                  fwd_whitened=dict(q=3, beta_temp=10, fv=12),
                  energy=dict(q=3, beta_temp=6, lp=13),
                  bwd=dict(q=2, beta_temp=8, gx=10, gth=11, grad=18))}


def _stride(beta_temp) -> int:
    """beta_temp's stride over the chains: 0 for one temperature, 1 for
    one per chain."""
    return int(beta_temp.dim() == 1)


def _beta_shape(beta_temp, C: int) -> tuple:
    """The shape beta_temp is checked against: (C,) for a 1-d tensor, else
    0-dim."""
    per_chain = isinstance(beta_temp, torch.Tensor) and beta_temp.dim() == 1
    return (C,) if per_chain else ()


def _prepare(kernel, f_vec, dtype, args, per_chain: bool = False):
    """The launch of ``kernel`` ("fwd", "fwd_whitened", "energy", "bwd"),
    counted under its kernel's name and under its own name and functor,
    and, with a temperature per chain (``per_chain``), again with "_pt"
    after the functor."""
    from magi_v2_tpu_torch.ops._build import Launch

    name = f"manifold_{kernel}"
    own = f"{name}_{cuda_model_of(f_vec) or 'given'}"
    return Launch(_entry(kernel, f_vec, dtype), args, LAUNCH_COUNTS,
                  (name.replace("_whitened", ""), own)
                  + ((own + "_pt",) if per_chain else ()))


def _launch(kernel, f_vec, dtype, args, per_chain: bool):
    _prepare(kernel, f_vec, dtype, args, per_chain)(
        torch.cuda.current_stream(args[0].device).cuda_stream)


def _on_card(name, dev, f_vec, D, dim, N):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    _check_width(f_vec, D, dim - N * D - D)


def manifold_fwd(f_vec, I, delta, RmD, q, x0T, a0, f0, mask, y, sigma_lb,
                 beta_temp, beta: float, dz=None):
    """-> dr (D, C, N), gcat (D, C, 2N) with the first half set, t14 (C, 2).
    With ``dz`` (C, D, N), the whitened form (``a0`` is then z0)."""
    C, D, N = delta.shape
    dev, dt = delta.device, delta.dtype
    dim = q.shape[1]
    _check_all((
        ("delta", delta, (C, D, N)), ("RmD", RmD, (D, C, 2 * N)),
        ("q", q, (C, dim)), ("x0T", x0T, (D, N)), ("a0", a0, (D, N)),
        ("f0", f0, (D, N)), ("mask", mask, (D, N)), ("y", y, (D, N)),
        ("sigma_lb", sigma_lb, (D,)),
        ("beta_temp", beta_temp, _beta_shape(beta_temp, C)),
    ) + (() if dz is None else (("dz", dz, (C, D, N)),)), dt, dev)
    if _takes_plain(dev):
        return manifold_fwd_plain(f_vec, I, delta, RmD, q, x0T, a0, f0, mask,
                                  y, sigma_lb, beta_temp, beta, dz)
    _on_card("manifold_fwd", dev, f_vec, D, dim, N)
    given = _given(f_vec)
    fv = _given_values(f_vec, I, delta, q, x0T) if given else None
    dr = torch.empty((D, C, N), dtype=dt, device=dev)
    gcat = torch.empty((D, C, 2 * N), dtype=dt, device=dev)
    t14 = torch.empty((C, 2), dtype=dt, device=dev)
    per_chain = _stride(beta_temp)
    _launch("fwd" if dz is None else "fwd_whitened", f_vec, dt, _fwd_args(
        given, delta, RmD, q, x0T, a0, f0, mask, y, sigma_lb, beta_temp, fv,
        beta, C, N, D, dim, dr, gcat, t14, make_scratch(C, N, dt, dev), dz,
        per_chain), per_chain)
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
        ("n_ds", n_ds, (D,)),
        ("beta_temp", beta_temp, _beta_shape(beta_temp, C)),
    ), dt, dev)
    if _takes_plain(dev):
        return manifold_energy_plain(f_vec, Ds, s0, t14, q, sigma_lb, n_ds,
                                     beta_temp, beta)
    _on_card("manifold_energy", dev, f_vec, D, dim, N)
    lp = torch.empty((C,), dtype=dt, device=dev)
    gDs = torch.empty((D, C, N), dtype=dt, device=dev)
    per_chain = _stride(beta_temp)
    _launch("energy", f_vec, dt, _energy_args(
        _given(f_vec), Ds, s0, t14, q, sigma_lb, n_ds, beta_temp, beta, C, N,
        D, dim, lp, gDs, make_scratch(C, N, dt, dev), per_chain), per_chain)
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
        ("beta_temp", beta_temp, _beta_shape(beta_temp, C)),
        ("gcat", gcat, (D, C, 2 * N)),
        ("grad", grad, (C, dim)),
    ), dt, dev)
    if _takes_plain(dev):
        return manifold_bwd_plain(f_vec, I, gdr, delta, q, x0T, mask, y,
                                  sigma_lb, n_ds, beta_temp, gcat, grad)
    _on_card("manifold_bwd", dev, f_vec, D, dim, N)
    given = _given(f_vec)
    vjp = _given_vjp(f_vec, I, gdr, delta, q, x0T) if given else None
    gpart = torch.empty((D, C, N), dtype=dt, device=dev)
    per_chain = _stride(beta_temp)
    _launch("bwd", f_vec, dt, _bwd_args(
        given, gdr, delta, q, x0T, mask, y, sigma_lb, n_ds, beta_temp, vjp,
        C, N, D, dim, gcat, gpart, grad, make_scratch(C, N, dt, dev),
        per_chain), per_chain)
    return gpart


class ManifoldPlan:
    """The three K1 kernels bound to a target's constants and to the
    buffers of one chain count.

    ``consts``: x0T, a0, f0, s0, mask, y (D, N), sigma_lb, n_ds (D,).
    ``bufs``: delta (C, D, N), RmD, gcat (D, C, 2N), dr, Ds, gDs, gdr,
    gpart (D, C, N), t14 (C, 2); the operator stages around the kernels
    write delta, RmD, Ds and gdr, the kernels the rest. ``whitened``: fwd
    takes its whitened form, reading ``bufs["dz"]`` (C, D, N) and z0 as
    ``consts["a0"]``, and RmD's second half only. Everything is
    checked here, once. ``fwd``, ``energy`` and ``bwd`` then take the
    state q (C, dim), beta_temp (0-dim, or (C,): one temperature per
    chain, which picks the launches of stride 1), the output that belongs
    to the caller (lp (C,), grad (C, dim)) and the stream, trust them (the
    caller checks q and beta_temp once per evaluation), and overwrite the
    buffers. For a
    field with no functor, fwd and bwd first evaluate the field or its
    VJPs with PyTorch on the card and point the launch at the result."""

    def __init__(self, f_vec, I, consts: dict, beta: float, dim: int,
                 bufs: dict, whitened: bool = False):
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
                    for k in ("dr", "Ds", "gDs", "gdr", "gpart"))
            + ((("dz", bufs["dz"], (C, D, N)),) if whitened else ()),
            dt, dev)
        self.whitened = whitened
        self.fwd_kernel = "fwd_whitened" if whitened else "fwd"
        if dim < N * D + D:
            raise ValueError(f"a state of {dim} entries does not hold "
                             f"{N} x {D} points and {D} noise levels")
        self.f_vec, self.I, self.beta = f_vec, I, float(beta)
        self.consts, self.bufs = dict(consts), dict(bufs)
        self.plain = _takes_plain(dev)
        if self.plain:
            return
        _on_card("ManifoldPlan", dev, f_vec, D, dim, N)
        self.given = _given(f_vec)
        self.at = _AT[self.given]
        c, b = self.consts, self.bufs
        self.scratch = make_scratch(C, N, dt, dev)
        # q and beta_temp (and lp, grad, the field's values and VJPs) are
        # bound at each call: the pointers given here stand in for them.
        # Each kernel has a launch of stride 0 and one of stride 1 (a
        # temperature per chain), indexed by the stride.
        q0 = bt0 = out0 = delta
        self._fwd, self._energy, self._bwd = [], [], []
        for st in (0, 1):
            self._fwd.append(_prepare(self.fwd_kernel, f_vec, dt, _fwd_args(
                self.given, delta, b["RmD"], q0, c["x0T"], c["a0"], c["f0"],
                c["mask"], c["y"], c["sigma_lb"], bt0, out0, self.beta, C, N,
                D, dim, b["dr"], b["gcat"], b["t14"], self.scratch,
                b["dz"] if whitened else None, st), st))
            self._energy.append(_prepare("energy", f_vec, dt, _energy_args(
                self.given, b["Ds"], c["s0"], b["t14"], q0, c["sigma_lb"],
                c["n_ds"], bt0, self.beta, C, N, D, dim, out0, b["gDs"],
                self.scratch, st), st))
            self._bwd.append(_prepare("bwd", f_vec, dt, _bwd_args(
                self.given, b["gdr"], delta, q0, c["x0T"], c["mask"],
                c["y"], c["sigma_lb"], c["n_ds"], bt0, (out0, out0), C, N, D,
                dim, b["gcat"], b["gpart"], out0, self.scratch, st), st))

    def _run(self, launch, at, stream, **now) -> None:
        for name, t in now.items():
            launch.rebind(at[name], t)
        launch(stream)

    def fwd(self, q, beta_temp, stream) -> None:
        """dr, gcat[..., :N] and t14 from delta and RmD (and, in the
        whitened form, dz)."""
        c, b = self.consts, self.bufs
        if self.plain:
            dr, gcat, t14 = manifold_fwd_plain(
                self.f_vec, self.I, b["delta"], b["RmD"], q, c["x0T"],
                c["a0"], c["f0"], c["mask"], c["y"], c["sigma_lb"],
                beta_temp, self.beta, b["dz"] if self.whitened else None)
            N = dr.shape[-1]
            b["dr"].copy_(dr)
            b["gcat"][..., :N].copy_(gcat[..., :N])
            b["t14"].copy_(t14)
            return
        now = dict(q=q, beta_temp=beta_temp)
        if self.given:
            # kept until the launch is enqueued; the caching allocator
            # orders its reuse on this stream
            now["fv"] = _given_values(self.f_vec, self.I, b["delta"], q,
                                      c["x0T"])
        self._run(self._fwd[_stride(beta_temp)], self.at[self.fwd_kernel],
                  stream, **now)

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
        self._run(self._energy[_stride(beta_temp)], self.at["energy"], stream,
                  q=q, beta_temp=beta_temp, lp=lp)

    def bwd(self, q, beta_temp, grad, stream) -> None:
        """gpart, gcat[..., N:] and grad[:, N*D:] (the caller's) from gdr
        and delta."""
        c, b = self.consts, self.bufs
        if self.plain:
            b["gpart"].copy_(manifold_bwd_plain(
                self.f_vec, self.I, b["gdr"], b["delta"], q, c["x0T"],
                c["mask"], c["y"], c["sigma_lb"], c["n_ds"], beta_temp,
                b["gcat"], grad))
            return
        now = dict(q=q, beta_temp=beta_temp, grad=grad)
        if self.given:
            now["gx"], now["gth"] = _given_vjp(self.f_vec, self.I, b["gdr"],
                                               b["delta"], q, c["x0T"])
        self._run(self._bwd[_stride(beta_temp)], self.at["bwd"], stream,
                  **now)
