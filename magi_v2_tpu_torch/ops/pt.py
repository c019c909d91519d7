"""The replica exchange of parallel tempering (kernel ``pt_swap``,
csrc/pt.cu) and its plain PyTorch version.

One swap round of the even-odd scheme of magi_v2_tpu/sampler/run.py:
pt_swap on rung-major chains (chain r * M + m is replica m of rung r, at
beta_r of the ladder ``betas``, beta_0 = 1): for each adjacent pair (i,
i + 1) of the round's parity (i % 2 == parity) and each replica m,

    log alpha = (beta_i - beta_{i+1}) (lp[(i+1) M + m] - lp[i M + m]),

lp the log-posterior at beta = 1, and the two states and their lp swap iff
log alpha is finite and log u[i, m] < log alpha, in the sampling dtype.
Each gap beta_i - beta_{i+1} is taken in float64 and then cast, as the
JAX function casts it (``ladder_gaps``). ``prop`` and ``accs`` count the
proposals and acceptances of each pair as integers.

``pt_swap_plain`` is the plain version (the CPU path and the oracle):
new tensors out. ``bind_pt_swap`` binds the kernel to fixed tensors
(checked once; q and lp updated in place, the counters added to, the
parity read from a one-int tensor), on the CPU the plain version;
``pt_swap`` is one call of it. On a CUDA tensor the wrapper launches the
kernel or raises. ``LAUNCH_COUNTS`` counts kernel launches only.
"""

from __future__ import annotations

import torch

KERNELS = ("pt_swap",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


def ladder_gaps(betas, dtype, device):
    """(R - 1,) beta_i - beta_{i+1} of the ladder ``betas`` (floats), each
    taken in float64 and cast to ``dtype``."""
    b = [float(x) for x in betas]
    return torch.tensor([b[i] - b[i + 1] for i in range(len(b) - 1)],
                        dtype=torch.float64).to(dtype=dtype, device=device)


def pt_swap_plain(q, lp1, betas, u, parity: int):
    """One swap round (see the module's docstring) on q (C, dim) and lp1
    (C,) at beta = 1, with uniforms u (R - 1, M) and ``parity`` 0 or 1.
    Returns (q, lp) after the round (new tensors) and the round's proposals
    and acceptances per pair, (R - 1,) int32 each."""
    R = len(betas)
    C, dim = q.shape
    M = C // R
    dlb = ladder_gaps(betas, q.dtype, q.device)
    qr = q.reshape(R, M, dim).clone()
    lpr = lp1.reshape(R, M).clone()
    prop = torch.zeros((R - 1,), dtype=torch.int32, device=q.device)
    accs = torch.zeros_like(prop)
    for i in range(R - 1):
        if i % 2 != parity:
            continue
        log_alpha = dlb[i] * (lpr[i + 1] - lpr[i])
        acc = torch.isfinite(log_alpha) & (torch.log(u[i]) < log_alpha)
        qi, qj = qr[i].clone(), qr[i + 1].clone()
        qr[i] = torch.where(acc[:, None], qj, qi)
        qr[i + 1] = torch.where(acc[:, None], qi, qj)
        li, lj = lpr[i].clone(), lpr[i + 1].clone()
        lpr[i] = torch.where(acc, lj, li)
        lpr[i + 1] = torch.where(acc, li, lj)
        prop[i] = M
        accs[i] = acc.sum()
    return qr.reshape(C, dim), lpr.reshape(C), prop, accs


_ENTRIES = {}


def _entry(dt):
    fn = _ENTRIES.get(dt)
    if fn is None:
        from magi_v2_tpu_torch.ops._build import load_library

        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"pt_swap takes float32 or float64, not {dt}")
        suffix = "f32" if dt == torch.float32 else "f64"
        fn = _ENTRIES[dt] = load_library().entry(f"magi_pt_swap_{suffix}",
                                                 "pt_swap")
    return fn


def bind_pt_swap(q, lp, betas, u, parity, prop, accs):
    """The swap kernel bound to its operands, checked here once: a callable
    of the stream that runs one swap round on what the tensors hold at the
    call (on the CPU the plain version). q (C, dim) and lp (C,) are updated
    in place, C = R M for the ladder ``betas`` (R floats); u (R - 1, M) in
    q's dtype; ``parity`` a (1,) int32 tensor; ``prop`` and ``accs`` (R -
    1,) int32 counters, added to."""
    dev, dt = q.device, q.dtype
    R = len(betas)
    if q.dim() != 2 or R < 2 or q.shape[0] % R:
        raise ValueError(f"q must be (C, dim) with C a multiple of the "
                         f"ladder's {R} rungs (at least 2)")
    C, dim = q.shape
    M = C // R
    for name, t, shape, want in (
            ("lp", lp, (C,), dt), ("u", u, (R - 1, M), dt),
            ("parity", parity, (1,), torch.int32),
            ("prop", prop, (R - 1,), torch.int32),
            ("accs", accs, (R - 1,), torch.int32)):
        if not (isinstance(t, torch.Tensor) and t.dtype == want
                and t.device == dev and t.shape == shape):
            raise TypeError(f"{name} must be a {shape} {want} tensor on "
                            f"{dev}")
    if dev.type == "cpu":
        def run(stream=None):
            q2, lp2, dp, da = pt_swap_plain(q, lp, betas, u, int(parity))
            q.copy_(q2)
            lp.copy_(lp2)
            prop.add_(dp)
            accs.add_(da)
        return run
    if dev.type != "cuda":
        raise ValueError(f"pt_swap runs on cpu or cuda, not {dev}")
    for name, t in (("q", q), ("lp", lp), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from magi_v2_tpu_torch.ops._build import Launch

    dlb = ladder_gaps(betas, dt, dev)
    return Launch(_entry(dt), [q, lp, dlb, u, parity, R, M, dim, prop, accs],
                  LAUNCH_COUNTS, "pt_swap")


def pt_swap(q, lp, betas, u, parity: int, prop, accs) -> None:
    """One swap round on the current stream, in place (``bind_pt_swap``'s
    arguments, ``parity`` an int)."""
    from magi_v2_tpu_torch.ops.banded import launch_stream

    par = torch.tensor([int(parity)], dtype=torch.int32, device=q.device)
    bind_pt_swap(q, lp, betas, u, par, prop, accs)(launch_stream(q.device))
