"""Limited-memory BFGS minimizer (counterpart of magi_v2_tpu/ops/lbfgs.py).

The JAX package runs the whole optimization inside one ``lax.while_loop``;
here the iterations and the line-search trials are a host loop, PyTorch's
idiom, with the same decisions, so that both walk the same iterates:

- the curvature history is a fixed (m, n) ring buffer ordered most recent
  first (``jnp.roll`` order), its empty slots masked; the update of a pair
  is made on the device (``torch.where``), nothing of it is read back;
- a pair is kept when s.y > 1e-10 |s||y|; the initial Hessian scale comes
  from slot 0; the step falls back to steepest descent whenever the
  two-loop direction is not one of descent;
- the line search is the strong-Wolfe bracketing and bisection zoom of
  Nocedal & Wright Alg. 3.5/3.6 (c2 = 0.9) as one state machine: state 0
  brackets by doubling from t = 1, state 1 zooms, 2 accepts, 3 fails; the
  zoom collapses at 10 eps max(1, |lo|) and takes ``lo`` (which always
  satisfies Armijo), and a search whose budget runs out falls back to
  ``lo`` when it has moved;
- an iteration ends the run on the gradient's sup-norm test or on a failed
  search; the loss trace has ``num_iters`` entries, its tail repeating the
  final loss.

Each objective evaluation reads one small tensor from the device: f(t),
phi'(t) = g(t).d and the sup-norm of g(t) (the first trial of an
iteration also carries phi'(0)). The host's decisions are made on NumPy
scalars of the objective's dtype, so they round as the device does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from magi_v2_tpu_torch.utils.profiling import untimed


class LbfgsResult(NamedTuple):
    params: Any               # a dict like x0, or a tensor when x0 is one
    loss: torch.Tensor        # objective at ``params`` (0-dim)
    grad_norm: torch.Tensor   # sup-norm of the gradient at ``params``
    converged: bool           # grad_norm <= tol at exit
    num_iters: int            # iterations applied
    losses: torch.Tensor      # (num_iters,) per-iteration loss trace


def _flatten(x0):
    """(flat tensor, unflatten): a dict's tensors concatenated in sorted key
    order (``ravel_pytree``'s order), or a tensor's own elements."""
    if isinstance(x0, torch.Tensor):
        shape = x0.shape
        return x0.detach().reshape(-1), lambda x: x.reshape(shape)
    keys = sorted(x0)
    shapes = [x0[k].shape for k in keys]
    sizes = [x0[k].numel() for k in keys]
    flat = torch.cat([x0[k].detach().reshape(-1) for k in keys])

    def unflatten(x):
        parts = torch.split(x, sizes)
        return {k: p.reshape(s) for k, p, s in zip(keys, parts, shapes)}

    return flat, unflatten


def _two_loop(g, S, Y, rho, valid):
    """H.g by the two-loop recursion over the masked ring buffer: S, Y
    (m, n) most recent first, rho (m,) = 1/(s.y), valid (m,) bool. Empty
    slots contribute the identity, so an empty history gives H = I."""
    m = S.shape[0]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    mask = valid.to(g.dtype)
    q, alphas = g, [None] * m
    for i in range(m):
        a = torch.where(valid[i], rho[i] * torch.dot(S[i], q), zero)
        q = q - a * mask[i] * Y[i]
        alphas[i] = a
    sy = torch.dot(S[0], Y[0])
    yy = torch.dot(Y[0], Y[0])
    gamma = torch.where(valid[0] & (yy > 0.0),
                        sy / torch.clamp(yy, min=1e-300), zero + 1.0)
    r = gamma * q
    for i in range(m - 1, -1, -1):
        b = torch.where(valid[i], rho[i] * torch.dot(Y[i], r), zero)
        r = r + mask[i] * (alphas[i] - b) * S[i]
    return r


def _push(buf, new, keep):
    """buf rolled by one slot with ``new`` in slot 0 where ``keep`` (a
    0-dim bool tensor), else buf."""
    rolled = torch.cat([new.reshape((1,) + buf.shape[1:]), buf[:-1]])
    return torch.where(keep, rolled, buf)


def lbfgs_minimize(
    fun: Callable[[Any], torch.Tensor],
    x0: Any,
    num_iters: int = 200,
    history_size: int = 10,
    tol: float = 1e-8,
    c1: float = 1e-4,
    max_backtracks: int = 25,
    timer=untimed,
) -> LbfgsResult:
    """Minimize the scalar ``fun`` from ``x0`` (a dict of tensors or a
    tensor), on x0's device and in its dtype. ``tol`` is on the sup-norm
    of the gradient; ``max_backtracks`` is the line search's budget of
    evaluations an iteration (bracketing and zoom together). A failed
    search ends the run at the current iterate, ``converged`` reporting
    the gradient test only. ``timer`` (``utils.profiling.PhaseTimer``)
    counts the iterations ("lbfgs_iters"), the value-and-gradient
    evaluations ("lbfgs_evals") and the reads of the device
    ("lbfgs_reads")."""
    x, unflatten = _flatten(x0)
    n, dtype, dev = x.shape[0], x.dtype, x.device
    fdt = np.dtype(str(dtype).removeprefix("torch.")).type
    eps = np.finfo(fdt).eps
    m = history_size
    one, zero, half = fdt(1.0), fdt(0.0), fdt(0.5)
    c1, c2 = fdt(c1), fdt(0.9)

    def value_and_grad(x):
        timer.count("lbfgs_evals")
        leaf = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(unflatten(leaf))
            (g,) = torch.autograd.grad(f, leaf)
        return f.detach(), g

    def read(*scalars):
        """The one read of an evaluation: NumPy scalars of ``fdt``."""
        timer.count("lbfgs_reads")
        return tuple(fdt(v) for v in torch.stack(scalars).cpu().numpy())

    def line_search(x, f0, g0, gn0, d):
        """(t, f_t, g_t, |g_t|_inf, ok) along ``d``; the gradient at the
        accepted point is returned, so the caller evaluates nothing
        again."""
        state, lo, f_lo, g_lo, gn_lo, hi = 0, zero, f0, g0, gn0, zero
        t, acc = one, (zero, f0, g0, gn0)
        dphi0 = None
        for _ in range(max_backtracks):
            f_dev, g_t = value_and_grad(x + float(t) * d)
            scalars = (f_dev, torch.dot(g_t, d), g_t.abs().max())
            if dphi0 is None:
                dphi0, f_t, dphi_t, gn_t = read(torch.dot(g0, d), *scalars)
            else:
                f_t, dphi_t, gn_t = read(*scalars)
            nan_t = not np.isfinite(f_t)
            armijo = bool(f_t <= f0 + c1 * t * dphi0)
            curv = bool(abs(dphi_t) <= -c2 * dphi0)
            accept = armijo and curv and not nan_t
            if state == 0:
                to_hi = (not armijo) or bool(f_t >= f_lo) or nan_t
                pos_slope = (armijo and not curv and bool(dphi_t >= 0)
                             and not nan_t)
                hi = t if to_hi else (lo if pos_slope else hi)
                state = 2 if accept else (1 if to_hi or pos_slope else 0)
                # lo walks forward while bracketing
                if pos_slope or state == 0:
                    lo, f_lo, g_lo, gn_lo = t, f_t, g_t, gn_t
                if accept:
                    acc = (t, f_t, g_t, gn_t)
                t = half * (lo + hi) if state == 1 else fdt(2.0) * t
            else:
                shrink_hi = (not armijo) or bool(f_t >= f_lo) or nan_t
                flip = (not shrink_hi and not curv
                        and bool(dphi_t * (hi - lo) >= 0))
                state = 2 if accept else 1
                hi = t if shrink_hi else (lo if flip else hi)
                if not shrink_hi:
                    lo, f_lo, g_lo, gn_lo = t, f_t, g_t, gn_t
                done = bool(abs(hi - lo) <= fdt(10 * eps) * max(one, abs(lo)))
                if done and state == 1:
                    state = 2 if lo > 0 else 3
                if accept:
                    acc = (t, f_t, g_t, gn_t)
                elif done and state == 2:
                    acc = (lo, f_lo, g_lo, gn_lo)
                t = half * (lo + hi)
            if state >= 2:
                break
        if state == 2:
            return (*acc, True)
        if lo > 0:       # the budget ran out: the Armijo-safe lo
            return lo, f_lo, g_lo, gn_lo, True
        return zero, f0, g0, gn0, False

    f_dev, g = value_and_grad(x)
    f, gn = read(f_dev, g.abs().max())
    S = torch.zeros((m, n), dtype=dtype, device=dev)
    Y = torch.zeros((m, n), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    valid = torch.zeros((m,), dtype=torch.bool, device=dev)
    losses, iters, done = [], 0, False
    while not done and iters < num_iters:
        d = -_two_loop(g, S, Y, rho, valid)
        d = torch.where(torch.dot(g, d) < 0.0, d, -g)
        t, f_new, g_new, gn_new, ok = line_search(x, f, g, gn, d)
        x_new = x + float(t) * d
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        keep = sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(y)
        S, Y = _push(S, s, keep), _push(Y, y, keep)
        rho = _push(rho, 1.0 / torch.clamp(sy, min=1e-300), keep)
        valid = _push(valid, torch.ones((), dtype=torch.bool, device=dev),
                      keep)
        x, f, g, gn = x_new, f_new, g_new, gn_new
        done = bool(gn <= tol) or not ok
        iters += 1
        timer.count("lbfgs_iters")
        losses.append(f)
    losses += [f] * (num_iters - iters)
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    return LbfgsResult(
        params=unflatten(x),
        loss=as_t(f),
        grad_norm=as_t(gn),
        converged=bool(gn <= tol),
        num_iters=iters,
        losses=as_t(np.asarray(losses, fdt)),
    )
