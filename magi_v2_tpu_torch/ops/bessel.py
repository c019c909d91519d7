"""Differentiable modified Bessel function K_nu(z) in PyTorch (counterpart of
magi_v2_tpu/ops/bessel.py).

Same algorithm as the JAX package: Temme's power series for z <= 2 and
Steed's continued fraction CF2 for z > 2 give (K_mu, K_{mu+1}) for
mu in (0, 1); the upward recurrence climbs to higher orders. The JAX custom
JVP becomes ``KvLadder``, a ``torch.autograd.Function`` whose backward calls
the ladder again with one more order, so it can be differentiated again.

CF2 freezes each lane once it has converged (as the JAX version does), so
stopping the loop when every lane is frozen gives the values of the
fixed-count loop; the loop checks that every ``_CF2_CHECK`` iterations.
"""

from __future__ import annotations

import math

import torch
from scipy.special import gamma as _scipy_gamma

_SERIES_ITERS = 40
_CF2_ITERS = 160
_CF2_CHECK = 8
_EXP_UNDERFLOW_Z = 700.0


def _tiny(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-30


def _temme_series(z, mu: float):
    """(K_mu(z), K_{mu+1}(z)) for 0 < z <= 2, |mu| < 1."""
    gampl = 1.0 / _scipy_gamma(1.0 + mu)
    gammi = 1.0 / _scipy_gamma(1.0 - mu)
    gam1 = (gammi - gampl) / (2.0 * mu) if mu != 0.0 else 0.5772156649015329
    gam2 = 0.5 * (gammi + gampl)
    pimu = math.pi * mu
    fact = pimu / math.sin(pimu) if mu != 0.0 else 1.0
    nu2 = mu * mu

    d = -torch.log(z / 2.0)
    e = mu * d
    safe_e = torch.where(e == 0, torch.ones_like(e), e)
    fact2 = torch.where(torch.abs(e) < 1e-30, torch.ones_like(e),
                        torch.sinh(e) / safe_e)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ee = torch.exp(e)
    p = 0.5 * ee / gampl
    q = 0.5 / (ee * gammi)
    c = torch.ones_like(z)
    dd = z * z / 4.0
    s, s1 = ff, p
    for i in range(1, _SERIES_ITERS + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - nu2)
        c = c * dd / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        s = s + c * ff
        s1 = s1 + c * (p - fi * ff)
    return s, s1 * (2.0 / z)


def _steed_cf2(z, mu: float):
    """(K_mu(z), K_{mu+1}(z)) for z > 2 via Steed's continued fraction."""
    nu2 = mu * mu
    a1 = 0.25 - nu2
    eps = torch.finfo(z.dtype).eps

    b0 = 2.0 * (1.0 + z)
    d0 = 1.0 / b0
    full = lambda v: torch.full_like(z, v)
    # carry rows: b, d, h, delh, q1, q2, q, c, a, s
    carry = torch.stack([
        b0, d0, d0, d0, full(0.0), full(1.0), full(a1), full(a1), full(-a1),
        1.0 + a1 * d0,
    ])
    done = torch.zeros_like(z, dtype=torch.bool)
    for i in range(2, _CF2_ITERS + 2):
        b, d, h, delh, q1, q2, q, c, a, s = carry.unbind(0)
        fi = float(i)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        s_n = s + q_n * delh_n
        new = torch.stack([b_n, d_n, h + delh_n, delh_n, q2, qnew, q_n, c_n,
                           a_n, s_n])
        carry = torch.where(done, carry, new)
        done = done | (torch.abs(q_n * delh_n) <= eps * torch.abs(s_n))
        if (i - 1) % _CF2_CHECK == 0 and bool(done.all()):
            break
    h, s = carry[2], carry[9]
    h = a1 * h
    zc = torch.clamp(z, max=_EXP_UNDERFLOW_Z)
    k_mu = torch.sqrt(math.pi / (2.0 * z)) * torch.exp(-zc) / s
    k_mu = torch.where(z > _EXP_UNDERFLOW_Z, torch.zeros_like(k_mu), k_mu)
    k_mu1 = k_mu * (mu + z + 0.5 - h) / z
    return k_mu, k_mu1


def _kv_ladder_raw(z, mu: float, n: int):
    """K_{mu+k}(z) for k = 0..n-1, stacked on a new leading axis."""
    z_safe = torch.clamp(z, min=_tiny(z.dtype))
    z_ser = torch.clamp(z_safe, max=2.0)
    z_cf = torch.clamp(z_safe, min=2.0)
    ks_mu, ks_mu1 = _temme_series(z_ser, mu)
    kc_mu, kc_mu1 = _steed_cf2(z_cf, mu)
    use_series = z_safe <= 2.0
    k0 = torch.where(use_series, ks_mu, kc_mu)
    k1 = torch.where(use_series, ks_mu1, kc_mu1)
    if n == 1:
        return k0[None]
    out = [k0, k1]
    for k in range(1, n - 1):
        out.append(out[k - 1] + (2.0 * (mu + k) / z_safe) * out[k])
    return torch.stack(out, dim=0)


class KvLadder(torch.autograd.Function):
    """Ladder K_{mu+k}(z), k < n, differentiable in z to any order.

    The forward pass keeps one order more than it returns: a first-order
    backward then needs no second series/CF2 evaluation, and the extra
    order is the same recurrence step the JAX JVP's ladder(n+1) takes. A
    backward that is itself differentiated (create_graph) re-enters the
    ladder so that its result carries a graph."""

    @staticmethod
    def forward(ctx, z, mu: float, n: int):
        ctx.mu, ctx.n = mu, n
        kk = _kv_ladder_raw(z.detach(), mu, n + 1)
        ctx.save_for_backward(z, kk)
        return kk[:n]

    @staticmethod
    def backward(ctx, grad_out):
        z, kk = ctx.saved_tensors
        mu, n = ctx.mu, ctx.n
        if torch.is_grad_enabled():
            kk = KvLadder.apply(z, mu, n + 1)
        orders = (mu + torch.arange(n, dtype=kk.dtype, device=kk.device))
        orders = orders.reshape((n,) + (1,) * z.dim())
        z_safe = torch.clamp(z, min=_tiny(z.dtype))
        # dK_v/dz = -K_{v+1} + (v/z) K_v
        dk = -kk[1: n + 1] + (orders / z_safe) * kk[:n]
        return torch.sum(grad_out * dk, dim=0), None, None


def kv_ladder(z, mu: float, n: int):
    """(n,) + z.shape tensor of K_{mu+k}(z), k = 0..n-1; 0 < mu < 1."""
    return KvLadder.apply(z, mu, n)


def _split_order(v: float):
    """Split order v >= 0 into (mu, k) with v = mu + k, 0 < mu < 1."""
    k = int(math.floor(v))
    mu = v - k
    mu = min(max(mu, 1e-8), 1 - 1e-8)
    return mu, k


def kv(v: float, z):
    """K_v(z) for real order v >= 0, differentiable w.r.t. z."""
    mu, k = _split_order(v)
    return kv_ladder(z, mu, k + 1)[k]


def kvp(v: float, z, n: int = 1):
    """n-th derivative of K_v w.r.t. z (mirror of scipy.special.kvp)."""
    if n == 0:
        return kv(v, z)
    mu, k = _split_order(v)
    if k < n:
        raise NotImplementedError(
            "kvp requires floor(v) >= n so all orders sit on one ladder"
        )
    ladder = kv_ladder(z, mu, k + n + 1)
    acc = 0.0
    for j in range(n + 1):
        acc = acc + math.comb(n, j) * ladder[k - n + 2 * j]
    return (-0.5) ** n * acc
