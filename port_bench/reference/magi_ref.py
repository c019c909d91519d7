"""Plain reference of the MAGI posterior that ``predict`` samples, for the
benchmark's check of ``correct``.

The port samples flat states [z | sigma_pre | theta_pre]: z, the
Gauss-Newton (GN) whitened coordinates of the trajectories (dense storage:
x = mu + L z, L = Lambda^{-1/2}; hybrid storage: x = mu + U^{-1} z, U the
banded Cholesky factor of a band of Lambda), theta = softplus(theta_pre),
sigma^2 = softplus(sigma_pre) + LB, or a known sigma^2 where the
configuration pins it. ``Reference`` works out again in float64, from the
observations and the fitted hyperparameters: the Matern (nu = 2.01)
conditioning matrices of Yang, Wong & Kou (PNAS 2021) with SciPy's Bessel
K, their pseudo-inverses and square roots (band-truncated as dense storage
samples them, or untruncated as hybrid storage does); the GN precision
Lambda at the fit's start and its factor; the tempered log-posterior of a
flat state and its gradient (autograd); and the leapfrog orbit of a state
under a mass.

Lambda's largest eigenvalues come from the pseudo-inverses' cut (their
eigenvalues near n eps of the largest), so two sound float64 builds of it
differ there while agreeing where the posterior lives. A whitened draw
carries the anchor L^{-1} (x0 - mu), large along those directions, so the
factor is compared on differences of draws, x_t - x_s = L (z_t - z_s),
which the sampler keeps at O(1) in every direction; and the target is
evaluated in the sampler's own coordinates, x = x0 + F (z - z0), with the
program's zero point and factor as its state (a ``frame``).

At dense-grid sizes (N_I = 1025) that rounding reaches the factor itself:
the reference's L and the port's banded U^{-1} map the same whitened
differences apart by as much as the differences (PERF.md). A fixed
linear preconditioner does not change the posterior over X, so any
invertible factor is sound; what is held is that the program samples the
right target in its own coordinates and maps its draws back through the
factor it sampled with. For a banded factor the frame's F = U^{-1} is
therefore worked out here in float64 from the float32 tiles the
program's factor holds (``upper_from_tiles``, ``Reference.factor_inverse``),
and the draws are held to that F; the chains' spread is still held to the
reference's own GN scale. The same rounding sets the top of K^{-1} (K's
smallest eigenvalues sit at its rounding), so a hybrid frame also takes
the program's S = K^{-1/2} as state, and ``Reference.k_gap`` holds that
S to the reference's K in the directions rounding leaves alone: worked
back from S, K differs from the reference's by its rounding in a few
tens of directions, where S^2 would read the inverse of it.

Plain PyTorch, NumPy and SciPy: nothing of the port and nothing of JAX.
TF32 is off for every product here, unless ``precision("tf32")`` (the
control) is held.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import scipy.special
import torch

NU = 2.01
# the share of K's directions that ``Reference.k_gap`` leaves to rounding
ROUNDING_RANK = 0.1


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def softplus(x):
    x = np.asarray(x, np.float64)
    return np.where(x > 30.0, x, np.log1p(np.exp(np.minimum(x, 30.0))))


# --------------------------------------------------------------------------
# grid and observations
# --------------------------------------------------------------------------


def grid(ts_obs, X_obs, discretization: int):
    """(I (N_I,), X on the grid with NaN between observations): 2^disc - 1
    evenly spaced points between consecutive observations."""
    ts_obs = np.asarray(ts_obs, np.float64)
    n, D = np.asarray(X_obs).shape
    stride = 2 ** discretization
    N_I = stride * (n - 1) + 1
    idx = np.arange(N_I)
    I = np.interp(idx, idx[::stride], ts_obs)
    Xg = np.full((N_I, D), np.nan)
    Xg[::stride] = X_obs
    return I, Xg


def interpolated_means(Xg):
    """The mean over the grid of each component's linear interpolation
    between its observations (constant beyond the first and last)."""
    idx = np.arange(Xg.shape[0])
    out = []
    for d in range(Xg.shape[1]):
        ok = ~np.isnan(Xg[:, d])
        out.append(np.interp(idx, idx[ok], Xg[ok, d]).mean())
    return np.array(out)


# --------------------------------------------------------------------------
# Matern conditioning matrices
# --------------------------------------------------------------------------


def matern_rows(dists, phi1, phi2, v=NU):
    """(kappa, dkappa/ds, d2kappa/dsdt) at nonnegative distances, float64:
    kappa(r) = phi1 A u^v K_v(u), u = sqrt(2 v) |r| / phi2, A = 2^{1-v} /
    Gamma(v); at r = 0 the limits phi1, 0 and v phi1 / (phi2^2 (v - 1))."""
    d = np.asarray(dists, np.float64)
    A = 2.0 ** (1.0 - v) / math.gamma(v)
    c = math.sqrt(2.0 * v) / phi2
    u = c * np.where(d > 0, d, 1.0)
    kv = lambda order: scipy.special.kv(order, u)
    uv = u ** v
    kappa = np.where(d > 0, phi1 * A * uv * kv(v), phi1)
    dk = np.where(d > 0, -phi1 * A * c * uv * kv(v - 1.0), 0.0)
    kpp = np.where(d > 0, phi1 * A * c ** 2 * (u ** (v - 1.0) * kv(v - 1.0)
                                               - uv * kv(v - 2.0)),
                   v * phi1 / (phi2 ** 2 * (v - 1.0)))
    return kappa, dk, kpp


def pinv_sym(a):
    """Pseudo-inverse of a symmetric matrix through its eigenvalues, the
    ones at or below n eps of the largest magnitude dropped (NumPy's
    pinv rule)."""
    w, V = torch.linalg.eigh((a + a.mT) / 2.0)
    cut = a.shape[-1] * torch.finfo(a.dtype).eps * w.abs().amax(-1, True)
    keep = w.abs() > cut
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
    return (V * w_inv[..., None, :]) @ V.mT


def sqrt_sym(a):
    """The symmetric PSD square root, negative eigenvalues clamped to 0."""
    w, V = torch.linalg.eigh((a + a.mT) / 2.0)
    return (V * torch.sqrt(w.clamp(min=0.0))[..., None, :]) @ V.mT


def band(a, b: int):
    """``a`` with every entry more than b off the diagonal set to 0."""
    n = a.shape[-1]
    i = torch.arange(n, device=a.device)
    return torch.where((i[:, None] - i[None, :]).abs() <= b, a, 0.0)


def operators(I, phi1s, phi2s, device, v=NU, dtype=torch.float64):
    """(C^{-1}, m, K^{-1}, K), each (D, N_I, N_I) on ``device``, on a
    uniform grid: the Matern Gram C, m = C' C^{-1} and K = C'' - C' C^{-1}
    'C, with C^{-1} and K^{-1} their pseudo-inverses; the Matern rows in
    float64, the rest in ``dtype``."""
    n = I.shape[0]
    h = float(np.diff(I).mean())
    i = np.arange(n)
    lag = np.abs(i[:, None] - i[None, :])
    sign = np.sign(i[:, None] - i[None, :])
    out = []
    for p1, p2 in zip(phi1s, phi2s):
        kr, dr, pr = matern_rows(h * np.arange(n), float(p1), float(p2), v)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        kappa, dk, kpp = t(kr[lag]), t(dr[lag] * sign), t(pr[lag])
        m = dk @ pinv_sym(kappa)
        K = kpp + m @ dk
        out.append((pinv_sym(kappa), m, pinv_sym(K), K))
    return tuple(torch.stack(x) for x in zip(*out))


# --------------------------------------------------------------------------
# the fit's hyperparameters
# --------------------------------------------------------------------------


def fourier_prior(X, t_range: float):
    """Each column's mean and the Gaussian prior (mean, sd) of its Matern
    bandwidth phi2 from the column's spectral-mass-weighted frequency f
    (the MAGI reference's rule): 0.5 / f where that spans two grid steps
    or more, else 0.25 t_range / f."""
    n = X.shape[0]
    spacing = t_range / max(n - 1, 1)
    out = []
    for d in range(X.shape[1]):
        zmod = np.abs(np.fft.fft(X[:, d]))
        power = zmod[1: (len(zmod) - 1) // 2 + 1] ** 2
        freq = np.sum(np.arange(1, len(power) + 1) * power) / np.sum(power)
        ref = 0.5 / freq
        if ref >= 2.0 * spacing:
            mean, sd = ref, ((1.0 - ref) / 3.0 if ref < 1.0 else ref / 2.0)
        else:
            mean = 0.25 * t_range / freq
            sd = mean / 2.0
        out.append((X[:, d].mean(), mean, sd))
    return np.array(out).T


def hparam_gradient(ts_obs, X_obs, phi1s, phi2s, sigma_sqs,
                    jitter: float = 1e-6, v=NU):
    """The largest |gradient| of the negative MAP objective of the GP
    hyperparameters at (phi1, phi2, sigma^2), in the softplus pre-space
    the fit optimises: each column y ~ N(mu, phi1 M_phi2 + (sigma^2 +
    jitter) I) at the observation times, with Gaussian priors on phi1
    (1e-4, 1000), sigma^2 ((0.1 sd(y))^2, 1000) and phi2 (the Fourier
    prior). At a converged fit it is near 0."""
    X = np.asarray(X_obs, np.float64)
    t = np.asarray(ts_obs, np.float64)
    n = t.shape[0]
    mus, mu_phi2, sd_phi2 = fourier_prior(X, float(t[-1] - t[0]))
    loc_sig = (X.std(axis=0) * 0.1) ** 2
    r = np.abs(t[:, None] - t[None, :])
    A = 2.0 ** (1.0 - v) / math.gamma(v)
    worst = 0.0
    for d in range(X.shape[1]):
        p1, p2, s2 = float(phi1s[d]), float(phi2s[d]), float(sigma_sqs[d])
        c = math.sqrt(2.0 * v) / p2
        u = c * np.where(r > 0, r, 1.0)
        shape = np.where(r > 0, A * u ** v * scipy.special.kv(v, u), 1.0)
        d_phi2 = np.where(r > 0, p1 * A * u ** (v + 1.0)
                          * scipy.special.kv(v - 1.0, u) / p2, 0.0)
        cov = p1 * shape + (s2 + jitter) * np.eye(n)
        y = X[:, d] - mus[d]
        inv = np.linalg.inv(cov)
        alpha = inv @ y
        grad = lambda dS: 0.5 * np.sum(inv * dS) - 0.5 * alpha @ dS @ alpha
        g = np.array([grad(shape) + (p1 - 1e-4) / 1000.0 ** 2,
                      grad(d_phi2) + (p2 - mu_phi2[d]) / sd_phi2[d] ** 2,
                      grad(np.eye(n)) + (s2 - loc_sig[d]) / 1000.0 ** 2])
        # d softplus(pre) / d pre = 1 - exp(-value)
        g *= 1.0 - np.exp(-np.array([p1, p2, s2]))
        worst = max(worst, float(np.abs(g).max()))
    return worst


# --------------------------------------------------------------------------
# the Gauss-Newton precision and its factor
# --------------------------------------------------------------------------


def field_jacobian(field, I, X, thetas):
    """J[n, d, e] = d f_d / d x_e at (t_n, x_n), (N, D, D) float64."""
    t = torch.as_tensor(I, dtype=torch.float64).reshape(-1, 1)
    x = torch.as_tensor(X, dtype=torch.float64)
    th = torch.as_tensor(thetas, dtype=torch.float64)
    row = lambda tn, xn: field(tn[None, :], xn[None, :], th)[0]
    return torch.func.vmap(torch.func.jacfwd(row, argnums=1))(t, x)


def gn_precision(R, m, S, J, beta, obs_mask, sigma_sqs):
    """The (N D, N D) GN precision of the trajectories, index n D + d:
    (R'R + (J - m)' S'S (J - m)) / beta + diag(observed / sigma^2), with
    R, m, S (D, N, N) per component and J (N, D, D) the field's
    Jacobian."""
    D, N = R.shape[0], R.shape[1]
    dev = R.device
    # the residual's Jacobian r_d(n) = f_d(x_n) - sum_k m_d[n, k] x_d(k)
    Rm = torch.zeros((N, D, N, D), dtype=torch.float64, device=dev)
    idx = torch.arange(N, device=dev)
    Rm[idx, :, idx, :] = J.to(dev)
    for d in range(D):
        Rm[:, d, :, d] -= m[d]
    Rm = Rm.reshape(N * D, N * D)
    blk = torch.zeros((N, D, N, D), dtype=torch.float64, device=dev)
    sts = torch.zeros_like(blk)
    for d in range(D):
        blk[:, d, :, d] = R[d].mT @ R[d]
        sts[:, d, :, d] = S[d].mT @ S[d]
    blk, sts = blk.reshape(N * D, N * D), sts.reshape(N * D, N * D)
    lam = (blk + Rm.mT @ sts @ Rm) / float(beta)
    obs = torch.as_tensor(np.asarray(obs_mask, np.float64)
                          / np.asarray(sigma_sqs, np.float64)[None, :],
                          device=dev).reshape(-1)
    return lam + torch.diag(obs)


@contextlib.contextmanager
def precision(name: str):
    """The dtype of ``name`` ("float64", "float32" or "tf32"), with the
    card's TF32 products switched on for "tf32" only while it is held (on
    the CPU "tf32" computes as "float32")."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield torch.float64 if name == "float64" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def log_sigmoid(x):
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def softplus_t(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Reference:
    """The plain MAGI posterior of one fitted dataset, worked out again in
    float64 from the observations and the fit's hyperparameters, theta
    start and smoothed start.

    - The Matern operators with the configuration's band truncation (or,
      ``exact``, untruncated, as hybrid storage samples them): R =
      C^{-1/2}, m, S = K^{-1/2} per component (D, N, N).
    - The GN precision Lambda at the fit's start and its dense factor L =
      Lambda^{-1/2} (eigenvalues floored at 1e-12 of the largest); ``apply``
      maps whitened draws to trajectories, x = mu + L z, and ``sd`` is the
      GN posterior scale sqrt(diag Lambda^{-1}) (N, D).
    - ``log_posterior``: the tempered log-posterior of the sampler's flat
      states [z | sigma_pre | theta_pre] and its gradient, in the
      coordinates of a ``Frame`` (x = x0 + F (z - z0)); with
      ``sigma_fixed`` (D,) the noise variances are those known values and
      sigma_pre carries no potential, as in a predict that pins them.
    """

    def __init__(self, setup: dict, field, device, exact: bool = False,
                 sigma_fixed=None):
        no_tf32()
        self.device, self.field = device, field
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        device=device)
        I, Xg = grid(setup["ts_obs"], setup["X_obs"],
                     setup["discretization"])
        N, D = Xg.shape
        self.N, self.D = N, D
        b = setup["bandsize"]
        self._grid = (I, setup["phi1s"], setup["phi2s"])
        Cinv, m, Kinv, self.K = operators(*self._grid, device)
        truncated = ((lambda a: band(a, b)) if b is not None and not exact
                     else (lambda a: a))
        self.R, self.S = sqrt_sym(truncated(Cinv)), sqrt_sym(truncated(Kinv))
        self.m = truncated(m)
        obs = ~np.isnan(Xg)
        self.beta = D * N / obs.sum()
        self.I = f64(I).reshape(-1, 1)
        self.mask = f64(obs)
        self.y = f64(np.where(obs, Xg, 0.0))
        self.n_ds = f64(obs.sum(axis=0))
        xhat = np.asarray(setup["Xhat_init"], np.float64)
        self.sigma_lb = f64((xhat.std(axis=0) * 0.01) ** 2)
        self.sigma_fixed = (None if sigma_fixed is None else f64(
            np.full(D, 1.0) * np.asarray(sigma_fixed, np.float64)))
        self.thetas0 = f64(setup["thetas_init"])
        J = field_jacobian(field, I, xhat, setup["thetas_init"])
        lam = gn_precision(self.R, self.m, self.S, J, self.beta, obs,
                           setup["sigma_sqs_init"])
        self.mu = f64(interpolated_means(Xg))
        w, V = torch.linalg.eigh((lam + lam.mT) / 2.0)
        w = torch.maximum(w, 1e-12 * w.max())
        self.L = (V * w.rsqrt()[None, :]) @ V.mT
        self.sd = (self.L ** 2).sum(1).sqrt().reshape(N, D)

    def apply(self, z, tf32: bool = False, op=None):
        """L z, float64 (..., N, D) from whitened draws z (..., N D) on the
        reference's device, or ``op`` z for another factor (N D, N D) in
        the flat order n D + d. With ``tf32`` (the control) the map runs as
        a float32 card would with TF32 on: its operands rounded to TF32's
        10-bit mantissa, the products summed in float32."""
        z = torch.as_tensor(z, device=self.device)
        shape = z.shape[:-1] + (self.N, self.D)
        flat = z.reshape(-1, self.N * self.D)
        op = self.L if op is None else op
        if tf32:
            flat, op = round_tf32(flat.float()), round_tf32(op.float())
        else:
            flat = flat.double()
        return (flat @ op.mT).double().reshape(shape)

    def factor_inverse(self, tiles):
        """F = U^{-1}, float64 (N D, N D) on the reference's device, of the
        banded upper factor U whose tiles the program holds (see
        ``upper_from_tiles``): the program's state, inverted here."""
        U = upper_from_tiles(torch.as_tensor(tiles, device=self.device)
                             .double(), self.N * self.D)
        eye = torch.eye(U.shape[0], dtype=torch.float64, device=self.device)
        return torch.linalg.solve_triangular(U, eye, upper=True)

    # the target ----------------------------------------------------------

    def s_in(self, dtype):
        """S = K^{-1/2} worked out again with every product and
        decomposition in ``dtype`` (the control of ``S`` as state)."""
        Kinv = operators(*self._grid, self.device, dtype=dtype)[2]
        return sqrt_sym(Kinv)

    def frame(self, x0, z0, F, S=None):
        """The sampler's coordinates x = x0 + F (z - z0) (x0 (N, D), z0
        (N D,), F (N D, N D) in the flat order n D + d), with the constants
        of the relative energy around x0, in float64: a0 = R (x0 - mu), f0
        = f(x0, theta0) and s0 = S (f0 - m (x0 - mu)), each (D, N). ``S``
        (D, N, N), where given, is the program's operator taken as state
        in place of the reference's own."""
        f64 = lambda a: torch.as_tensor(a, device=self.device).double()
        x0, z0, F = f64(x0), f64(z0), f64(F)
        S = self.S if S is None else f64(S)
        xc = (x0 - self.mu).T[..., None]                      # (D, N, 1)
        f0 = self.field(self.I, x0, self.thetas0).T            # (D, N)
        a0 = (self.R @ xc)[..., 0]
        s0 = (S @ (f0[..., None] - self.m @ xc))[..., 0]
        return {"x0": x0, "z0": z0, "F": F, "S": S, "a0": a0, "f0": f0,
                "s0": s0}

    def k_gap(self, S) -> float:
        """How far an operator S (D, N, N), such as the program's, is from
        K^{-1/2} where float64 determines K: K worked back from S (the
        pseudo-inverse of S^2, the eigenvalues at or below n eps of S's
        own precision dropped) less the reference's K, its singular value
        next after the ``ROUNDING_RANK`` share of N largest, over the
        median singular value of the reference's K; the worst component.
        K's rounding is of low rank: two sound float64 builds of it at
        N_I = 1025 differ by 22 in one direction, 1e-3 in the 21st and
        1e-5 in the 100th, where a band-truncated S moves K by 2e-3 to
        8e-2 (PERF.md)."""
        S = torch.as_tensor(S, device=self.device)
        S2 = S.double() @ S.double()
        w, V = torch.linalg.eigh((S2 + S2.mT) / 2.0)
        cut = S.shape[-1] * torch.finfo(S.dtype).eps * w.abs().amax(-1, True)
        keep = w > cut
        w_inv = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
        K = (V * w_inv[..., None, :]) @ V.mT
        r = int(ROUNDING_RANK * S.shape[-1])
        gap = torch.linalg.svdvals(K - self.K)[..., r]
        scale = torch.linalg.svdvals(self.K).median(-1).values
        return float((gap / scale).max())

    def log_posterior(self, q, beta_temp, frame, dtype=torch.float64):
        """(lp (C,), grad (C, dim)) at the flat states q (C, N D + D + P)
        in ``frame``'s coordinates, computed in ``dtype``:

            lp = beta_temp [ -((t1 + t2) / beta + t3 + t4) / 2
                             + sum log sigmoid(sigma_pre, theta_pre) ]

        with delta = F (z - z0), x = x0 + delta, theta = softplus(theta_pre),
        sigma^2 = softplus(sigma_pre) + LB; t1 = ||R (x - mu)||^2, t2 = ||S
        (f(x, theta) - m (x - mu))||^2, each less its value at x0 (the
        relative energy, formed from R delta and m delta); t3 = sum_d n_d
        log(2 pi sigma_d^2); t4 the observations' squared residuals over
        sigma^2. beta = D N / observations, the prior's temperature."""
        N, D = self.N, self.D
        ND = N * D
        c = lambda a: a.to(dtype)
        qd = c(torch.as_tensor(q, device=self.device)).detach()
        qd.requires_grad_(True)
        bt = c(torch.as_tensor(beta_temp, device=self.device))
        R, S, m = c(self.R), c(frame["S"]), c(self.m)
        a0, f0, s0 = (c(frame[k])[None] for k in ("a0", "f0", "s0"))
        delta = ((qd[:, :ND] - c(frame["z0"])) @ c(frame["F"]).mT
                 ).reshape(-1, N, D)
        x = c(frame["x0"]) + delta
        sig_pre, th_pre = qd[:, ND:ND + D], qd[:, ND + D:]
        dT = delta.transpose(1, 2)[..., None]                  # (C, D, N, 1)
        Rd = (R @ dT)[..., 0]
        t1 = (Rd * (Rd + 2.0 * a0)).sum((1, 2))
        f = self.field(c(self.I), x, softplus_t(th_pre)).transpose(1, 2)
        dr = (f - f0) - (m @ dT)[..., 0]
        Ds = (S @ dr[..., None])[..., 0]
        t2 = (Ds * (Ds + 2.0 * s0)).sum((1, 2))
        sig2 = (softplus_t(sig_pre) + c(self.sigma_lb)
                if self.sigma_fixed is None
                else c(self.sigma_fixed).expand_as(sig_pre))
        t3 = (c(self.n_ds) * torch.log(2.0 * math.pi * sig2)).sum(-1)
        r = x - c(self.y)
        t4 = ((c(self.mask) * r * r).sum(1) / sig2).sum(-1)
        lj = log_sigmoid(th_pre).sum(-1)
        if self.sigma_fixed is None:
            lj = log_sigmoid(sig_pre).sum(-1) + lj
        lp = bt * (-0.5 * ((t1 + t2) / float(self.beta) + t3 + t4) + lj)
        (grad,) = torch.autograd.grad(lp.sum(), qd)
        return lp.detach(), grad

    # the transition --------------------------------------------------------

    def orbits(self, q, p, eps, velocity, frame, beta_temp, steps: int,
               dtype=torch.float64):
        """The leapfrog orbit from (q, p) (C, dim) at step sizes ``eps``
        (C,): a generator of q after each of ``steps`` steps (kick by half
        a step with the log-posterior's gradient, drift a step with the
        velocity ``velocity(p)`` = M^{-1} p, kick by half a step), in
        ``dtype``."""
        grad = lambda qq: self.log_posterior(qq, beta_temp, frame, dtype)[1]
        q, p = q.to(dtype), p.to(dtype)
        e = eps.to(dtype)[:, None]
        g = grad(q)
        for _ in range(steps):
            p = p + 0.5 * e * g
            q = q + e * velocity(p)
            g = grad(q)
            p = p + 0.5 * e * g
            yield q


class Mass:
    """The sampler's mass as the program adapted it (its state): the
    inverse-mass diagonal ``diag`` (dim,) and, over the last k
    coordinates, the dense inverse mass ``tail_inv`` (k, k) and the factor
    ``tail_msqrt`` A with A A' = tail_inv^{-1} (k = 0: none)."""

    def __init__(self, diag, tail_inv=None, tail_msqrt=None):
        self.diag, self.tail_inv, self.tail_msqrt = diag, tail_inv, tail_msqrt
        self.k = 0 if tail_inv is None else tail_inv.shape[-1]

    def _split(self, a):
        head = a.shape[-1] - self.k
        return a[..., :head], a[..., head:], head

    def momentum(self, normals, dtype=torch.float64):
        """p ~ N(0, M) from standard normals (C, dim)."""
        n = normals.to(dtype)
        head_n, tail_n, head = self._split(n)
        out = head_n / self.diag[:head].to(dtype).sqrt()
        if self.k:
            out = torch.cat([out, tail_n @ self.tail_msqrt.to(dtype).mT], -1)
        return out

    def velocity(self, p):
        """M^{-1} p."""
        head_p, tail_p, head = self._split(p)
        out = head_p * self.diag[:head].to(p.dtype)
        if self.k:
            out = torch.cat([out, tail_p @ self.tail_inv.to(p.dtype)], -1)
        return out


def upper_from_tiles(tiles, n: int):
    """The dense upper-triangular (n, n) matrix U of block-banded tiles
    (nb, nw, T, T) with tile[q, s, r, c] = U[q T + r, (q + s) T + c] (the
    diagonal tile at s = 0; rows and columns past n are padding)."""
    nb, nw, T = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    U = torch.zeros((nb * T, (nb + nw) * T), dtype=tiles.dtype,
                    device=tiles.device)
    for q in range(nb):
        U[q * T:(q + 1) * T, q * T:(q + nw) * T] = (
            tiles[q].permute(1, 0, 2).reshape(T, nw * T))
    return U[:n, :n]


def round_tf32(a):
    """float32 ``a`` rounded to TF32 (10 explicit mantissa bits, nearest,
    ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)
