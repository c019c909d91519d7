"""Exact-posterior MAP and Laplace approximation (counterpart of
magi_v2_tpu/map_laplace.py): ``MAGI_v2.map_estimate``.

The joint mode of the exact (untruncated, beta_temp = 1) MAGI posterior
over (X, theta), sigma^2 pinned or profiled, with Laplace credible sds and
joint draws. The draws are the chain starts of
``predict(init_states=...)``: the JAX package measured them as the fix for
the centered sampler's slow mixing of an unobserved component (Hes1's H,
95% band coverage 0.256 -> 0.597).

Method, as in the JAX module: the trajectory block is whitened (a linear
coordinate change, for the optimizer's conditioning only) and the negative
log-posterior is minimized over (w, theta) by Adam, then by SciPy's
L-BFGS-B on the host with positivity bounds on theta. Two whitenings
(``precondition=``):

- ``"gn"``: w = U (x - mu), U the banded Cholesky factor of the
  Gauss-Newton precision the banded sampler builds
  (``sampler/precond.py:build_gn_cholesky_banded``); each evaluation
  unwhitens by the exact triangular solve, a dense float64
  ``solve_triangular`` with U. The alternative, K4 at one chain under
  autograd (its adjoint the backward), took 2.6 times as long a value and
  gradient on the card at Hes1's N*D = 387 (chip_smoke.py's Hes1 Laplace
  phase times both; PERF.md), and torch.func's Hessian needs the
  forward-mode derivative that the dense solve has;
- ``"prior"``: x_d = mu_d + C_d^{1/2} w_d.

Free sigma^2 is profiled in closed form (SSE_d / N_d, clipped at the
lower-bound heuristic, with the envelope theorem's stop-gradient). The
Hessian at the MAP comes from forward-over-reverse products
(``torch.func``), in blocks of basis vectors.

Placement: float64 torch on the model's device (the card by default) for
every value, gradient and Hessian block, the value and gradient replayed
there as one CUDA graph; SciPy's L-BFGS-B and the eigendecomposition of
the Hessian on the host. This is setup work: no hand-written kernel is
involved.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

def _sym_sqrt_inv(A_inv):
    """C^{1/2} from C^{-1}, pinv-consistent: eigenvalues at or below 1e-14
    of the largest stay zero (the JAX module's cutoff)."""
    w, v = torch.linalg.eigh((A_inv + A_inv.transpose(-1, -2)) / 2.0)
    w = torch.clamp(w, min=0.0)
    big = w > torch.amax(w, dim=-1, keepdim=True) * 1e-14
    s = torch.where(big, torch.rsqrt(torch.where(big, w, torch.ones_like(w))),
                    torch.zeros_like(w))
    return (v * s[..., None, :]) @ v.transpose(-1, -2)


def _hessian_chunked(grad_fn, z, chunk: int = 256):
    """Dense (dim, dim) Hessian of a scalar function from the JVPs of its
    gradient ``grad_fn`` along basis vectors, ``chunk`` at a time (peak
    memory chunk x dim), symmetrized; NumPy float64."""
    dim = z.shape[0]
    eye = torch.eye(dim, dtype=z.dtype, device=z.device)
    hvp = torch.func.vmap(lambda t: torch.func.jvp(grad_fn, (z,), (t,))[1])
    H = torch.cat([hvp(eye[i: i + chunk]) for i in range(0, dim, chunk)])
    H = H.cpu().numpy()
    return (H + H.T) / 2.0


def _value_and_grad(neg_lp, z0):
    """``z -> (neg_lp(z), its gradient)``, float64, for z like ``z0`` (the
    warm-up's point). On a CUDA device the
    evaluation (the objective and its backward) is captured once as a CUDA
    graph on a fixed input and replayed: an evaluation is some hundred small
    launches, and L-BFGS-B takes tens of thousands of them on a stiff
    posterior (Hes1), so their host cost would set the MAP's wall. Elsewhere
    it runs eagerly. The two give the same values."""

    def eager(z):
        z = z.detach().requires_grad_(True)
        v = neg_lp(z)
        (g,) = torch.autograd.grad(v, z)
        return v.detach(), g

    device = z0.device
    if device.type != "cuda":
        return eager
    z_in = z0.detach().clone().requires_grad_(True)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            eager(z_in)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v_out = neg_lp(z_in)
        (g_out,) = torch.autograd.grad(v_out, z_in)

    def replayed(z):
        with torch.no_grad():
            z_in.copy_(z)
        graph.replay()
        return v_out.detach().clone(), g_out.clone()

    return replayed


def _dense_upper(U_band: np.ndarray) -> np.ndarray:
    """The dense upper-triangular U of band storage
    (``band[b + k, i] = U[i, i + k]``)."""
    two_b1, n = U_band.shape
    b = (two_b1 - 1) // 2
    U = np.zeros((n, n))
    for k in range(b + 1):
        i = np.arange(n - k)
        U[i, i + k] = U_band[b + k, : n - k]
    return U


def map_estimate(model, sigma_sqs_fixed=None, adam_steps: int = 1000,
                 adam_lr: float = 0.02, lbfgs_maxiter: int = 20000,
                 laplace: bool = True, verbose: bool = False,
                 laplace_draws: int = 0, draws_seed: int = 0,
                 draws_scale: float = 1.0, draws_rel_floor: float = 1e-9,
                 precondition: str = "gn"):
    """Joint MAP of the exact (untruncated, beta_temp = 1) posterior over
    (X, theta[, sigma^2]), with the JAX function's arguments and result
    keys.

    sigma_sqs_fixed: scalar or (D,) known noise variances; None profiles
    sigma^2 (bounded below by predict's sigma_sqs_LB heuristic).
    laplace_draws: joint draws from N(z_map, draws_scale^2 H^{-1}) as
    natural-coordinate ``X_draws`` (n, N_I, D) and ``theta_draws`` (n,
    D_thetas), the Hessian's near-flat directions (eigenvalue below
    draws_rel_floor of the largest) capped at that floor and theta clipped
    at 1e-8; the normals come from ``np.random.default_rng(draws_seed)``,
    as in the JAX package. precondition: "gn" or "prior" (the same MAP;
    only the optimizer's conditioning differs).

    Returns theta_map, sigma_sqs_map, X_map (N_I, D), neg_logpost,
    grad_norm (the projected gradient's), lbfgs_iters, lbfgs_message,
    active_bounds, converged, band_truncation_bypassed, precondition,
    wall_s (and gn_jitter, gn_bw_precision for "gn"); with laplace (or
    draws): theta_sd, theta_cov, X_sd, hessian_spd, hessian_min_eig_rel."""
    if precondition not in ("gn", "prior"):
        raise ValueError(f"precondition must be 'gn' or 'prior', got "
                         f"{precondition!r}")
    laplace = bool(laplace or laplace_draws)
    t_start = time.time()
    D, D_th, N = model.D, model.D_thetas, model.mag_I
    ND = N * D
    dev = model.config.torch_device
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64),
                                 dtype=torch.float64, device=dev)

    # the exact operators: initial_fit band-truncates a banded model's in
    # place, and the truncation is the approximation this evaluates past
    bypassed = model.BANDSIZE is not None
    C_inv, m_ds, K_inv = (model._exact_operators() if bypassed
                          else (model.C_d_invs, model.m_ds, model.K_d_invs))
    from magi_v2_tpu_torch.ops.linalg import sym_sqrt

    R, S, m = sym_sqrt(f64(C_inv)), sym_sqrt(f64(K_inv)), f64(m_ds)
    mu = f64(model.mu_ds)
    beta = float(model.beta)
    oi = model.obs_index
    idxs = torch.as_tensor(np.asarray(oi.not_nan_idxs), dtype=torch.long,
                           device=dev)
    cols = torch.as_tensor(np.asarray(oi.not_nan_cols), dtype=torch.long,
                           device=dev)
    y_obs, N_ds, grid_I = f64(oi.y_observed), f64(oi.N_ds), f64(model.I)

    gn = precondition == "gn"
    if gn:
        from magi_v2_tpu_torch.sampler.precond import (
            build_gn_cholesky_banded,
        )

        U_band, gn_info = build_gn_cholesky_banded(
            model,
            sigma_sqs_init=None if sigma_sqs_fixed is None else np.broadcast_to(
                np.asarray(sigma_sqs_fixed, np.float64), (D,)),
            C_inv_sqrts=R, K_inv_sqrts=S,
        )
        U = f64(_dense_upper(U_band))

        def to_xc(w):
            """x - mu (N, D) from the whitened w: U^{-1} w."""
            return torch.linalg.solve_triangular(
                U, w.reshape(ND, 1), upper=True).reshape(N, D)

        w0 = (U @ (f64(model.Xhat_init) - mu).reshape(ND)).reshape(N, D)
    else:
        C_half = _sym_sqrt_inv(f64(C_inv))
        A = R @ C_half                                # t1 factor
        M = m @ C_half                                # m (x - mu)
        w0 = torch.einsum("dnm,md->nd", R, f64(model.Xhat_init) - mu)

    sigma_free = sigma_sqs_fixed is None
    if sigma_free:
        sig_lb = f64(np.maximum(
            (np.asarray(model.Xhat_init).std(axis=0)
             * model.config.sigma_sq_lb_scale) ** 2, 1e-12))
    else:
        sig_fix = f64(np.broadcast_to(np.asarray(sigma_sqs_fixed, np.float64),
                                      (D,)))

    def sigma_profile(x_at_obs):
        """argmin_s of N_d log(2 pi s) + SSE_d / s, SSE_d / N_d, clipped at
        the bound and held constant under differentiation (the envelope
        theorem: at an interior optimum the derivative in sigma is 0, at
        the bound sigma is locally constant)."""
        sse = torch.zeros(D, dtype=x_at_obs.dtype, device=dev).index_add(
            0, cols, (x_at_obs - y_obs) ** 2)
        return torch.maximum(sse / N_ds, sig_lb).detach()

    def neg_lp(z):
        w, theta = z[:ND].reshape(N, D), z[ND:]
        if gn:
            xc = to_xc(w)
            x = xc + mu
            t1 = torch.sum(torch.einsum("dnm,md->dn", R, xc) ** 2)
            r = (model.f_vec(grid_I, x, theta).T
                 - torch.einsum("dnm,md->dn", m, xc))
        else:
            x = torch.einsum("dnm,md->nd", C_half, w) + mu
            t1 = torch.sum(torch.einsum("dnm,md->nd", A, w) ** 2)
            r = (model.f_vec(grid_I, x, theta).T
                 - torch.einsum("dnm,md->dn", M, w))
        t2 = torch.sum(torch.einsum("dnm,dm->dn", S, r) ** 2)
        x_at_obs = x.reshape(-1)[idxs]
        sig = sigma_profile(x_at_obs) if sigma_free else sig_fix
        t4 = torch.sum((x_at_obs - y_obs) ** 2 / sig[cols])
        t3 = torch.sum(N_ds * torch.log(2.0 * math.pi * sig))
        return 0.5 * ((t1 + t2) / beta + t3 + t4)

    th0 = np.maximum(np.asarray(model.thetas_init, np.float64), 1e-8)
    z0 = torch.cat([w0.reshape(-1), f64(th0)])
    value_and_grad = _value_and_grad(neg_lp, z0)
    if adam_steps:
        # optax.adam(adam_lr)'s update: eps 1e-8, torch's default
        z = z0.clone().requires_grad_(True)
        opt = torch.optim.Adam([z], lr=adam_lr)
        first = last = None
        for i in range(adam_steps):
            v, z.grad = value_and_grad(z)
            opt.step()
            first = v if first is None else first
            last = v
        z0 = z.detach().clone()
        # Adam can push bounded coordinates negative; clamp before L-BFGS-B
        z0[ND:] = torch.clamp(z0[ND:], min=1e-8)
        if verbose:
            print(f"[map] adam {adam_steps} steps: F {float(first):.2f} -> "
                  f"{float(last):.2f}")

    from scipy.optimize import minimize

    def fun_np(z):
        v, g = value_and_grad(f64(z))
        return float(v), g.cpu().numpy()

    bounds = [(None, None)] * ND + [(1e-10, None)] * D_th
    lbs = np.array([-np.inf] * ND + [1e-10] * D_th)

    def projected(z, g):
        """Zero the gradient where it points out of an active lower bound,
        whose raw gradient is legitimately large and meaningless."""
        g = np.asarray(g).copy()
        act = (z <= lbs * (1 + 1e-9) + 1e-300) & (g > 0)
        g[act] = 0.0
        return g, act

    # L-BFGS-B can stop on a failed line search far from the optimum; a
    # restart from the current point (its curvature pairs cleared)
    # recovers, up to four passes, as in the JAX function
    z_np, nit_total = z0.cpu().numpy(), 0
    for attempt in range(4):
        sol = minimize(fun_np, z_np, jac=True, method="L-BFGS-B",
                       bounds=bounds,
                       options={"maxiter": lbfgs_maxiter, "maxcor": 50,
                                "ftol": 1e-16, "gtol": 1e-8})
        nit_total += int(sol.nit)
        z_np = sol.x
        g, active = projected(sol.x, sol.jac)
        grad_norm = float(np.linalg.norm(g))
        if verbose:
            print(f"[map] L-BFGS-B pass {attempt}: nit={sol.nit} "
                  f"F={sol.fun:.3f} |g_proj|={grad_norm:.3g} "
                  f"active_bounds={int(active.sum())}")
        if sol.success or grad_norm <= 1e-3 * (1.0 + abs(sol.fun)):
            break
    z_map = f64(sol.x)
    w_map, theta_map = z_map[:ND].reshape(N, D), sol.x[ND:].copy()
    if gn:
        X_map_t = to_xc(w_map) + mu
    else:
        X_map_t = torch.einsum("dnm,md->nd", C_half, w_map) + mu
    X_map = X_map_t.cpu().numpy()
    sig_map = (sigma_profile(X_map_t.reshape(-1)[idxs]) if sigma_free
               else sig_fix).cpu().numpy()

    out = {
        "theta_map": theta_map,
        "sigma_sqs_map": sig_map,
        "X_map": X_map,
        "neg_logpost": float(sol.fun),
        "grad_norm": grad_norm,
        "lbfgs_iters": nit_total,
        "lbfgs_message": str(sol.message),
        "active_bounds": int(active.sum()),
        # L-BFGS-B's own flag can be False on a benign line-search stop with
        # active bounds; a small projected gradient is first-order
        # optimality
        "converged": bool(sol.success
                          or grad_norm <= 1e-3 * (1.0 + abs(sol.fun))),
        "band_truncation_bypassed": bypassed,
        "precondition": precondition,
        "wall_s": time.time() - t_start,
    }
    if gn:
        out["gn_jitter"] = float(gn_info["jitter"])
        out["gn_bw_precision"] = int(gn_info["bw_precision"])
    if not laplace:
        return out

    grad_fn = torch.func.grad(neg_lp)
    H = _hessian_chunked(grad_fn, z_map)
    # flat directions (Hes1's f and g profiles are flat over decades) make
    # H near-singular: an eigendecomposition handles both cases
    w_eig, V = np.linalg.eigh(H)
    spd = bool(w_eig.min() > 0)
    w_clip = np.maximum(w_eig, w_eig.max() * 1e-12)
    H_inv = (V / w_clip[None, :]) @ V.T
    th_sl = slice(ND, ND + D_th)
    out["theta_sd"] = np.sqrt(np.diag(H_inv[th_sl, th_sl]))
    out["theta_cov"] = H_inv[th_sl, th_sl]
    Hww = H_inv[:ND, :ND]
    if gn:
        # x_flat = mu_flat + T w with T = U^{-1} (mixing components), so
        # var(x_flat) = diag(T Hww T')
        T_unwhiten = torch.linalg.solve_triangular(
            U, torch.eye(ND, dtype=torch.float64, device=dev),
            upper=True).cpu().numpy()
        X_var = np.einsum("ij,ij->i", T_unwhiten @ Hww,
                          T_unwhiten).reshape(N, D)
    else:
        # x[:, d] = mu_d + C_half[d] w[:, d]
        Ch = C_half.cpu().numpy()
        Hw = Hww.reshape(N, D, N, D)
        X_var = np.stack(
            [np.einsum("nm,mk,nk->n", Ch[d], Hw[:, d, :, d], Ch[d],
                       optimize=True) for d in range(D)], axis=1)
    out["X_sd"] = np.sqrt(np.maximum(X_var, 0.0))
    out["hessian_spd"] = spd
    out["hessian_min_eig_rel"] = float(w_eig.min() / w_eig.max())

    if laplace_draws:
        # z = z_map + scale V diag(w_draw^{-1/2}) eps: H^{-1} with the
        # near-flat directions' variance capped
        rng = np.random.default_rng(draws_seed)
        w_draw = np.maximum(w_eig, w_eig.max() * draws_rel_floor)
        half = V / np.sqrt(w_draw)[None, :]
        eps = rng.standard_normal((laplace_draws, sol.x.shape[0]))
        zs = sol.x[None, :] + draws_scale * (eps @ half.T)
        mu_np = mu.cpu().numpy()
        if gn:
            out["X_draws"] = ((zs[:, :ND] @ T_unwhiten.T)
                              .reshape(laplace_draws, N, D)
                              + mu_np[None, None, :])
        else:
            W = zs[:, :ND].reshape(laplace_draws, N, D)
            out["X_draws"] = (np.einsum("dnm,cmd->cnd", Ch, W)
                              + mu_np[None, None, :])
        out["theta_draws"] = np.maximum(zs[:, ND:], 1e-8)
    return out
