"""Gauss-Newton posterior preconditioning and the fused sampler target
(counterpart of magi_v2_tpu/sampler/precond.py, dense storage only).

Setup builds the Gauss-Newton precision of the X block at the init point,

    Lambda = [ blkdiag_d(C_d^{-1}) + (dr/dX)' blkdiag_d(K_d^{-1}) (dr/dX) ] / beta
             + diag(observed)/sigma^2,

and the sampler works in z = L^{-1}(x - mu) with L = Lambda^{-1/2}, all in
float64 on the config's device (see the JAX module for the measurements
behind the design).

``make_tempered_logp_grad_gn`` returns the per-leapfrog target: the tempered
log-posterior and its gradient for a batch of chains, in the relative-energy
form around a ``RefPoint``. Its six matrix products are GEMMs with chains as
the free dimension; the pointwise and per-chain work between them is the
three K1 kernels of ops/manifold.py.
"""

from __future__ import annotations

import torch

from magi_v2_tpu_torch.ops.manifold import (
    manifold_bwd,
    manifold_energy,
    manifold_fwd,
)


def pointwise_ode_jacobian(f_vec, I, Xhat, thetas):
    """J[n, d, e] = d f_d(t_n, x_n) / d x_e — (N, D, D), at fixed theta."""
    I = I.reshape(-1, 1)

    def row(t_n, x_n):
        return f_vec(t_n[None, :], x_n[None, :], thetas)[0]

    return torch.func.vmap(torch.func.jacfwd(row, argnums=1))(I, Xhat)


def gauss_newton_precision(
    C_invs, m_ds, K_invs, beta, obs_mask, sigma_sqs, J,
    C_inv_sqrts=None, K_inv_sqrts=None,
):
    """The (N*D, N*D) Gauss-Newton precision of the X block, index order
    flat = n*D + d (X.ravel()). obs_mask (N, D); sigma_sqs (D,); J (N, D, D).
    With the factored R = C^{-1/2}, S = K^{-1/2} the precision is built from
    R'R and S'S, the operators the sampler evaluates."""
    if C_inv_sqrts is not None:
        C_invs = C_inv_sqrts.transpose(-1, -2) @ C_inv_sqrts
    if K_inv_sqrts is not None:
        K_invs = K_inv_sqrts.transpose(-1, -2) @ K_inv_sqrts
    D, N = C_invs.shape[0], C_invs.shape[1]

    lam = torch.zeros((N, D, N, D), dtype=C_invs.dtype, device=C_invs.device)
    for d in range(D):
        Kd, Ad = K_invs[d], m_ds[d]
        Bd = J[:, d, :]                      # (N, D): d f_d / d x_e
        KA = Kd @ Ad
        lam += torch.einsum("me,mM,Mf->meMf", Bd, Kd, Bd)
        lam[:, :, :, d] -= torch.einsum("me,mM->meM", Bd, KA)
        lam[:, d, :, :] -= torch.einsum("Mm,Mf->mMf", KA, Bd)
        lam[:, d, :, d] += Ad.T @ KA + C_invs[d]

    lam = lam.reshape(N * D, N * D) / float(beta)
    obs_diag = (obs_mask / sigma_sqs[None, :]).reshape(-1)
    return lam + torch.diag(obs_diag.to(lam.dtype))


def factor_precision(lam, floor_ratio: float = 1e-12):
    """(L, L_inv) = (Lambda^{-1/2}, Lambda^{1/2}) via symmetric eigh."""
    w, V = torch.linalg.eigh((lam + lam.T) / 2.0)
    w = torch.maximum(w, floor_ratio * torch.max(w))
    L = (V * (w ** -0.5)[None, :]) @ V.T
    L_inv = (V * (w ** 0.5)[None, :]) @ V.T
    return L, L_inv


def build_gn_whitening(model, C_inv_sqrts, K_inv_sqrts):
    """(L, L_inv) full-state whitening factors of a fitted port model, in
    float64 on the model's device, from the factored operators the sampler
    evaluates. (The JAX version also returns A1 = L' blkdiag(C^{-1}) L for
    the absolute-energy target, which is not ported.)"""
    dev = model.config.torch_device
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    obs_mask = (~torch.isnan(f64(model.X_obs_discret))).to(torch.float64)
    sigma = f64(model.sigma_sqs_init)
    J = pointwise_ode_jacobian(
        model.f_vec, f64(model.I), f64(model.Xhat_init), f64(model.thetas_init)
    )
    lam = gauss_newton_precision(
        f64(model.C_d_invs), f64(model.m_ds), f64(model.K_d_invs),
        model.beta, obs_mask, sigma, J,
        C_inv_sqrts=C_inv_sqrts, K_inv_sqrts=K_inv_sqrts,
    )
    return factor_precision(lam)


def whiten_X_full(X, mu_ds, L_inv):
    """z (N, D) from X (N, D) using the full (ND, ND) factor."""
    return (L_inv @ (X - mu_ds[None, :]).reshape(-1)).reshape(X.shape)


def unwhiten_Z_full(Z, mu_ds, L):
    """X (..., N, D) from z (..., N, D): x = mu + L z_flat."""
    shape = Z.shape
    xc = Z.reshape(shape[:-2] + (-1,)) @ L.T
    return xc.reshape(shape) + mu_ds


class GNTarget:
    """The fused tempered log-posterior and gradient in GN-whitened
    coordinates, relative to a RefPoint, for a batch of chains (K1).

    Per call, with chains as the GEMMs' free dimension:

        delta = L (z - z0)                      GEMM
        [R delta; m delta]                      batched GEMM   -> manifold_fwd
        Ds = S dr                               batched GEMM   -> manifold_energy
        g_dr = S' g_Ds                          batched GEMM   -> manifold_bwd
        g_delta = [R' | -m'] [g_Rd; g_dr] + .   batched GEMM
        grad_z = L' g_delta                     GEMM

    Layouts follow ops/manifold.py: per-component blocks are (D, C, N), and
    L's rows are permuted at setup so that delta comes out component-major.
    """

    def __init__(self, data, f_vec, L, ref, z0, N_I: int, D: int,
                 D_thetas: int):
        self.f_vec = f_vec
        self.N, self.D, self.P = N_I, D, D_thetas
        dt, dev = L.dtype, L.device
        # perm[d*N + n] = n*D + d: row (d, n) of the component-major factor
        perm = torch.arange(N_I * D, device=dev).reshape(N_I, D).T.reshape(-1)
        L_perm = L[perm]
        self.L_perm = L_perm.contiguous()          # (DN, ND): g_z = g_delta L_perm
        self.Lt_perm = L_perm.T.contiguous()       # (ND, DN): delta = dz Lt_perm
        R, m, S = data.C_inv_sqrts, data.m_ds, data.K_inv_sqrts
        self.W_fwd = torch.cat([R.transpose(1, 2), m.transpose(1, 2)],
                               dim=2).contiguous()          # (D, N, 2N)
        self.W_bwd = torch.cat([R, -m], dim=1).contiguous()  # (D, 2N, N)
        self.S = S.contiguous()
        self.St = S.transpose(1, 2).contiguous()
        self.z0 = z0
        self.I = data.I
        self.x0T = ref.x0.T.contiguous()
        self.a0, self.f0, self.s0 = ref.a0, ref.f0, ref.s0
        mask = torch.zeros(N_I * D, dtype=dt, device=dev)
        mask[data.not_nan_idxs] = 1.0
        y = torch.zeros(N_I * D, dtype=dt, device=dev)
        y[data.not_nan_idxs] = data.y_observed
        self.mask = mask.reshape(N_I, D).T.contiguous()
        self.y = y.reshape(N_I, D).T.contiguous()
        self.sigma_lb = data.sigma_sqs_LB.contiguous()
        self.n_ds = data.N_ds.contiguous()
        self.beta = float(data.beta)

    def to(self, device) -> "GNTarget":
        """A copy of this target with every tensor on ``device``."""
        out = object.__new__(GNTarget)
        out.__dict__ = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                        for k, v in self.__dict__.items()}
        return out

    def __call__(self, q, beta_temp):
        """q (C, dim) -> (logp (C,), grad (C, dim)); beta_temp 0-dim."""
        N, D = self.N, self.D
        ND = N * D
        C = q.shape[0]
        q = q.contiguous()
        delta = torch.mm(q[:, :ND] - self.z0, self.Lt_perm).view(C, D, N)
        RmD = torch.bmm(delta.transpose(0, 1), self.W_fwd)
        dr, gcat, t14 = manifold_fwd(
            self.f_vec, self.I, delta, RmD, q, self.x0T, self.a0, self.f0,
            self.mask, self.y, self.sigma_lb, beta_temp, self.beta,
        )
        Ds = torch.bmm(dr, self.St)
        lp, gDs = manifold_energy(
            self.f_vec, Ds, self.s0, t14, q, self.sigma_lb, self.n_ds,
            beta_temp, self.beta,
        )
        gdr = torch.bmm(gDs, self.S)
        grad = torch.empty_like(q)
        gpart = manifold_bwd(
            self.f_vec, self.I, gdr, delta, q, self.x0T, self.mask, self.y,
            self.sigma_lb, self.n_ds, beta_temp, gcat, grad,
        )
        g_delta = torch.baddbmm(gpart, gcat, self.W_bwd)
        grad[:, :ND] = torch.mm(g_delta.transpose(0, 1).reshape(C, ND),
                                self.L_perm)
        return lp, grad


def make_tempered_logp_grad_gn(data, f_vec, L, N_I: int, D: int,
                               D_thetas: int, ref, z0):
    """Fused evaluation in GN-whitened coordinates, relative to ``ref``
    (posterior.RefPoint) — the float32-safe form the JAX package samples
    with. Returns ``logp_grad(q (C, dim), beta_temp) -> (logp (C,), grad)``.
    The absolute-energy branch (ref=None, t1 = z'A1z) is not ported."""
    if ref is None or z0 is None:
        raise NotImplementedError(
            "only the relative-energy target (ref and z0) is ported"
        )
    if data.C_inv_sqrts is None or data.K_inv_sqrts is None:
        raise ValueError("the relative target needs C_inv_sqrts and K_inv_sqrts")
    return GNTarget(data, f_vec, L, ref, z0, N_I, D, D_thetas)
