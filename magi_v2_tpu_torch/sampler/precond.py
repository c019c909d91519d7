"""Gauss-Newton posterior preconditioning and the fused sampler target
(counterpart of magi_v2_tpu/sampler/precond.py).

Setup builds the Gauss-Newton precision of the X block at an anchor point,

    Lambda = [ blkdiag_d(C_d^{-1}) + (dr/dX)' blkdiag_d(K_d^{-1}) (dr/dX) ] / beta
             + diag(observed)/sigma^2,

in float64, and the sampler works in whitened coordinates z: dense
storage z = L^{-1}(x - mu) with L = Lambda^{-1/2} (eigh), banded and
hybrid storage z = U (x - mu) with Lambda = U'U the banded Cholesky factor
(host SciPy), unwhitened per leapfrog by the exact block-banded back
substitution (K4). See the JAX module for the measurements behind the
design.

``GNTarget`` is the per-leapfrog target of all three storage modes: the
tempered log-posterior and its gradient for a batch of chains, in the
relative-energy form around a ``RefPoint``. It is one pipeline with two
pluggable linear stages around the three K1 kernels of ops/manifold.py.
For each chain count it sees, the target keeps one workspace: the
intermediates in fixed buffers and every stage bound to them once
(arguments checked and, on the card, argument lists converted then), so
that an evaluation only launches. The two stages:

- the whitening stage, delta = W (z - z0) and its adjoint: a dense GEMM
  with L (``DenseWhitening``), the K4 solve with U (``BandedWhitening``),
  or the identity in centered coordinates (``IdentityWhitening``);
- the operator stage, [R; m] delta, S dr and their adjoints: dense batched
  GEMMs (``DenseOperators``) or K3 on the band-truncated factors
  (``BandedOperators``).

Dense storage = (L, dense), hybrid = (K4, dense), banded = (K4, K3).

Centered coordinates (``reparam="centered"``: the sampler's X block is the
trajectories themselves) take the identity as the whitening stage
(``IdentityWhitening``: delta = x - x0) with the dense operators (dense
storage) or K3 (banded storage), so they keep the factored ||R x||^2 forms
and the relative energies, which a raw float32 x'C^{-1}x would lose.

The GP-prior whitened coordinates (``reparam="whitened"``: X = mu + L z,
L = C^{1/2} per component) take ``GPWhitening`` (delta = L dz, one batched
GEMM over the components) with the m-only operators: t1 is ||z||^2, which
K1's whitened form takes from dz itself, so R is never applied.
"""

from __future__ import annotations

import torch

import numpy as np

from types import SimpleNamespace

from magi_v2_tpu_torch.ops.banded import (
    BandedMatrix,
    UpperFactor,
    launch_stream,
    banded_solve,
    bind_matvec,
    bind_solve,
    block_banded_matvec_upper,
)
from magi_v2_tpu_torch.ops.manifold import ManifoldPlan
from magi_v2_tpu_torch.utils.profiling import untimed


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
    """z (..., N, D) from X (..., N, D) using the full (ND, ND) factor."""
    xc = (X - mu_ds).reshape(X.shape[:-2] + (-1,))
    return (xc @ L_inv.T).reshape(X.shape)


def unwhiten_Z_full(Z, mu_ds, L):
    """X (..., N, D) from z (..., N, D): x = mu + L z_flat."""
    shape = Z.shape
    xc = Z.reshape(shape[:-2] + (-1,)) @ L.T
    return xc.reshape(shape) + mu_ds


# --------------------------------------------------------------------------
# banded Gauss-Newton whitening (the O(ND * b) large-grid path)
# --------------------------------------------------------------------------


def gauss_newton_precision_band(
    C_invs, m_ds, K_invs, beta, obs_mask, sigma_sqs, J, bw: int,
    comp_bandwidth: int | None = None, C_inv_sqrts=None, K_inv_sqrts=None,
):
    """Banded storage (2*bw+1, N*D) of the Gauss-Newton precision Lambda
    in float64, band[bw + k, i] = Lambda[i, i + k] (NumPy out, as the JAX
    function; NumPy arrays or tensors in).

    Index order flat = n*D + d (X.ravel()), the order in which Lambda is
    banded. The per-component operators are read banded at
    ``comp_bandwidth``; with the float64 square roots R, S the precision is
    assembled from band(R)'band(R) and band(S)'band(S), the exact PSD
    curvature of the banded target (the raw band-truncated operators are
    indefinite at dense-grid sizes). ``gauss_newton_precision`` forms it
    dense from the band-masked inputs on the device of the operators (the
    first tensor among them, else the CPU), and one gather takes the band:
    at the Lorenz dense grid (ND = 3075) ~26 GFLOP of float64 GEMMs, 0.036
    s on an H100 with the band's copy to the host, 0.49 s on its host's
    8 CPU threads (scripts/gn_band_probe.py)."""
    dev = operator_device(C_inv_sqrts, K_inv_sqrts, C_invs, K_invs)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    N = m_ds.shape[-1]
    b = N - 1 if comp_bandwidth is None else int(min(comp_bandwidth, N - 1))
    i = torch.arange(N, device=dev)
    inside = (i[:, None] - i[None, :]).abs() <= b
    banded = lambda a: None if a is None else torch.where(inside, f64(a), 0.0)
    lam = gauss_newton_precision(
        None if C_inv_sqrts is not None else banded(C_invs), banded(m_ds),
        None if K_inv_sqrts is not None else banded(K_invs), beta,
        f64(obs_mask), f64(sigma_sqs), f64(J),
        C_inv_sqrts=banded(C_inv_sqrts), K_inv_sqrts=banded(K_inv_sqrts),
    )
    return dense_band(lam, int(min(bw, lam.shape[0] - 1))).cpu().numpy()


def operator_device(*operators) -> torch.device:
    """The device of the first tensor among ``operators``, else the CPU:
    where ``gauss_newton_precision_band`` assembles the precision."""
    return next((a.device for a in operators if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def dense_band(lam, bw: int):
    """The (2 bw + 1, n) band storage of the square tensor ``lam`` in one
    gather: band[bw + k, i] = lam[i, i + k], zero where i + k is off the
    matrix."""
    n = lam.shape[0]
    i = torch.arange(n, device=lam.device)
    j = i[None, :] + torch.arange(-bw, bw + 1, device=lam.device)[:, None]
    inside = (j >= 0) & (j < n)
    return torch.where(inside, lam[i[None, :], j.clamp(0, n - 1)], 0.0)


def build_gn_cholesky_banded(model, sigma_sqs_init=None,
                             bw_precision: int | None = None,
                             C_inv_sqrts=None, K_inv_sqrts=None, at_X=None,
                             at_thetas=None, timer=untimed):
    """Banded Cholesky factor U of the Gauss-Newton precision Lambda = U'U
    of a fitted port model in float64: (U_band, info), Lambda's band
    assembled on the device of the square roots (the card's, where they
    live; counted as ``gn_precision_on_card``), U on the host. The
    sampler whitens with z = U (x - mu), whose curvature U^{-T} Lambda
    U^{-1} is the identity; x = mu + U^{-1} z is the exact block-banded
    back substitution (K4). With the float64 square roots of the operators
    the precision's bandwidth defaults to its natural 4*D*bandsize (no
    truncation of Lambda). ``at_X``/``at_thetas`` move the linearization
    anchor (predict's ``gn_anchor``); ``timer`` times the Jacobian, the
    precision band and the Cholesky ("setup_gn_*")."""
    from magi_v2_tpu_torch.ops.banded_host import banded_cholesky_upper

    N, D = model.mag_I, model.D
    bsize = model.BANDSIZE if model.BANDSIZE is not None else N - 1
    if bw_precision is None:
        if C_inv_sqrts is not None:
            bw_precision = min(N * D - 1, 4 * D * bsize)
        else:
            bw_precision = min(N * D - 1, D * (bsize + 1))
    obs_mask = (~np.isnan(model.X_obs_discret)).astype(np.float64)
    sigma = model.sigma_sqs_init if sigma_sqs_init is None else sigma_sqs_init
    X_anchor = model.Xhat_init if at_X is None else np.asarray(at_X)
    th_anchor = model.thetas_init if at_thetas is None else np.asarray(
        at_thetas)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    dtype=torch.float64)
    with timer("setup_gn_jacobian"):
        J = pointwise_ode_jacobian(model.f_vec, f64(model.I), f64(X_anchor),
                                   f64(th_anchor))
    with timer("setup_gn_precision"):
        ops = (C_inv_sqrts, K_inv_sqrts, model.C_d_invs, model.K_d_invs)
        if operator_device(*ops).type == "cuda":
            timer.count("gn_precision_on_card")
        lam_band = gauss_newton_precision_band(
            model.C_d_invs, model.m_ds, model.K_d_invs, model.beta, obs_mask,
            sigma, J, bw_precision, comp_bandwidth=bsize,
            C_inv_sqrts=C_inv_sqrts, K_inv_sqrts=K_inv_sqrts,
        )
    with timer("setup_gn_cholesky"):
        U_band, jitter = banded_cholesky_upper(lam_band)
    return U_band, {"jitter": jitter, "bw_precision": int(bw_precision)}


def whiten_X_banded(X, mu_ds, U_blocks):
    """z (..., N, D) from X (..., N, D): z = U (X - mu) flattened, one
    banded matvec (U_blocks in ``banded_to_blocks_upper`` layout)."""
    xc = (X - mu_ds).reshape(X.shape[:-2] + (-1,))
    return block_banded_matvec_upper(U_blocks, xc).reshape(X.shape)


def unwhiten_Z_banded(Z, mu_ds, factor: UpperFactor):
    """X (..., N, D) from z (..., N, D): x = mu + U^{-1} z by the exact
    block-banded back substitution (K4)."""
    shape = Z.shape
    zf = Z.reshape(-1, 1, shape[-2] * shape[-1])
    x = torch.empty_like(zf)
    banded_solve(factor, zf, x)
    return x.reshape(shape) + mu_ds


# --------------------------------------------------------------------------
# the fused target
# --------------------------------------------------------------------------


def _to(obj, device):
    """A copy of ``obj`` (a stage or target) with every tensor, and every
    member that has ``to``, on ``device``; a target's copy starts with no
    workspace."""
    out = object.__new__(type(obj))
    out.__dict__ = {
        k: (v.to(device) if isinstance(v, torch.Tensor) or hasattr(v, "to")
            else v)
        for k, v in obj.__dict__.items()
    }
    if "_workspaces" in out.__dict__:
        out._workspaces = {}
    return out


# A stage's ``bind(b)`` takes a workspace's buffers ``b`` (GNTarget._bind:
# dz (C, ND), delta (C, D, N), RmD and gcat (D, C, 2N), dr, Ds, gDs, gdr
# and gpart (D, C, N)) and returns its calls bound to them, each a callable
# of the stream. The operator stage is bound first and adds ``g_delta``, the
# (D, C, N) tensor its last product writes and the whitening stage's
# adjoint reads, in the layout that suits it.


class DenseWhitening:
    """delta = L (z - z0) as one GEMM, component-major: L's rows are
    permuted at setup so that delta comes out (C, D, N)."""

    def __init__(self, L, N: int, D: int):
        self.N, self.D = N, D
        # perm[d*N + n] = n*D + d: row (d, n) of the component-major factor
        perm = torch.arange(N * D, device=L.device).reshape(N, D).T.reshape(-1)
        L_perm = L[perm]
        self.L_perm = L_perm.contiguous()        # (DN, ND): g_z = g_delta L_perm
        self.Lt_perm = L_perm.T.contiguous()     # (ND, DN): delta = dz Lt_perm

    def bind(self, b):
        """delta <- dz Lt_perm, and grad[:, :ND] <- g_delta (as (C, D*N))
        L_perm."""
        dz = b["dz"]
        C, ND = dz.shape
        delta2 = b["delta"].view(C, ND)
        g_delta2 = b["g_delta"].transpose(0, 1).reshape(C, ND)
        if g_delta2.data_ptr() != b["g_delta"].data_ptr():
            raise ValueError("the dense whitening reads g_delta chain-major")
        return SimpleNamespace(
            forward=lambda stream: torch.mm(dz, self.Lt_perm, out=delta2),
            backward=lambda grad, stream: torch.mm(g_delta2, self.L_perm,
                                                   out=grad[:, :ND]))

    to = _to


class IdentityWhitening:
    """Centered coordinates: delta = x - x0, the sampler's (C, N*D) block
    of x - x0 (interleaved, n*D + d) permuted to the component-major (C, D,
    N) delta; the adjoint g_x = g_delta, permuted back into the gradient's
    leading N*D columns."""

    def __init__(self, N: int, D: int):
        self.N, self.D = N, D

    def bind(self, b):
        dz = b["dz"]
        C, ND = dz.shape
        N, D = self.N, self.D
        dz3 = dz.view(C, N, D).permute(0, 2, 1)
        g_delta = b["g_delta"].permute(1, 2, 0)         # (C, N, D) view
        return SimpleNamespace(
            forward=lambda stream: b["delta"].copy_(dz3),
            backward=lambda grad, stream: grad[:, :ND].view(C, N, D).copy_(
                g_delta))

    to = _to


class GPWhitening:
    """The GP-prior whitening of ``reparam="whitened"``: delta_d = L_d dz_d
    for each component, one GEMM batched over D with the chains as the
    free dimension, where dz (C, D, N) is component-major (``whitened``:
    the target's difference z - z0 writes it so, and K1's whitened fwd
    reads it there). The adjoint adds L_d' g_delta_d onto the t1 seed
    -(beta_T/beta) z that K1 wrote to gcat[..., :N], and writes the sum to
    the gradient's leading N*D (interleaved) columns."""

    whitened = True

    def __init__(self, L, N: int, D: int):
        self.N, self.D = N, D
        self.Lt = L.transpose(1, 2).contiguous()   # delta_d = dz_d Lt_d
        self.L = L.contiguous()                    # L_d' g = g_d L_d

    def bind(self, b):
        dz_t, delta_t = b["dz"].transpose(0, 1), b["delta"].transpose(0, 1)
        C = b["dz"].shape[0]
        N, D = self.N, self.D
        seed, g_delta = b["gcat"][..., :N], b["g_delta"]

        def backward(grad, stream):
            seed.baddbmm_(g_delta, self.L)
            grad[:, :N * D].view(C, N, D).copy_(seed.permute(1, 2, 0))

        return SimpleNamespace(
            forward=lambda stream: torch.bmm(dz_t, self.Lt, out=delta_t),
            backward=backward)

    to = _to


class BandedWhitening:
    """delta = U^{-1} (z - z0) by K4; its adjoint U^{-T} by K4's adjoint.
    U is banded in the interleaved order n*D + d; the permutation to and
    from the component-major (C, D, N) blocks is folded into the kernel's
    loads and stores (strided views, no transpose copies)."""

    def __init__(self, factor: UpperFactor, N: int, D: int):
        self.factor, self.N, self.D = factor, N, D

    def _interleaved(self, flat):
        """(C, ND) interleaved, as (C, D, N)."""
        return flat.view(flat.shape[0], self.N, self.D).permute(0, 2, 1)

    def bind(self, b):
        dz = b["dz"]
        ND = dz.shape[1]
        forward = bind_solve(self.factor, self._interleaved(dz), b["delta"])
        # bound to a gradient's leading ND columns; each call brings its own
        adjoint = bind_solve(self.factor, b["g_delta"].permute(1, 0, 2),
                             self._interleaved(b["grad0"][:, :ND]),
                             adjoint=True)
        return SimpleNamespace(
            forward=forward,
            backward=lambda grad, stream: adjoint(
                stream, self._interleaved(grad[:, :ND])))

    to = _to


class DenseOperators:
    """[R; m] delta, S dr and their adjoints as batched GEMMs over the D
    components, with [R; m] and [R' | -m'] stacked so that each direction
    takes one GEMM. With R None (the whitened target, whose t1 is ||z||^2)
    the first and last products are m delta and -m' g_dr alone, half the
    size, and RmD's and gcat's first halves are left to K1."""

    def __init__(self, R, m, S):
        if R is None:
            self.W_fwd = m.transpose(1, 2).contiguous()          # (D, N, N)
            self.W_bwd = (-m).contiguous()                       # (D, N, N)
        else:
            self.W_fwd = torch.cat([R.transpose(1, 2), m.transpose(1, 2)],
                                   dim=2).contiguous()           # (D, N, 2N)
            self.W_bwd = torch.cat([R, -m], dim=1).contiguous()  # (D, 2N, N)
        self.m_only = R is None
        self.S = S.contiguous()
        self.St = S.transpose(1, 2).contiguous()

    def bind(self, b):
        """RmD = [R delta | m delta], Ds = S dr, gdr = S' gDs, and
        g_delta = gpart + R' g_Rd - m' g_dr with gcat = [g_Rd | g_dr] (m
        only: RmD[..., N:] = m delta, g_delta = gpart - m' g_dr)."""
        delta_t = b["delta"].transpose(0, 1)
        N = b["delta"].shape[-1]
        rm_out, g_in = b["RmD"], b["gcat"]
        if self.m_only:
            rm_out, g_in = rm_out[..., N:], g_in[..., N:]
        # chain-major, so that the dense whitening's adjoint reads it as a
        # (C, D*N) matrix without a copy
        g_delta = b["g_delta"] = torch.empty_like(b["delta"]).transpose(0, 1)
        return SimpleNamespace(
            rm=lambda stream: torch.bmm(delta_t, self.W_fwd, out=rm_out),
            s=lambda stream: torch.bmm(b["dr"], self.St, out=b["Ds"]),
            s_adjoint=lambda stream: torch.bmm(b["gDs"], self.S,
                                               out=b["gdr"]),
            rm_adjoint=lambda stream: torch.baddbmm(
                b["gpart"], g_in, self.W_bwd, out=g_delta))

    to = _to


class BandedOperators:
    """The same products through K3 on the band-truncated block storage of
    R, m and S (D, nb, nw, 128, 128); chains are the kernel's free
    dimension and the (D, C, N) / (C, D, N) layouts enter as strides.
    [R; m] delta and [R' | -m'] gcat are one paired launch each."""

    def __init__(self, R_blocks, m_blocks, S_blocks):
        self.R = BandedMatrix.make(R_blocks)
        self.m = BandedMatrix.make(m_blocks)
        self.S = BandedMatrix.make(S_blocks)

    def bind(self, b):
        """The four products of ``DenseOperators.bind``, one K3 launch each;
        g_delta is gpart, accumulated in place."""
        N = b["delta"].shape[-1]
        halves = lambda t: (t[..., :N].transpose(0, 1),
                            t[..., N:].transpose(0, 1))
        t = lambda name: (b[name].transpose(0, 1),)
        b["g_delta"] = b["gpart"]
        return SimpleNamespace(
            rm=bind_matvec((self.R, self.m), (b["delta"],), halves(b["RmD"])),
            s=bind_matvec((self.S,), t("dr"), t("Ds")),
            s_adjoint=bind_matvec((self.S,), t("gDs"), t("gdr"),
                                  adjoint=True),
            rm_adjoint=bind_matvec((self.R, self.m), halves(b["gcat"]),
                                   t("gpart"), adjoint=True,
                                   alpha=(1.0, -1.0), accumulate=True))

    to = _to


class GNTarget:
    """The fused tempered log-posterior and gradient in GN-whitened
    coordinates, relative to a RefPoint, for a batch of chains (K1).

    Per call, with chains as the free dimension of every product:

        delta = W (z - z0)                      whitening stage
        [R delta; m delta]                      operator stage -> manifold_fwd
        Ds = S dr                               operator stage -> manifold_energy
        g_dr = S' g_Ds                          operator stage -> manifold_bwd
        g_delta = [R' | -m'] [g_Rd; g_dr] + .   operator stage
        grad_z = W' g_delta                     whitening stage

    Layouts follow ops/manifold.py: per-component blocks are (D, C, N).
    dz = z - z0 is (C, N*D) in the sampler's interleaved order, or (C, D,
    N) for a whitening stage that reads it component-major (``whitened``:
    ``GPWhitening``, whose K1 plan then takes its whitened form).

    Every intermediate lives in a workspace made when the target first
    sees a chain count (``_bind``): the buffers, the two stages and the K1
    plan bound to them, their arguments checked then and not again. A
    call checks q and beta_temp, overwrites the intermediates, and returns
    a new lp and a new grad: the eager sampler holds those of the current
    state while it evaluates the proposal, so they are never reused.
    ``bind`` gives the same evaluation on fixed q, beta_temp, lp and grad,
    which the bound sampler replays as a CUDA graph; ``bind_value`` the
    log-posterior alone (parallel tempering's swap). beta_temp is 0-dim,
    or (C,) for one temperature per chain (parallel tempering's rungs)."""

    def __init__(self, data, f_vec, whitening, operators, ref, z0, N_I: int,
                 D: int, D_thetas: int):
        self.f_vec = f_vec
        self.N, self.D, self.P = N_I, D, D_thetas
        self.whitening, self.operators = whitening, operators
        dt, dev = z0.dtype, z0.device
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
        self._workspaces = {}

    to = _to

    def _bind(self, C: int):
        """The workspace of C chains: buffers, bound stages, K1 plan."""
        N, D = self.N, self.D
        dt, dev = self.z0.dtype, self.z0.device
        dim = N * D + D + self.P
        new = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
        whitened = getattr(self.whitening, "whitened", False)
        b = dict(dz=new(C, D, N) if whitened else new(C, N * D),
                 delta=new(C, D, N), t14=new(C, 2),
                 grad0=new(C, dim),
                 **{k: new(D, C, 2 * N) for k in ("RmD", "gcat")},
                 **{k: new(D, C, N)
                    for k in ("dr", "Ds", "gDs", "gdr", "gpart")})
        consts = {k: getattr(self, k) for k in ("x0T", "a0", "f0", "s0",
                                                "mask", "y", "sigma_lb",
                                                "n_ds")}
        operators = self.operators.bind(b)
        if whitened:
            # the one elementwise pass that forms dz writes it
            # component-major, the layout of the whitening's GEMM
            z0T = self.z0.view(N, D).T
            diff = lambda q: torch.sub(
                q[:, :N * D].view(C, N, D).transpose(1, 2), z0T,
                out=b["dz"])
        else:
            diff = lambda q: torch.sub(q[:, :N * D], self.z0, out=b["dz"])
        return SimpleNamespace(
            bufs=b, q_shape=(C, dim), operators=operators, diff=diff,
            whitening=self.whitening.bind(b),
            k1=ManifoldPlan(self.f_vec, self.I, consts, self.beta, dim, b,
                            whitened=whitened))

    def _workspace(self, C: int):
        ws = self._workspaces.get(C)
        if ws is None:
            ws = self._workspaces[C] = self._bind(C)
        return ws

    def _check(self, name, t, shape):
        dt, dev = self.z0.dtype, self.z0.device
        if not (isinstance(t, torch.Tensor) and t.dtype == dt
                and t.device == dev and t.shape == shape):
            raise TypeError(f"{name} must be a {tuple(shape)} {dt} tensor "
                            f"on {dev}")

    def _evaluate_value(self, ws, q, beta_temp, lp, stream) -> None:
        """The forward half of an evaluation: lp at q, through the
        workspace (the whitening and operator stages' forward products and
        K1's fwd and energy kernels)."""
        ws.diff(q)
        ws.whitening.forward(stream)
        ws.operators.rm(stream)
        ws.k1.fwd(q, beta_temp, stream)
        ws.operators.s(stream)
        ws.k1.energy(q, beta_temp, lp, stream)

    def _evaluate(self, ws, q, beta_temp, lp, grad) -> None:
        """One evaluation at q into lp and grad, through the workspace."""
        stream = launch_stream(self.z0.device)
        wh, op, k1 = ws.whitening, ws.operators, ws.k1
        self._evaluate_value(ws, q, beta_temp, lp, stream)
        op.s_adjoint(stream)
        k1.bwd(q, beta_temp, grad, stream)
        op.rm_adjoint(stream)
        wh.backward(grad, stream)

    def _check_beta(self, beta_temp, C: int) -> None:
        dt, dev = self.z0.dtype, self.z0.device
        if not (isinstance(beta_temp, torch.Tensor)
                and beta_temp.shape in ((), (C,)) and beta_temp.dtype == dt
                and beta_temp.device == dev and beta_temp.is_contiguous()):
            raise TypeError(f"beta_temp must be a 0-dim or ({C},) {dt} "
                            f"tensor on {dev}")

    def __call__(self, q, beta_temp):
        """q (C, dim) -> (logp (C,), grad (C, dim)); beta_temp 0-dim or
        (C,)."""
        z0 = self.z0
        dt, dev = z0.dtype, z0.device
        if not (isinstance(q, torch.Tensor) and q.dim() == 2
                and q.dtype == dt and q.device == dev):
            raise TypeError(f"q must be a (C, dim) {dt} tensor on {dev}")
        C = q.shape[0]
        self._check_beta(beta_temp, C)
        ws = self._workspace(C)
        if q.shape != ws.q_shape:
            raise ValueError(f"q has shape {tuple(q.shape)}, expected "
                             f"{ws.q_shape}")
        q = q.contiguous()
        lp = torch.empty((C,), dtype=dt, device=dev)
        grad = torch.empty_like(q)
        self._evaluate(ws, q, beta_temp, lp, grad)
        return lp, grad

    def _bound_workspace(self, q, beta_temp, lp, grad=None):
        """The workspace of q's chain count, with q, beta_temp, lp and (when
        given) grad checked."""
        if not (isinstance(q, torch.Tensor) and q.dim() == 2):
            raise TypeError("q must be a (C, dim) tensor")
        ws = self._workspace(q.shape[0])
        outs = (("lp", lp, ws.q_shape[:1]),) + (
            () if grad is None else (("grad", grad, ws.q_shape),))
        for name, t, shape in (("q", q, ws.q_shape),) + outs:
            self._check(name, t, shape)
        self._check_beta(beta_temp, q.shape[0])
        if not all(t.is_contiguous() for _, t, _ in (("q", q, 0),) + outs):
            raise ValueError("q, lp and grad must be contiguous")
        return ws

    def bind(self, q, beta_temp, lp, grad):
        """The evaluation bound to fixed tensors, checked here once: a
        callable of no arguments that evaluates the target at what q (C,
        dim) holds, at the temperature beta_temp (0-dim, or one per chain,
        (C,)) holds, into lp (C,) and grad (C, dim), and allocates nothing.
        It shares the workspace of C chains with ``__call__``. The
        sampler's ``BoundTransition`` captures it into a CUDA graph."""
        ws = self._bound_workspace(q, beta_temp, lp, grad)
        return lambda: self._evaluate(ws, q, beta_temp, lp, grad)

    def bind_value(self, q, beta_temp, lp):
        """``bind``'s log-posterior alone: a callable of no arguments that
        writes into lp (C,) what ``bind``'s evaluation writes there, the
        same bits, running only the forward half (no adjoint products and
        no K1 bwd). Parallel tempering's swap (sampler/pt.py) captures it
        beside the swap kernel."""
        ws = self._bound_workspace(q, beta_temp, lp)
        return lambda: self._evaluate_value(ws, q, beta_temp, lp,
                                            launch_stream(self.z0.device))


def _relative_only(ref, z0):
    if ref is None or z0 is None:
        raise NotImplementedError(
            "only the relative-energy target (ref and z0) is ported"
        )


def make_tempered_logp_grad_gn(data, f_vec, L, N_I: int, D: int,
                               D_thetas: int, ref, z0):
    """Dense storage: delta = L (z - z0), dense operators. Relative to
    ``ref`` (posterior.RefPoint), the float32-safe form the JAX package
    samples with. Returns ``logp_grad(q (C, dim), beta_temp) -> (logp (C,),
    grad)``. The absolute-energy branch (ref=None, t1 = z'A1z) is not
    ported."""
    _relative_only(ref, z0)
    if data.C_inv_sqrts is None or data.K_inv_sqrts is None:
        raise ValueError("the relative target needs C_inv_sqrts and K_inv_sqrts")
    return GNTarget(
        data, f_vec, DenseWhitening(L, N_I, D),
        DenseOperators(data.C_inv_sqrts, data.m_ds, data.K_inv_sqrts),
        ref, z0, N_I, D, D_thetas,
    )


def make_tempered_logp_grad_centered(data, f_vec, N_I: int, D: int,
                                     D_thetas: int, ref, z0):
    """Centered coordinates, dense storage: delta = x - x0 with z0 the
    flattened x0 (``ref.x0`` in the sampling dtype), dense operators, the
    relative energies around ``ref``. Its log-posterior differs from the
    JAX package's absolute ``log_posterior`` by the constant energy of the
    reference point."""
    _relative_only(ref, z0)
    if data.C_inv_sqrts is None or data.K_inv_sqrts is None:
        raise ValueError("the relative target needs C_inv_sqrts and K_inv_sqrts")
    return GNTarget(
        data, f_vec, IdentityWhitening(N_I, D),
        DenseOperators(data.C_inv_sqrts, data.m_ds, data.K_inv_sqrts),
        ref, z0, N_I, D, D_thetas,
    )


def make_tempered_logp_grad_whitened(data, f_vec, L, N_I: int, D: int,
                                     D_thetas: int, ref, z0):
    """The GP-prior whitened target (``reparam="whitened"``, dense
    storage): X = mu + L z with ``L`` (D, N, N) the GP square roots
    (``magi_state.gp_sqrt_factors``), t1 = ||z||^2. Relative to ``ref``,
    whose x0 must be mu + L z0 for the flattened start ``z0`` (N*D,
    interleaved, in the sampling dtype): delta = L (z - z0) and t1 - ||z0||^2
    = sum dz (dz + 2 z0), which K1's whitened fwd computes, reading z0 where
    the GN form reads a0. Its log-posterior differs from the JAX package's
    by the constant energy of the reference point."""
    _relative_only(ref, z0)
    if data.K_inv_sqrts is None:
        raise ValueError("the relative target needs K_inv_sqrts")
    ref = ref._replace(a0=z0.view(N_I, D).T.contiguous())
    return GNTarget(
        data, f_vec, GPWhitening(L, N_I, D),
        DenseOperators(None, data.m_ds, data.K_inv_sqrts),
        ref, z0, N_I, D, D_thetas,
    )


def make_tempered_logp_grad_centered_banded(data, f_vec, N_I: int, D: int,
                                            D_thetas: int, ref, z0):
    """Centered coordinates in banded storage: delta = x - x0 (the identity
    whitening) and every operator through K3 on the band-truncated square
    roots (``data`` a BandedPosteriorData with C_sqrt_blocks and
    K_sqrt_blocks), the counterpart of the JAX package's centered
    ``log_posterior`` on banded data. ``ref`` must be built from the same
    band-truncated float64 operators, ``z0`` the flattened x0."""
    _relative_only(ref, z0)
    if data.C_sqrt_blocks is None or data.K_sqrt_blocks is None:
        raise ValueError(
            "the centered banded target needs the banded sqrt factors; "
            "build the data via to_banded_data(..., C_inv_sqrts_f64=..., "
            "K_inv_sqrts_f64=...)"
        )
    return GNTarget(
        data, f_vec, IdentityWhitening(N_I, D),
        BandedOperators(data.C_sqrt_blocks, data.m_blocks,
                        data.K_sqrt_blocks),
        ref, z0, N_I, D, D_thetas,
    )


def make_tempered_logp_grad_gn_hybrid(data, f_vec, factor: UpperFactor,
                                      N_I: int, D: int, D_thetas: int, ref,
                                      z0):
    """Hybrid storage: banded-GN coordinates (delta = U^{-1}(z - z0), K4
    on ``factor``) against the EXACT dense operators of ``data`` (a dense
    PosteriorData with C_inv_sqrts): the truncation touches the
    preconditioner only, never the target. ``ref``/``z0`` must come from
    the same exact operators."""
    _relative_only(ref, z0)
    if data.C_inv_sqrts is None or data.K_inv_sqrts is None:
        raise ValueError(
            "hybrid mode needs the dense factored operators; build the "
            "data with C_inv_sqrts/K_inv_sqrts"
        )
    return GNTarget(
        data, f_vec, BandedWhitening(factor, N_I, D),
        DenseOperators(data.C_inv_sqrts, data.m_ds, data.K_inv_sqrts),
        ref, z0, N_I, D, D_thetas,
    )


def make_tempered_logp_grad_gn_banded(data, f_vec, factor: UpperFactor,
                                      N_I: int, D: int, D_thetas: int, ref,
                                      z0):
    """Banded storage: every operator O(ND * b) — K4 on ``factor`` for the
    whitening, K3 on the band-truncated square roots (``data`` a
    BandedPosteriorData with C_sqrt_blocks/K_sqrt_blocks) for the
    energies. ``ref`` must be built from the same band-truncated float64
    operators."""
    _relative_only(ref, z0)
    if data.C_sqrt_blocks is None or data.K_sqrt_blocks is None:
        raise ValueError(
            "banded GN whitening needs the banded sqrt factors; build the "
            "data via to_banded_data(..., C_inv_sqrts_f64=..., "
            "K_inv_sqrts_f64=...)"
        )
    return GNTarget(
        data, f_vec, BandedWhitening(factor, N_I, D),
        BandedOperators(data.C_sqrt_blocks, data.m_blocks,
                        data.K_sqrt_blocks),
        ref, z0, N_I, D, D_thetas,
    )
