"""Sampler coordinate systems for MAGI_v2.predict() (counterpart of
magi_v2_tpu/sampler/modes.py). ``reparam="precond"``: Gauss-Newton
whitening around a float64 relative-energy zero point, with

- ``storage="dense"``: z = L^{-1}(x - mu), L from a dense (ND, ND) eigh;
- ``storage="hybrid"``: z = U (x - mu), U the banded GN Cholesky factor,
  around the EXACT dense operators (truncation touches the preconditioner
  only); the accurate dense-grid mode;
- ``storage="banded"``: the same whitening around the band-truncated
  operators, every per-leapfrog product O(ND * b) (the target itself is
  the band-truncated posterior).

``reparam="whitened"`` (dense storage only): the GP prior's whitening
z_d = C_d^{-1/2}(x_d - mu_d), t1 = ||z||^2. ``reparam="centered"``: X
sampled directly, like the reference, through the same relative-energy
target (the identity as its whitening stage), in dense or banded storage;
hybrid storage takes ``precond`` only, as in the JAX package.

Each map is linear and fixed, so the posterior over X is the same in all
of them. Known-sigma pinning (``sigma_sqs_fixed``) is applied here, inside
``build_sampling_mode``, so that a re-anchored banded mode keeps it;
user-supplied starts (``init_states``) enter through ``apply_init_states``
and each mode's float64 ``whiten64``. ``refresh_gn_anchor`` is the
mid-warmup re-anchoring of the banded and hybrid modes
(``precond_refresh_steps``): a short stage-A warmup, then the GN factor,
zero point and whitening rebuilt at the chains' median
(``SamplingMode.rebuild``) and the chains restarted in the new
coordinates. The JAX package measured it harmful at dense-grid scale and
warns; the port keeps the feature and the warning.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from magi_v2_tpu_torch.ops.banded import (
    UpperFactor,
    banded_solve,
    block_banded_matvec_upper,
)
from magi_v2_tpu_torch.sampler.magi_state import (
    gp_sqrt_factors,
    unwhiten_Z,
    whiten_X,
)
from magi_v2_tpu_torch.utils.profiling import untimed

# grid size from which float32 sampling in dense storage warns (the JAX
# package measured its step size collapsing at N_I ~ 1k)
DENSE_FLOAT32_WARN_N_I = 768


class PinnedSigma:
    """A fused target with the sigma_pre block pinned at known values (the
    original magi package's useFixedSigma): the fixed values are
    substituted and their gradient zeroed, so the coordinates carry no
    potential. Under leapfrog a zero-force coordinate keeps its momentum,
    so acceptance is that of a sampler without them. Works on a copy of
    the chain states, which stays contiguous for the kernels."""

    def __init__(self, logp_grad, sig_pre_fix, N_I: int, D: int):
        self.logp_grad, self.sig_pre_fix = logp_grad, sig_pre_fix
        self.N_I, self.D = N_I, D

    def __call__(self, q, beta_temp):
        lo, hi = self.N_I * self.D, (self.N_I + 1) * self.D
        qf = q.clone()
        qf[..., lo:hi] = self.sig_pre_fix
        v, g = self.logp_grad(qf, beta_temp)
        g[..., lo:hi] = 0.0
        return v, g

    def bind(self, q, beta_temp, lp, grad):
        """The pinned evaluation on fixed tensors (see ``GNTarget.bind``),
        through a fixed copy of the states."""
        qf = torch.empty_like(q)
        evaluate = self.logp_grad.bind(qf, beta_temp, lp, grad)
        lo, hi = self.N_I * self.D, (self.N_I + 1) * self.D
        fix = self.sig_pre_fix.expand(q.shape[0], hi - lo)

        def run():
            qf.copy_(q)
            qf[:, lo:hi].copy_(fix)
            evaluate()
            grad[:, lo:hi].zero_()

        return run

    def bind_value(self, q, beta_temp, lp):
        """The pinned log-posterior alone on fixed tensors (see
        ``GNTarget.bind_value``), through a fixed copy of the states."""
        qf = torch.empty_like(q)
        evaluate = self.logp_grad.bind_value(qf, beta_temp, lp)
        lo, hi = self.N_I * self.D, (self.N_I + 1) * self.D
        fix = self.sig_pre_fix.expand(q.shape[0], hi - lo)

        def run():
            qf.copy_(q)
            qf[:, lo:hi].copy_(fix)
            evaluate()

        return run

    def to(self, device) -> "PinnedSigma":
        return PinnedSigma(self.logp_grad.to(device),
                           self.sig_pre_fix.to(device), self.N_I, self.D)


def pin_sigma_coordinates(logp_grad, sig_pre_fix, N_I: int, D: int):
    """``logp_grad`` with the sigma_pre block pinned (see PinnedSigma)."""
    return PinnedSigma(logp_grad, sig_pre_fix, N_I, D)


@dataclass
class SamplingMode:
    """The fused target and the coordinate maps predict() needs around it.

    - ``logp_grad(q (C, dim), beta_temp) -> (logp (C,), grad (C, dim))``,
      sigma pinning (if any) applied;
    - ``X0`` — initial X-block coordinates (N_I, D) in the sampling dtype;
    - ``factor`` — maps z draws back to trajectories: L (x = mu + L z) in
      dense storage, an ``UpperFactor`` U (x = mu + U^{-1} z) in banded
      and hybrid storage, None in centered coordinates (x = z);
    - ``gn`` — the banded-GN parts (U_blocks, U_dinv, factor, ref, z0,
      z064, info), or None;
    - ``whiten64(X) -> z`` — natural-coordinate trajectories X (..., N_I,
      D, float64 on the model's device) into this mode's X-block
      coordinates, in float64 exactly as ``X0`` was made (the identity in
      centered coordinates); ``apply_init_states`` maps user starts with
      it;
    - ``rebuild(anchor_X, anchor_th) -> SamplingMode`` — the banded and
      hybrid modes only (None elsewhere): the same mode with its GN
      factor, zero point and whitening anchored at a new natural-coordinate
      point (X (N_I, D), theta (D_thetas,)), sigma pinning kept.
    """

    reparam: str
    storage: str
    logp_grad: Callable
    X0: torch.Tensor
    factor: object
    gn: Optional[dict] = None
    whiten64: Optional[Callable] = None
    rebuild: Optional[Callable] = None


def _build_banded_gn_parts(model, data, dtype, R64, S64, anchor_X, anchor_th,
                           exact: bool, timer=untimed):
    """(logp_grad, parts) with the GN factor, the relative-energy zero
    point and the whitening all anchored at (X, theta).

    ``exact=False`` (storage "banded"): the target evaluates through the
    band-truncated factored operators and the zero point is built from the
    same band-truncated factors. ``exact=True`` (storage "hybrid"): the
    target and the zero point use the exact operators (R64/S64 are then
    the untruncated factors); only the GN factor is banded."""
    from magi_v2_tpu_torch.ops.banded import (
        banded_diag_tile_inverses,
        banded_to_blocks_upper,
    )
    from magi_v2_tpu_torch.posterior import make_ref_point
    from magi_v2_tpu_torch.sampler.precond import (
        build_gn_cholesky_banded,
        make_tempered_logp_grad_gn_banded,
        make_tempered_logp_grad_gn_hybrid,
        whiten_X_banded,
    )

    dev = model.config.torch_device
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    dtype=torch.float64, device=dev)
    N, D = model.mag_I, model.D
    U_band, gn_info = build_gn_cholesky_banded(
        model, C_inv_sqrts=R64, K_inv_sqrts=S64, at_X=anchor_X,
        at_thetas=anchor_th, timer=timer,
    )
    with timer("setup_factor_tiles"):
        U_blocks64 = banded_to_blocks_upper(f64(U_band))
        # diagonal-tile inverses in float64, cast afterwards (see
        # banded_diag_tile_inverses)
        U_dinv64 = banded_diag_tile_inverses(U_blocks64, N * D)
    if exact:
        m_ref = (model._exact_operators()[1] if model.BANDSIZE is not None
                 else model.m_ds)
        R_ref, S_ref = R64, S64
    else:
        R_ref, S_ref = _band_truncated(model, R64, S64)
        m_ref = model.m_ds
    with timer("setup_ref_point"):
        ref = make_ref_point(model.I, anchor_X, model.mu_ds, anchor_th,
                             model.f_vec, R_ref, S_ref, m_ref, dtype,
                             device=dev)
    with timer("setup_fold_factor"):
        z064 = whiten_X_banded(f64(anchor_X), f64(model.mu_ds), U_blocks64)
        # K4's folded tiles are formed in float64, then cast
        factor = UpperFactor.make(U_blocks64, U_dinv64, N * D).to(dtype)
        z0 = z064.reshape(-1).to(dtype)
    maker = (make_tempered_logp_grad_gn_hybrid if exact
             else make_tempered_logp_grad_gn_banded)
    with timer("setup_target"):
        lp = maker(data, model.f_vec, factor, N, D, model.D_thetas, ref=ref,
                   z0=z0)
    whiten64 = lambda X: whiten_X_banded(X, f64(model.mu_ds), U_blocks64)
    return lp, {"U_blocks": factor.tiles, "U_dinv": factor.dinv,
                "factor": factor, "ref": ref, "z0": z0, "z064": z064,
                "info": gn_info, "whiten64": whiten64}


def _band_truncated(model, R64, S64):
    """R64 and S64 with everything beyond the model's bandsize zeroed: the
    float64 operators the banded target evaluates through K3."""
    i = torch.arange(model.mag_I, device=R64.device)
    in_band = ((i[:, None] - i[None, :]).abs() <= model.BANDSIZE)[None]
    zero = torch.zeros((), dtype=torch.float64, device=R64.device)
    return torch.where(in_band, R64, zero), torch.where(in_band, S64, zero)


def check_reparam_storage(reparam: str, storage: str) -> None:
    """The JAX package's combinations: hybrid storage takes only the GN
    whitening, banded storage not the GP-prior one (whose factors are
    dense)."""
    if reparam not in ("precond", "centered", "whitened"):
        raise ValueError(f"unknown reparam mode {reparam!r}")
    if storage not in ("dense", "banded", "hybrid"):
        raise ValueError(f"unknown storage mode {storage!r}")
    if storage == "banded" and reparam == "whitened":
        raise ValueError(
            "storage='banded' supports reparam='precond' (banded "
            "Gauss-Newton whitening, the recommended large-grid mode) or "
            "'centered'; the GP-prior whitening factors are dense"
        )
    if storage == "hybrid" and reparam != "precond":
        raise ValueError(
            "storage='hybrid' is the banded-GN-whitened exact-operator mode; "
            "it requires reparam='precond'"
        )


def build_sampling_mode(model, data, reparam: str, storage: str, dtype, R64,
                        S64, sig_pre_fix=None, anchor=None,
                        timer=untimed) -> SamplingMode:
    """Construct the SamplingMode of a fitted port model. ``data`` is the
    (dense or banded) posterior data predict() built; R64/S64 the float64
    clamped square roots of C^{-1}/K^{-1} on the model's device;
    ``sig_pre_fix`` the pre-space pinned sigma values (or None);
    ``anchor`` an optional natural-coordinate (X (N_I, D), thetas) point
    for the banded/hybrid GN factor and zero point (predict's
    ``gn_anchor``), instead of (Xhat_init, thetas_init); ``timer`` times
    the parts (``utils.profiling.PhaseTimer``)."""
    check_reparam_storage(reparam, storage)
    if anchor is not None and (reparam != "precond" or storage == "dense"):
        raise ValueError(
            "anchor= (predict gn_anchor=) is supported for the banded-GN "
            "modes only (reparam='precond', storage='banded'/'hybrid') — "
            f"got reparam={reparam!r}, storage={storage!r}"
        )
    dev = model.config.torch_device
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    dtype=torch.float64, device=dev)

    def pin(logp_grad):
        if sig_pre_fix is None:
            return logp_grad
        return pin_sigma_coordinates(
            logp_grad, torch.as_tensor(np.asarray(sig_pre_fix), dtype=dtype,
                                       device=dev),
            model.mag_I, model.D,
        )

    if reparam == "precond" and storage in ("banded", "hybrid"):
        def banded_mode(anchor_X, anchor_th, timer=untimed):
            logp_grad, gn = _build_banded_gn_parts(
                model, data, dtype, R64, S64,
                np.asarray(anchor_X, np.float64),
                np.asarray(anchor_th, np.float64),
                exact=storage == "hybrid", timer=timer,
            )
            return SamplingMode(
                reparam=reparam, storage=storage, logp_grad=pin(logp_grad),
                X0=gn["z064"].to(dtype), factor=gn["factor"], gn=gn,
                whiten64=gn["whiten64"], rebuild=banded_mode)

        return banded_mode(*((model.Xhat_init, model.thetas_init)
                             if anchor is None else anchor), timer=timer)

    whiten64 = None
    if reparam == "centered":
        from magi_v2_tpu_torch.posterior import make_ref_point
        from magi_v2_tpu_torch.sampler.precond import (
            make_tempered_logp_grad_centered,
            make_tempered_logp_grad_centered_banded,
        )

        banded = storage == "banded"
        # the banded target evaluates t1 and t2 through the band-truncated
        # square roots, so its zero point is built from the same ones
        R_ref, S_ref = (_band_truncated(model, R64, S64) if banded
                        else (R64, S64))
        with timer("setup_ref_point"):
            ref = make_ref_point(
                model.I, model.Xhat_init, model.mu_ds, model.thetas_init,
                model.f_vec, R_ref, S_ref, model.m_ds, dtype, device=dev,
            )
        maker = (make_tempered_logp_grad_centered_banded if banded
                 else make_tempered_logp_grad_centered)
        with timer("setup_target"):
            logp_grad = maker(data, model.f_vec, model.mag_I, model.D,
                              model.D_thetas, ref=ref,
                              z0=ref.x0.reshape(-1))
        factor, gn, X0 = None, None, ref.x0
        whiten64 = lambda X: X
    elif reparam == "whitened":
        from magi_v2_tpu_torch.posterior import make_ref_point
        from magi_v2_tpu_torch.sampler.precond import (
            make_tempered_logp_grad_whitened,
        )

        mu64 = f64(model.mu_ds)
        with timer("setup_gp_whitening"):
            L64, L_inv64 = gp_sqrt_factors(f64(model.C_d_invs))
        whiten64 = lambda X: whiten_X(X, mu64, L_inv64)
        # z0 in float64, then cast; the zero point x0 = mu + L z0 is built
        # from the cast z0, so that x = x0 + L (z - z0) is mu + L z exactly
        X0 = whiten64(f64(model.Xhat_init)).to(dtype)
        with timer("setup_ref_point"):
            ref = make_ref_point(
                model.I, unwhiten_Z(X0.double(), mu64, L64), model.mu_ds,
                model.thetas_init, model.f_vec, R64, S64, model.m_ds, dtype,
                device=dev,
            )
        factor, gn = L64.to(dtype), None
        with timer("setup_target"):
            logp_grad = make_tempered_logp_grad_whitened(
                data, model.f_vec, factor, model.mag_I, model.D,
                model.D_thetas, ref=ref, z0=X0.reshape(-1),
            )
    else:
        if dtype == torch.float32 and model.mag_I >= DENSE_FLOAT32_WARN_N_I:
            warnings.warn(
                "storage='dense' with reparam='precond' in float32: the "
                "JAX package measured a step-size collapse at N_I ~ 1k (a "
                "high-gradient curvature cliff the GN linearization misses "
                "at this scale); use storage='hybrid' or 'banded' (the "
                "large-grid modes, which need a bandsize).",
                stacklevel=3,
            )
        from magi_v2_tpu_torch.posterior import make_ref_point
        from magi_v2_tpu_torch.sampler.precond import (
            build_gn_whitening,
            make_tempered_logp_grad_gn,
            whiten_X_full,
        )

        with timer("setup_gn_whitening"):
            L64, L_inv64 = build_gn_whitening(model, R64, S64)
        with timer("setup_ref_point"):
            ref = make_ref_point(
                model.I, model.Xhat_init, model.mu_ds, model.thetas_init,
                model.f_vec, R64, S64, model.m_ds, dtype, device=dev,
            )
        with timer("setup_target"):
            z064 = whiten_X_full(f64(model.Xhat_init), f64(model.mu_ds),
                                 L_inv64)
            factor = L64.to(dtype)
            logp_grad = make_tempered_logp_grad_gn(
                data, model.f_vec, factor, model.mag_I, model.D,
                model.D_thetas, ref=ref, z0=z064.reshape(-1).to(dtype),
            )
        gn = None
        X0 = z064.to(dtype)
        mu64 = f64(model.mu_ds)
        whiten64 = lambda X: whiten_X_full(X, mu64, L_inv64)
    return SamplingMode(reparam=reparam, storage=storage,
                        logp_grad=pin(logp_grad), X0=X0, factor=factor, gn=gn,
                        whiten64=whiten64)


def apply_init_states(q0, init_states: dict, mode: SamplingMode, model,
                      sigma_sqs_LB, sigma_sqs_fixed):
    """Overwrite blocks of the chains' start ``q0`` (num_chains, N_I*D + D
    + D_thetas; NumPy in the sampling dtype, changed in place and
    returned) from natural-coordinate user values, as the JAX function
    does (predict's ``init_states``). Keys, each optional:

    - "X": trajectories (num_chains, N_I, D) or (N_I, D) (broadcast),
      mapped through the mode's float64 ``whiten64``, the map that made
      ``mode.X0``;
    - "thetas": (num_chains, D_thetas) or (D_thetas,), natural scale;
    - "sigma_sqs": (num_chains, D) or (D,) noise variances, refused when
      ``sigma_sqs_fixed`` pins sigma.

    thetas and sigma_sqs go through the inverse softplus above their
    lower bound (0 and ``sigma_sqs_LB``) and to -5.0 at or below it, as
    predict's default start does. The standard use: Laplace-scattered
    starts, ``map_estimate(laplace_draws=num_chains)``'s X_draws and
    theta_draws."""
    unknown = set(init_states) - {"X", "thetas", "sigma_sqs"}
    if unknown:
        raise ValueError(
            f"init_states has unknown keys {sorted(unknown)}; expected a "
            "subset of {'X', 'thetas', 'sigma_sqs'}"
        )
    num_chains = q0.shape[0]
    N, D, Dth = model.mag_I, model.D, model.D_thetas

    def per_chain(name, arr, shape):
        arr = np.asarray(arr, np.float64)
        if arr.shape == shape:
            arr = np.broadcast_to(arr, (num_chains,) + shape)
        if arr.shape != (num_chains,) + shape:
            raise ValueError(
                f"init_states[{name!r}] has shape {arr.shape}; expected "
                f"{(num_chains,) + shape} or {shape}"
            )
        if np.any(np.isnan(arr)):
            raise ValueError(f"init_states[{name!r}] contains NaNs")
        return arr

    def pre(vals, lower):
        out = np.full_like(vals, -5.0)
        above = vals > lower
        y = (vals - lower)[above]
        out[above] = y + np.log(-np.expm1(-y))
        return out

    if "X" in init_states:
        Xi = per_chain("X", init_states["X"], (N, D))
        dev = model.config.torch_device
        Z = mode.whiten64(torch.tensor(Xi, dtype=torch.float64,
                                       device=dev))
        q0[:, : N * D] = Z.reshape(num_chains, N * D).cpu().numpy()
    if "sigma_sqs" in init_states:
        if sigma_sqs_fixed is not None:
            raise ValueError(
                "init_states['sigma_sqs'] conflicts with sigma_sqs_fixed "
                "(sigma coordinates are pinned)"
            )
        ss = per_chain("sigma_sqs", init_states["sigma_sqs"], (D,))
        lb = np.broadcast_to(np.asarray(sigma_sqs_LB, np.float64), (D,))
        q0[:, N * D: N * D + D] = pre(ss, lb[None, :])
    if "thetas" in init_states:
        th = per_chain("thetas", init_states["thetas"], (Dth,))
        q0[:, N * D + D:] = pre(th, np.zeros((1, Dth)))
    return q0


_REFRESH_NEEDS_BANDED = (
    "precond_refresh_steps requires reparam='precond' and "
    "storage='banded' (the mode whose linearization goes stale "
    "at dense-grid scale)"
)


def refresh_gn_anchor(mode: SamplingMode, model, q0, num_chains: int,
                      sampler_config, dtype, seed: int,
                      precond_refresh_steps: int, verbose: bool = False,
                      restart: str = "remap", restart_scatter: float = 0.1,
                      timer=untimed):
    """Stage A and the re-anchoring of a banded or hybrid GN mode
    (predict's ``precond_refresh_steps``), as the JAX function: a warmup of
    ``precond_refresh_steps`` transitions (``run_chains`` with one result,
    seed + 1000, its checkpoints under ``<checkpoint_path>/stageA``) moves
    the chains off the start, then ``reanchor`` rebuilds the mode at their
    median and restarts them. Returns (the rebuilt mode, the stage-B
    starts (num_chains, dim) in NumPy).

    ``restart``: "remap" carries each chain's stage-A state into the new
    coordinates (z = z0_new + U_new (x - x_anchor)); "laplace" restarts
    every chain at a scaled GN Laplace draw of the new anchor (z0_new +
    ``restart_scatter`` * N(0, I), theta at the anchor plus a 0.05 jitter
    on its pre-image, sigma carried from stage A).

    Experimental and measured HARMFUL at dense-grid scale by the JAX
    package (Lorenz N_I = 1025 x 256 chains: 31-91% divergences, R-hat
    4.8-198 across the restart modes; see its refresh_gn_anchor), which
    this warns of as it does. ``timer`` times stage A ("refresh_stage_a")
    and the rebuild with the restart ("refresh_rebuild"). An unknown
    restart is refused before stage A runs."""
    from magi_v2_tpu_torch.sampler.run import run_chains

    if mode.rebuild is None:
        raise ValueError(_REFRESH_NEEDS_BANDED)
    if restart not in ("remap", "laplace"):
        raise ValueError(f"unknown refresh restart mode {restart!r}")
    warnings.warn(
        "precond_refresh_steps is experimental and measured HARMFUL at "
        "dense-grid scale (Lorenz N_I=1025 x 256 chains: 31-91% divergence "
        "across all restart modes; see refresh_gn_anchor docstring). The "
        "supported large-grid recipe is no refresh: init-anchored banded "
        "GN sampling the tempered (anneal_mode='reference') target.",
        stacklevel=2,
    )
    ck = sampler_config.checkpoint_path
    cfg_a = sampler_config._replace(
        num_results=1, num_burnin_steps=precond_refresh_steps,
        progress_every=0, thin=1,
        # stage A is another step sequence than the main run's: a
        # checkpoint namespace of its own
        checkpoint_path=os.path.join(ck, "stageA") if ck else "",
    )
    t0 = time.perf_counter()
    with timer("refresh_stage_a"):
        samples_a, _ = run_chains(
            mode.logp_grad,
            torch.as_tensor(np.asarray(q0), dtype=dtype,
                            device=model.config.torch_device),
            seed + 1000, cfg_a, timer=timer,
        )
    qs_a = samples_a[-1].to(model.config.torch_device)
    with timer("refresh_rebuild"):
        mode, q0 = reanchor(mode, model, qs_a, seed, restart,
                            restart_scatter)
    if verbose:
        print(f"[precond_refresh] re-anchored after {precond_refresh_steps} "
              f"steps in {time.perf_counter() - t0:.0f}s")
        one = torch.ones((), dtype=dtype, device=model.config.torch_device)
        lps = mode.logp_grad(torch.as_tensor(q0[:4], dtype=dtype,
                                             device=one.device), one)[0]
        print(f"[precond_refresh] lp at remapped chains[:4]: "
              f"{np.round(lps.cpu().numpy(), 2)}")
    return mode, q0


def reanchor(mode: SamplingMode, model, qs_a, seed: int,
             restart: str = "remap", restart_scatter: float = 0.1):
    """The part of ``refresh_gn_anchor`` after stage A, from the stage-A
    chain states ``qs_a`` (C, dim) in the sampling dtype on the model's
    device: the trajectories x = x0 + U^{-1}(z - z0) (K4 on the card, the
    zero point's float64 x0 added in float64), the anchor at their chain
    median and the chain mean of softplus(theta_pre), the mode rebuilt
    there, and the restart. Returns (the rebuilt mode, the stage-B starts
    in NumPy: float64 for "laplace", the sampling dtype for "remap")."""
    from magi_v2_tpu_torch.posterior import softplus
    from magi_v2_tpu_torch.sampler.precond import unwhiten_Z_banded

    if restart not in ("remap", "laplace"):
        raise ValueError(f"unknown refresh restart mode {restart!r}")
    N, D, Dth = model.mag_I, model.D, model.D_thetas
    ND = N * D
    C, dt = qs_a.shape[0], qs_a.dtype
    gn = mode.gn
    dz = qs_a[:, :ND] - gn["z0"][None, :]
    Xc = unwhiten_Z_banded(dz.reshape(C, N, D),
                           torch.zeros((D,), dtype=dt, device=dz.device),
                           gn["factor"])
    X_chains = (Xc.double() + gn["ref"].x0.double()[None]).cpu().numpy()
    # NumPy's median: the mean of the two middle values for an even count
    anchor_X = np.median(X_chains, axis=0)
    anchor_th = softplus(qs_a[:, ND + D:]).mean(dim=0).double().cpu().numpy()
    mode = mode.rebuild(anchor_X, anchor_th)
    if restart == "laplace":
        rng = np.random.default_rng(seed + 2000)
        z_new = mode.gn["z064"].reshape(1, -1).cpu().numpy()
        z_new = z_new + restart_scatter * rng.standard_normal((C, ND))
        th_pre = (anchor_th + np.log(-np.expm1(-anchor_th)))[None, :] \
            + 0.05 * rng.standard_normal((C, Dth))
        sig_pre = qs_a[:, ND:ND + D].double().cpu().numpy()
        return mode, np.concatenate([z_new, sig_pre, th_pre], axis=1)
    # z_new = z0_new + U_new (x - x_anchor): the deviation is small, so the
    # sampling dtype keeps it (K3 on the card)
    dev = qs_a.device
    delta = (torch.as_tensor(X_chains, dtype=dt, device=dev)
             - torch.as_tensor(anchor_X, dtype=dt, device=dev)[None])
    z_new = mode.gn["z0"][None, :] + block_banded_matvec_upper(
        mode.gn["U_blocks"], delta.reshape(C, -1))
    return mode, torch.cat([z_new, qs_a[:, ND:]], dim=1).cpu().numpy()


def unwhiten_draws(mode: SamplingMode, Z, mu_ds, max_bytes: int = 1 << 30):
    """Trajectories from z draws Z (T, C, N_I, D): X = mu + L z (one GEMM
    per chunk, or, for the GP factor of the whitened mode, one batched
    over its D blocks, x_d = mu_d + L_d z_d), X = mu + U^{-1} z (K4 over
    the chunk's draws and chains), the chunk bounded by ``max_bytes`` of
    output, or, in centered coordinates, X = z. Draws staged in host
    memory (``SamplerConfig.stage_above_bytes``) stay there: each chunk
    goes to mu_ds's device, is mapped there and comes back, so the card
    never holds more than a chunk."""
    if mode.factor is None:
        return Z.clone()
    dev = mu_ds.device
    staged = Z.device != dev
    T = Z.shape[0]
    per_draw = max(1, Z[0].numel() * Z.element_size())
    chunk = max(1, max_bytes // per_draw)
    out = torch.empty_like(Z)
    for i in range(0, T, chunk):
        z = Z[i: i + chunk].to(dev)
        dst = out[i: i + chunk]
        if isinstance(mode.factor, UpperFactor):
            flat = z.reshape(-1, 1, z.shape[-2] * z.shape[-1])
            x = torch.empty_like(flat) if staged else dst.view(flat.shape)
            banded_solve(mode.factor, flat.contiguous(), x)
            x += mu_ds.repeat(z.shape[-2])
            if not staged:
                continue
        elif mode.reparam == "whitened":
            x = unwhiten_Z(z, mu_ds, mode.factor)
        else:
            flat = z.reshape(z.shape[:2] + (-1,))
            x = (flat @ mode.factor.T).reshape(z.shape) + mu_ds
        dst.copy_(x.reshape(dst.shape))
    return out
