"""User-facing facade: MAGI_v2 in PyTorch (counterpart of
magi_v2_tpu/api.py) — construct -> ``initial_fit`` -> ``predict`` ->
results dict, with the JAX package's signatures and results-dict keys.

Setup (hyperparameter MAP, kernel matrices, pseudo-inverses, theta init,
Gauss-Newton whitening) runs in float64 on ``config.device``; sampling runs
there in ``config.dtype``. The fitted state is kept as host NumPy arrays,
like the JAX model's, so a fit can be carried across packages
(utils/checkpoint.py).

Ported so far: ``initial_fit`` for fully and partially observed systems
(the gradient-matching init of unobserved components); ``predict`` with
``algorithm="nuts"`` (the default) or ``"hmc"``, ``reparam="precond"`` in
every storage mode (``"dense"``, ``"hybrid"``, ``"banded"``),
``reparam="centered"`` in dense and banded storage and
``reparam="whitened"`` in dense storage, ``sigma_sqs_fixed``,
``gn_anchor``, ``init_states``, ``map_warmstart_iters`` and parallel
tempering (``pt_betas``, ``pt_swap_every``), mid-run checkpoint/resume
(``checkpoint_path``, ``dispatch_block_steps``) and ``profile_timings``;
``map_estimate`` (the exact posterior's MAP with Laplace draws, the
starts ``init_states`` takes); forecasting (``extend_for_forecast``,
``update_kernel_matrices``); the mid-warmup GN re-anchoring
(``precond_refresh_steps``) and host staging of draws
(``stage_above_bytes``). Chain sharding over devices is
``magi_v2_tpu_torch.parallel``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from magi_v2_tpu_torch import preprocess
from magi_v2_tpu_torch.config import DEFAULT_CONFIG, MagiConfig
from magi_v2_tpu_torch.hparams import fit_kernel_hparams
from magi_v2_tpu_torch.init import (
    fit_theta_fully_observed,
    fit_unobserved_gradient_matching,
)
from magi_v2_tpu_torch.ops.kernels import magi_kernel_matrices, uniform_spacing
from magi_v2_tpu_torch.ops.linalg import band_part, sym_pinv, sym_sqrt
from magi_v2_tpu_torch.posterior import make_posterior_data, to_banded_data
from magi_v2_tpu_torch.sampler.magi_state import (
    flatten_state,
    unflatten_samples,
)
from magi_v2_tpu_torch.sampler.modes import (
    apply_init_states,
    build_sampling_mode,
    check_reparam_storage,
    refresh_gn_anchor,
    unwhiten_draws,
)
from magi_v2_tpu_torch.sampler.run import SamplerConfig, run_chains
from magi_v2_tpu_torch.utils.profiling import PhaseTimer, untimed


def _np_softplus(x):
    return np.where(x > 30.0, x, np.log1p(np.exp(np.minimum(x, 30.0))))


def _np_softplus_inverse(y):
    return y + np.log(-np.expm1(-y))


class MAGI_v2:
    """MAnifold-constrained Gaussian process Inference in PyTorch.

    - D_thetas: number of ODE parameters.
    - ts_obs: (N,) observation timesteps.
    - X_obs: (N, D) observations; NaN marks missing values.
    - bandsize: half-bandwidth of the band truncation of the precision
      operators, or None for dense.
    - f_vec: torch ODE field f(t (N,1), X (..., N, D), thetas (..., P)).
    """

    def __init__(
        self,
        D_thetas: int,
        ts_obs: np.ndarray,
        X_obs: np.ndarray,
        bandsize: Union[int, None],
        f_vec: Callable,
        config: MagiConfig = DEFAULT_CONFIG,
    ):
        self.config = config
        self.D_thetas = D_thetas
        self.BANDSIZE = bandsize
        self.f_vec = f_vec

        self.ts_obs = np.asarray(ts_obs)
        self.X_obs = np.asarray(X_obs, dtype=np.float64)
        self.N, self.D = self.X_obs.shape

        self.observed_indicators = (~np.isnan(self.X_obs)).mean(axis=0) > 0
        self.observed_components = np.arange(self.D)[self.observed_indicators]
        self.D_observed = len(self.observed_components)
        self.unobserved_components = np.setdiff1d(
            np.arange(self.D), self.observed_components
        )
        self.D_unobserved = len(self.unobserved_components)
        # the column order of [observed | unobserved] back to the model's
        self.proper_order = np.argsort(
            np.concatenate([self.observed_components,
                            self.unobserved_components])
        )
        self.N_ds = (~np.isnan(self.X_obs)).sum(axis=0)

        self.I = None
        self.X_obs_discret = None
        self.beta = None
        self.mag_I = None
        self.obs_index = None
        self.X_interp_obs = None
        self.phi1s = np.full((self.D,), np.nan)
        self.phi2s = np.full((self.D,), np.nan)
        self.sigma_sqs_init = np.full((self.D,), np.nan)
        self.Xhat_init = None
        self.thetas_init = None
        self.mu_ds = np.full((self.D,), np.nan)
        self.C_d_invs = None
        self.m_ds = None
        self.K_d_invs = None
        self.band_truncation = None
        # initial_fit's trace (utils.profiling.PhaseTimer.export)
        self.fit_trace = None

    # ------------------------------------------------------------------

    def _f64(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64,
                               device=self.config.torch_device)

    def _build_inverse_matrices(self, phi1s, phi2s):
        """Batched (C^{-1}, m, K^{-1}) over components, float64 on the
        config's device; returned as host arrays."""
        C, m, K = magi_kernel_matrices(
            self._f64(self.I.reshape(-1)), self._f64(phi1s), self._f64(phi2s),
            self.config.matern_nu, spacing=uniform_spacing(self.I),
        )
        return tuple(a.cpu().numpy() for a in (sym_pinv(C), m, sym_pinv(K)))

    def _exact_operators(self):
        """Untruncated (C^{-1}, m, K^{-1}) at the fitted hyperparameters, as
        host arrays. initial_fit band-truncates the model's operators in
        place when a bandsize is set; storage="hybrid" needs the exact
        ones, so they are rebuilt, once per (phi1s, phi2s, grid)."""
        key = (self.phi1s.tobytes(), self.phi2s.tobytes(), self.I.tobytes())
        cache = getattr(self, "_exact_ops_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        ops = self._build_inverse_matrices(self.phi1s, self.phi2s)
        self._exact_ops_cache = (key, ops)
        return ops

    def initial_fit(self, discretization: int, verbose: bool = False,
                    thetas_init=None):
        """Discretize, fit GP hyperparameters, initialize theta and, for a
        partially observed system, the unobserved trajectories (the JAX
        package's gradient-matching branch: the observed components
        CV-smoothed, a multi-start gradient-matching fit of (X_unobs,
        theta), the unobserved components' hyperparameters fitted on the
        grid).

        The fit is traced (``utils.profiling.PhaseTimer``) into
        ``fit_trace``: a root span "initial_fit" and its phases
        "hparam_mle" (attribute ``optimizer``; counters "lbfgs_iters",
        "lbfgs_evals", "lbfgs_reads" or "adam_steps"), "kernel_matrices",
        "theta_init" (counter "adam_steps", and on a card
        "adam_graph_steps") or, partially observed, "gradient_matching"
        (the same counters) and "hparam_mle_unobserved", and
        "cv_smoother"; each phase records the counters' change over it in
        ``attrs["counts"]``. ``fit_timings`` is the view of its phases:
        host wall seconds per phase name, each phase ending after the
        device is waited for. ``verbose`` prints both.

        ``thetas_init`` (D_thetas,) skips the theta fit of a fully observed
        system and starts theta there. On dense grids the fit through
        K^{-1} can be ill-posed (Lorenz at N_I = 1025: K's cancellation
        falls below float64's resolution, see ROADMAP.md queue 3); a fit of
        the same data at a coarser discretization is then a sound start. A
        partially observed system fits theta jointly with its unobserved
        trajectories, which the JAX package does from no given start, so
        ``thetas_init`` is refused there."""
        partial = not np.all(self.observed_indicators)
        if thetas_init is not None:
            if partial:
                raise ValueError(
                    "thetas_init is taken only by a fully observed system: "
                    "with unobserved components theta is fitted jointly "
                    "with their trajectories by gradient matching")
            thetas_init = np.asarray(thetas_init, np.float64)
            if thetas_init.shape != (self.D_thetas,) or not np.all(
                    np.isfinite(thetas_init)):
                raise ValueError(
                    f"thetas_init must be {self.D_thetas} finite values, got "
                    f"{thetas_init!r}")
        timer = PhaseTimer(self.config.torch_device, trace=True)
        self.fit_timings = timer.phases
        with timer.span("initial_fit", discretization=discretization):
            self._fit_phases(timer, discretization, partial, thetas_init,
                             verbose)
        self.fit_trace = timer.export()
        if verbose:
            print(f"initial_fit phases (s): {self.fit_timings}; counters: "
                  f"{timer.counts}")

    def _fit_phases(self, timer, discretization, partial, thetas_init,
                    verbose):
        """``initial_fit``'s work, its phases timed by ``timer``."""
        cfg = self.config
        obs = self.observed_indicators
        self.I, self.X_obs_discret = preprocess.discretize(
            self.ts_obs, self.X_obs, discretization
        )
        self.mag_I = self.I.shape[0]
        self.beta = (self.D * self.mag_I) / self.N_ds.sum()
        self.obs_index = preprocess.build_observation_index(self.X_obs_discret)
        self.X_interp_obs = preprocess.linear_interpolate(
            self.X_obs_discret[:, obs])
        if cfg.hparam_fit_points == "obs":
            fit_I = self.ts_obs.reshape(-1, 1)
            fit_X = preprocess.linear_interpolate(self.X_obs[:, obs])
        elif cfg.hparam_fit_points == "grid":
            fit_I, fit_X = self.I, self.X_interp_obs
        else:
            raise ValueError(
                f"unknown hparam_fit_points {cfg.hparam_fit_points!r}"
            )
        hparams = lambda I, X: fit_kernel_hparams(
            I, X,
            nu=cfg.matern_nu,
            learning_rate=cfg.hparam_learning_rate,
            num_iters=cfg.hparam_num_iters,
            cholesky_jitter=cfg.cholesky_jitter,
            optimizer=cfg.hparam_optimizer,
            device=cfg.torch_device,
            timer=timer,
        )
        with timer("hparam_mle", optimizer=cfg.hparam_optimizer):
            hp = hparams(fit_I, fit_X)
        self.Xhat_init = self.X_obs_discret.copy()
        self.C_d_invs, self.m_ds, self.K_d_invs = (
            np.zeros((self.D, self.mag_I, self.mag_I)) for _ in range(3))
        with timer("kernel_matrices"):
            self._set_components(self.observed_components, hp,
                                 self.X_interp_obs)
        if partial:
            with timer("gradient_matching"):
                X_smoothed_obs = preprocess.cv_cubic_smoother(
                    self.I,
                    self.X_interp_obs,
                    n_splits=cfg.spline_cv_folds,
                    obs_per_knot=cfg.spline_obs_per_knot,
                    min_points=cfg.spline_min_points,
                )
                X_unobs, self.thetas_init, _ = \
                    fit_unobserved_gradient_matching(
                        self.f_vec,
                        self._f64(self.I),
                        self._f64(X_smoothed_obs),
                        self.proper_order,
                        self.D_unobserved,
                        self.D_thetas,
                        learning_rate=cfg.init_learning_rate,
                        num_iters=cfg.init_num_iters,
                        # the winner by the observed-manifold score (see
                        # the JAX function), from the observed components'
                        # operators
                        observed_components=self.observed_components,
                        m_ds_obs=self._f64(self.m_ds[obs]),
                        K_invs_obs=self._f64(self.K_d_invs[obs]),
                        mu_obs=self._f64(self.mu_ds[obs]),
                        timer=timer,
                    )
            with timer("hparam_mle_unobserved",
                       optimizer=cfg.hparam_optimizer):
                hp_unobs = hparams(self.I, X_unobs)
            with timer("kernel_matrices"):
                self._set_components(self.unobserved_components, hp_unobs,
                                     X_unobs)
        else:
            with timer("theta_init"):
                if thetas_init is None:
                    self.thetas_init, _ = fit_theta_fully_observed(
                        self.f_vec,
                        self._f64(self.I),
                        self._f64(self.Xhat_init),
                        self._f64(self.mu_ds),
                        self._f64(self.m_ds),
                        self._f64(self.K_d_invs),
                        self.D_thetas,
                        learning_rate=cfg.init_learning_rate,
                        num_iters=cfg.init_num_iters,
                        timer=timer,
                    )
                else:
                    self.thetas_init = thetas_init.copy()
        self._apply_band_truncation(verbose)
        with timer("cv_smoother"):
            self.Xhat_init = preprocess.cv_cubic_smoother(
                self.I,
                self.Xhat_init,
                n_splits=cfg.spline_cv_folds,
                obs_per_knot=cfg.spline_obs_per_knot,
                min_points=cfg.spline_min_points,
            )

    def _set_components(self, comps, hp, X_init):
        """Write the fitted hyperparameters ``hp``, the initial
        trajectories X_init (N_I, len(comps)), their means and the
        operators built from the hyperparameters into the slots ``comps``
        of the model's per-component state."""
        self.phi1s[comps] = hp["phi1s"]
        self.phi2s[comps] = hp["phi2s"]
        self.sigma_sqs_init[comps] = hp["sigma_sqs"]
        self.Xhat_init[:, comps] = X_init
        self.mu_ds[comps] = X_init.mean(axis=0)
        ops = self._build_inverse_matrices(hp["phi1s"], hp["phi2s"])
        for stack, op in zip((self.C_d_invs, self.m_ds, self.K_d_invs), ops):
            stack[comps] = op

    def _apply_band_truncation(self, verbose: bool = False):
        """Band-truncate C^{-1}/K^{-1}/m and record, per operator family,
        the largest relative Frobenius mass the truncation drops."""
        self.band_truncation = None
        if self.BANDSIZE is None:
            return
        self.band_truncation = {}
        for name in ("C_d_invs", "K_d_invs", "m_ds"):
            A = np.asarray(getattr(self, name))
            Ab = band_part(torch.as_tensor(A), self.BANDSIZE,
                           self.BANDSIZE).numpy()
            num = np.linalg.norm((A - Ab).reshape(A.shape[0], -1), axis=1)
            den = np.linalg.norm(A.reshape(A.shape[0], -1), axis=1)
            self.band_truncation[name] = float(
                (num / np.maximum(den, 1e-300)).max()
            )
            setattr(self, name, Ab)
        if verbose:
            print("band truncation (rel Frobenius mass dropped): "
                  + ", ".join(f"{k}={v:.2e}"
                              for k, v in self.band_truncation.items()))
        worst = max(self.band_truncation.values())
        if worst > 0.05:
            import warnings

            warnings.warn(
                f"bandsize={self.BANDSIZE} drops {worst:.0%} of the "
                "precision-operator Frobenius mass (band_truncation "
                f"attribute: {self.band_truncation}); the truncated "
                "posterior is a materially different distribution (the "
                "JAX package measured a ~10% theta bias on Lorenz "
                "N_I=1025/b=100 while the exact posterior's mode is at "
                "truth). Use predict(storage='hybrid') (exact operators, "
                "banded GN whitening), widen bandsize, coarsen the grid, or "
                "treat results as approximate.",
                stacklevel=3,
            )

    # ------------------------------------------------------------------

    def _sigma_bounds(self, sigma_sqs_LB, sigma_sqs_fixed):
        """(sigma_sqs_LB (D,), sig_fix64 or None, sigma_pre_fix or None):
        the noise-variance lower bound, and with ``sigma_sqs_fixed`` the
        known variances and their softplus pre-images. The bound is kept
        strictly below the known values so that the bijection
        sigma^2 = softplus(pre) + LB can represent them."""
        if sigma_sqs_LB is None:
            sigma_sqs_LB = (
                self.Xhat_init.std(axis=0) * self.config.sigma_sq_lb_scale
            ) ** 2
        sigma_sqs_LB = np.broadcast_to(
            np.asarray(sigma_sqs_LB, np.float64), (self.D,)
        ).copy()
        if sigma_sqs_fixed is None:
            return sigma_sqs_LB, None, None
        sig_fix64 = np.broadcast_to(
            np.asarray(sigma_sqs_fixed, np.float64), (self.D,)
        )
        if not np.all(np.isfinite(sig_fix64)) or np.any(sig_fix64 <= 0):
            raise ValueError(
                "sigma_sqs_fixed must be finite and > 0 (a zero or negative "
                "known variance makes the softplus bijection pre-image -inf "
                f"and NaNs every energy); got {sig_fix64!r}"
            )
        sigma_sqs_LB = np.minimum(sigma_sqs_LB, 0.5 * sig_fix64)
        return (sigma_sqs_LB, sig_fix64,
                np.log(np.expm1(sig_fix64 - sigma_sqs_LB)))

    def _gn_anchor(self, gn_anchor):
        """Validated natural-coordinate (X, thetas) anchor, or None."""
        if gn_anchor is None:
            return None
        unknown = set(gn_anchor) - {"X", "thetas"}
        if unknown:
            raise ValueError(
                f"gn_anchor has unknown keys {sorted(unknown)}; expected "
                "{'X', 'thetas'}"
            )
        aX = np.asarray(gn_anchor.get("X", self.Xhat_init), np.float64)
        ath = np.asarray(gn_anchor.get("thetas", self.thetas_init),
                         np.float64)
        if aX.shape != (self.mag_I, self.D):
            raise ValueError(
                f"gn_anchor['X'] has shape {aX.shape}; expected "
                f"{(self.mag_I, self.D)}"
            )
        if ath.shape != (self.D_thetas,):
            raise ValueError(
                f"gn_anchor['thetas'] has shape {ath.shape}; expected "
                f"{(self.D_thetas,)}"
            )
        if np.any(np.isnan(aX)) or np.any(np.isnan(ath)):
            raise ValueError("gn_anchor contains NaNs")
        return aX, ath

    def _build_sampling_setup(self, reparam: str, storage: str, dtype,
                              sigma_sqs_LB=None, sigma_sqs_fixed=None,
                              gn_anchor=None, timer=untimed):
        """(mode, data, sigma_sqs_LB): the float64 factored precisions, the
        dense or banded posterior data in ``dtype`` and the SamplingMode,
        all on the config's device. ``timer`` (``timing.PhaseTimer``) times
        each part ("setup_*").

        storage="hybrid" evaluates the posterior through the exact
        (untruncated) operators, rebuilt when initial_fit truncated them,
        and whitens with the banded GN factor; "banded" stores the
        band-truncated operators and their band-truncated square roots in
        block-banded form; "dense" uses the model's operators as they are."""
        sigma_sqs_LB, _, pre_fix = self._sigma_bounds(sigma_sqs_LB,
                                                      sigma_sqs_fixed)
        if storage not in ("dense", "banded", "hybrid"):
            raise ValueError(f"unknown storage mode {storage!r}")
        if storage != "dense" and self.BANDSIZE is None:
            raise ValueError(
                f"storage={storage!r} requires a bandsize: the banded GN "
                "whitening factor is built at the model's bandsize"
                + (" (the posterior itself evaluates untruncated)"
                   if storage == "hybrid" else "")
            )
        check_reparam_storage(reparam, storage)
        if storage == "hybrid":
            with timer("setup_exact_operators"):
                C_ops, m_ops, K_ops = self._exact_operators()
        else:
            C_ops, m_ops, K_ops = self.C_d_invs, self.m_ds, self.K_d_invs
        dev = self.config.torch_device
        # R = C^{-1/2}, S = K^{-1/2} in float64 (negative eigenvalues, which
        # band truncation can leave, clamp to 0)
        with timer("setup_operator_sqrt"):
            R64 = sym_sqrt(self._f64(C_ops))
            S64 = sym_sqrt(self._f64(K_ops))
        with timer("setup_posterior_data"):
            data = make_posterior_data(
                self.I, C_ops, m_ops, K_ops, self.mu_ds, self.beta,
                self.obs_index, sigma_sqs_LB, dtype,
                C_inv_sqrts=R64 if storage != "banded" else None,
                K_inv_sqrts=S64 if storage != "banded" else None, device=dev,
            )
            if storage == "banded":
                data = to_banded_data(data, self.BANDSIZE,
                                      C_inv_sqrts_f64=R64,
                                      K_inv_sqrts_f64=S64)
        mode = build_sampling_mode(self, data, reparam, storage, dtype, R64,
                                   S64, sig_pre_fix=pre_fix,
                                   anchor=self._gn_anchor(gn_anchor),
                                   timer=timer)
        return mode, data, sigma_sqs_LB

    def _dense_tail_size(self, mass_matrix: str, sigma_sqs_fixed=None) -> int:
        """Map the ``mass_matrix`` mode to SamplerConfig.dense_tail_size.
        "tail_dense" covers the (sigma_pre, theta_pre) block, theta_pre only
        when sigma is pinned: pinned coordinates carry no potential and
        random-walk ballistically, so their moments would pollute a dense
        block. "dense" covers the whole flat state and excludes pinning."""
        full_dim = self.mag_I * self.D + self.D + self.D_thetas
        if mass_matrix == "auto":
            mass_matrix = ("dense" if sigma_sqs_fixed is None
                           and full_dim <= 1024 else "tail_dense")
        if mass_matrix == "diag":
            return 0
        if mass_matrix == "tail_dense":
            return (self.D_thetas if sigma_sqs_fixed is not None
                    else self.D + self.D_thetas)
        if mass_matrix == "dense":
            if sigma_sqs_fixed is not None:
                raise ValueError(
                    "mass_matrix='dense' with sigma_sqs_fixed is not "
                    "supported: the pinned sigma coordinates random-walk "
                    "ballistically and their sample moments are "
                    "meaningless; use mass_matrix='tail_dense' (theta "
                    "block only) instead"
                )
            return full_dim
        raise ValueError(
            f"unknown mass_matrix {mass_matrix!r}; expected 'auto', "
            "'diag', 'tail_dense' or 'dense'"
        )

    # ------------------------------------------------------------------

    def predict(
        self,
        num_results: int = 1000,
        num_burnin_steps: int = 1000,
        sigma_sqs_LB=None,
        verbose: bool = False,
        num_chains: int = 1,
        seed: int = 0,
        init_jitter: float = 0.0,
        use_annealing: bool = True,
        adapt_mass_matrix: Optional[bool] = None,
        storage: str = "dense",
        reparam: str = "precond",
        thin: int = 1,
        dispatch_block_steps: Optional[int] = None,
        algorithm: str = "nuts",
        hmc_num_leapfrogs: int = 64,
        anneal_mode: str = "warmup_only",
        matmul_precision: str = "highest",
        mass_matrix: str = "diag",
        dense_shrinkage: float = 0.0,
        mass_window: Optional[tuple] = None,
        mass_window2: Optional[tuple] = None,
        mass_window1_diag: bool = False,
        sigma_sqs_fixed=None,
        map_warmstart_iters: int = 0,
        precond_refresh_steps: int = 0,
        precond_refresh_restart: str = "remap",
        precond_refresh_scatter: float = 0.1,
        checkpoint_path: str = "",
        profile_timings: bool = False,
        stage_above_bytes: Optional[int] = None,
        init_states: Optional[dict] = None,
        gn_anchor: Optional[dict] = None,
        pt_betas: Optional[tuple] = None,
        pt_swap_every: int = 1,
        reseat_accept_below: Optional[float] = None,
    ):
        """Sample the posterior; same arguments and results dict as
        magi_v2_tpu.MAGI_v2.predict. Ported: ``algorithm`` "nuts" (tree
        depth up to ``config.max_tree_depth``) or "hmc", with
        ``reparam="precond"`` and ``storage`` "dense", "hybrid" (banded GN
        whitening around the exact operators: the accurate dense-grid
        mode) or "banded" (every operator O(N_I * bandsize); the target is
        the band-truncated posterior), ``reparam="centered"`` (X sampled
        directly, like the reference) with ``storage`` "dense" or "banded",
        or ``reparam="whitened"`` (the GP prior's whitening, t1 = ||z||^2)
        with ``storage="dense"``; other combinations raise ValueError, as
        in the JAX package. ``sigma_sqs_fixed`` (known noise variances,
        pinned), ``gn_anchor`` (precond banded/hybrid only),
        ``map_warmstart_iters`` (Adam steps, eps 1e-7 at the config's
        init_learning_rate, on this target at beta 1 from the default
        start, before the jitter) and ``init_states`` (natural-coordinate
        starts, applied after the jitter: ``sampler/modes.py:
        apply_init_states``; e.g. ``map_estimate(laplace_draws=num_chains)
        ``'s X_draws and theta_draws). ``pt_betas`` (a decreasing ladder
        from 1.0, R rungs, num_chains a multiple of R) tempers the
        sampling phase: chains are rung-major, chain r M + m at beta_r
        with the step eps beta_r^(-1/2), and every ``pt_swap_every``
        transitions adjacent rungs propose even-odd swaps
        (``sampler/pt.py``); only the beta = 1 rung's M = num_chains / R
        chains are returned, with per-chain statistics sliced alike, and
        ``kernel_results["pt_swap_accept"]`` holds each adjacent pair's
        swap acceptance (R - 1,). ``checkpoint_path`` (a directory, "" =
        off) persists the sampler's carry at every block of
        ``dispatch_block_steps`` transitions and each sampling block's
        draws; calling predict again with the same arguments resumes bit
        for bit from the last block, and a checkpoint of another run is
        refused (``sampler/run.py``). ``profile_timings`` traces the call
        (``utils.profiling.PhaseTimer``: the spans below a root "predict",
        the sampler's down to each transition, NUTS doubling and device
        read, the graph replays' counters and, on one card, the device
        markers of the sampling phase; ``sampler/run.py``) and fills
        ``results["timings"]`` with its views, the sampler's phase walls
        under the JAX package's keys and sampler_total_s, unwhiten_s,
        x_fetch_s, post_total_s, and with the trace itself under "trace":
        {"spans": [...], "counts": {...}, "fit": ``fit_trace``}; it is
        None otherwise. ``stage_above_bytes``
        (default 1 GiB, ``SamplerConfig``): with ``dispatch_block_steps``,
        draws larger than this are staged to host memory block by block
        (0 stages always), the same bits either way; the unwhitening then
        maps them on the device chunk by chunk. ``precond_refresh_steps``
        (banded and hybrid storage, ``reparam="precond"``; experimental,
        and measured harmful at dense-grid scale by the JAX package, which
        warns) runs that many warmup transitions, re-anchors the GN factor
        at the chains' median and restarts them
        (``precond_refresh_restart`` "remap" or "laplace", the latter at
        ``precond_refresh_scatter``: ``sampler/modes.py:
        refresh_gn_anchor``) before the main run, which under
        ``anneal_mode="warmup_only"`` then runs unannealed. With
        num_chains > 1 the ``*_samps`` arrays carry a chain axis at
        position 1. Host wall seconds per phase land in
        ``predict_timings``, the view of the call's phase spans (the
        device is waited for at the end of each): the parts of the sampling
        setup ("setup_*", with "setup_rest" the span's remainder, its wall
        less its parts'), "map_warmstart" if asked for, "refresh_stage_a"
        and "refresh_rebuild" with a refresh, "sampling" and "unwhiten"
        (the draws' copy to the host, the span "x_fetch", comes after
        it). ``reseat_accept_below`` (default 0.05, ``SamplerConfig``; 0
        switches it off) is the port's warmup re-seat rule, which the JAX
        package does not have: at the start of each mass window and at the
        end of step-size adaptation (at the latest four fifths into
        burn-in), a chain whose mean acceptance over the last twentieth of
        burn-in before that point is below it moves to the current state
        of a chain drawn at random from the others, where fewer than half
        the chains are below (``sampler/run.py:reseat_stuck``). Where no
        chain is below, the draws are the bits the rule off gives."""
        # a NumPy ladder too (its truth value is ambiguous)
        pt_betas = (tuple(float(b) for b in pt_betas)
                    if pt_betas is not None else None)
        if matmul_precision != "highest":
            raise ValueError(
                "the port always runs float32 matmuls at full precision "
                "(TF32 off); matmul_precision must be 'highest'"
            )
        for name, arr in (("Xhat_init", self.Xhat_init),
                          ("sigma_sqs_init", self.sigma_sqs_init),
                          ("thetas_init", self.thetas_init)):
            if arr is None or np.any(np.isnan(arr)):
                raise ValueError(f"{name} has NaNs: run initial_fit first")

        cfg = self.config
        dtype, dev = cfg.dtype, cfg.torch_device
        sig_fix64, sigma_pre_fix = self._sigma_bounds(sigma_sqs_LB,
                                                      sigma_sqs_fixed)[1:]
        dense_tail_size = self._dense_tail_size(mass_matrix, sigma_sqs_fixed)
        timer = PhaseTimer(dev, trace=profile_timings)
        self.predict_timings = timer.phases
        root = timer.open("predict")
        with timer("setup_rest"):
            mode, data, sigma_sqs_LB = self._build_sampling_setup(
                reparam, storage, dtype, sigma_sqs_LB=sigma_sqs_LB,
                sigma_sqs_fixed=sigma_sqs_fixed, gn_anchor=gn_anchor,
                timer=timer,
            )
        # the parts were timed inside; what is left is the rest
        timer.phases["setup_rest"] -= sum(
            v for k, v in timer.phases.items() if k != "setup_rest")

        def pre_init(vals, lower):
            above = vals > lower
            out = np.full_like(vals, -5.0)
            out[above] = _np_softplus_inverse(vals[above] - lower[above])
            return out

        sigma_pre0 = (sigma_pre_fix.copy() if sigma_sqs_fixed is not None
                      else pre_init(self.sigma_sqs_init, sigma_sqs_LB))
        theta_pre0 = pre_init(self.thetas_init,
                              np.zeros_like(self.thetas_init))
        q0 = flatten_state(
            mode.X0.cpu(),
            torch.as_tensor(sigma_pre0, dtype=dtype),
            torch.as_tensor(theta_pre0, dtype=dtype),
        ).numpy()
        if map_warmstart_iters:
            with timer("map_warmstart"):
                q0, vals = map_warmstart(mode.logp_grad, q0,
                                         map_warmstart_iters,
                                         cfg.init_learning_rate, dtype, dev)
            if verbose:
                print(f"[map_warmstart] logp {vals[0]:.1f} -> "
                      f"{vals[-1]:.1f} over {map_warmstart_iters} steps")
        q0 = np.broadcast_to(q0, (num_chains, q0.shape[0])).copy()
        ND = self.mag_I * self.D
        if init_jitter > 0.0 and num_chains > 1:
            rng = np.random.default_rng(seed + 1)
            q0[1:, :ND] += init_jitter * rng.standard_normal(
                (num_chains - 1, ND)
            )
        if init_states is not None:
            q0 = apply_init_states(q0, init_states, mode, self, sigma_sqs_LB,
                                   sigma_sqs_fixed)

        sampler_config = SamplerConfig(
            num_results=num_results,
            num_burnin_steps=num_burnin_steps,
            initial_step_size=cfg.initial_step_size,
            target_accept=cfg.target_accept,
            adaptation_fraction=cfg.adaptation_fraction,
            max_tree_depth=cfg.max_tree_depth,
            anneal_min_temp=cfg.anneal_min_temp,
            use_annealing=use_annealing,
            anneal_mode=anneal_mode,
            adapt_mass_matrix=(cfg.adapt_mass_matrix
                               if adapt_mass_matrix is None
                               else adapt_mass_matrix),
            progress_every=(max(1, (num_burnin_steps + num_results) // 20)
                            if verbose else 0),
            thin=thin,
            algorithm=algorithm,
            hmc_num_leapfrogs=hmc_num_leapfrogs,
            dense_tail_size=dense_tail_size,
            dense_shrinkage=dense_shrinkage,
            **({} if mass_window is None else {
                "mass_window_begin": float(mass_window[0]),
                "mass_window_end": float(mass_window[1])}),
            **({} if mass_window2 is None else {
                "mass_window2_begin": float(mass_window2[0]),
                "mass_window2_end": float(mass_window2[1])}),
            mass_window1_diag=mass_window1_diag,
            pt_betas=pt_betas or (),
            pt_swap_every=pt_swap_every,
            dispatch_block_steps=dispatch_block_steps or 0,
            checkpoint_path=checkpoint_path,
            profile_timings=profile_timings,
            **({} if stage_above_bytes is None
               else {"stage_above_bytes": stage_above_bytes}),
            **({} if reseat_accept_below is None
               else {"reseat_accept_below": float(reseat_accept_below)}),
        )
        if precond_refresh_steps:
            mode, q0 = refresh_gn_anchor(
                mode, self, q0, num_chains, sampler_config, dtype, seed,
                precond_refresh_steps, verbose=verbose,
                restart=precond_refresh_restart,
                restart_scatter=precond_refresh_scatter, timer=timer,
            )
            if anneal_mode == "warmup_only":
                # the annealing ramp ran in stage A; running it again would
                # re-flatten the target the refresh re-anchored
                sampler_config = sampler_config._replace(use_annealing=False)
        start = time.time()
        with timer("sampling"):
            samples, stats = run_chains(
                mode.logp_grad,
                torch.as_tensor(q0, dtype=dtype, device=dev),
                seed,
                sampler_config,
                timer=timer,
            )
        if pt_betas and len(pt_betas) > 1:
            # only the beta = 1 rung (rung-major: the first M chains) draws
            # from the posterior; the per-chain stats are sliced to match
            num_chains = num_chains // len(pt_betas)
            samples = samples[:, :num_chains].contiguous()
            stats = stats._replace(
                accept_probs=stats.accept_probs[:, :num_chains],
                num_leapfrogs=stats.num_leapfrogs[:, :num_chains],
                divergences=stats.divergences[:, :num_chains],
                depths=stats.depths[:, :num_chains],
            )
            if verbose:
                print("[pt] swap acceptance per adjacent pair: "
                      f"{np.round(stats.pt_swap_accept.cpu().numpy(), 3)}")
        with timer("unwhiten") as unwhiten:
            Z, sigma_pre, theta_pre = unflatten_samples(
                samples, self.mag_I, self.D, self.D_thetas
            )
            X_samps = unwhiten_draws(mode, Z, data.mu_ds)
        with timer.span("x_fetch") as fetch:
            X_samps = X_samps.cpu().numpy()
        minutes = np.round((time.time() - start) / 60, 2)
        squeeze = num_chains == 1

        def host(a):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            return a[:, 0] if squeeze else a

        with timer.span("host_copy") as host_copy:
            if sigma_sqs_fixed is not None:
                # the pinned coordinates random-walk; report the known
                # values
                sigma_sqs_samps = np.broadcast_to(
                    sig_fix64, host(sigma_pre).shape).copy()
            else:
                sigma_sqs_samps = (_np_softplus(host(sigma_pre))
                                   + sigma_sqs_LB)
            thetas_samps = _np_softplus(host(theta_pre))
            samples_np = samples.cpu().numpy()
        timer.close(root)
        out_timings = None
        if profile_timings:
            out_timings = dict(stats.timings)
            out_timings.update(
                sampler_total_s=timer.phases["sampling"],
                unwhiten_s=timer.phases["unwhiten"],
                x_fetch_s=(fetch.t1_ns - fetch.t0_ns) * 1e-9,
                post_total_s=(host_copy.t1_ns - unwhiten.t0_ns) * 1e-9,
                trace={**timer.export(), "fit": self.fit_trace},
            )
        return {
            "timings": out_timings,
            "phi1s": self.phi1s,
            "phi2s": self.phi2s,
            "Xhat_init": self.Xhat_init,
            "sigma_sqs_init": self.sigma_sqs_init,
            "thetas_init": self.thetas_init,
            "I": self.I,
            "X_samps": X_samps[:, 0] if squeeze else X_samps,
            "sigma_sqs_samps": sigma_sqs_samps,
            "thetas_samps": thetas_samps,
            "kernel_results": {
                "step_size": stats.step_size.cpu().numpy(),
                "inv_mass": stats.inv_mass.cpu().numpy(),
                "tail_inv_mass": (
                    None if stats.tail_inv_mass is None
                    else stats.tail_inv_mass.cpu().numpy()
                ),
                "accept_probs": stats.accept_probs.cpu().numpy(),
                "num_leapfrogs": stats.num_leapfrogs,
                "divergences": stats.divergences.cpu().numpy(),
                "depths": stats.depths,
                **({} if stats.pt_swap_accept is None else {
                    "pt_swap_accept": stats.pt_swap_accept.cpu().numpy()}),
            },
            "sample_results": (samples_np if samples_np.nbytes <= 1 << 30
                               else None),
            "minutes_elapsed": minutes,
        }

    def extend_for_forecast(self, t_max_new: float, results: dict = None):
        """Extend the grid to ``t_max_new`` at its spacing, for forecasting
        (as magi_v2_tpu.MAGI_v2.extend_for_forecast): the discretized
        observations are padded with NaN rows (the observation index stays
        valid), Xhat/theta/sigma^2 start from the means of ``results`` (a
        prior predict()'s, meaned over every leading axis, chains too) when
        given, the last row of Xhat is repeated over the new points, and
        the operators are rebuilt at the new N_I. Call predict() after.

        Needs a uniform fit grid (else ValueError, before any state is
        touched): on another grid, build ``I_new`` and call
        ``update_kernel_matrices``."""
        dts = np.diff(self.I[:, 0])
        if not np.allclose(dts, dts[0], rtol=1e-8, atol=1e-12 * abs(dts[0])):
            raise ValueError(
                "extend_for_forecast requires a uniform fit grid (measured "
                f"spacings span [{dts.min():.6g}, {dts.max():.6g}]); extend "
                "the grid yourself and call update_kernel_matrices instead"
            )
        dt = self.I[1, 0] - self.I[0, 0]
        I_new = np.arange(self.I[0, 0], t_max_new + dt / 2, dt)
        n_pad = len(I_new) - self.mag_I
        if n_pad <= 0:
            raise ValueError("t_max_new must extend beyond the current grid")

        self.X_obs_discret = np.vstack(
            [self.X_obs_discret, np.full((n_pad, self.D), np.nan)]
        )
        self.obs_index = preprocess.build_observation_index(self.X_obs_discret)
        if results is not None:
            X_mean = results["X_samps"]
            X_mean = X_mean.mean(axis=tuple(range(X_mean.ndim - 2)))
            self.thetas_init = results["thetas_samps"].reshape(
                -1, self.D_thetas).mean(axis=0)
            self.sigma_sqs_init = results["sigma_sqs_samps"].reshape(
                -1, self.D).mean(axis=0)
        else:
            X_mean = self.Xhat_init
        pad = np.repeat(X_mean[-1:, :], n_pad, axis=0)
        self.Xhat_init = np.vstack([X_mean, pad])
        self.update_kernel_matrices(I_new, self.phi1s, self.phi2s)

    def update_kernel_matrices(self, I_new, phi1s_new, phi2s_new):
        """Rebuild C^{-1}/m/K^{-1} on the grid ``I_new`` (reference
        magi_v2.py:433-462), float64 on the config's device, band-truncated
        again where a bandsize is set. Future observations are padded into
        X_obs_discret separately (``extend_for_forecast`` does both). The
        exact operators storage="hybrid" rebuilds are keyed by the grid, so
        none of the old grid's is reused."""
        self.I = np.asarray(I_new).reshape(-1, 1)
        self.phi1s = np.asarray(phi1s_new).copy()
        self.phi2s = np.asarray(phi2s_new).copy()
        self.mag_I = self.I.shape[0]
        self.beta = (self.D * self.mag_I) / self.N_ds.sum()
        self.C_d_invs, self.m_ds, self.K_d_invs = self._build_inverse_matrices(
            self.phi1s, self.phi2s)
        self._apply_band_truncation()

    def map_estimate(self, **kwargs):
        """Joint MAP of the exact (untruncated, beta = 1) posterior with
        Laplace credible sds and, with ``laplace_draws``, joint draws for
        ``predict(init_states=...)``; the arguments and result keys of
        magi_v2_tpu.MAGI_v2.map_estimate (see ``map_laplace.map_estimate``).
        Float64 on the config's device; L-BFGS-B on the host."""
        from magi_v2_tpu_torch.map_laplace import map_estimate

        return map_estimate(self, **kwargs)


def map_warmstart(logp_grad, q0, iters: int, learning_rate: float, dtype,
                  device):
    """``iters`` Adam steps (eps 1e-7, ``optax.adam(lr, eps=1e-7)``'s
    update) ascending the sampler's own target ``logp_grad`` at beta 1
    from the single start ``q0`` (dim,) (NumPy): predict's
    ``map_warmstart_iters``, the JAX package's MAP polish of the heuristic
    start. Returns (the polished start, the log-posterior before each
    step, as floats)."""
    q = torch.as_tensor(q0, dtype=dtype, device=device)[None].clone()
    q.requires_grad_(True)
    opt = torch.optim.Adam([q], lr=learning_rate, eps=1e-7)
    one = torch.ones((), dtype=dtype, device=device)
    vals = torch.empty((iters,), dtype=dtype, device=device)
    for i in range(iters):
        with torch.no_grad():
            v, g = logp_grad(q.detach(), one)
        vals[i] = v[0]
        q.grad = -g
        opt.step()
    return q.detach()[0].cpu().numpy(), vals.tolist()
