"""Multi-chain sampling: warmup (dual-averaging step size, staged Welford
mass adaptation, temperature annealing) and sampling with NUTS
(the default) or jittered fixed-length HMC (counterpart of
magi_v2_tpu/sampler/run.py).

Chains are the leading axis of every state tensor. The step size, the
dual-averaging state, the Welford moments and the mass live on the device;
what the host decides — the jittered HMC trajectory length, which step
adapts, when a mass window closes — depends only on step counters. An HMC
transition never waits for the card; a NUTS transition reads one flag a
doubling (whether any chain's tree goes on, sampler/nuts.py). Counters
that are host-known (the dual-averaging and Welford counts) are Python
floats.

Parallel tempering (``pt_betas``: sampler/pt.py) tempers the sampling
phase per chain and swaps adjacent rungs every ``pt_swap_every``
transitions; warmup is shared by all chains, as in the JAX package.

Not ported here (see ROADMAP.md queue 1): checkpoint/resume and dispatch
blocking.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from magi_v2_tpu_torch.sampler.hmc import BoundTransition, hmc_step
from magi_v2_tpu_torch.sampler.nuts import BoundNuts, NutsConfig, draw_noise
from magi_v2_tpu_torch.sampler.pt import (
    BoundSwap,
    check_ladder,
    rung_temperatures,
)
from magi_v2_tpu_torch.sampler.mass import (
    identity_mass,
    mass_diag,
    mass_from_moments,
    mass_kinetic,
    mass_sample_momentum,
    mass_tail_inv,
    mass_vel,
)


def pin_full_float32_matmuls() -> None:
    """Keep float32 GEMMs in full float32: TF32 keeps ~3 decimal digits,
    the same trap as the TPU's default bf16 passes, which collapsed the
    sampler's acceptance (the precision-operator contractions cancel
    ~1e3-magnitude terms down to O(1))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def log_temperature_schedule(step, min_temp=0.1):
    """beta_temp(step) = max(1/log(step+2), min_temp), in float64 NumPy."""
    step = np.asarray(step, np.float64)
    return np.maximum(1.0 / np.log(step + 2.0), min_temp)


class SamplerConfig(NamedTuple):
    num_results: int = 1000
    num_burnin_steps: int = 1000
    initial_step_size: float = 0.1
    target_accept: float = 0.75
    adaptation_fraction: float = 0.8
    max_tree_depth: int = 10
    max_energy_diff: float = 1000.0
    anneal_min_temp: float = 0.1
    use_annealing: bool = True
    # "reference": the schedule runs through sampling too; "warmup_only":
    # anneal during warmup, sample the beta=1 posterior
    anneal_mode: str = "reference"
    adapt_mass_matrix: bool = True
    mass_window_begin: float = 0.45
    mass_window_end: float = 0.7
    # optional second Welford window (end <= begin disables)
    mass_window2_begin: float = 0.0
    mass_window2_end: float = 0.0
    # with two windows: apply only the diagonal at the first window's close
    mass_window1_diag: bool = False
    # dense inverse-mass block over the last k coordinates (k = dim: the
    # full dense metric)
    dense_tail_size: int = 0
    dense_shrinkage: float = 0.0
    # print a progress line every k steps (0 = off; reads device values)
    progress_every: int = 0
    thin: int = 1
    # transition kernel: "nuts" (adaptive trajectory lengths, chains in
    # masked lockstep) or "hmc" (a fixed jittered length shared by all
    # chains)
    algorithm: str = "nuts"
    # HMC's trajectory length: uniform on {1, ..., hmc_num_leapfrogs}, one
    # draw per transition shared by all chains
    hmc_num_leapfrogs: int = 64
    # parallel tempering of the sampling phase (two rungs or more): chains
    # are rung-major, chains [r*M, (r+1)*M) at beta = pt_betas[r] (M =
    # C/R), and every pt_swap_every transitions adjacent rungs propose
    # even-odd exchanges (sampler/pt.py)
    pt_betas: tuple = ()
    pt_swap_every: int = 1


class DAState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: float


def da_init(step_size: torch.Tensor) -> DAState:
    log_eps = torch.log(step_size)
    return DAState(
        log_step=log_eps,
        log_step_avg=log_eps,
        h_bar=torch.zeros_like(step_size),
        mu=torch.log(10.0 * step_size),
        count=0.0,
    )


def da_update(s: DAState, accept_prob, target: float) -> DAState:
    """Stan/TFP dual averaging: gamma=0.05, t0=10, kappa=0.75."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    m = s.count + 1.0
    eta = 1.0 / (m + t0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (target - accept_prob)
    log_step = s.mu - math.sqrt(m) / gamma * h_bar
    w = m ** (-kappa)
    log_step_avg = w * log_step + (1.0 - w) * s.log_step_avg
    return DAState(log_step, log_step_avg, h_bar, s.mu, m)


class Welford(NamedTuple):
    count: float
    mean: torch.Tensor   # (dim,)
    m2: torch.Tensor     # (dim,) or (k, k) for the covariance accumulator


def welford_init(dim, dtype, device) -> Welford:
    z = torch.zeros(dim, dtype=dtype, device=device)
    return Welford(0.0, z, z.clone())


def welford_add_batch(w: Welford, xs) -> Welford:
    """Merge a batch xs (C, dim) via Chan's parallel update."""
    cb = float(xs.shape[0])
    bmean = torch.mean(xs, dim=0)
    bm2 = torch.sum((xs - bmean) ** 2, dim=0)
    delta = bmean - w.mean
    tot = w.count + cb
    mean = w.mean + delta * cb / tot
    m2 = w.m2 + bm2 + delta ** 2 * w.count * cb / tot
    return Welford(tot, mean, m2)


def welford_variance(w: Welford):
    """Regularized variance (Stan's shrinkage toward 1e-3)."""
    var = w.m2 / max(w.count - 1.0, 1.0)
    n = w.count
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


def welford_cov_init(k, dtype, device) -> Welford:
    return Welford(0.0, torch.zeros(k, dtype=dtype, device=device),
                   torch.zeros((k, k), dtype=dtype, device=device))


def welford_cov_add_batch(w: Welford, xs) -> Welford:
    """Merge a batch xs (C, k) via Chan's parallel covariance update."""
    cb = float(xs.shape[0])
    bmean = torch.mean(xs, dim=0)
    xc = xs - bmean
    bm2 = xc.T @ xc
    delta = bmean - w.mean
    tot = w.count + cb
    mean = w.mean + delta * cb / tot
    m2 = w.m2 + bm2 + torch.outer(delta, delta) * w.count * cb / tot
    return Welford(tot, mean, m2)


def welford_covariance(w: Welford, shrinkage: float = 0.0):
    """Regularized covariance (Stan's shrinkage toward 1e-3 * I), with the
    off-diagonals optionally pulled toward zero by ``shrinkage``."""
    cov = w.m2 / max(w.count - 1.0, 1.0)
    n = w.count
    eye = torch.eye(w.mean.shape[0], dtype=cov.dtype, device=cov.device)
    cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
    if shrinkage > 0.0:
        cov = (1.0 - shrinkage) * cov + shrinkage * torch.diag(torch.diag(cov))
    return cov


class ChainStats(NamedTuple):
    step_size: torch.Tensor        # final adapted step size (0-dim)
    inv_mass: torch.Tensor         # (dim,) inverse-mass diagonal
    accept_probs: torch.Tensor     # (num_results, C)
    num_leapfrogs: np.ndarray      # (num_results, C) leapfrogs per chain
    divergences: torch.Tensor      # (num_results, C) bool
    depths: np.ndarray             # (num_results, C) tree depth (HMC:
                                   # ceil(log2 L), as the JAX package)
    tail_inv_mass: torch.Tensor | None = None
    # (R-1,) swap acceptance of each adjacent rung pair (PT runs only)
    pt_swap_accept: torch.Tensor | None = None


def find_reasonable_step_size(logp_grad, q0_row, generator, inv_mass,
                              initial_step_size: float):
    """Hoffman-Gelman Algorithm 4 on one chain (q0_row (1, dim)): double or
    halve eps until the one-leapfrog acceptance crosses 1/2. Runs once
    before warmup and reads the device on each try."""
    logp0, grad0 = logp_grad(q0_row)
    p0 = mass_sample_momentum(inv_mass, generator, q0_row.shape,
                              q0_row.dtype, q0_row.device)
    H0 = -logp0 + mass_kinetic(inv_mass, p0)

    def log_accept(eps: float) -> float:
        p_half = p0 + 0.5 * eps * grad0
        q1 = q0_row + eps * mass_vel(inv_mass, p_half)
        logp1, grad1 = logp_grad(q1)
        p1 = p_half + 0.5 * eps * grad1
        H1 = -logp1 + mass_kinetic(inv_mass, p1)
        dH = float(H1 - H0) if bool(torch.isfinite(H1)) else math.inf
        return -dH

    log_half = math.log(0.5)
    eps = float(initial_step_size)
    la = log_accept(eps)
    direction = 1.0 if la > log_half else -1.0
    it = 0
    while direction * la > direction * log_half and it < 40:
        eps = eps * 2.0 ** direction
        la = log_accept(eps)
        it += 1
    return eps


def run_chains(
    tempered_logp_grad: Callable,   # (q (C, dim), beta_temp) -> (logp, grad)
    q0: torch.Tensor,               # (C, dim) initial chain states
    seed: int,
    config: SamplerConfig = SamplerConfig(),
):
    """Warmup + sampling of C chains with ``config.algorithm``: "nuts"
    (``nuts.BoundNuts``) or "hmc" (jittered fixed-length HMC).

    For HMC, a ``tempered_logp_grad`` with a bound evaluation (``bind``, as
    the targets ``predict`` builds have) takes the sampler's bound
    transition (``hmc.BoundTransition``: CUDA graphs on the card); any
    other callable the eager ``hmc_step``. NUTS takes ``BoundNuts`` for
    both, with CUDA graphs where the target binds. Either way the two
    forms give the same draws.

    With two rungs or more in ``config.pt_betas``, chain c samples at its
    rung's beta and step eps * beta^(-1/2) after warmup, and a swap round
    (``pt.BoundSwap``: the value-only evaluation and the swap kernel, one
    CUDA graph on the card) follows every ``pt_swap_every``-th sampling
    transition; samples and stats keep every rung (``predict`` returns the
    beta = 1 rung), and ``stats.pt_swap_accept`` holds each pair's
    acceptance.

    Returns (samples (num_results, C, dim) on q0's device, ChainStats).
    The momenta and uniforms come from a ``torch.Generator`` on the device
    seeded with ``seed``, a swap round's uniforms after its transition's;
    HMC's trajectory lengths from a NumPy generator on the host with the
    same seed.
    """
    if config.algorithm not in ("nuts", "hmc"):
        raise ValueError(f"unknown algorithm {config.algorithm!r}; expected "
                         "'nuts' or 'hmc'")
    nuts = config.algorithm == "nuts"
    pin_full_float32_matmuls()
    C, dim = q0.shape
    dtype, dev = q0.dtype, q0.device
    betas = check_ladder(config, C)
    pt = betas is not None
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    host_rng = np.random.default_rng(int(seed))

    B = config.num_burnin_steps
    num_adapt = int(config.adaptation_fraction * B)
    win_lo = int(config.mass_window_begin * B)
    win_hi = int(config.mass_window_end * B)
    win2_lo = int(config.mass_window2_begin * B)
    win2_hi = int(config.mass_window2_end * B)
    adapt_mass = config.adapt_mass_matrix and win_hi > win_lo
    two_windows = config.adapt_mass_matrix and win2_hi > win2_lo
    if two_windows:
        if win_hi <= win_lo:
            raise ValueError(
                f"mass_window2 requires a valid first window (got [{win_lo}, "
                f"{win_hi}))"
            )
        if win2_lo < win_hi:
            raise ValueError(
                f"mass_window2 [{win2_lo}, {win2_hi}) must start at or after "
                f"mass_window_end ({win_hi})"
            )
        if win2_hi >= num_adapt:
            raise ValueError(
                f"mass_window2 must end (step {win2_hi}) before step-size "
                f"adaptation does (step {num_adapt}): the step size has to "
                "re-adapt to the re-estimated metric"
            )

    total = B + config.num_results * config.thin
    steps = np.arange(total)
    if not config.use_annealing:
        temps = np.ones(total)
    else:
        temps = log_temperature_schedule(steps, config.anneal_min_temp)
        if config.anneal_mode == "warmup_only":
            ramp_end = num_adapt
            if adapt_mass:
                ramp_end = min(ramp_end, win_lo)
            temps = np.maximum(temps,
                               np.clip(steps / max(ramp_end, 1), 0.0, 1.0))
        elif config.anneal_mode != "reference":
            raise ValueError(f"unknown anneal_mode {config.anneal_mode!r}")
    temps = torch.as_tensor(temps, dtype=dtype, device=dev)

    def draw_num_leapfrogs() -> int:
        return max(1, math.ceil(host_rng.random() * config.hmc_num_leapfrogs))

    # a target with a bound evaluation runs on fixed buffers, and on the
    # card as replayed CUDA graphs, made once the first mass is known
    bound = None

    nuts_cfg = NutsConfig(config.max_tree_depth, config.max_energy_diff)

    def transition(qs, eps, inv_mass, step, beta_temp=None):
        if beta_temp is None:
            beta_temp = temps[step]
        if nuts:
            return bound(qs, eps, inv_mass, beta_temp,
                         draw_noise(gen, C, dim, nuts_cfg.max_tree_depth,
                                    dtype, dev))
        normals = torch.randn((C, dim), generator=gen, dtype=dtype, device=dev)
        uniforms = torch.rand((C,), generator=gen, dtype=dtype, device=dev)
        if bound is not None:
            return bound(qs, eps, inv_mass, beta_temp, draw_num_leapfrogs(),
                         normals, uniforms, config.max_energy_diff)
        return hmc_step(
            lambda q: tempered_logp_grad(q, beta_temp), qs, eps, inv_mass,
            draw_num_leapfrogs(), normals, uniforms, config.max_energy_diff,
        )

    def progress(phase, step, eps, info):
        every = config.progress_every
        if every and step % every == 0:
            L = info.num_leapfrogs
            print(
                f"[sampler] {phase} step {step:>6} eps={float(eps):.5f} "
                f"accept={float(info.accept_prob.mean()):.3f} "
                f"L={float(L.float().mean()) if nuts else L} "
                f"div={float(info.diverging.to(dtype).mean()):.4f}",
                flush=True,
            )

    k = config.dense_tail_size
    inv_mass = identity_mass(dim, k, dtype, dev)
    eps0 = find_reasonable_step_size(
        lambda q: tempered_logp_grad(q, temps[0]), q0[:1], gen, inv_mass,
        config.initial_step_size,
    )
    da = da_init(torch.tensor(eps0, dtype=dtype, device=dev))
    wf = welford_init(dim, dtype, dev)
    wf_tail = welford_cov_init(k, dtype, dev) if k > 0 else None
    if nuts:
        bound = BoundNuts(tempered_logp_grad, q0, inv_mass, nuts_cfg,
                          per_chain=pt)
    elif hasattr(tempered_logp_grad, "bind"):
        bound = BoundTransition(tempered_logp_grad, q0, inv_mass,
                                per_chain=pt)

    qs = q0
    for step in range(B):
        eps = torch.exp(da.log_step if da.count < num_adapt
                        else da.log_step_avg)
        qs, info = transition(qs, eps, inv_mass, step)
        progress("warmup", step, eps, info)
        if step < num_adapt:
            da = da_update(da, torch.mean(info.accept_prob),
                           config.target_accept)
        if not adapt_mass:
            continue
        in_window = win_lo <= step < win_hi or (
            two_windows and win2_lo <= step < win2_hi)
        if in_window:
            wf = welford_add_batch(wf, qs)
            if wf_tail is not None:
                wf_tail = welford_cov_add_batch(wf_tail, qs[:, -k:])
        if step == win_hi or (two_windows and step == win2_hi):
            var = welford_variance(wf)
            if wf_tail is None:
                inv_mass = var
            else:
                cov = welford_covariance(wf_tail, config.dense_shrinkage)
                if two_windows and config.mass_window1_diag and step == win_hi:
                    cov = torch.diag(torch.diag(cov))
                inv_mass = mass_from_moments(var, cov)
            # restart dual averaging around the current step size and the
            # accumulators for a second window
            da = da_init(torch.exp(da.log_step))
            wf = welford_init(dim, dtype, dev)
            wf_tail = welford_cov_init(k, dtype, dev) if k > 0 else None

    eps_final = torch.exp(da.log_step_avg)
    beta_s = eps_s = swap = None
    if pt:
        # sampling at each chain's rung: its beta and a step scaled by
        # beta^(-1/2), both in the sampling dtype
        beta_s, scale = rung_temperatures(betas, C, dtype, dev)
        eps_s = eps_final * scale
        swap = BoundSwap(tempered_logp_grad, q0, betas)
    T = config.num_results
    samples = torch.empty((T, C, dim), dtype=dtype, device=dev)
    accept = torch.empty((T, C), dtype=dtype, device=dev)
    diverging = torch.empty((T, C), dtype=torch.bool, device=dev)
    num_leapfrogs = (torch.empty((T, C), dtype=torch.int32, device=dev)
                     if nuts else np.empty((T, C), np.int32))
    depths = torch.empty((T, C), dtype=torch.int32, device=dev)
    for i in range(T):
        for t in range(config.thin):
            step = B + i * config.thin + t
            if not pt:
                qs, info = transition(qs, eps_final, inv_mass, step)
            else:
                qs, info = transition(qs, eps_s, inv_mass, step, beta_s)
                rel = step - B
                if (rel + 1) % config.pt_swap_every == 0:
                    u = torch.rand((len(betas) - 1, C // len(betas)),
                                   generator=gen, dtype=dtype, device=dev)
                    qs = swap(qs, u, (rel // config.pt_swap_every) % 2)
            progress("sample", step, eps_final, info)
        samples[i] = qs
        accept[i] = info.accept_prob
        diverging[i] = info.diverging
        num_leapfrogs[i] = info.num_leapfrogs
        if nuts:
            depths[i] = info.depth

    if nuts:
        num_leapfrogs, depths = num_leapfrogs.cpu().numpy(), \
            depths.cpu().numpy()
    else:
        depths = np.ceil(np.log2(np.maximum(num_leapfrogs, 1))).astype(
            np.int32)
    stats = ChainStats(
        step_size=eps_final,
        inv_mass=mass_diag(inv_mass),
        accept_probs=accept,
        num_leapfrogs=num_leapfrogs,
        divergences=diverging,
        depths=depths,
        tail_inv_mass=mass_tail_inv(inv_mass),
        pt_swap_accept=swap.acceptance(dtype) if pt else None,
    )
    return samples, stats
