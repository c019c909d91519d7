"""Multi-chain sampling: warmup (dual-averaging step size, staged Welford
mass adaptation, temperature annealing) and sampling with NUTS
(the default) or jittered fixed-length HMC (counterpart of
magi_v2_tpu/sampler/run.py).

``run_chains`` is a warmup loop and a sampling loop over four parts, each
the one owner of a decision: ``Schedule`` (what each step does),
``Stepper`` (a transition of all chains: the algorithm, the shards, the
noise), ``WarmupCarry`` and ``SampleCarry`` (a phase's state, which a
checkpoint writes and reads back) and ``DrawStore`` (the draws, on the
device or staged to host memory).

Chains are the leading axis of every state tensor. The step size, the
dual-averaging state, the Welford moments and the mass live on the device;
what the host decides — the jittered HMC trajectory length, which step
adapts, when a mass window closes — depends only on step counters. An HMC
transition never waits for the card; a NUTS transition reads one flag a
doubling (whether any chain's tree goes on, sampler/nuts.py).

Warmup's re-seat rule (``reseat_accept_below``; the JAX package has
none) reads each chain's acceptance at the boundaries of
``reseat_stretches`` and moves the chains that stopped accepting to other
chains' states (``reseat_stuck``). Sampling is untouched; where no chain
is below, the draws are the rule off's bits.

Parallel tempering (``pt_betas``: sampler/pt.py) tempers the sampling
phase per chain and swaps adjacent rungs every ``pt_swap_every``
transitions; warmup is shared by all chains, as in the JAX package.

``dispatch_block_steps`` cuts warmup and sampling into blocks of
transitions (a thinned draw costs ``thin`` of them), as the JAX package's
dispatch blocks. Here a block is only a checkpoint boundary: its size
changes no draw. With ``checkpoint_path`` each boundary writes the phase's
carry and the generators' states (the device generator's, and the host
NumPy generator's: HMC's trajectory lengths) to ``state.npz`` (atomically:
a temporary file, then ``os.replace``; each tensor with its strides) and
each sampling block its draws and per-draw statistics to
``draws_NNNNNN.npz``; a second identical call resumes bit for bit from the
last boundary, or loads a finished run from disk without a transition.
The bound transitions are rebuilt on resume. A fingerprint of the run
refuses a checkpoint of another.

``profile_timings`` traces the run into a ``utils.profiling.PhaseTimer``
(the caller's ``timer``, or one of its own): spans ``eps_init``,
``warmup`` and ``sample`` (each waiting for the device at its end; the
last two hold Python's garbage collector off, see ``PhaseTimer.span``),
their ``block`` spans (waiting too), a ``transition`` span per
transition (a NUTS ``doubling`` per doubling, its device read a
``device_read`` span), the ``sample`` span's ``stage`` and ``drain``, and
the bound transitions' replay counters. On one card the ``warmup`` and
``sample`` spans' transitions and doublings carry device markers
(``dev_t0_ns``, ``dev_t1_ns``: where the card reached the start and the
end of their work, on the host clock). The ``warmup`` span carries the
re-seat rule's ``chains_reseated`` and ``reseats`` ([boundary, chains
moved] at each boundary read), the ``sample`` span ``worst_chain_accept``
(the lowest mean acceptance of a chain over the phase's draws, one
reduction at its end). ``ChainStats.timings`` is the view of those spans
under the JAX package's keys.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from magi_v2_tpu_torch.sampler.hmc import BoundTransition
from magi_v2_tpu_torch.sampler.nuts import (
    BoundNuts,
    NutsConfig,
    draw_noise,
)
from magi_v2_tpu_torch.sampler.pt import (
    BoundSwap,
    check_ladder,
    rung_temperatures,
    swap_acceptance,
)
from magi_v2_tpu_torch.utils.profiling import PhaseTimer, untimed
from magi_v2_tpu_torch.sampler.mass import (
    TailDenseMass,
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
    # draw per transition shared by all chains (the JAX package's
    # hmc_jitter); with hmc_jitter False every transition takes
    # hmc_num_leapfrogs and nothing is drawn for it
    hmc_num_leapfrogs: int = 64
    hmc_jitter: bool = True
    # parallel tempering of the sampling phase (two rungs or more): chains
    # are rung-major, chains [r*M, (r+1)*M) at beta = pt_betas[r] (M =
    # C/R), and every pt_swap_every transitions adjacent rungs propose
    # even-odd exchanges (sampler/pt.py)
    pt_betas: tuple = ()
    pt_swap_every: int = 1
    # transitions a block (0: one block), a checkpoint boundary; a thinned
    # draw costs ``thin`` transitions of it
    dispatch_block_steps: int = 0
    # directory for mid-run checkpoint/resume ("" = off; see the module's
    # docstring)
    checkpoint_path: str = ""
    # the run's trace (the module's docstring) and ChainStats.timings, its
    # phase spans each after a device sync (the syncs cost the host's lead
    # over the card: keep off in production)
    profile_timings: bool = False
    # the JAX package's stage_above_bytes: with dispatch blocks, draws whose
    # total (num_results * C * dim * itemsize) exceeds this many bytes are
    # staged to (pinned) host memory block by block, so the device holds a
    # block's draws, not the run's; a checkpointed run always stages. An
    # I/O knob: the draws are the same bits either way
    stage_above_bytes: int = 1 << 30
    # warmup's re-seat rule (``reseat_stretches``): at each boundary a
    # chain whose mean acceptance over the stretch before it is below this
    # moves to the state of a chain drawn from the others (0 = off). 0.05:
    # stuck chains read 0 (every transition divergent); healthy chains read
    # >= 0.1 in the benchmark's three cells (PERF.md)
    reseat_accept_below: float = 0.05


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
    # profile_timings only: eps_init_s, warmup_s, warmup_block_walls_s,
    # block_walls_s, sample_total_s, sample_dispatch_s,
    # sample_first_dispatch_s, sample_stage_s (the host's time in the
    # device-to-host copies of staged blocks), staged_bytes, sample_drain_s
    timings: dict | None = None


def sampler_timings(spans: list, parent) -> dict:
    """``ChainStats.timings`` (the JAX package's keys) as the view of one
    run's ``spans`` (``utils.profiling.Span``) whose top spans are the
    children of span id ``parent`` (None: roots): eps_init_s, warmup_s and
    warmup_block_walls_s where warmup ran in this call, block_walls_s
    where a sampling block did; sample_total_s (the ``sample`` span, its
    drain included), sample_drain_s, sample_dispatch_s (its blocks),
    sample_first_dispatch_s, sample_stage_s (its ``stage`` spans) and
    staged_bytes (its counter)."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    sec = lambda s: (s.t1_ns - s.t0_ns) * 1e-9
    top = {s.name: s for s in kids.get(parent, [])}
    named = lambda s, name: [sec(c) for c in kids.get(s.id, [])
                             if c.name == name]
    out = {}
    if "eps_init" in top:
        out["eps_init_s"] = sec(top["eps_init"])
    if "warmup" in top:
        if named(top["warmup"], "block"):
            out["warmup_block_walls_s"] = named(top["warmup"], "block")
        out["warmup_s"] = sec(top["warmup"])
    sample = top["sample"]
    blocks = named(sample, "block")
    if blocks:
        out["block_walls_s"] = blocks
    out["sample_drain_s"] = sum(named(sample, "drain"))
    out["sample_total_s"] = sec(sample)
    out["sample_dispatch_s"] = float(sum(blocks))
    out["sample_first_dispatch_s"] = blocks[0] if blocks else None
    out["sample_stage_s"] = float(sum(named(sample, "stage")))
    out["staged_bytes"] = sample.attrs["counts"].get("staged_bytes", 0)
    return out


def _blocks(total: int, block_steps: int, transitions_per_step: int = 1):
    """[(start, size)] blocks of ``total`` steps, ``block_steps``
    transitions each (a step runs ``transitions_per_step``); one block when
    ``block_steps`` is 0 or covers the total."""
    B = block_steps
    if B > 0 and transitions_per_step > 1:
        B = max(1, B // transitions_per_step)
    if B <= 0 or B >= total:
        return [(0, total)]
    return [(s, min(B, total - s)) for s in range(0, total, B)]


def reseat_stretches(B: int, num_adapt: int, window_starts=()) -> dict:
    """{boundary: first step of its stretch} of warmup's re-seat rule.
    The boundaries (the steps before which the rule reads): the start of
    each mass window, so that the Welford moments leave out the chains it
    moves, and the end of step-size adaptation, at the latest four fifths
    into burn-in (B - ceil(B / 5)), so that a moved chain runs a fifth of
    burn-in before the first draw; never step 0. A boundary's stretch is
    the last twentieth of burn-in before it (ceil(B / 20) steps, from the
    boundary before it at the earliest): the chains that a mass window's
    close strands (its restart of dual averaging throws every chain about
    for some ten transitions) show only in the transitions before the
    next boundary."""
    last = min(num_adapt, B - -(-B // 5))
    w = -(-B // 20)
    out, prev = {}, 0
    for b in sorted({b for b in (*window_starts, last) if 0 < b <= last}):
        out[b], prev = max(prev, b - w), b
    return out


def reseat_stuck(qs, accept_sum, n: int, threshold: float, gen):
    """One boundary of the re-seat rule: each chain whose mean acceptance
    over the stretch's ``n`` transitions (``accept_sum`` (C,) / n) is below
    ``threshold`` moves to the current state of a chain drawn by ``gen``
    from those that are not. Returns (states, chains moved). Reads the
    device once; draws nothing, and moves nothing, when no chain is below,
    or half the chains or more: then the step that all chains share fails,
    not the chains, and moving them would copy a few chains over the
    rest."""
    flagged = (accept_sum < threshold * n).cpu()
    bad = torch.nonzero(flagged).flatten()
    if bad.numel() == 0 or 2 * bad.numel() >= flagged.numel():
        return qs, 0
    ok = torch.nonzero(~flagged).flatten().to(qs.device)
    pick = torch.randint(ok.numel(), (bad.numel(),), generator=gen,
                         device=qs.device)
    qs = qs.clone()
    qs[bad.to(qs.device)] = qs[ok[pick]]
    return qs, bad.numel()


_CKPT_VERSION = "torch-v1"


def _ckpt_fingerprint(config: SamplerConfig, C: int, dim: int, seed,
                      q0) -> str:
    """The identity of a run: every SamplerConfig field but the I/O knobs
    (progress_every, checkpoint_path, profile_timings, stage_above_bytes),
    the chain count and state width, the seed and a digest of the initial
    states."""
    ident = config._replace(progress_every=0, checkpoint_path="",
                            profile_timings=False,
                            stage_above_bytes=SamplerConfig().stage_above_bytes)
    q0_digest = hashlib.blake2b(
        np.ascontiguousarray(q0.detach().cpu().numpy()).tobytes(),
        digest_size=8).hexdigest()
    return (f"{_CKPT_VERSION}/{ident!r}/C{C}/dim{dim}/seed{int(seed)}/"
            f"q0{q0_digest}")


def _tuple_items(name, t) -> dict:
    """A NamedTuple of a carry (None: nothing) as ``<name>_<field>``
    arrays."""
    return {} if t is None else {f"{name}_{f}": v
                                 for f, v in zip(t._fields, t)}


def _mass_items(inv_mass):
    if isinstance(inv_mass, TailDenseMass):
        return _tuple_items("mass", inv_mass)
    return {"mass_diag": inv_mass}


def _ckpt_tensor(arrays, name, device):
    """The carry's tensor ``name`` on ``device``, with the strides it was
    saved with (a product's bits may depend on its operands' layout)."""
    a = arrays[name]
    t = torch.empty_strided(a.shape, tuple(arrays[f"_stride_{name}"]),
                            dtype=torch.from_numpy(a).dtype, device=device)
    return t.copy_(torch.from_numpy(a))


def _ckpt_tuple(cls, arrays, name, device):
    """The NamedTuple ``cls`` that ``_tuple_items`` saved as ``name`` (None:
    none was), its tensors on ``device``."""
    keys = [f"{name}_{f}" for f in cls._fields]
    if keys[0] not in arrays:
        return None
    return cls(*(_ckpt_tensor(arrays, k, device) if f"_stride_{k}" in arrays
                 else float(arrays[k]) for k in keys))


def _ckpt_mass(arrays, device):
    if "mass_tail_inv" in arrays:
        return _ckpt_tuple(TailDenseMass, arrays, "mass", device)
    return _ckpt_tensor(arrays, "mass_diag", device)


def _ckpt_save_state(dirpath, phase, nxt, carry, fingerprint):
    """Atomically persist a block boundary's carry (phase: warmup or
    sample; ``nxt`` the next step of the phase). Tensors are saved with
    their strides, the generator's state as its bytes."""
    os.makedirs(dirpath, exist_ok=True)
    arrays = {}
    for name, v in carry.items():
        if isinstance(v, torch.Tensor):
            arrays[name] = v.detach().cpu().numpy()
            arrays[f"_stride_{name}"] = np.asarray(v.stride(), np.int64)
        else:
            arrays[name] = np.asarray(v)
    # np.savez appends ".npz" to a name without it: keep the suffix
    tmp = os.path.join(dirpath, "state.tmp.npz")
    np.savez(tmp, _phase=np.array(phase), _next=np.array(nxt),
             _fingerprint=np.array(fingerprint), **arrays)
    os.replace(tmp, os.path.join(dirpath, "state.npz"))


def _ckpt_load_state(dirpath, fingerprint):
    """(phase, next step, {name: array}) of the saved carry, or None."""
    p = os.path.join(dirpath, "state.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        found = str(z["_fingerprint"])
        if found != fingerprint:
            raise ValueError(
                f"sampler checkpoint at {dirpath!r} is from a different "
                f"run (saved {found!r} != requested {fingerprint!r}); "
                "delete the directory or point checkpoint_path elsewhere"
            )
        return str(z["_phase"]), int(z["_next"]), {k: z[k] for k in z.files}


def _ckpt_save_draws(dirpath, start, s_blk, info_dict):
    tmp = os.path.join(dirpath, f"draws_{start:06d}.tmp.npz")
    np.savez(tmp, samples=np.asarray(s_blk),
             **{f"info_{k}": np.asarray(v) for k, v in info_dict.items()})
    os.replace(tmp, os.path.join(dirpath, f"draws_{start:06d}.npz"))


def _ckpt_load_draws(dirpath, start):
    p = os.path.join(dirpath, f"draws_{start:06d}.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return z["samples"], {
            k[len("info_"):]: z[k] for k in z.files if k.startswith("info_")
        }


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


class Shard(NamedTuple):
    """Chains [lo, hi) of a run, on ``device``, with their own copy of the
    target (its workspaces and bound graphs are the shard's)."""
    lo: int
    hi: int
    device: torch.device
    target: Callable


def make_shards(target, C: int, mesh) -> list:
    """One ``Shard`` per entry of ``mesh`` (a sequence of devices, an entry
    per shard, repeats allowed): contiguous chain ranges of C / len(mesh),
    each with the target moved to its device."""
    k = len(mesh)
    if k == 0 or C % k:
        raise ValueError(f"num chains {C} must be a multiple of mesh size "
                         f"{k}")
    M = C // k
    return [Shard(i * M, (i + 1) * M, torch.device(d),
                  target.to(d) if hasattr(target, "to") else target)
            for i, d in enumerate(mesh)]


class Schedule:
    """What each step of a run does, from the config and the chain count
    alone: the mass ``windows`` ((first, end)) and their ``closes`` ({end:
    keep only the diagonal}), the re-seat rule's ``reseat_at`` ({boundary:
    stretch start}), the temperatures, the PT ladder, the blocks."""

    def __init__(self, config: SamplerConfig, C: int):
        self.betas = check_ladder(config, C)
        self.B = B = config.num_burnin_steps
        self.num_adapt = num_adapt = int(config.adaptation_fraction * B)
        win_lo = int(config.mass_window_begin * B)
        win_hi = int(config.mass_window_end * B)
        win2_lo = int(config.mass_window2_begin * B)
        win2_hi = int(config.mass_window2_end * B)
        adapt_mass = config.adapt_mass_matrix and win_hi > win_lo
        two_windows = config.adapt_mass_matrix and win2_hi > win2_lo
        if two_windows:
            if win_hi <= win_lo:
                raise ValueError(
                    f"mass_window2 requires a valid first window (got "
                    f"[{win_lo}, {win_hi}))"
                )
            if win2_lo < win_hi:
                raise ValueError(
                    f"mass_window2 [{win2_lo}, {win2_hi}) must start at or "
                    f"after mass_window_end ({win_hi})"
                )
            if win2_hi >= num_adapt:
                raise ValueError(
                    f"mass_window2 must end (step {win2_hi}) before step-size "
                    f"adaptation does (step {num_adapt}): the step size has "
                    "to re-adapt to the re-estimated metric"
                )
        self.windows = (((win_lo, win_hi),) if adapt_mass else ()) + (
            ((win2_lo, win2_hi),) if two_windows else ())
        self.closes = {hi: two_windows and config.mass_window1_diag
                       and hi == win_hi for _, hi in self.windows}
        self.reseat_at = {}
        if config.reseat_accept_below > 0.0:
            self.reseat_at = reseat_stretches(
                B, num_adapt, tuple(lo for lo, _ in self.windows))
        self.summed = {s for b, lo in self.reseat_at.items()
                       for s in range(lo, b)}
        self.transitions = B + config.num_results * config.thin
        steps = np.arange(self.transitions)
        if not config.use_annealing:
            self.temps = np.ones(steps.size)
        else:
            self.temps = log_temperature_schedule(steps,
                                                  config.anneal_min_temp)
            if config.anneal_mode == "warmup_only":
                ramp_end = min(num_adapt, win_lo) if adapt_mass else num_adapt
                self.temps = np.maximum(self.temps, np.clip(
                    steps / max(ramp_end, 1), 0.0, 1.0))
            elif config.anneal_mode != "reference":
                raise ValueError(
                    f"unknown anneal_mode {config.anneal_mode!r}")
        self.warmup_blocks = _blocks(B, config.dispatch_block_steps)
        self.sample_blocks = _blocks(config.num_results,
                                     config.dispatch_block_steps, config.thin)


def _part(x, sh: Shard, C: int | None = None):
    # shard sh's rows of a per-chain tensor of C rows (a 0-dim one, or any
    # with C None, whole) on its device; a tuple's part by part
    if isinstance(x, tuple):
        return type(x)(*(_part(t, sh, C) for t in x))
    if not isinstance(x, torch.Tensor):
        return x
    if C is not None and x.dim() and x.shape[0] == C:
        x = x[sh.lo:sh.hi]
    return x.to(sh.device)


class Stepper:
    """One transition of all C chains, NUTS (``nuts.BoundNuts``) or HMC
    (``hmc.BoundTransition``), over ``shards`` (None: one, q0's device and
    ``target`` itself): each runs its chains on its device with its own
    target and bound transition. The noise of all C chains is drawn on the
    first shard's device from ``gen``, HMC's trajectory length from
    ``host_rng`` on the host, both seeded with ``seed``, and the states
    are gathered there, so a sharded run draws what the unsharded one
    does and pools its statistics alike."""

    def __init__(self, nuts: bool, config: SamplerConfig, target, q0, seed,
                 shards=None, per_chain: bool = False):
        if shards is None:
            shards = [Shard(0, q0.shape[0], q0.device, target)]
        self.shards, self.nuts, self.config = shards, nuts, config
        self.device, self.target = shards[0].device, shards[0].target
        self.q0, self.per_chain = q0.to(self.device), per_chain
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.host_rng = np.random.default_rng(int(seed))
        # made at the first mass; the trace recorder (run_chains sets it)
        self.bounds = self.recorder = None
        self._masses = (None, None)

    def anchor(self, transitions: int) -> None:
        # the device markers' start, an event for each marker the
        # transitions can make; none across shards (they time one card)
        if self.recorder is not None and len(self.shards) == 1:
            depth = self.config.max_tree_depth if self.nuts else 0
            self.recorder.anchor(transitions * (2 + 2 * depth))

    def rng_items(self) -> dict:
        return {"gen": self.gen.get_state(),
                "host_rng": json.dumps(self.host_rng.bit_generator.state)}

    def set_rng(self, arrays) -> None:
        self.gen.set_state(torch.from_numpy(arrays["gen"]))
        self.host_rng.bit_generator.state = json.loads(str(arrays["host_rng"]))

    def bind(self, inv_mass) -> None:
        """Makes the bound transitions, once: they hold the mass's form."""
        if self.bounds is not None:
            return
        parts = [(self.target, self.q0, inv_mass)]
        if len(self.shards) > 1:
            parts = [(sh.target, self.q0[sh.lo:sh.hi].to(sh.device), mass)
                     for sh, mass in zip(self.shards,
                                         self._shard_masses(inv_mass))]
        cfg = NutsConfig(self.config.max_tree_depth,
                         self.config.max_energy_diff)
        self.bounds = [
            BoundNuts(t, q, m, cfg, per_chain=self.per_chain) if self.nuts
            else BoundTransition(t, q, m, per_chain=self.per_chain)
            for t, q, m in parts]
        for b in self.bounds:
            b.recorder = self.recorder

    def _shard_masses(self, inv_mass) -> list:
        # each shard's copy of the mass, remade when the mass changes
        if inv_mass is not self._masses[0]:
            self._masses = (inv_mass, [_part(inv_mass, sh)
                                       for sh in self.shards])
        return self._masses[1]

    def _noise(self) -> tuple:
        # the bound transitions' arguments after the temperature
        (C, dim), dt, dev = self.q0.shape, self.q0.dtype, self.device
        if self.nuts:
            return (draw_noise(self.gen, C, dim, self.config.max_tree_depth,
                               dt, dev),)
        normals = torch.randn((C, dim), generator=self.gen, dtype=dt,
                              device=dev)
        uniforms = torch.rand((C,), generator=self.gen, dtype=dt, device=dev)
        L = self.config.hmc_num_leapfrogs
        if self.config.hmc_jitter:
            L = max(1, math.ceil(self.host_rng.random() * L))
        return L, normals, uniforms, self.config.max_energy_diff

    def __call__(self, qs, eps, inv_mass, step: int, beta_temp):
        """(states, info) of transition ``step`` from ``qs`` (C, dim), its
        step size and temperature each 0-dim or one a chain."""
        args = (qs, eps, inv_mass, beta_temp, *self._noise())
        rec = self.recorder
        if rec is None:
            return self._step(args)
        s = rec.open("transition", step=step)
        rec.mark(s, "dev_t0_ns")
        out = self._step(args)
        rec.mark(s, "dev_t1_ns")
        rec.close(s)
        return out

    def _step(self, args):
        if len(self.bounds) == 1:
            return self.bounds[0](*args)
        C = args[0].shape[0]
        qs, infos = zip(*(
            bound(*(mass if i == 2 else _part(a, sh, C)
                    for i, a in enumerate(args)))
            for bound, sh, mass in zip(self.bounds, self.shards,
                                       self._shard_masses(args[2]))))
        cat = lambda xs: (torch.cat([x.to(self.device) for x in xs])
                          if isinstance(xs[0], torch.Tensor) else xs[0])
        return cat(qs), type(infos[0])(*map(cat, zip(*infos)))


class WarmupCarry(NamedTuple):
    """Warmup's state between transitions (a warmup checkpoint with the
    generators' states)."""
    qs: torch.Tensor
    da: DAState
    wf: Welford
    wf_tail: Welford | None    # the dense tail's covariance, or None
    inv_mass: object
    accept_sum: torch.Tensor   # (C,) acceptance over the re-seat stretch
    reseats: list              # (boundary, chains moved) at each boundary

    def arrays(self) -> dict:
        return {"qs": self.qs, **_tuple_items("da", self.da),
                **_tuple_items("wf", self.wf),
                **_tuple_items("wf_tail", self.wf_tail),
                **_mass_items(self.inv_mass),
                "reseat_accept_sum": self.accept_sum,
                "reseats": np.asarray(self.reseats, np.int64).reshape(-1, 2)}

    @classmethod
    def load(cls, arrays, device) -> WarmupCarry:
        return cls(_ckpt_tensor(arrays, "qs", device),
                   _ckpt_tuple(DAState, arrays, "da", device),
                   _ckpt_tuple(Welford, arrays, "wf", device),
                   _ckpt_tuple(Welford, arrays, "wf_tail", device),
                   _ckpt_mass(arrays, device),
                   _ckpt_tensor(arrays, "reseat_accept_sum", device),
                   [tuple(int(v) for v in r) for r in arrays["reseats"]])


class SampleCarry(NamedTuple):
    """Sampling's state between blocks (a sampling checkpoint with the
    generators' states)."""
    qs: torch.Tensor
    eps: torch.Tensor          # warmup's step size
    inv_mass: object
    swap_prop: torch.Tensor | None = None   # PT's swap counters, (R - 1,)
    swap_accs: torch.Tensor | None = None

    def arrays(self) -> dict:
        swaps = ({} if self.swap_prop is None else
                 {"swap_prop": self.swap_prop, "swap_accs": self.swap_accs})
        return {"qs": self.qs, "eps": self.eps,
                **_mass_items(self.inv_mass), **swaps}

    @classmethod
    def load(cls, arrays, device) -> SampleCarry:
        swaps = [_ckpt_tensor(arrays, name, device)
                 for name in ("swap_prop", "swap_accs") if name in arrays]
        return cls(_ckpt_tensor(arrays, "qs", device),
                   _ckpt_tensor(arrays, "eps", device),
                   _ckpt_mass(arrays, device), *swaps)


class DrawStore:
    """The sampling phase's draws and per-draw statistics (``arrays``).
    Draws of more than ``stage_above_bytes`` (with dispatch blocks), and a
    checkpointed run's, are staged: each block is computed into a device
    buffer and copied into (pinned) host memory. HMC's trajectory lengths
    are host ints and stay on the host."""

    def __init__(self, nuts: bool, config: SamplerConfig, blocks, q0,
                 recorder):
        T, (C, dim), dev = config.num_results, q0.shape, q0.device
        ck = bool(config.checkpoint_path)
        staged = ck or (
            config.dispatch_block_steps > 0
            and T * C * dim * q0.element_size() > config.stage_above_bytes)
        new = partial(torch.empty, device="cpu" if staged else dev,
                      pin_memory=staged and dev.type == "cuda")
        self.arrays = {
            "samples": new((T, C, dim), dtype=q0.dtype),
            "accept": new((T, C), dtype=q0.dtype),
            "diverging": new((T, C), dtype=torch.bool),
            "num_leapfrogs": (new((T, C), dtype=torch.int32) if nuts
                              else np.empty((T, C), np.int32))}
        if nuts:
            self.arrays["depths"] = new((T, C), dtype=torch.int32)
        # what a block writes on the device (when staged, into a buffer)
        self.per_draw = {name: a for name, a in self.arrays.items()
                         if isinstance(a, torch.Tensor)}
        self.nuts, self.device, self.recorder = nuts, dev, recorder
        self.span = untimed.span if recorder is None else recorder.span
        self.bufs = self.copy_stream = None
        if staged:
            # two buffers on the card, so that a block's copy (on a stream
            # of its own, after the block's last write) overlaps the next
            # block's compute, as the JAX package's finalize_block overlaps
            # its fetch; one where the copy is synchronous (the CPU, or a
            # checkpoint, whose files need the block on the host)
            nbuf = 2 if dev.type == "cuda" and not ck else 1
            bmax = max(size for _, size in blocks)
            self.bufs = [{name: torch.empty((bmax,) + a.shape[1:],
                                            dtype=a.dtype, device=dev)
                          for name, a in self.per_draw.items()}
                         for _ in range(nbuf)]
            self.copied = [None] * nbuf
            if nbuf == 2:
                self.copy_stream = torch.cuda.Stream(dev)

    def load(self, dirpath, start: int, end: int) -> None:
        # block [start, end) of a finished run, from its draws file
        loaded = _ckpt_load_draws(dirpath, start)
        if loaded is None:
            raise FileNotFoundError(
                f"checkpoint state at {dirpath!r} marks block {start} "
                f"complete but draws_{start:06d}.npz is missing; "
                "delete state.npz to restart")
        for name, arr in self.arrays.items():
            a = loaded[0] if name == "samples" else loaded[1][name]
            arr[start:end] = (torch.from_numpy(a)
                              if isinstance(arr, torch.Tensor) else a)

    def open(self, b: int, start: int, size: int) -> None:
        # block b, draws [start, start + size), takes the next puts
        self.start, self.size = start, size
        if self.bufs is None:
            self.views = {name: a[start:start + size]
                          for name, a in self.per_draw.items()}
            return
        j = self.j = b % len(self.bufs)
        if self.copied[j] is not None:
            # the buffer's last copy must be done before it is rewritten
            torch.cuda.current_stream(self.device).wait_event(self.copied[j])
        self.views = {name: buf[:size] for name, buf in self.bufs[j].items()}

    def put(self, i: int, qs, info) -> None:
        v, n = self.views, i - self.start
        v["samples"][n] = qs
        v["accept"][n] = info.accept_prob
        v["diverging"][n] = info.diverging
        if self.nuts:
            v["num_leapfrogs"][n] = info.num_leapfrogs
            v["depths"][n] = info.depth
        else:
            self.arrays["num_leapfrogs"][i] = info.num_leapfrogs

    def stage(self) -> None:
        # a staged run's open block, from its device buffer to the host
        if self.bufs is None:
            return
        start, end = self.start, self.start + self.size
        with self.span("stage"):
            stream = self.copy_stream
            if stream is not None:
                stream.wait_event(
                    torch.cuda.current_stream(self.device).record_event())
            with torch.cuda.stream(stream):
                for name, v in self.views.items():
                    self.per_draw[name][start:end].copy_(
                        v, non_blocking=stream is not None)
                if stream is not None:
                    self.copied[self.j] = stream.record_event()
            if self.recorder is not None:
                host = (0 if self.nuts
                        else self.arrays["num_leapfrogs"][start:end].nbytes)
                self.recorder.count("staged_bytes", host + sum(
                    v.numel() * v.element_size() for v in self.views.values()))

    def host_block(self, start: int, end: int):
        # block [start, end) in host memory, as its draws file holds it
        return self.arrays["samples"][start:end].numpy(), {
            name: (arr[start:end].numpy() if isinstance(arr, torch.Tensor)
                   else arr[start:end].copy())
            for name, arr in self.arrays.items() if name != "samples"}

    def drain(self) -> None:
        with self.span("drain", wait=True):
            if self.recorder is not None and self.copy_stream is not None:
                self.copy_stream.synchronize()

    def stats(self) -> dict:
        """The arrays, the copies done; num_leapfrogs and depths in NumPy
        (HMC's depth ceil(log2 L), as the JAX package's)."""
        if self.copy_stream is not None:
            self.copy_stream.synchronize()
        out = dict(self.arrays)
        if self.nuts:
            for name in ("num_leapfrogs", "depths"):
                out[name] = out[name].cpu().numpy()
        else:
            out["depths"] = np.ceil(np.log2(np.maximum(
                out["num_leapfrogs"], 1))).astype(np.int32)
        return out


def _progress(config: SamplerConfig, phase: str, step: int, eps, info):
    every = config.progress_every
    if every and step % every == 0:
        L = info.num_leapfrogs
        print(
            f"[sampler] {phase} step {step:>6} eps={float(eps):.5f} "
            f"accept={float(info.accept_prob.mean()):.3f} "
            f"L={L if isinstance(L, int) else float(L.float().mean())} "
            f"div={float(info.diverging.to(eps.dtype).mean()):.4f}",
            flush=True,
        )


def _welfords(qs, k: int):
    # a mass window's empty accumulators: the variances, and the
    # covariance of the last k coordinates (None: k = 0)
    dim, dt, dev = qs.shape[1], qs.dtype, qs.device
    return (welford_init(dim, dt, dev),
            welford_cov_init(k, dt, dev) if k > 0 else None)


def _warmup_start(stepper: Stepper, config: SamplerConfig, beta_temp,
                  span) -> WarmupCarry:
    q0 = stepper.q0
    (C, dim), dt, dev = q0.shape, q0.dtype, q0.device
    with span("eps_init", wait=True):
        inv_mass = identity_mass(dim, config.dense_tail_size, dt, dev)
        eps0 = find_reasonable_step_size(
            lambda q: stepper.target(q, beta_temp), q0[:1], stepper.gen,
            inv_mass, config.initial_step_size)
    return WarmupCarry(q0, da_init(torch.tensor(eps0, dtype=dt, device=dev)),
                       *_welfords(q0, config.dense_tail_size), inv_mass,
                       torch.zeros((C,), dtype=dt, device=dev), [])


def _warmup(c: WarmupCarry, done: int, sched: Schedule, stepper: Stepper,
            temps, config: SamplerConfig, span, fingerprint) -> WarmupCarry:
    """Warmup's blocks from step ``done`` on, each checkpointed at its
    end."""
    ck, k = config.checkpoint_path, config.dense_tail_size
    for start, size in sched.warmup_blocks:
        if start + size <= done:
            continue
        stepper.bind(c.inv_mass)
        qs, da, wf, wf_tail, inv_mass, accept_sum, reseats = c
        with span("block", wait=True):
            for step in range(start, start + size):
                if step in sched.reseat_at:
                    qs, moved = reseat_stuck(
                        qs, accept_sum, step - sched.reseat_at[step],
                        config.reseat_accept_below, stepper.gen)
                    reseats.append((step, moved))
                    accept_sum.zero_()
                eps = torch.exp(da.log_step if da.count < sched.num_adapt
                                else da.log_step_avg)
                qs, info = stepper(qs, eps, inv_mass, step, temps[step])
                _progress(config, "warmup", step, eps, info)
                if step in sched.summed:
                    accept_sum += info.accept_prob
                if step < sched.num_adapt:
                    da = da_update(da, torch.mean(info.accept_prob),
                                   config.target_accept)
                if any(lo <= step < hi for lo, hi in sched.windows):
                    wf = welford_add_batch(wf, qs)
                    if wf_tail is not None:
                        wf_tail = welford_cov_add_batch(wf_tail, qs[:, -k:])
                if step in sched.closes:
                    var = welford_variance(wf)
                    if wf_tail is None:
                        inv_mass = var
                    else:
                        cov = welford_covariance(wf_tail,
                                                 config.dense_shrinkage)
                        if sched.closes[step]:
                            cov = torch.diag(torch.diag(cov))
                        inv_mass = mass_from_moments(var, cov)
                    # restart dual averaging around the current step size
                    # and the accumulators for a second window
                    da = da_init(torch.exp(da.log_step))
                    wf, wf_tail = _welfords(qs, k)
        c = WarmupCarry(qs, da, wf, wf_tail, inv_mass, accept_sum, reseats)
        if ck:
            _ckpt_save_state(ck, "warmup", start + size, {
                **c.arrays(), **stepper.rng_items()}, fingerprint)
    return c


def _sample(c: SampleCarry, done: int, sched: Schedule, stepper: Stepper,
            store: DrawStore, temps, config: SamplerConfig, span,
            fingerprint) -> SampleCarry:
    """Sampling's blocks, those that end by draw ``done`` loaded from the
    checkpoint, the others run and checkpointed at their ends."""
    ck, qs, eps, beta, swap = config.checkpoint_path, c.qs, c.eps, None, None
    (C, _), dt, dev = qs.shape, qs.dtype, qs.device
    if sched.betas is not None:
        # sampling at each chain's rung: its beta and a step scaled by
        # beta^(-1/2), both in the sampling dtype
        beta, scale = rung_temperatures(sched.betas, C, dt, dev)
        eps = c.eps * scale
    for b, (start, size) in enumerate(sched.sample_blocks):
        if ck and start + size <= done:
            store.load(ck, start, start + size)
            continue
        stepper.bind(c.inv_mass)
        if sched.betas is not None and swap is None:
            swap = BoundSwap(stepper.target, stepper.q0, sched.betas)
            swap.prop.copy_(c.swap_prop)
            swap.accs.copy_(c.swap_accs)
            c = c._replace(swap_prop=swap.prop, swap_accs=swap.accs)
        store.open(b, start, size)
        with span("block", wait=True):
            for i in range(start, start + size):
                for t in range(config.thin):
                    step = sched.B + i * config.thin + t
                    qs, info = stepper(qs, eps, c.inv_mass, step,
                                       temps[step] if beta is None else beta)
                    rel = step - sched.B
                    if swap is not None and (
                            (rel + 1) % config.pt_swap_every == 0):
                        u = torch.rand(
                            (len(sched.betas) - 1, C // len(sched.betas)),
                            generator=stepper.gen, dtype=dt, device=dev)
                        qs = swap(qs, u, (rel // config.pt_swap_every) % 2)
                    _progress(config, "sample", step, c.eps, info)
                store.put(i, qs, info)
        store.stage()
        c = c._replace(qs=qs)
        if ck:
            _ckpt_save_draws(ck, start, *store.host_block(start, start + size))
            _ckpt_save_state(ck, "sample", start + size, {
                **c.arrays(), **stepper.rng_items()}, fingerprint)
    return c


def run_chains(
    tempered_logp_grad: Callable,   # (q (C, dim), beta_temp) -> (logp, grad)
    q0: torch.Tensor,               # (C, dim) initial chain states
    seed: int,
    config: SamplerConfig = SamplerConfig(),
    shards: list | None = None,
    timer=untimed,
):
    """Warmup + sampling of C chains with ``config.algorithm``: "nuts"
    (``nuts.BoundNuts``) or "hmc" (jittered fixed-length HMC,
    ``hmc.BoundTransition``), on fixed buffers: a ``tempered_logp_grad``
    with a bound evaluation (``bind``, as every target ``predict`` builds)
    is bound to them, as CUDA graphs on the card; any other callable is
    evaluated eagerly into them, with the same draws.

    With two rungs or more in ``config.pt_betas`` (sampler/pt.py), chain c
    samples at its rung's beta and step eps * beta^(-1/2) after warmup,
    and a swap round follows every ``pt_swap_every``-th sampling
    transition, its uniforms drawn after the transition's; samples and
    stats keep every rung (``predict`` returns the beta = 1 rung), and
    ``stats.pt_swap_accept`` holds each pair's acceptance.

    ``shards``: see ``Stepper`` (``make_shards``; ``parallel.
    run_chains_sharded`` makes them). Returns (samples (num_results, C,
    dim), ChainStats), on the first shard's device, or in host memory when
    the run stages its draws (``DrawStore``). ``dispatch_block_steps``,
    ``checkpoint_path`` and ``profile_timings``: see the module's
    docstring; with ``profile_timings`` the run's spans go into ``timer``
    where it traces (a ``PhaseTimer`` made with ``trace=True``), under the
    span open there now, else into a recorder of the run's own.
    """
    algorithm = config.algorithm
    if algorithm not in ("nuts", "hmc"):
        raise ValueError(f"unknown algorithm {algorithm!r}; expected "
                         "'nuts' or 'hmc'")
    pin_full_float32_matmuls()
    C, dim = q0.shape
    sched = Schedule(config, C)
    stepper = Stepper(algorithm == "nuts", config, tempered_logp_grad, q0,
                      seed, shards, per_chain=sched.betas is not None)
    q0, dev = stepper.q0, stepper.device
    rec = None
    if config.profile_timings:
        # its spans wait for the first shard's device: the states are
        # gathered there every transition, after every shard's work
        rec = timer if timer.trace else PhaseTimer(dev, trace=True)
        first_span, parent = len(rec.spans), rec.innermost()
    stepper.recorder = rec
    span = untimed.span if rec is None else rec.span
    temps = torch.as_tensor(sched.temps, dtype=q0.dtype, device=dev)
    ck = config.checkpoint_path
    fingerprint = _ckpt_fingerprint(config, C, dim, seed, q0) if ck else ""
    phase, done, arrays = ((ck and _ckpt_load_state(ck, fingerprint))
                           or (None, 0, None))
    if arrays is not None:
        stepper.set_rng(arrays)
    if phase == "sample":
        # warmup finished in an earlier call
        carry = SampleCarry.load(arrays, dev)
    else:
        warm = (WarmupCarry.load(arrays, dev) if phase == "warmup"
                else _warmup_start(stepper, config, temps[0], span))
        stepper.anchor(sched.transitions)
        with span("warmup", wait=True, hold_gc=True) as warmup_span:
            warm = _warmup(warm, done, sched, stepper, temps, config, span,
                           fingerprint)
            eps = torch.exp(warm.da.log_step_avg)
            if rec is not None:
                warmup_span.attrs["chains_reseated"] = sum(
                    n for _, n in warm.reseats)
                warmup_span.attrs["reseats"] = [list(r) for r in warm.reseats]
        swaps = [] if sched.betas is None else [
            torch.zeros((len(sched.betas) - 1,), dtype=torch.int32,
                        device=dev) for _ in range(2)]
        carry, done = SampleCarry(warm.qs, eps, warm.inv_mass, *swaps), 0
        if ck:
            _ckpt_save_state(ck, "sample", 0, {
                **carry.arrays(), **stepper.rng_items()}, fingerprint)
    store = DrawStore(algorithm == "nuts", config, sched.sample_blocks, q0,
                      rec)
    stepper.anchor(sched.transitions)
    with span("sample", wait=True, hold_gc=True) as sample_span:
        carry = _sample(carry, done, sched, stepper, store, temps, config,
                        span, fingerprint)
        store.drain()
    if rec is not None:
        rec.resolve_marks()
        if config.num_results:
            # the lowest mean acceptance of a chain over the phase's draws
            sample_span.attrs["worst_chain_accept"] = float(
                store.arrays["accept"].mean(dim=0).min())
    out = store.stats()
    return out["samples"], ChainStats(
        step_size=carry.eps,
        inv_mass=mass_diag(carry.inv_mass),
        accept_probs=out["accept"],
        num_leapfrogs=out["num_leapfrogs"],
        divergences=out["diverging"],
        depths=out["depths"],
        tail_inv_mass=mass_tail_inv(carry.inv_mass),
        pt_swap_accept=(None if sched.betas is None else swap_acceptance(
            carry.swap_prop, carry.swap_accs, q0.dtype)),
        timings=(None if rec is None
                 else sampler_timings(rec.spans[first_span:], parent)),
    )
