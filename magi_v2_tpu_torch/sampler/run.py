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

Warmup's re-seat rule (``reseat_accept_below``; the JAX package has
none): at each boundary of ``reseat_stretches`` (the start of each mass
window, the end of step-size adaptation, at the latest four fifths into
burn-in) the host reads once each chain's acceptance, summed on the device
over the last twentieth of burn-in before it; where fewer than half the
chains are below the threshold, each of them moves to the current state of
a chain drawn with the run's generator from the others (``reseat_stuck``;
momenta are drawn afresh every transition). Sampling is untouched. Where
no chain is below, nothing is drawn and the draws are the rule off's bits.

Parallel tempering (``pt_betas``: sampler/pt.py) tempers the sampling
phase per chain and swaps adjacent rungs every ``pt_swap_every``
transitions; warmup is shared by all chains, as in the JAX package.

``dispatch_block_steps`` cuts warmup and sampling into blocks of
transitions (a thinned draw costs ``thin`` of them), as the JAX package's
dispatch blocks. Here a block is only a checkpoint boundary: its size
changes no draw. With ``checkpoint_path`` each boundary writes the carry
to ``state.npz`` (atomically: a temporary file, then ``os.replace``) and
each sampling block its draws and per-draw statistics to
``draws_NNNNNN.npz``; a second identical call resumes bit for bit from the
last boundary, or loads a finished run from disk without a transition.
The carry holds the chain states, the dual-averaging state, both Welford
accumulators, the inverse mass (each tensor with its strides), the step
size, the device generator's state, the host NumPy generator's (HMC's
trajectory lengths), warmup's re-seat sums and record and, under PT,
the swap counters; the bound transitions are rebuilt on resume. A
fingerprint of the run refuses a checkpoint of another.

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
from typing import Callable, NamedTuple

import numpy as np
import torch

from magi_v2_tpu_torch.sampler.hmc import BoundTransition, HmcInfo, hmc_step
from magi_v2_tpu_torch.sampler.nuts import (
    BoundNuts,
    NutsConfig,
    NutsInfo,
    NutsNoise,
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


def _welford_items(name, w):
    if w is None:
        return {}
    return {f"{name}_count": w.count, f"{name}_mean": w.mean,
            f"{name}_m2": w.m2}


def _mass_items(inv_mass):
    if isinstance(inv_mass, TailDenseMass):
        return {"mass_diag": inv_mass.diag, "mass_tail_inv": inv_mass.tail_inv,
                "mass_tail_msqrt": inv_mass.tail_msqrt}
    return {"mass_diag": inv_mass}


def _ckpt_tensor(arrays, name, device):
    """The carry's tensor ``name`` on ``device``, with the strides it was
    saved with (a product's bits may depend on its operands' layout)."""
    a = arrays[name]
    t = torch.empty_strided(a.shape, tuple(arrays[f"_stride_{name}"]),
                            dtype=torch.from_numpy(a).dtype, device=device)
    return t.copy_(torch.from_numpy(a))


def _ckpt_welford(arrays, name, device) -> Welford:
    return Welford(float(arrays[f"{name}_count"]),
                   _ckpt_tensor(arrays, f"{name}_mean", device),
                   _ckpt_tensor(arrays, f"{name}_m2", device))


def _ckpt_mass(arrays, device):
    diag = _ckpt_tensor(arrays, "mass_diag", device)
    if "mass_tail_inv" not in arrays:
        return diag
    return TailDenseMass(diag, _ckpt_tensor(arrays, "mass_tail_inv", device),
                         _ckpt_tensor(arrays, "mass_tail_msqrt", device))


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


def _target_on(target, device):
    """The target's copy on ``device`` (``target.to``), or the callable
    itself when it has no ``to``."""
    return target.to(device) if hasattr(target, "to") else target


def _mass_on(inv_mass, device):
    """The inverse mass on ``device``: the same object when it is there."""
    parts = inv_mass if isinstance(inv_mass, TailDenseMass) else (inv_mass,)
    if all(t.device == device for t in parts):
        return inv_mass
    if isinstance(inv_mass, TailDenseMass):
        return TailDenseMass(*(t.to(device) for t in inv_mass))
    return inv_mass.to(device)


def make_shards(target, C: int, mesh) -> list:
    """One ``Shard`` per entry of ``mesh`` (a sequence of devices, an entry
    per shard, repeats allowed): contiguous chain ranges of C / len(mesh),
    each with the target moved to its device."""
    k = len(mesh)
    if k == 0 or C % k:
        raise ValueError(f"num chains {C} must be a multiple of mesh size "
                         f"{k}")
    M = C // k
    return [Shard(i * M, (i + 1) * M, torch.device(d), _target_on(target, d))
            for i, d in enumerate(mesh)]


def run_chains(
    tempered_logp_grad: Callable,   # (q (C, dim), beta_temp) -> (logp, grad)
    q0: torch.Tensor,               # (C, dim) initial chain states
    seed: int,
    config: SamplerConfig = SamplerConfig(),
    shards: list | None = None,
    timer=untimed,
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

    ``shards`` (``make_shards``; ``parallel.run_chains_sharded`` makes
    them) splits each transition over chain ranges, each on its shard's
    device with its own target, workspaces and bound transition; the
    states, the noise and everything pooled (dual averaging's mean
    acceptance, the Welford moments, the swap rounds, the checkpoint
    carry) live gathered, (C, ...), on the first shard's device. None is
    one shard: q0's device and ``tempered_logp_grad`` itself, with no
    slicing and no gather.

    Returns (samples (num_results, C, dim), ChainStats): on the first
    shard's device, or in host memory when the run stages its draws
    (``config.stage_above_bytes``). The momenta and uniforms of all C
    chains come from a ``torch.Generator`` on that device seeded with
    ``seed``, a swap round's uniforms after its transition's; HMC's
    trajectory lengths from a NumPy generator on the host with the same
    seed. So a sharded run draws what the unsharded one draws.
    ``config.dispatch_block_steps``, ``checkpoint_path`` and
    ``profile_timings``: see the module's docstring; with
    ``profile_timings`` the run's spans go into ``timer`` where it traces
    (a ``PhaseTimer`` made with ``trace=True``), under the span open there
    now, else into a recorder of the run's own.
    """
    if config.algorithm not in ("nuts", "hmc"):
        raise ValueError(f"unknown algorithm {config.algorithm!r}; expected "
                         "'nuts' or 'hmc'")
    nuts = config.algorithm == "nuts"
    pin_full_float32_matmuls()
    C, dim = q0.shape
    if shards is None:
        shards = [Shard(0, C, q0.device, tempered_logp_grad)]
    dtype, dev = q0.dtype, shards[0].device
    q0 = q0.to(dev)
    tempered_logp_grad = shards[0].target
    single = len(shards) == 1
    betas = check_ladder(config, C)
    pt = betas is not None
    rec = None
    if config.profile_timings:
        # its spans wait for the first shard's device: the states are
        # gathered there every transition, after every shard's work
        rec = timer if timer.trace else PhaseTimer(dev, trace=True)
        first_span, parent = len(rec.spans), rec.innermost()
    span = untimed.span if rec is None else rec.span
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

    # the re-seat rule's {boundary: stretch start}, and the steps it sums
    reseat_at = {}
    if config.reseat_accept_below > 0.0:
        reseat_at = reseat_stretches(
            B, num_adapt, ((win_lo,) if adapt_mass else ())
            + ((win2_lo,) if two_windows else ()))
    summed = {s for b, lo in reseat_at.items() for s in range(lo, b)}

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
        if not config.hmc_jitter:
            return config.hmc_num_leapfrogs
        return max(1, math.ceil(host_rng.random() * config.hmc_num_leapfrogs))

    # a target with a bound evaluation runs on fixed buffers, and on the
    # card as replayed CUDA graphs, made once the first mass is known: one
    # bound transition per shard
    bounds = None
    masses = {"src": None, "per_shard": None}

    nuts_cfg = NutsConfig(config.max_tree_depth, config.max_energy_diff)

    def shard_masses(inv_mass):
        """Each shard's copy of the mass, remade when the mass changes."""
        if inv_mass is not masses["src"]:
            masses["src"] = inv_mass
            masses["per_shard"] = [_mass_on(inv_mass, sh.device)
                                   for sh in shards]
        return masses["per_shard"]

    def shard_step(i, qs, eps, inv_mass, beta_temp, noise):
        bound = bounds[i]
        if nuts:
            return bound(qs, eps, inv_mass, beta_temp, noise)
        L, normals, uniforms = noise
        if bound is not None:
            return bound(qs, eps, inv_mass, beta_temp, L, normals, uniforms,
                         config.max_energy_diff)
        target = shards[i].target
        return hmc_step(
            lambda q: target(q, beta_temp), qs, eps, inv_mass, L, normals,
            uniforms, config.max_energy_diff,
        )

    def part(t, sh):
        """Shard ``sh``'s rows of a per-chain tensor (a 0-dim one whole),
        on its device."""
        if t.dim() and t.shape[0] == C:
            t = t[sh.lo:sh.hi]
        return t.to(sh.device)

    def gather(outs):
        qs = torch.cat([q.to(dev) for q, _ in outs])
        infos = [info for _, info in outs]
        cat = lambda f: torch.cat([getattr(x, f).to(dev) for x in infos])
        if nuts:
            return qs, NutsInfo(*(cat(f) for f in NutsInfo._fields))
        return qs, HmcInfo(cat("accept_prob"), infos[0].num_leapfrogs,
                           cat("diverging"))

    def transition(qs, eps, inv_mass, step, beta_temp=None):
        if beta_temp is None:
            beta_temp = temps[step]
        if nuts:
            noise = draw_noise(gen, C, dim, nuts_cfg.max_tree_depth, dtype,
                               dev)
        else:
            normals = torch.randn((C, dim), generator=gen, dtype=dtype,
                                  device=dev)
            uniforms = torch.rand((C,), generator=gen, dtype=dtype,
                                  device=dev)
            noise = (draw_num_leapfrogs(), normals, uniforms)
        if rec is None:
            return step_all(qs, eps, inv_mass, beta_temp, noise)
        s = rec.open("transition", step=step)
        rec.mark(s, "dev_t0_ns")
        out = step_all(qs, eps, inv_mass, beta_temp, noise)
        rec.mark(s, "dev_t1_ns")
        rec.close(s)
        return out

    def step_all(qs, eps, inv_mass, beta_temp, noise):
        """One transition of every shard's chains, gathered."""
        if single:
            return shard_step(0, qs, eps, inv_mass, beta_temp, noise)
        per = shard_masses(inv_mass)
        outs = []
        for i, sh in enumerate(shards):
            if nuts:
                sh_noise = NutsNoise(*(part(t, sh) for t in noise))
            else:
                sh_noise = (noise[0], part(noise[1], sh), part(noise[2], sh))
            outs.append(shard_step(i, part(qs, sh), part(eps, sh), per[i],
                                   part(beta_temp, sh), sh_noise))
        return gather(outs)

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
    ck = config.checkpoint_path
    fingerprint = _ckpt_fingerprint(config, C, dim, seed, q0) if ck else ""
    resume = _ckpt_load_state(ck, fingerprint) if ck else None

    def restore(arrays, name):
        return _ckpt_tensor(arrays, name, dev)

    def rng_state():
        return {"gen": gen.get_state(),
                "host_rng": json.dumps(host_rng.bit_generator.state)}

    def set_rng_state(arrays):
        gen.set_state(torch.from_numpy(arrays["gen"]))
        host_rng.bit_generator.state = json.loads(str(arrays["host_rng"]))

    def make_bound(inv_mass):
        nonlocal bounds
        per = [inv_mass] if single else shard_masses(inv_mass)
        bounds = []
        for sh, mass in zip(shards, per):
            q0_sh = q0 if single else q0[sh.lo:sh.hi].to(sh.device)
            if nuts:
                bounds.append(BoundNuts(sh.target, q0_sh, mass, nuts_cfg,
                                        per_chain=pt))
            elif hasattr(sh.target, "bind"):
                bounds.append(BoundTransition(sh.target, q0_sh, mass,
                                              per_chain=pt))
            else:
                bounds.append(None)
        for b in bounds:
            if b is not None:
                b.recorder = rec

    T = config.num_results

    def anchor():
        """The device markers' start before the first sampling phase
        that runs (``PhaseTimer.anchor`` starts them once), with an event
        for each marker the run can make: two a transition, two a
        doubling."""
        if rec is not None and single:
            per = 2 + (2 * config.max_tree_depth if nuts else 0)
            rec.anchor((B + T * config.thin) * per)

    sample_done = 0
    swap = swap_counts = None

    def sample_carry():
        counts = (swap.prop, swap.accs) if swap is not None else swap_counts
        return {"qs": qs, "eps": eps_final, **_mass_items(inv_mass),
                **rng_state(),
                **({"swap_prop": counts[0], "swap_accs": counts[1]}
                   if pt else {})}

    if resume is not None and resume[0] == "sample":
        # warmup finished in an earlier call: its carry
        _, sample_done, arrays = resume
        qs = restore(arrays, "qs")
        eps_final = restore(arrays, "eps")
        inv_mass = _ckpt_mass(arrays, dev)
        set_rng_state(arrays)
        if pt:
            swap_counts = (restore(arrays, "swap_prop"),
                           restore(arrays, "swap_accs"))
    else:
        if resume is not None:
            # a warmup block boundary
            _, warmup_done, arrays = resume
            qs = restore(arrays, "qs")
            da = DAState(*(restore(arrays, f"da_{f}")
                           for f in DAState._fields[:4]),
                         float(arrays["da_count"]))
            wf = _ckpt_welford(arrays, "wf", dev)
            wf_tail = _ckpt_welford(arrays, "wf_tail", dev) if k > 0 else None
            inv_mass = _ckpt_mass(arrays, dev)
            accept_sum = restore(arrays, "reseat_accept_sum")
            reseats = [tuple(int(v) for v in r) for r in arrays["reseats"]]
            set_rng_state(arrays)
        else:
            with span("eps_init", wait=True):
                inv_mass = identity_mass(dim, k, dtype, dev)
                eps0 = find_reasonable_step_size(
                    lambda q: tempered_logp_grad(q, temps[0]), q0[:1], gen,
                    inv_mass, config.initial_step_size,
                )
            da = da_init(torch.tensor(eps0, dtype=dtype, device=dev))
            wf = welford_init(dim, dtype, dev)
            wf_tail = welford_cov_init(k, dtype, dev) if k > 0 else None
            qs, warmup_done = q0, 0
            # each chain's acceptance summed over the re-seat stretch, and
            # (boundary, chains moved) at each boundary read
            accept_sum = torch.zeros((C,), dtype=dtype, device=dev)
            reseats = []
        anchor()
        with span("warmup", wait=True, hold_gc=True) as warmup_span:
            for start, size in _blocks(B, config.dispatch_block_steps):
                if start + size <= warmup_done:
                    continue
                if bounds is None:
                    make_bound(inv_mass)
                with span("block", wait=True):
                    for step in range(start, start + size):
                        if step in reseat_at:
                            qs, moved = reseat_stuck(
                                qs, accept_sum, step - reseat_at[step],
                                config.reseat_accept_below, gen)
                            reseats.append((step, moved))
                            accept_sum.zero_()
                        eps = torch.exp(da.log_step
                                        if da.count < num_adapt
                                        else da.log_step_avg)
                        qs, info = transition(qs, eps, inv_mass, step)
                        progress("warmup", step, eps, info)
                        if step in summed:
                            accept_sum += info.accept_prob
                        if step < num_adapt:
                            da = da_update(da,
                                           torch.mean(info.accept_prob),
                                           config.target_accept)
                        if not adapt_mass:
                            continue
                        in_window = win_lo <= step < win_hi or (
                            two_windows and win2_lo <= step < win2_hi)
                        if in_window:
                            wf = welford_add_batch(wf, qs)
                            if wf_tail is not None:
                                wf_tail = welford_cov_add_batch(
                                    wf_tail, qs[:, -k:])
                        if step == win_hi or (two_windows
                                              and step == win2_hi):
                            var = welford_variance(wf)
                            if wf_tail is None:
                                inv_mass = var
                            else:
                                cov = welford_covariance(
                                    wf_tail, config.dense_shrinkage)
                                if (two_windows
                                        and config.mass_window1_diag
                                        and step == win_hi):
                                    cov = torch.diag(torch.diag(cov))
                                inv_mass = mass_from_moments(var, cov)
                            # restart dual averaging around the current
                            # step size and the accumulators for a second
                            # window
                            da = da_init(torch.exp(da.log_step))
                            wf = welford_init(dim, dtype, dev)
                            wf_tail = (welford_cov_init(k, dtype, dev)
                                       if k > 0 else None)
                if ck:
                    _ckpt_save_state(ck, "warmup", start + size, {
                        "qs": qs, **{f"da_{f}": getattr(da, f)
                                     for f in DAState._fields},
                        **_welford_items("wf", wf),
                        **_welford_items("wf_tail", wf_tail),
                        **_mass_items(inv_mass), **rng_state(),
                        "reseat_accept_sum": accept_sum,
                        "reseats": np.asarray(reseats, np.int64).reshape(
                            -1, 2)}, fingerprint)
            eps_final = torch.exp(da.log_step_avg)
            if rec is not None:
                warmup_span.attrs["chains_reseated"] = sum(
                    n for _, n in reseats)
                warmup_span.attrs["reseats"] = [list(r) for r in reseats]
        if pt:
            swap_counts = tuple(torch.zeros((len(betas) - 1,),
                                            dtype=torch.int32, device=dev)
                                for _ in range(2))
        if ck:
            _ckpt_save_state(ck, "sample", 0, sample_carry(), fingerprint)

    beta_s = eps_s = None
    if pt:
        # sampling at each chain's rung: its beta and a step scaled by
        # beta^(-1/2), both in the sampling dtype
        beta_s, scale = rung_temperatures(betas, C, dtype, dev)
        eps_s = eps_final * scale

    blocks = _blocks(T, config.dispatch_block_steps, config.thin)
    # draws of more than stage_above_bytes, and a checkpointed run's, are
    # staged: each block is computed into a device buffer and copied into
    # host memory (pinned on the card); the device holds a block's draws
    stage_host = bool(ck) or (
        config.dispatch_block_steps > 0
        and T * C * dim * q0.element_size() > config.stage_above_bytes)
    out_dev = torch.device("cpu") if stage_host else dev
    pin = stage_host and dev.type == "cuda"

    def out(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=out_dev, pin_memory=pin)

    samples = out(T, C, dim)
    accept = out(T, C)
    diverging = out(T, C, dt=torch.bool)
    num_leapfrogs = (out(T, C, dt=torch.int32) if nuts
                     else np.empty((T, C), np.int32))
    depths = out(T, C, dt=torch.int32) if nuts else None
    # the per-draw tensors a block writes on the device (when staged, into
    # a device buffer first)
    per_draw = {"samples": samples, "accept": accept,
                 "diverging": diverging,
                 **({"num_leapfrogs": num_leapfrogs, "depths": depths}
                    if nuts else {})}
    info_arrays = {"accept": accept, "diverging": diverging,
                   "num_leapfrogs": num_leapfrogs,
                   **({"depths": depths} if nuts else {})}
    bufs = copy_stream = None
    if stage_host:
        # two device buffers on the card, so that a block's copy (on a
        # stream of its own, after the block's last write) overlaps the
        # next block's compute, as the JAX package's finalize_block
        # overlaps its fetch; one where the copy is synchronous (the CPU,
        # or a checkpoint, whose files need the block on the host)
        nbuf = 2 if dev.type == "cuda" and not ck else 1
        bmax = max(size for _, size in blocks)
        bufs = [{name: torch.empty((bmax,) + a.shape[1:], dtype=a.dtype,
                                   device=dev)
                 for name, a in per_draw.items()} for _ in range(nbuf)]
        copied = [None] * nbuf
        if nbuf == 2:
            copy_stream = torch.cuda.Stream(dev)

    def stage(j, start, size, views):
        """Block [start, start + size)'s draws and stats, from device
        buffer j into the host arrays."""
        if copy_stream is None:
            for name, v in views.items():
                per_draw[name][start:start + size].copy_(v)
        else:
            done = torch.cuda.current_stream(dev).record_event()
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(done)
                for name, v in views.items():
                    per_draw[name][start:start + size].copy_(
                        v, non_blocking=True)
                copied[j] = copy_stream.record_event()
        if rec is not None:
            rec.count("staged_bytes", sum(
                v.numel() * v.element_size() for v in views.values()) + (
                0 if nuts else num_leapfrogs[start:start + size].nbytes))

    anchor()
    with span("sample", wait=True, hold_gc=True) as sample_span:
        for b, (start, size) in enumerate(blocks):
            end = start + size
            if ck and end <= sample_done:
                loaded = _ckpt_load_draws(ck, start)
                if loaded is None:
                    raise FileNotFoundError(
                        f"checkpoint state at {ck!r} marks block {start} "
                        f"complete but draws_{start:06d}.npz is missing; "
                        "delete state.npz to restart")
                samples[start:end] = torch.from_numpy(loaded[0])
                for name, arr in info_arrays.items():
                    arr[start:end] = (torch.from_numpy(loaded[1][name])
                                      if isinstance(arr, torch.Tensor)
                                      else loaded[1][name])
                continue
            if bounds is None:
                make_bound(inv_mass)
            if pt and swap is None:
                swap = BoundSwap(tempered_logp_grad, q0, betas)
                swap.prop.copy_(swap_counts[0])
                swap.accs.copy_(swap_counts[1])
            if stage_host:
                j = b % len(bufs)
                if copied[j] is not None:
                    # the buffer's last copy must be done before it is
                    # rewritten
                    torch.cuda.current_stream(dev).wait_event(copied[j])
                views = {name: buf[:size] for name, buf in bufs[j].items()}
            else:
                views = {name: a[start:end] for name, a in per_draw.items()}
            with span("block", wait=True):
                for i in range(start, end):
                    for t in range(config.thin):
                        step = B + i * config.thin + t
                        if not pt:
                            qs, info = transition(qs, eps_final, inv_mass,
                                                  step)
                        else:
                            qs, info = transition(qs, eps_s, inv_mass, step,
                                                  beta_s)
                            rel = step - B
                            if (rel + 1) % config.pt_swap_every == 0:
                                u = torch.rand(
                                    (len(betas) - 1, C // len(betas)),
                                    generator=gen, dtype=dtype, device=dev)
                                qs = swap(qs, u,
                                          (rel // config.pt_swap_every) % 2)
                        progress("sample", step, eps_final, info)
                    n = i - start
                    views["samples"][n] = qs
                    views["accept"][n] = info.accept_prob
                    views["diverging"][n] = info.diverging
                    if nuts:
                        views["num_leapfrogs"][n] = info.num_leapfrogs
                        views["depths"][n] = info.depth
                    else:
                        num_leapfrogs[i] = info.num_leapfrogs
            if stage_host:
                with span("stage"):
                    stage(j, start, size, views)
            if ck:
                # the block's draws, on the host, to disk with the carry
                i_blk = {name: (arr[start:end].numpy()
                                if isinstance(arr, torch.Tensor)
                                else arr[start:end].copy())
                         for name, arr in info_arrays.items()}
                _ckpt_save_draws(ck, start, samples[start:end].numpy(),
                                 i_blk)
                _ckpt_save_state(ck, "sample", end, sample_carry(),
                                 fingerprint)
        with span("drain", wait=True):
            if rec is not None and copy_stream is not None:
                copy_stream.synchronize()
    if rec is not None:
        rec.resolve_marks()
        if T:
            # the lowest mean acceptance of a chain over the phase's draws
            sample_span.attrs["worst_chain_accept"] = float(
                accept.mean(dim=0).min())
    if copy_stream is not None:
        # the host arrays are read from here on
        copy_stream.synchronize()
    if nuts:
        num_leapfrogs, depths = num_leapfrogs.cpu().numpy(), \
            depths.cpu().numpy()
    else:
        depths = np.ceil(np.log2(np.maximum(num_leapfrogs, 1))).astype(
            np.int32)
    counts = (swap.prop, swap.accs) if swap is not None else swap_counts
    stats = ChainStats(
        step_size=eps_final,
        inv_mass=mass_diag(inv_mass),
        accept_probs=accept,
        num_leapfrogs=num_leapfrogs,
        divergences=diverging,
        depths=depths,
        tail_inv_mass=mass_tail_inv(inv_mass),
        pt_swap_accept=swap_acceptance(*counts, dtype) if pt else None,
        timings=(None if rec is None
                 else sampler_timings(rec.spans[first_span:], parent)),
    )
    return samples, stats
