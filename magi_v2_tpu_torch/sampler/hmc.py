"""Fixed-length (jittered) HMC transition for all chains at once
(counterpart of magi_v2_tpu/sampler/hmc.py), with the leapfrog update as
kernel K2 (csrc/leapfrog.cu) and, on the card, each leapfrog replayed as a
CUDA graph.

Chains are the leading axis of ``q`` (C, dim); every chain runs exactly
``num_leapfrogs`` leapfrogs, a Python int drawn on the host by the caller,
so the loop needs no device value. Step size and mass stay on the device:
nothing in the transition waits for the card.

``leapfrog_update`` is K2's wrapper and ``bind_leapfrog`` its bound form
(arguments checked and converted once): for a CPU tensor they run the plain
version (``leapfrog_update_plain``, the same operations in the same order
as the JAX loop body, so a transition is reproducible bit for bit); for a
CUDA tensor they launch the kernel or raise. K2 takes every mass form in
one launch (a diagonal, a dense tail block, the full dense metric of any
width), and NUTS's leaf form (a signed step per chain, a mask of the
chains that move, the velocities out; sampler/nuts.py). It updates q and
p in place. ``LAUNCH_COUNTS`` counts kernel launches only.

Two forms of one transition, which give the same bits:

- ``hmc_step``: eager, for any ``logp_grad`` callable (the analytic
  targets of the tests); a new lp and grad at each evaluation.
- ``BoundTransition``: on fixed buffers, to which a target with a bound
  evaluation (``target.bind(q, beta_temp, lp, grad)``, as ``GNTarget``
  and ``PinnedSigma`` have) is bound and into which any other callable is
  evaluated eagerly. For a bound target on the card it captures three
  steps as CUDA graphs once (the evaluation at the start; the first
  leapfrog, K2 with one kick and the drift, then the evaluation; every
  later leapfrog, K2 with two kicks and the drift, then the evaluation) and
  replays them: L + 1 replays per transition, the two kinetic-energy K2
  launches and the accept test eager around them. The step size,
  temperature, state and mass of each transition are copied into the
  buffers, never recaptured. The step size and the temperature are one per
  chain, (C,): a 0-dim value is copied into every chain's entry, so that
  one set of graphs serves annealed, fixed-temperature and tempered
  (parallel tempering: a rung's beta and step per chain) sampling. On the
  CPU it runs the same steps eagerly.
  A capture or replay that fails raises; there is no other path on the
  card.

A bound transition's ``recorder`` (a ``utils.profiling.PhaseTimer``, set
by ``run_chains`` when it traces; None otherwise) counts each step's
replays ("replays.<step>") and the host ns spent in them
("replay_ns.<step>", the whole of ``CapturedStep.replay``) into the
trace; on the CPU the eager steps are counted alike. ``GRAPH_COUNTS``
counts the card's replays of the process, whether or not a recorder is
set.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, NamedTuple

import torch

from magi_v2_tpu_torch.ops.banded import launch_stream
from magi_v2_tpu_torch.sampler.mass import (
    TailDenseMass,
    mass_vel,
    momentum_from_normal,
)

KERNELS = ("leapfrog_update",)
LAUNCH_COUNTS = {k: 0 for k in KERNELS}
# captures made, and the replays of each captured step by its name (the
# names ``capture_steps`` was given: HMC's here, NUTS's in sampler/nuts.py),
# counted from the step's first capture
GRAPH_COUNTS = {"captures": 0}

# csrc/leapfrog.cu: a stream CTA's threads and elements a thread, a tail
# cluster's columns a thread group, most CTAs a cluster and most column
# groups a thread
_THREADS, _QUAD = 256, 4
_TAIL_COLS, _MAX_CLUSTER, _MAX_CPT = 64, 8, 8


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


def reset_graph_counts() -> None:
    for k in GRAPH_COUNTS:
        GRAPH_COUNTS[k] = 0


def graph_counts() -> dict:
    return dict(GRAPH_COUNTS)


class HmcInfo(NamedTuple):
    accept_prob: torch.Tensor   # (C,)
    num_leapfrogs: int
    diverging: torch.Tensor     # (C,) bool


def leapfrog_update_plain(q, p, g, step_size, inv_mass, nkick: int,
                          drift: bool, kinetic: bool, active=None, vel=None):
    """K2's plain version: p <- p + (eps/2) g ``nkick`` times; v = M^{-1} p
    (into ``vel`` when it is given); q <- q + eps v when ``drift``; returns
    0.5 p.v per chain when ``kinetic``, else None. ``step_size`` is 0-dim
    or one signed step per chain (C,); a chain whose ``active`` flag (C,
    bool) is False keeps its q and p."""
    if step_size.dim() == 1:
        step_size = step_size[:, None]
    half = 0.5 * step_size
    if active is None:
        for _ in range(nkick):
            torch.addcmul(p, g, half, out=p)
    elif nkick:
        kicked = p.clone()
        for _ in range(nkick):
            torch.addcmul(kicked, g, half, out=kicked)
        torch.where(active[:, None], kicked, p, out=p)
    if not (drift or kinetic or vel is not None):
        return None
    v = mass_vel(inv_mass, p)
    if vel is not None:
        vel.copy_(v)
    if drift:
        if active is None:
            torch.addcmul(q, v, step_size, out=q)
        else:
            torch.where(active[:, None], torch.addcmul(q, v, step_size), q,
                        out=q)
    return 0.5 * torch.sum(p * v, dim=-1) if kinetic else None


def _mass_parts(inv_mass):
    """(diag (dim,), tail_inv (k, k) or None, k) of an inverse mass."""
    if not isinstance(inv_mass, TailDenseMass):
        return inv_mass, None, 0
    return inv_mass.diag, inv_mass.tail_inv, inv_mass.k


def _tail_layout(k: int):
    """(column groups a tail thread owns, CTAs a cluster, column blocks a
    CTA) for a dense block of k columns, as csrc/leapfrog.cu picks them."""
    cpt = -(-k // (_MAX_CLUSTER * _TAIL_COLS))
    cpt = next((n for n in (1, 2, 4) if cpt <= n), _MAX_CPT)
    blocks = -(-k // (_TAIL_COLS * cpt))
    npass = -(-blocks // _MAX_CLUSTER)
    return cpt, -(-blocks // npass), npass


def tail_stride(k: int) -> int:
    """The row stride K2 reads a (k, k) dense inverse-mass block with: the
    columns its cluster covers, so that every CTA's share of a row starts
    on a 16-byte boundary."""
    cpt, jb, npass = _tail_layout(k)
    return jb * npass * _TAIL_COLS * cpt


def padded_tail(tail_inv):
    """A copy of the (k, k) block ``tail_inv`` as the (k, k) view of a
    zero-padded (k, ``tail_stride(k)``) tensor: K2's layout."""
    k = tail_inv.shape[-1]
    out = torch.zeros((k, tail_stride(k)), dtype=tail_inv.dtype,
                      device=tail_inv.device)[:, :k]
    out.copy_(tail_inv)
    return out


def kinetic_partials(dim: int, k: int) -> int:
    """Partial kinetic sums of one chain: one per stream CTA of its row's
    diagonal head and one per CTA of its dense block's cluster."""
    head = dim - k
    segs = -(-(-(-(head + _QUAD - 1) // _QUAD)) // _THREADS) if head else 0
    return segs + (_tail_layout(k)[1] if k else 0)


def _takes_plain(device) -> bool:
    """Whether a call on ``device`` runs the plain version: on the CPU
    only."""
    return device.type == "cpu"


_ENTRIES = {}


def _entry(dt):
    fn = _ENTRIES.get(dt)
    if fn is None:
        from magi_v2_tpu_torch.ops._build import load_library

        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"leapfrog_update takes float32 or float64, "
                            f"not {dt}")
        suffix = "f32" if dt == torch.float32 else "f64"
        fn = _ENTRIES[dt] = load_library().entry(
            f"magi_leapfrog_update_{suffix}", "leapfrog_update")
    return fn


def bind_leapfrog(q, p, g, step_size, inv_mass, nkick: int, drift: bool,
                  kinetic=None, active=None, vel=None):
    """K2 bound to its operands, checked here once: a callable of the
    stream that runs one leapfrog update on the tensors given now (on the
    CPU the plain version), q and p (C, dim) in place, the kinetic energies
    into ``kinetic`` (C,) and the velocities M^{-1} p into ``vel`` (C, dim)
    when they are given. ``step_size`` is a 0-dim tensor (HMC) or one
    signed step per chain (C,) (a NUTS leaf); a chain whose ``active`` (C,
    bool) flag is False keeps its q and p bit for bit. ``inv_mass`` is a
    diagonal or a ``TailDenseMass`` of any width whose tensors are read at
    each call, on the card only if its dense block is in K2's padded
    layout (``padded_tail``): another block is copied into it here."""
    dev, dt = q.device, q.dtype
    if q.dim() != 2:
        raise ValueError("q must be (C, dim)")
    C, dim = q.shape
    diag, tail_inv, k = _mass_parts(inv_mass)
    named = [("p", p), ("g", g), ("step_size", step_size), ("diag", diag)]
    named += [("tail_inv", tail_inv)] if k else []
    named += [("kinetic", kinetic)] if kinetic is not None else []
    named += [("vel", vel)] if vel is not None else []
    for name, t in named:
        if not (isinstance(t, torch.Tensor) and t.dtype == dt
                and t.device == dev):
            raise TypeError(f"{name} must be a {dt} tensor on {dev}")
    if p.shape != (C, dim) or g.shape != (C, dim) or (
            step_size.shape not in ((), (C,))):
        raise ValueError("q, p, g must be (C, dim) and step_size 0-dim or "
                         "(C,)")
    if diag.shape != (dim,) or (k and tail_inv.shape != (k, k)):
        raise ValueError(f"the inverse mass must be a ({dim},) diagonal "
                         f"with a (k, k) tail block")
    if kinetic is not None and kinetic.shape != (C,):
        raise ValueError(f"kinetic must be ({C},)")
    if vel is not None and vel.shape != (C, dim):
        raise ValueError(f"vel must be ({C}, {dim})")
    if active is not None and not (
            isinstance(active, torch.Tensor) and active.dtype == torch.bool
            and active.shape == (C,) and active.device == dev):
        raise TypeError(f"active must be a ({C},) bool tensor on {dev}")
    nkick, drift = int(nkick), bool(drift)
    if _takes_plain(dev):
        def run(stream=None):
            kin = leapfrog_update_plain(q, p, g, step_size, inv_mass, nkick,
                                        drift, kinetic is not None, active,
                                        vel)
            if kinetic is not None:
                kinetic.copy_(kin)
        return run
    if dev.type != "cuda":
        raise ValueError(f"leapfrog_update runs on cpu or cuda, not {dev}")
    touched = [("p", p)] + ([("g", g)] if nkick else []) + (
        [("q", q)] if drift else []) + ([("vel", vel)] if vel is not None
                                        else [])
    for name, t in touched:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    for name, t in (("the inverse-mass diagonal", diag),
                    ("step_size", step_size), ("active", active)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ld = tail_stride(k) if k else 0
    if k and (tail_inv.stride() != (ld, 1) or tail_inv.data_ptr() % 16):
        tail_inv = padded_tail(tail_inv)
    from magi_v2_tpu_torch.ops._build import Launch

    S = kinetic_partials(dim, k)
    part = ticket = None
    if kinetic is not None:
        part = torch.empty((C, S), dtype=dt, device=dev)
        ticket = torch.zeros((C,), dtype=torch.int32, device=dev)
    return Launch(_entry(dt),
                  [q, p, g, diag, tail_inv, step_size, k, ld, C, dim, nkick,
                   int(drift), step_size.dim(), active, vel, kinetic, part,
                   S, ticket],
                  LAUNCH_COUNTS, "leapfrog_update")


def leapfrog_update(q, p, g, step_size, inv_mass, nkick: int, drift: bool,
                    kinetic: bool, active=None, vel=None):
    """K2: the kicks, velocity, drift and kinetic energy of one leapfrog
    for every chain, q and p (C, dim) updated in place; ``step_size`` a
    0-dim tensor or one signed step per chain; ``active`` and ``vel`` as
    in ``bind_leapfrog``. Returns the kinetic energies (C,) when
    ``kinetic``."""
    kin = (torch.empty((q.shape[0],), dtype=q.dtype, device=q.device)
           if kinetic else None)
    bind_leapfrog(q, p, g, step_size, inv_mass, nkick, drift, kin, active,
                  vel)(launch_stream(q.device))
    return kin


def _metropolis(q, qc, logp0, kin0, logp, kin1, uniforms, L: int,
                max_energy_diff: float):
    """The accept test of a transition from q to the proposal qc."""
    H0 = -logp0 + kin0
    H1 = -logp + kin1
    dH = H1 - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH, float("inf")))
    accept_prob = torch.exp(torch.clamp(-dH, max=0.0))
    diverging = dH > max_energy_diff
    accept = (uniforms < accept_prob) & ~diverging
    q_out = torch.where(accept[:, None], qc, q)
    info = HmcInfo(
        accept_prob=torch.where(diverging, torch.zeros_like(accept_prob),
                                accept_prob),
        num_leapfrogs=L,
        diverging=diverging,
    )
    return q_out, info


def hmc_step(logp_grad: Callable, q, step_size, inv_mass, num_leapfrogs: int,
             normals, uniforms, max_energy_diff: float = 1000.0):
    """One Metropolis-corrected HMC transition of every chain.

    ``logp_grad(q (C, dim)) -> (logp (C,), grad (C, dim))``;
    ``step_size`` a 0-dim tensor or one per chain (C,); ``normals`` (C,
    dim) standard normals for the momenta and ``uniforms`` (C,) for the
    accept test — drawn by the caller, so a test can feed the numbers
    another sampler drew.

    The closing half-kick of one leapfrog and the opening half-kick of the
    next are one K2 launch (rounded in that order, as two kicks).
    """
    L = int(num_leapfrogs)
    logp0, grad0 = logp_grad(q)
    pc = momentum_from_normal(inv_mass, normals).contiguous()
    kin0 = leapfrog_update(q, pc, grad0, step_size, inv_mass, nkick=0,
                           drift=False, kinetic=True)
    qc, gc, logp = q.clone(), grad0, logp0
    for i in range(L):
        leapfrog_update(qc, pc, gc, step_size, inv_mass,
                        nkick=1 if i == 0 else 2, drift=True, kinetic=False)
        logp, gc = logp_grad(qc)
    kin1 = leapfrog_update(qc, pc, gc, step_size, inv_mass,
                           nkick=1 if L else 0, drift=False, kinetic=True)
    return _metropolis(q, qc, logp0, kin0, logp, kin1, uniforms, L,
                       max_energy_diff)


def _launch_counters():
    from magi_v2_tpu_torch.ops import banded, manifold, nuts, pt

    return (manifold.LAUNCH_COUNTS, banded.LAUNCH_COUNTS, LAUNCH_COUNTS,
            nuts.LAUNCH_COUNTS, pt.LAUNCH_COUNTS)


class CapturedStep:
    """A CUDA graph of one step and the kernel launches it holds, which
    each replay adds to the launch counts."""

    def __init__(self, graph, launches):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        for counts, new in zip(_launch_counters(), self.launches):
            for k, n in new.items():
                counts[k] += n


def run_step(bound, name: str) -> None:
    """Step ``name`` of a bound transition (``BoundTransition``,
    ``sampler/nuts.py:BoundNuts``): its graph's replay on the card, else
    the step run eagerly; with the bound's ``recorder`` the replay (or
    the eager step) and its host ns are counted under the step's name."""
    rec = bound.recorder
    t0 = None if rec is None else time.perf_counter_ns()
    if bound.graphs is not None:
        bound.graphs[name].replay()
        GRAPH_COUNTS[name] += 1
    else:
        bound.steps[name]()
    if rec is not None:
        dt = time.perf_counter_ns() - t0
        rec.count(f"replay_ns.{name}", dt)
        rec.count(f"replays.{name}")


def capture_steps(steps: dict, device) -> dict:
    """{name: CapturedStep} of the callables ``steps`` (each runs on the
    current stream and allocates nothing it keeps). Each runs once on the
    capture stream first, so that every first-launch setting (a kernel's
    shared-memory attribute, the card's SM count, cuBLAS's workspace) is
    made before any capture; the graphs share one memory pool. A capture
    records launches and runs none: its launch counts are taken back and
    added at each replay instead. Python's garbage collector is held off
    while the graphs are captured: a collection in a capture could free an
    earlier run's graphs or events (cyclic garbage), a CUDA call that
    invalidates the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        return _capture_steps(steps, device)
    finally:
        if collecting:
            gc.enable()


def _capture_steps(steps: dict, device) -> dict:
    counters = _launch_counters()
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        for fn in steps.values():
            fn()
    current.wait_stream(stream)
    graphs, pool = {}, None
    for name, fn in steps.items():
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
        pool = graph.pool()
        launches = []
        for counts, was in zip(counters, before):
            launches.append({k: counts[k] - was[k] for k in counts
                             if counts[k] != was[k]})
            counts.update(was)
        graphs[name] = CapturedStep(graph, launches)
    GRAPH_COUNTS["captures"] += len(graphs)
    for name in graphs:
        GRAPH_COUNTS.setdefault(name, 0)
    return graphs


class BoundBuffers:
    """What the bound transitions (``BoundTransition``, ``nuts.BoundNuts``)
    share: the state, step size, temperature and mass buffers, the target's
    evaluation into them, a transition's arguments copied in, and the
    steps' capture where the target binds and the state lies on the card."""

    def _buffers(self, q0, inv_mass, per_chain: bool) -> None:
        C, dt, dev = q0.shape[0], q0.dtype, q0.device
        self.device, self.per_chain = dev, per_chain
        self.q = q0.clone(memory_format=torch.contiguous_format)
        # step size 0 until the first transition: the warm-up before the
        # captures then leaves q where it is
        self.step_size = torch.zeros((C,), dtype=dt, device=dev)
        self.beta_temp = torch.ones((C,), dtype=dt, device=dev)
        # tail_inv in K2's padded layout, so that its launches read it
        diag, tail_inv, self.k = _mass_parts(inv_mass)
        self.diag = diag.clone()
        self.tail_inv = padded_tail(tail_inv) if self.k else None
        self.mass = (TailDenseMass(self.diag, self.tail_inv, None) if self.k
                     else self.diag)
        self._mass_src = inv_mass

    def _evaluation(self, target):
        """The target at q into lp and g, at the (C,) temperatures with
        ``per_chain``, else at the first: its bound evaluation where it has
        one (``target.bind``), else an eager adapter, which evaluates
        ``target(q, beta_temp)`` and copies the result in."""
        beta = self.beta_temp if self.per_chain else self.beta_temp[0]
        if hasattr(target, "bind"):
            return target.bind(self.q, beta, self.lp, self.g)

        def evaluate():
            lp, g = target(self.q, beta)
            self.lp.copy_(lp)
            self.g.copy_(g)
        return evaluate

    def _capture(self, target, device) -> None:
        self.graphs = (capture_steps(self.steps, device)
                       if device.type == "cuda" and hasattr(target, "bind")
                       else None)
        # the trace recorder of the steps' replays (run_chains sets it)
        self.recorder = None

    def _take(self, q, step_size, inv_mass, beta_temp) -> None:
        """A transition's step size, temperature, mass (when ``inv_mass``
        is another object than the last one) and state. Without
        ``per_chain`` a (C,) temperature would be read at chain 0 alone."""
        if not self.per_chain and beta_temp.dim():
            raise ValueError("beta_temp has one value per chain; bind the "
                             "transition with per_chain=True")
        self.step_size.copy_(step_size)
        self.beta_temp.copy_(beta_temp)
        if inv_mass is not self._mass_src:
            diag, tail_inv, k = _mass_parts(inv_mass)
            if k != self.k:
                raise ValueError(f"the transition was bound to a dense block "
                                 f"of {self.k} columns, not {k}")
            self.diag.copy_(diag)
            if k:
                self.tail_inv.copy_(tail_inv)
            self._mass_src = inv_mass
        self.q.copy_(q)

    def _step(self, name: str) -> None:
        run_step(self, name)


class BoundTransition(BoundBuffers):
    """``hmc_step`` on fixed buffers of C chains (see the module's
    docstring): q (the proposal), p, g, lp, lp0, kin0, kin1, step_size and
    beta_temp (C,), and the mass parts. ``target(q, beta_temp) -> (lp,
    grad)``, bound where it has ``bind``; ``q0`` (C, dim) gives the shapes
    and the first state; ``inv_mass`` the mass form, fixed for the object.
    With ``per_chain`` the target is bound to the (C,) temperatures (K1's
    launches of stride 1), else to the first, which a 0-dim temperature
    fills like every other."""

    def __init__(self, target, q0, inv_mass, per_chain: bool = False):
        C, dim = q0.shape
        dt, dev = q0.dtype, q0.device
        self._buffers(q0, inv_mass, per_chain)
        new = lambda *s: torch.empty(s, dtype=dt, device=dev)
        self.p, self.g = torch.zeros_like(self.q), torch.zeros_like(self.q)
        self.lp, self.lp0, self.kin0, self.kin1 = (new(C) for _ in range(4))
        evaluate = self._evaluation(target)

        def k2(nkick, drift, kinetic=None):
            return bind_leapfrog(self.q, self.p, self.g, self.step_size,
                                 self.mass, nkick, drift, kinetic)

        first, later = k2(1, True), k2(2, True)
        self._kinetic0 = k2(0, False, self.kin0)
        self._kinetic1 = (k2(0, False, self.kin1), k2(1, False, self.kin1))
        stream = lambda: launch_stream(dev)

        def leapfrog(update):
            def run():
                update(stream())
                evaluate()
            return run

        self.steps = {"start": evaluate, "first": leapfrog(first),
                      "next": leapfrog(later)}
        self._capture(target, dev)

    def __call__(self, q, step_size, inv_mass, beta_temp, num_leapfrogs: int,
                 normals, uniforms, max_energy_diff: float = 1000.0):
        """One transition from q, as ``hmc_step(lambda r: target(r,
        beta_temp), q, ...)``: the same arguments, the same result; the
        step size 0-dim or (C,), the temperature 0-dim, or (C,) for an
        object made ``per_chain``. A mass is copied in when ``inv_mass`` is
        another object than the last one."""
        L = int(num_leapfrogs)
        self._take(q, step_size, inv_mass, beta_temp)
        self._step("start")
        self.lp0.copy_(self.lp)
        self.p.copy_(momentum_from_normal(inv_mass, normals))
        stream = launch_stream(self.device)
        self._kinetic0(stream)
        for i in range(L):
            self._step("first" if i == 0 else "next")
        self._kinetic1[1 if L else 0](stream)
        return _metropolis(q, self.q, self.lp0, self.kin0, self.lp,
                           self.kin1, uniforms, L, max_energy_diff)
