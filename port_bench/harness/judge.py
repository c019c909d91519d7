"""The check that decides ``correct``: what the window's predict calls
returned, and what their transitions computed, held to the plain
reference (``port_bench/reference``).

Five numbers (hybrid storage: six), each against the cell's limit in
``port_bench/limits/<cell>.json``:

- ``fit_grad``: the largest |gradient| of the hyperparameter objective,
  in the fit's own coordinates, at the hyperparameters the last
  initial_fit returned (``reference/magi_ref.py:hparam_gradient``): the
  fit judged by itself.
- ``lp_gap``: the target evaluation (the whitening GEMM, the operator
  GEMMs and K1's fwd and energy kernels). At two transitions of the
  window drawn from the seed (``Capture``), the log-posterior that the
  transition computed at its states (HMC: its start and its proposal;
  NUTS: both ends of the trajectory) against the reference's at the same
  states: the largest gap in nats of lp's deviation from its mean over
  chains (lp is relative to a zero point).
- ``orbit_gap``: the transition (K2 and the NUTS leaf) and the target's
  gradient (K1's bwd kernel and the adjoint GEMMs), which steers every
  step of it. The reference integrates the leapfrog orbit of each
  captured transition from its start and the momenta its normals give
  under the transition's mass and step size: HMC's proposal against the
  orbit's point at L steps; NUTS's trajectory ends and proposal against
  the nearest point of the orbit within the doublings the chain ran. The
  largest distance over chains, over the chain's largest distance from
  its start along its orbit (a trajectory that turns back toward its
  start does not shrink the scale). For HMC the gap is also taken over
  sqrt(L) and at the 90th percentile over chains: the rounding that a
  sound float32 trajectory gathers grows with its length as a random walk
  (L is jittered over 1..192), and its worst chain swings from draw to
  draw.
- ``draw_gap``: every draw of every chain that ``predict`` returned,
  against a GN factor applied in float64 to the port's own whitened draws
  (``sample_results``), taken as differences from the chain's last draw
  (reference/magi_ref.py says why differences): the largest |dX -
  dX_ref| over each component's largest |dX_ref|; and the largest
  relative gap of theta, and of sigma^2 where it is sampled, to the
  softplus of its sampled pre-image. In dense storage the factor is the
  reference's own L, so the number holds the program's GN factor, which
  the two numbers above take as its state, and the unwhitening. With a
  banded factor (hybrid storage) it is that call's own factor, U^{-1}
  worked out in float64 from the tiles the call's target held: at
  N_I = 1025 two sound float64 builds of the GN factor differ along the
  pseudo-inverses' cut by rounding alone, and a fixed preconditioner does
  not change the posterior, so the number holds K4's float32 unwhitening
  and the softplus maps, and the target and orbit numbers hold the rest.
- ``stall``: for each chain, the median over trajectory values of the
  reference's GN posterior sd over the chain's sd across its draws; the
  largest over chains. A chain whose transitions return their state
  reads infinity (written as 1e30): it sampled nothing.
- ``k_gap`` (hybrid storage): the operator S = K^{-1/2} that the
  captured transitions' target evaluates through, held to the
  reference's K where float64 determines it (``Reference.k_gap``): K
  worked back from S less the reference's K, past its largest tenth of
  directions. At N_I = 513 and 1025 K = C'' - C' C^{-1} 'C cancels to
  its rounding in a few tens of directions, and K^{-1} is largest
  there: two builds of the port's own operators (card and CPU, float64)
  put lp 2,985 nats apart across chains at the same states, as far as
  the reference's build is from either (PERF.md). The target and orbit
  numbers therefore take the program's S as state, beside its zero
  point and factor, and this number holds S in the other directions,
  where a band-truncated K^{-1} moves K by 60 times what rounding
  does on the card.

The numbers are the largest over the window's calls and captures. The
program's state that the target and orbit numbers take as given (the
zero point, the GN factor, the mass and step size that warmup adapted) is
named in PERF.md. The reference takes the configuration's storage:
dense storage the band-truncated operators, hybrid storage the exact
ones; banded storage is not judged (its target is the band-truncated
posterior, whose square roots the port clamps).
"""

from __future__ import annotations

import contextlib
import math
import weakref

import numpy as np
import torch

from port_bench.harness.manifest import field
from port_bench.reference.magi_ref import (Mass, Reference, hparam_gradient,
                                           precision, softplus,
                                           upper_from_tiles)

INFINITE = 1e30
NUMBERS = ("fit_grad", "lp_gap", "orbit_gap", "draw_gap", "stall")
# hybrid storage's target takes the program's S as state; this holds it
HYBRID_NUMBERS = NUMBERS + ("k_gap",)


def numbers(cell) -> tuple:
    """The numbers the check compares in ``cell``."""
    hybrid = cell.recipe().get("storage", "dense") == "hybrid"
    return HYBRID_NUMBERS if hybrid else NUMBERS


# --------------------------------------------------------------------------
# what the window's transitions computed
# --------------------------------------------------------------------------


def picks(seed: int, burnin: int, num_results: int, calls=(0, 1)):
    """The transitions the check reads: one sampling transition, drawn
    from the seed, in each of the window's calls ``calls``."""
    rng = np.random.default_rng([seed % 2**63, 7])
    return [(c, burnin + int(rng.integers(num_results))) for c in calls]


def _gn_target(target):
    """The GN target of a bound transition's target (a pinned-sigma target
    wraps it as ``logp_grad``)."""
    return getattr(target, "logp_grad", target)


def _factor_tiles(target):
    """The tiles of the target's banded GN factor U (on the host), or None
    for a target whose whitening is not banded."""
    factor = getattr(getattr(_gn_target(target), "whitening", None),
                     "factor", None)
    return None if factor is None else factor.tiles.detach().cpu().clone()


def factor_bandwidth(tiles, n: int) -> int:
    """The upper bandwidth of the banded factor U (n, n) that ``tiles``
    hold: the largest j - i with U[i, j] != 0."""
    i, j = upper_from_tiles(torch.as_tensor(tiles), n).nonzero(as_tuple=True)
    return int((j - i).max()) if i.numel() else 0


def _frame(target) -> dict:
    """The program's coordinates of the target a transition was bound to:
    x = x0 + F (z - z0), F in the flat order n D + d: the dense factor,
    or, for a banded one, nothing here (the reference inverts the tiles of
    the call's factor, ``Capture.factors``) but the operator S."""
    target = _gn_target(target)
    wh = getattr(target, "whitening", None)
    N, D = target.N, target.D
    out = {"x0": target.x0T.T.clone(), "z0": target.z0.clone()}
    if hasattr(wh, "L_perm"):
        out["F"] = wh.L_perm.reshape(D, N, N * D).transpose(0, 1).reshape(
            N * D, N * D).clone()
    elif getattr(wh, "factor", None) is not None:
        out["S"] = target.operators.S.clone()
    else:
        raise NotImplementedError("the check reads GN targets only (a dense "
                                  "or a banded factor)")
    return out


def _mass(inv_mass) -> Mass:
    if isinstance(inv_mass, torch.Tensor):
        return Mass(inv_mass.clone())
    return Mass(inv_mass.diag.clone(), inv_mass.tail_inv.clone(),
                inv_mass.tail_msqrt.clone())


def _per_chain(x, C: int):
    return torch.as_tensor(x).reshape(-1).expand(C).clone()


class Capture:
    """Wraps the port's bound transitions (``BoundTransition``,
    ``BoundNuts``) while installed: counts each predict call's
    transitions, and at the ``picks`` (call, transition) copies what the
    transition took (state, step size, mass, temperature, noise) and
    computed (proposal, trajectory ends, log-posterior at its states) into
    ``taken``. At each call's end it copies the tiles of the banded GN
    factor, if any, of the target its last transition was bound to
    (``factors``, by call; a call samples one target), and hands them to
    the call's entries of ``taken`` as their ``factor``. Elsewhere a
    transition passes straight through, apart from ``observers`` (the
    trace's ``tracing.Tap``), each told of every transition before and
    after it runs and of every call's end."""

    def __init__(self, picks=(), observers=()):
        self.picks = set(picks)
        self.observers = list(observers)
        self.call, self.n = -1, 0
        self.taken = []
        self.factors = {}
        self._last = None
        self._targets = weakref.WeakKeyDictionary()
        self._saved = []

    def _take_hmc(self, obj, a, out):
        C = a["q"].shape[0]
        return {"kind": "hmc", "call": self.call, "q": a["q"].clone(),
                "eps": _per_chain(a["step_size"], C),
                "beta_temp": a["beta_temp"].clone(),
                "mass": _mass(a["inv_mass"]), "normals": a["normals"].clone(),
                "L": int(a["num_leapfrogs"]), "frame": _frame(
                    self._targets[obj]),
                "states": [(a["q"].clone(), obj.lp0.clone()),
                           (obj.q.clone(), obj.lp.clone())],
                "proposal": obj.q.clone()}

    def _take_nuts(self, obj, a, out):
        C = a["q"].shape[0]
        prop, info = out
        ends = {s: obj.ends[s]["q"].clone() for s in ("minus", "plus")}
        return {"kind": "nuts", "call": self.call, "q": a["q"].clone(),
                "eps": _per_chain(a["step_size"], C),
                "beta_temp": a["beta_temp"].clone(),
                "mass": _mass(a["inv_mass"]),
                "normals": a["noise"].normals.clone(),
                "go_right": a["noise"].go_right.clone(),
                "depth": info.depth.clone(), "frame": _frame(
                    self._targets[obj]),
                "states": [(obj.ends[s]["q"].clone(),
                            obj.ends[s]["lp"].clone())
                           for s in ("minus", "plus")],
                "ends": ends, "proposal": prop.clone()}

    def _wrap(self, cls, take, names):
        init, call = cls.__init__, cls.__call__
        cap = self

        def __init__(obj, target, *args, **kwargs):
            init(obj, target, *args, **kwargs)
            cap._targets[obj] = target

        def __call__(obj, *args, **kwargs):
            for o in cap.observers:
                o.before(cap.call, cap.n)
            out = call(obj, *args, **kwargs)
            cap._last = obj
            if (cap.call, cap.n) in cap.picks:
                a = dict(zip(names, args), **kwargs)
                cap.taken.append(take(obj, a, out))
            for o in cap.observers:
                o.after(cap.call, cap.n)
            cap.n += 1
            return out

        self._saved.append((cls, init, call))
        cls.__init__, cls.__call__ = __init__, __call__

    @contextlib.contextmanager
    def installed(self):
        from magi_v2_tpu_torch.sampler.hmc import BoundTransition
        from magi_v2_tpu_torch.sampler.nuts import BoundNuts

        first = ("q", "step_size", "inv_mass", "beta_temp")
        self._wrap(BoundTransition, self._take_hmc,
                   first + ("num_leapfrogs", "normals", "uniforms"))
        self._wrap(BoundNuts, self._take_nuts, first + ("noise",))
        try:
            yield self
        finally:
            for cls, init, call in reversed(self._saved):
                cls.__init__, cls.__call__ = init, call
            self._saved.clear()

    @contextlib.contextmanager
    def call_of(self, index: int):
        """Around predict call ``index``: its transitions counted from 0."""
        self.call, self.n, self._last = index, 0, None
        try:
            yield
        finally:
            if self._last is not None:
                tiles = _factor_tiles(self._targets.get(self._last))
                self.factors[index] = tiles
                for t in self.taken:
                    if t["call"] == index:
                        t["factor"] = tiles
            self._last = None
            for o in self.observers:
                o.end_call(index)
            self.call = -1


# --------------------------------------------------------------------------
# the target and the orbit
# --------------------------------------------------------------------------


def _frame64(ref: Reference, t: dict) -> dict:
    f = t["frame"]
    F = f["F"] if "F" in f else ref.factor_inverse(t["factor"])
    return ref.frame(f["x0"], f["z0"], F, f.get("S"))


def _norm(a):
    return a.double().norm(dim=-1)


def lp_gap(ref: Reference, t: dict, control: str | None = None) -> float:
    """The gap of the program's lp at one captured transition's states to
    the reference's (float64), in nats, each taken as its deviation from
    its mean over chains; with ``control``, the reference computed in that
    precision stands in for the program."""
    frame = _frame64(ref, t)
    gap = 0.0
    centred = lambda a: a.double() - a.double().mean()
    for q, lp in t["states"]:
        q = q.to(ref.device)
        lp_ref = ref.log_posterior(q, t["beta_temp"], frame)[0]
        if control is not None:
            with precision(control) as dt:
                lp = ref.log_posterior(q, t["beta_temp"], frame, dt)[0]
        d = (centred(lp.to(ref.device)) - centred(lp_ref)).abs()
        gap = max(gap, float(torch.nan_to_num(d, nan=torch.inf).max()))
    return gap


def _extents(t: dict):
    """Per chain, the leapfrog steps its NUTS trajectory may span to each
    side: the sums of 2^d over the doublings d it ran in that direction."""
    D = t["go_right"].shape[1]
    ran = (torch.arange(D, device=t["depth"].device)[None, :]
           < t["depth"][:, None].long())
    w = (2 ** torch.arange(D, device=ran.device))[None, :]
    right = (ran & t["go_right"]).long() * w
    left = (ran & ~t["go_right"]).long() * w
    return left.sum(1), right.sum(1)


def orbit_gap(ref: Reference, t: dict, control: str | None = None) -> float:
    """The largest gap over chains of one captured transition's points to
    the reference's float64 orbit (the module says which points), over
    the chain's largest distance from its start along the orbit. With
    ``control``, the orbit computed in that precision stands in for the
    program, compared point by point over the same span."""
    frame = _frame64(ref, t)
    dev = ref.device
    q0 = t["q"].to(dev).double()
    mass = t["mass"]
    p0 = mass.momentum(t["normals"].to(dev))
    eps = t["eps"].to(dev).double()
    C = q0.shape[0]

    def run(sign, steps):
        orbit = ref.orbits(q0, p0, sign * eps, mass.velocity, frame,
                           t["beta_temp"], steps)
        if control is None:
            return ((j + 1, q, None) for j, q in enumerate(orbit))
        with precision(control) as dt:
            ctrl = ref.orbits(q0, p0, sign * eps, mass.velocity, frame,
                              t["beta_temp"], steps, dt)
            return [(j + 1, q, qc) for j, (q, qc)
                    in enumerate(zip(orbit, ctrl))]

    if t["kind"] == "hmc":
        extent = torch.zeros(C, dtype=torch.float64, device=dev)
        for j, q, qc in run(1.0, t["L"]):
            extent = torch.maximum(extent, _norm(q - q0))
        pt = t["proposal"].to(dev) if control is None else qc
        # over sqrt(L), the 90th percentile over chains: rounding gathers
        # as a random walk along the jittered length, and the worst of the
        # chains swings from draw to draw (PERF.md)
        return _ratio(_norm(pt.double() - q), extent * math.sqrt(t["L"]),
                      0.9)

    left, right = _extents(t)
    left, right = left.to(dev), right.to(dev)
    extent = torch.zeros(C, dtype=torch.float64, device=dev)
    gap = torch.zeros_like(extent)
    inf = torch.full_like(extent, torch.inf)
    points = {"minus": t["ends"]["minus"], "plus": t["ends"]["plus"],
              "proposal": t["proposal"]}
    points = {k: v.to(dev).double() for k, v in points.items()}
    near = {k: _norm(v - q0) for k, v in points.items()}
    near_side = {"minus": near["minus"].clone(), "plus": near["plus"].clone()}
    for sign, side, span in ((-1.0, "minus", left), (1.0, "plus", right)):
        for j, q, qc in run(sign, int(span.max())):
            inside = j <= span
            extent = torch.where(inside, torch.maximum(extent, _norm(q - q0)),
                                 extent)
            if control is not None:
                gap = torch.where(inside, torch.maximum(
                    gap, _norm(qc.double() - q)), gap)
                continue
            for k in (side, "proposal"):
                d = torch.nan_to_num(_norm(points[k] - q), nan=torch.inf)
                d = torch.where(inside, d, inf)
                if k == side:
                    near_side[k] = torch.minimum(near_side[k], d)
                else:
                    near[k] = torch.minimum(near[k], d)
    if control is None:
        gap = torch.maximum(torch.maximum(near_side["minus"],
                                          near_side["plus"]), near["proposal"])
    return _ratio(gap, extent)


def _ratio(gap, scale, quantile: float = 1.0) -> float:
    """The largest gap / scale over chains, or its ``quantile``: a gap
    where the scale is 0, or one that is not a number, is infinite."""
    r = torch.where(scale > 0, gap / scale.clamp(min=1e-300),
                    torch.where(gap > 0, torch.inf, 0.0))
    r = torch.nan_to_num(r, nan=torch.inf, posinf=torch.inf)
    return float(r.max() if quantile >= 1.0 else
                 torch.quantile(r, quantile, interpolation="higher"))


# --------------------------------------------------------------------------
# the draws
# --------------------------------------------------------------------------


def keep(res: dict, N: int, D: int, factor=None) -> dict:
    """What the check needs of one call's results (host arrays, kept as
    ``predict`` returned them): the whitened draws and the trajectories,
    theta and sigma^2 with their pre-images, each chain's spread, and the
    tiles of the call's banded GN factor (``Capture.factors``), if any."""
    X = res["X_samps"]                         # (T, C, N, D)
    raw = res["sample_results"]                # (T, C, N D + D + P)
    ND = N * D
    return {
        "z": raw[:, :, :ND],
        "X": X,
        "sigma_pre": raw[:, :, ND:ND + D],
        "theta_pre": raw[:, :, ND + D:],
        "thetas": res["thetas_samps"],
        "sigma_sqs": res["sigma_sqs_samps"],
        "chain_sd": X.std(axis=0, dtype=np.float64),   # (C, N, D)
        "factor": factor,
    }


def draw_gap(ref: Reference, kept: dict, sigma_fixed, tf32: bool = False,
             block_bytes: int = 1 << 28) -> float:
    """The largest gap of one call's draws to the reference's, as the
    module says; with ``tf32`` the reference's map, computed as a TF32
    card would, stands in for the port's (the control). The map is the
    reference's own L, or U^{-1} of the call's banded factor where it had
    one. Draws go through the reference in blocks of about
    ``block_bytes``."""
    z, X = kept["z"], kept["X"]
    T = z.shape[0]
    dev = ref.device
    op = (None if kept.get("factor") is None
          else ref.factor_inverse(kept["factor"]))
    apply = lambda a, tf32=False: ref.apply(a, tf32, op)
    last_z = torch.as_tensor(np.asarray(z[-1]), device=dev, dtype=torch.float64)
    last_x = torch.as_tensor(np.asarray(X[-1]), device=dev, dtype=torch.float64)
    last_ctrl = apply(last_z, tf32=True) if tf32 else None
    last_ref = apply(last_z)
    step = max(1, block_bytes // max(1, z[0].size * 8))
    diff = torch.zeros(ref.D, dtype=torch.float64, device=dev)
    scale = torch.zeros_like(diff)
    for t0 in range(0, T - 1, step):
        zt = torch.as_tensor(np.asarray(z[t0:min(T - 1, t0 + step)]),
                             device=dev, dtype=torch.float64)
        d_ref = apply(zt) - last_ref
        if tf32:
            d = apply(zt, tf32=True) - last_ctrl
        else:
            d = torch.as_tensor(np.asarray(X[t0:t0 + zt.shape[0]]),
                                device=dev, dtype=torch.float64) - last_x
        flat = lambda a: a.reshape(-1, ref.D)
        diff = torch.maximum(diff, flat(d - d_ref).abs().amax(0))
        scale = torch.maximum(scale, flat(d_ref).abs().amax(0))
    # a chain that never moved has no scale: any gap there is infinite
    gaps = [float(torch.where(scale > 0, diff / scale.clamp(min=1e-300),
                              torch.where(diff > 0, torch.inf, 0.0)).max())]
    theta_ref = softplus(kept["theta_pre"])
    gaps.append(float((np.abs(kept["thetas"] - theta_ref)
                       / np.abs(theta_ref)).max()))
    if sigma_fixed is None:
        sig_ref = softplus(kept["sigma_pre"]) + ref.sigma_lb.cpu().numpy()
        gaps.append(float((np.abs(kept["sigma_sqs"] - sig_ref)
                           / np.abs(sig_ref)).max()))
    return max(gaps)


def stall(ref: Reference, kept: dict) -> float:
    sd_ref = ref.sd.cpu().numpy()[None]                   # (1, N, D)
    chain_sd = kept["chain_sd"]
    with np.errstate(divide="ignore"):
        ratio = np.where(chain_sd > 0, sd_ref / chain_sd, np.inf)
    worst = float(np.median(ratio.reshape(ratio.shape[0], -1), axis=1).max())
    return min(worst, INFINITE)


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def control_precision(cfg: dict) -> str:
    """The precision below the configuration's: float32 for float64, TF32
    for float32."""
    return "float32" if cfg["dtype"] == "float64" else "tf32"


def reference(cell, fit: dict, device) -> Reference:
    """The plain reference of the cell's posterior: band-truncated
    operators for dense storage, the exact ones for hybrid storage, and
    the known noise variances where the cell pins them."""
    recipe = cell.recipe()
    storage = recipe.get("storage", "dense")
    if storage == "banded":
        raise NotImplementedError(
            "banded storage samples the band-truncated posterior through "
            "square roots that the port clamps to PSD; the reference would "
            "have to truncate and clamp exactly as the port does, so the "
            "check judges dense and hybrid storage only")
    if storage not in ("dense", "hybrid"):
        raise ValueError(f"unknown storage {storage!r}")
    return Reference(fit, field(cell.config["field"]), device,
                     exact=storage == "hybrid",
                     sigma_fixed=recipe.get("sigma_sqs_fixed"))


def fit_gradient(cell, fit: dict) -> float:
    mc = cell.config.get("magi_config", {})
    if mc.get("hparam_fit_points", "obs") != "obs":
        raise ValueError("the reference fits the hyperparameters at the "
                         "observations only")
    return hparam_gradient(fit["ts_obs"], fit["X_obs"], fit["phi1s"],
                           fit["phi2s"], fit["sigma_sqs_init"],
                           mc.get("cholesky_jitter", 1e-6))


def judge(cell, fit: dict, kept_calls: list, taken: list, device,
          control: str | None = None, ref: Reference | None = None) -> dict:
    """{number: value} over the window's calls and captured transitions,
    from the fit's outputs (``fit``: the observations and what the last
    initial_fit returned; ``ref`` the reference built from them, where
    built already). With ``control`` the reference in that precision
    stands in for the program in the target, orbit and draw numbers."""
    ref = reference(cell, fit, device) if ref is None else ref
    sigma_fixed = cell.recipe().get("sigma_sqs_fixed")
    # no captured transition: nothing of the target was checked
    out = {"fit_grad": fit_gradient(cell, fit), "lp_gap": INFINITE,
           "orbit_gap": INFINITE, "draw_gap": 0.0, "stall": 0.0}
    if taken:
        out["lp_gap"] = out["orbit_gap"] = 0.0
    for t in taken:
        out["lp_gap"] = max(out["lp_gap"], lp_gap(ref, t, control))
        out["orbit_gap"] = max(out["orbit_gap"], orbit_gap(ref, t, control))
    if "k_gap" in numbers(cell):
        out["k_gap"] = INFINITE if not taken else 0.0
        if control is not None:
            with precision(control) as dt:
                S_ctrl = ref.s_in(dt)
        for t in taken:
            out["k_gap"] = max(out["k_gap"], ref.k_gap(
                t["frame"]["S"] if control is None else S_ctrl))
    for kept in kept_calls:
        out["draw_gap"] = max(out["draw_gap"], draw_gap(
            ref, kept, sigma_fixed, tf32=control is not None))
        out["stall"] = max(out["stall"], stall(ref, kept))
    # a reading that is not a number failed: it is written as infinite
    return {k: INFINITE if np.isnan(v) else min(float(v), INFINITE)
            for k, v in out.items()}
