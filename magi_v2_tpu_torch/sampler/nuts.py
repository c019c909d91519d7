"""Multinomial No-U-Turn sampler for all chains at once (counterpart of
magi_v2_tpu/sampler/nuts.py), in masked lockstep: the semantics of the JAX
package's ``jax.vmap(nuts_step)``. See the JAX module for the algorithm
(iterative tree doubling, the popcount checkpoint scheme, the
orientation-sensitive U-turn criterion).

Every chain doubles its trajectory at the same time; a chain whose tree
has terminated, or whose subtree has turned or diverged, is masked and
left as it is while the others go on. A doubling's prologue opens its
first leaf with K2's NUTS form (sampler/hmc.py: the opening half-kick,
the velocity and the drift of every running chain); a leaf is then two
steps on fixed buffers: the target's evaluation, and one launch of the
leaf kernel (ops/nuts.py), which closes the leaf (the closing half-kick,
v = M^{-1} p and the kinetic energy), runs its epilogue (the weight, the
proposal, the checkpoint store and the U-turn checks), advances the leaf
counter and, unless the leaf is its doubling's last, opens the next leaf.
A chain that turns or diverges at a leaf has been opened for the next one
as well; nothing reads that state (ops/nuts.py). A checkpoint slot stores
the leaf's v beside its q, so the U-turn checks make no product with
M^{-1} (the JAX leaf recomputes one per slot).

The noise is drawn by the caller (``draw_noise``), so a test can feed the
numbers the JAX sampler draws: standard normals for the momenta (C, dim),
a direction per chain and doubling (C, D), one uniform per leaf
(C, 2^D - 1; leaf n of doubling d at column 2^d - 1 + n) and one per
doubling's acceptance across subtrees (C, D).

``BoundNuts`` is the transition on fixed buffers of C chains. For a target
with a bound evaluation (``target.bind``) on the card it captures five
steps as CUDA graphs once, the evaluation at the start, the root (the
initial kinetic energy and the trajectory's state), a doubling's prologue
(each chain's edge by its direction), one leaf and a doubling's epilogue
(the acceptance across subtrees, the endpoints, the whole-trajectory
U-turn), and replays them: 2^d leaves in doubling d whatever the chains
do (the masked leaves cost a leaf's time each), and one read of the
device per doubling, whether any chain goes on. With a ``recorder``
(``utils.profiling.PhaseTimer``, set by ``run_chains`` when it traces)
each doubling is a "doubling" span with device markers at its start
(before its prologue's replay) and its end (after its epilogue's), and
its read a "device_read" span. The leaf index and the
doubling live on the device. On the CPU, or for any other callable, the
same steps run eagerly: ``nuts_step`` is that form, and gives the same
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from magi_v2_tpu_torch.ops.banded import launch_stream
from magi_v2_tpu_torch.ops.nuts import bind_nuts_leaf
from magi_v2_tpu_torch.sampler.hmc import (
    BoundBuffers,
    bind_leapfrog,
)
from magi_v2_tpu_torch.sampler.mass import momentum_from_normal


class NutsConfig(NamedTuple):
    max_tree_depth: int = 10       # TFP NoUTurnSampler default
    max_energy_diff: float = 1000.0  # TFP divergence threshold


class NutsInfo(NamedTuple):
    accept_prob: torch.Tensor     # (C,) mean leaf acceptance
    num_leapfrogs: torch.Tensor   # (C,) int32
    diverging: torch.Tensor       # (C,) bool
    depth: torch.Tensor           # (C,) int32


class NutsNoise(NamedTuple):
    normals: torch.Tensor     # (C, dim) standard normals of the momenta
    go_right: torch.Tensor    # (C, D) bool, the direction of each doubling
    leaf_u: torch.Tensor      # (C, 2^D - 1) one uniform per leaf
    accept_u: torch.Tensor    # (C, D) the acceptance across subtrees


def draw_noise(generator, C: int, dim: int, max_depth: int, dtype,
               device) -> NutsNoise:
    """One transition's noise from ``generator``, on ``device``."""
    u = lambda *s: torch.rand(s, generator=generator, dtype=dtype,
                              device=device)
    normals = torch.randn((C, dim), generator=generator, dtype=dtype,
                          device=device)
    return NutsNoise(normals, u(C, max_depth) < 0.5,
                     u(C, (1 << max_depth) - 1), u(C, max_depth))


def _where(cond, a, b) -> None:
    """b <- a where cond (C,), in place."""
    torch.where(cond.view(-1, *([1] * (b.dim() - 1))), a, b, out=b)


class BoundNuts(BoundBuffers):
    """``nuts_step`` on fixed buffers of C chains (see the module's
    docstring). ``target(q, beta_temp) -> (lp, grad)``, bound where it has
    ``bind``; ``q0`` (C, dim) gives the shapes; ``inv_mass`` the mass form
    (a diagonal, or a dense block of fixed width), fixed for the object.
    The buffers, temperatures and graphs are ``BoundTransition``'s
    (``hmc.BoundBuffers``)."""

    def __init__(self, target, q0, inv_mass, cfg: NutsConfig = NutsConfig(),
                 per_chain: bool = False):
        C, dim = q0.shape
        D = int(cfg.max_tree_depth)
        if D < 1:
            raise ValueError("max_tree_depth must be at least 1")
        self.cfg = cfg
        self._buffers(q0, inv_mass, per_chain)
        dt, dev = q0.dtype, q0.device
        new = lambda *s, dtype=dt: torch.zeros(s, dtype=dtype, device=dev)
        self.p, self.g, self.v = new(C, dim), new(C, dim), new(C, dim)
        self.lp, self.kin, self.H0, self.eps = (new(C) for _ in range(4))
        # the trajectory: its two ends (q, p, g, lp, v), proposal, weight
        self.ends = {side: {k: new(C, dim) if k != "lp" else new(C)
                            for k in ("q", "p", "g", "lp", "v")}
                     for side in ("minus", "plus")}
        self.prop_q, self.lsw, self.sum_alpha = new(C, dim), new(C), new(C)
        b = lambda: new(C, dtype=torch.bool)
        self.terminated, self.diverging, self.go = b(), b(), b()
        self.n_leaves, self.depth = (new(C, dtype=torch.int32)
                                     for _ in range(2))
        # the subtree being built
        self.sub_prop_q, self.sub_lsw, self.sub_sum_alpha = (
            new(C, dim), new(C), new(C))
        self.active, self.turning, self.sub_diverging = b(), b(), b()
        self.sub_n = new(C, dtype=torch.int32)
        self.ckpt_q, self.ckpt_v = new(D, C, dim), new(D, C, dim)
        # the noise, and (doubling, leaf) on the device
        self.go_right = new(C, D, dtype=torch.bool)
        self.leaf_u, self.accept_u = new(C, (1 << D) - 1), new(C, D)
        self.ctr = new(2, dtype=torch.int32)
        self.going = new(dtype=torch.bool)

        evaluate = self._evaluation(target)
        stream = lambda: launch_stream(dev)
        k2_root = bind_leapfrog(self.q, self.p, self.g, self.step_size,
                                self.mass, 0, False, self.kin, vel=self.v)
        self._k2_open = bind_leapfrog(self.q, self.p, self.g, self.eps,
                                      self.mass, 1, True, active=self.active)
        close_open = bind_nuts_leaf(
            self.q, self.p, self.g, self.lp, self.H0, self.eps, self.mass,
            self.leaf_u, self.ctr, self.sub_lsw, self.sub_sum_alpha,
            self.sub_prop_q, self.ckpt_q, self.ckpt_v, self.active,
            self.turning, self.sub_diverging, self.sub_n, self.v,
            cfg.max_energy_diff)

        def leaf():
            evaluate()
            close_open(stream())

        self.steps = {"nuts_start": evaluate, "nuts_root": self._root(k2_root),
                      "nuts_prologue": self._prologue, "nuts_leaf": leaf,
                      "nuts_epilogue": self._epilogue}
        self._capture(target, dev)

    def _root(self, k2_root):
        def run():
            k2_root(launch_stream(self.device))
            torch.sub(self.kin, self.lp, out=self.H0)
            for end in self.ends.values():
                for name, t in end.items():
                    t.copy_(getattr(self, name))
            self.prop_q.copy_(self.q)
            for t in (self.lsw, self.sum_alpha, self.n_leaves, self.depth,
                      self.terminated, self.diverging, self.ctr):
                t.zero_()
        return run

    def _this_doubling(self, noise):
        """Column ctr[0] of (C, D) noise, read on the device."""
        return torch.index_select(noise, 1, self.ctr[:1].long())[:, 0]

    def _prologue(self) -> None:
        """Doubling ctr[0]: each running chain's edge, by its direction,
        into the leaf's buffers, the subtree's state, and its first leaf's
        opening (K2's NUTS form)."""
        torch.logical_not(self.terminated, out=self.active)
        self.go.copy_(self._this_doubling(self.go_right))
        torch.where(self.go, self.step_size, -self.step_size, out=self.eps)
        minus, plus = self.ends["minus"], self.ends["plus"]
        for name in ("q", "p", "g"):
            torch.where(self.go[:, None], plus[name], minus[name],
                        out=getattr(self, name))
        self.sub_prop_q.copy_(self.q)
        self.sub_lsw.fill_(float("-inf"))
        for t in (self.sub_sum_alpha, self.sub_n, self.turning,
                  self.sub_diverging):
            t.zero_()
        self.ctr[1:].zero_()
        self._k2_open(launch_stream(self.device))

    def _epilogue(self) -> None:
        """The acceptance across subtrees, the endpoints and the
        whole-trajectory U-turn of the running chains; the next doubling;
        whether any chain goes on."""
        run = ~self.terminated
        ok = ~self.turning & ~self.sub_diverging
        keep = run & ok
        u = self._this_doubling(self.accept_u)
        take = keep & (torch.log(u) < torch.clamp(self.sub_lsw - self.lsw,
                                                  max=0.0))
        _where(take, self.sub_prop_q, self.prop_q)
        _where(keep, torch.logaddexp(self.lsw, self.sub_lsw), self.lsw)
        for side, cond in (("plus", keep & self.go), ("minus",
                                                      keep & ~self.go)):
            for name, t in self.ends[side].items():
                _where(cond, getattr(self, name), t)
        minus, plus = self.ends["minus"], self.ends["plus"]
        dq = plus["q"] - minus["q"]
        whole = ((torch.sum(dq * minus["v"], dim=-1) < 0.0)
                 | (torch.sum(dq * plus["v"], dim=-1) < 0.0))
        self.diverging |= run & self.sub_diverging
        _where(run, self.sum_alpha + self.sub_sum_alpha, self.sum_alpha)
        _where(run, self.n_leaves + self.sub_n, self.n_leaves)
        self.depth += run.to(torch.int32)
        self.terminated |= run & (~ok | whole)
        self.ctr[:1].add_(1)
        torch.any(~self.terminated, out=self.going)

    def _traced_end(self, rec, span, d: int) -> bool:
        """The end of doubling ``d`` under a recorder: its end marker
        (after its epilogue's replay), its device read in a span of its
        own, and the span's close. Whether the transition stops."""
        rec.mark(span, "dev_t1_ns")
        stop = d + 1 == self.cfg.max_tree_depth
        if not stop:
            read = rec.open("device_read")
            stop = not bool(self.going)
            rec.close(read)
        rec.close(span)
        return stop

    def __call__(self, q, step_size, inv_mass, beta_temp, noise: NutsNoise,
                 on_doubling=None):
        """One transition from q (C, dim) at ``step_size`` (0-dim or one per
        chain) and ``beta_temp`` (0-dim, or (C,) for an object made
        ``per_chain``), with ``noise``: -> (the new states (C, dim),
        NutsInfo). A mass is copied in when ``inv_mass`` is another object
        than the last one. ``on_doubling(d)``, where given, is called after
        doubling d's leaves, before its epilogue (to read the subtree's
        state)."""
        self._take(q, step_size, inv_mass, beta_temp)
        self.go_right.copy_(noise.go_right)
        self.leaf_u.copy_(noise.leaf_u)
        self.accept_u.copy_(noise.accept_u)
        self._step("nuts_start")
        self.p.copy_(momentum_from_normal(inv_mass, noise.normals))
        self._step("nuts_root")
        rec = self.recorder
        for d in range(self.cfg.max_tree_depth):
            if rec is not None:
                span = rec.open("doubling", depth=d)
                rec.mark(span, "dev_t0_ns")
            self._step("nuts_prologue")
            for _ in range(1 << d):
                self._step("nuts_leaf")
            if on_doubling is not None:
                on_doubling(d)
            self._step("nuts_epilogue")
            if rec is not None:
                if self._traced_end(rec, span, d):
                    break
            # the one read of the device in a doubling
            elif d + 1 < self.cfg.max_tree_depth and not bool(self.going):
                break
        n = torch.clamp(self.n_leaves, min=1).to(self.lsw.dtype)
        info = NutsInfo(accept_prob=self.sum_alpha / n,
                        num_leapfrogs=self.n_leaves.clone(),
                        diverging=self.diverging.clone(),
                        depth=self.depth.clone())
        return self.prop_q.clone(), info


def nuts_step(logp_grad, q, step_size, inv_mass, noise: NutsNoise,
              cfg: NutsConfig = NutsConfig()):
    """One NUTS transition of every chain from q (C, dim), eagerly:
    ``logp_grad(q) -> (logp (C,), grad (C, dim))``, ``step_size`` a 0-dim
    tensor or one per chain (C,), ``noise`` as ``draw_noise`` gives it.
    Returns (q_new, NutsInfo)."""
    one = torch.ones((), dtype=q.dtype, device=q.device)
    step = BoundNuts(lambda r, _: logp_grad(r), q, inv_mass, cfg)
    return step(q, step_size, inv_mass, one, noise)
