"""Parallel tempering (replica exchange) for the sampling loop
(counterpart of the PT block of magi_v2_tpu/sampler/run.py).

The ladder beta_0 = 1 > beta_1 > ... > beta_{R-1} > 0 tempers the
sampling phase: chains are rung-major, chain r * M + m is replica m of
rung r and samples the target at beta_r with the step eps * beta_r^(-1/2)
(``rung_temperatures``). Every ``pt_swap_every`` sampling transitions a
swap round evaluates the log-posterior of every chain at beta = 1 (value
only: no gradient) and proposes the even-odd exchange of adjacent rungs,
parity alternating round by round (ops/pt.py: kernel ``pt_swap`` and its
plain version ``pt_swap_plain``). Only the beta = 1 rung samples the
posterior; the hot rungs carry mode crossings down the ladder.

``BoundSwap`` is a swap round on fixed buffers: the states (C, dim), lp
(C,), a 0-dim beta of one, the round's uniforms (R - 1, M) and parity,
and the integer counters of proposals and acceptances per pair. For a
target with a value-only bound evaluation (``bind_value``, as the targets
``predict`` builds have) on the card, the evaluation and the swap kernel
are one CUDA graph, replayed once a round; for any other target the
evaluation (``target(q, one)[0]``) runs eagerly before the kernel, and on
the CPU the plain version runs.
"""

from __future__ import annotations

import torch

from magi_v2_tpu_torch.ops.banded import launch_stream
from magi_v2_tpu_torch.ops.pt import bind_pt_swap
from magi_v2_tpu_torch.sampler.hmc import GRAPH_COUNTS, capture_steps


def check_ladder(config, num_chains: int):
    """The ladder of a ``SamplerConfig`` as a tuple of floats, checked as
    the JAX package checks it (the same messages), or None when it has
    fewer than two rungs (no tempering)."""
    betas = tuple(float(b) for b in (
        () if config.pt_betas is None else config.pt_betas))
    R = len(betas)
    if R < 2:
        return None
    if abs(betas[0] - 1.0) > 1e-12:
        raise ValueError(f"pt_betas must start at 1.0, got {betas}")
    if any(b2 >= b1 for b1, b2 in zip(betas, betas[1:])) or betas[-1] <= 0:
        raise ValueError(
            f"pt_betas must be strictly decreasing and positive: {betas}"
        )
    if num_chains % R:
        raise ValueError(
            f"num chains ({num_chains}) must divide by the PT ladder length "
            f"({R})"
        )
    if config.use_annealing and config.anneal_mode == "reference":
        raise ValueError(
            "pt_betas requires a fixed beta=1 sampling target: use "
            "use_annealing=False or anneal_mode='warmup_only' (the "
            "'reference' schedule tempers the sampling phase itself)"
        )
    if config.pt_swap_every < 1:
        raise ValueError("pt_swap_every must be >= 1")
    return betas


def rung_temperatures(betas, num_chains: int, dtype, device):
    """(beta (C,), the step's scale beta^(-1/2) (C,)) of rung-major chains,
    in ``dtype`` as the JAX package computes them."""
    b = torch.tensor(betas, dtype=dtype, device=device)
    beta_c = torch.repeat_interleave(b, num_chains // len(betas))
    return beta_c, beta_c ** -0.5


class BoundSwap:
    """Swap rounds of C rung-major chains on the ladder ``betas`` (see the
    module's docstring), with the proposals and acceptances of each pair
    counted as integers over the rounds (``prop``, ``accs``)."""

    def __init__(self, target, q0, betas):
        C, dim = q0.shape
        R = len(betas)
        dt, dev = q0.dtype, q0.device
        self.betas, self.R, self.M, self.device = tuple(betas), R, C // R, dev
        self.q = q0.clone(memory_format=torch.contiguous_format)
        self.lp = torch.zeros((C,), dtype=dt, device=dev)
        self.one = torch.ones((), dtype=dt, device=dev)
        self.u = torch.zeros((R - 1, self.M), dtype=dt, device=dev)
        self.parity = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.prop = torch.zeros((R - 1,), dtype=torch.int32, device=dev)
        self.accs = torch.zeros_like(self.prop)
        kernel = bind_pt_swap(self.q, self.lp, self.betas, self.u,
                              self.parity, self.prop, self.accs)
        if hasattr(target, "bind_value"):
            evaluate = target.bind_value(self.q, self.one, self.lp)
        else:
            def evaluate():
                self.lp.copy_(target(self.q, self.one)[0])

        def swap():
            evaluate()
            kernel(launch_stream(dev))

        self._swap = swap
        self.graph = None
        if dev.type == "cuda" and hasattr(target, "bind_value"):
            # the capture's warm-up runs a round on q0 at parity 0 with
            # u = 0 (log u = -inf: every finite pair swaps); the counters
            # are reset after it
            self.graph = capture_steps({"pt_swap": swap}, dev)["pt_swap"]
            self.prop.zero_()
            self.accs.zero_()

    def __call__(self, q, u, parity: int):
        """One swap round from the states q (C, dim) with the uniforms u
        (R - 1, M) at ``parity`` (0 or 1): -> the states after it (a new
        tensor)."""
        self.q.copy_(q)
        self.u.copy_(u)
        self.parity.fill_(int(parity))
        if self.graph is None:
            self._swap()
        else:
            self.graph.replay()
            GRAPH_COUNTS["pt_swap"] += 1
        return self.q.clone()


def swap_acceptance(prop, accs, dtype):
    """(R - 1,) accepted over proposed swaps of each pair (0 where none was
    proposed), divided once, in ``dtype``."""
    return accs.to(dtype) / torch.clamp(prop, min=1).to(dtype)
