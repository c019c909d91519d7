"""Tracing and profiling (counterpart of magi_v2_tpu/utils/profiling.py):
named phase walls, a ``torch.profiler`` trace of the CPU and the card, and
a structured sampler report."""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


def untimed(name: str):
    """The timer of a call that records nothing."""
    return contextlib.nullcontext()


class PhaseTimer:
    """Named phase walls. ``with timer.phase(name):`` adds the block's host
    seconds to ``phases[name]``, after waiting for ``device`` when it is a
    card, so the wall includes the device work the block queued. The timer
    is also the callable that ``timer=`` arguments take (``untimed`` is the
    one that records nothing): ``with timer(name):``."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    __call__ = phase

    def report(self) -> dict:
        total = sum(self.phases.values())
        return {**{k: round(v, 3) for k, v in self.phases.items()},
                "total_s": round(total, 3)}

    def __repr__(self):
        return f"PhaseTimer({json.dumps(self.report())})"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, the CPU's and, where there
    is a card, its kernels, written as a Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing or Perfetto). Yields the
    profiler, whose ``key_averages()`` sums the kernels by name.

    Usage:
        with device_trace("magi-trace"):
            model.predict(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sampler_report(results: dict, wall_seconds: float | None = None) -> dict:
    """Structured diagnostics from a predict() results dict."""
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    kr = results["kernel_results"]
    theta = np.asarray(results["thetas_samps"])
    if theta.ndim == 2:
        theta = theta[:, None, :]
    summary = summarize_chains(theta, wall_seconds)
    return {
        "step_size": float(np.asarray(kr["step_size"])),
        "mean_accept_prob": float(np.asarray(kr["accept_probs"]).mean()),
        "divergence_rate": float(np.asarray(kr["divergences"]).mean()),
        "mean_tree_depth": float(np.asarray(kr["depths"]).mean()),
        "mean_leapfrogs_per_step": float(
            np.asarray(kr["num_leapfrogs"]).mean()),
        **summary,
    }
