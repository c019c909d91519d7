"""Host wall time of named phases, for ``MAGI_v2.predict_timings``."""

from __future__ import annotations

import contextlib
import time

import torch


def untimed(name: str):
    """The timer of a call that records nothing."""
    return contextlib.nullcontext()


class PhaseTimer:
    """``with timer(name):`` adds the host seconds of the block to
    ``times[name]``, after waiting for ``device`` when it is a card (so the
    time includes the device work the block queued)."""

    def __init__(self, device):
        self.device = device
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[name] = (self.times.get(name, 0.0)
                            + time.perf_counter() - t0)
