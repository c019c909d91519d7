"""What a traced run (``--trace 1``) reads around the port's calls: the
port's own launch and graph counters over each call's sampling phase, and
a ``torch.profiler`` trace of a bounded slice of one call's transitions
(``Tap``, told of each transition by ``judge.Capture``)."""

from __future__ import annotations

import torch


def counters() -> dict:
    """The port's launch counts by kernel (and by K1 functor) and its graph
    replays by step name."""
    from magi_v2_tpu_torch.ops import banded, manifold, nuts, pt
    from magi_v2_tpu_torch.sampler import hmc

    out = {}
    for mod in (manifold, banded, hmc, nuts, pt):
        out.update(mod.launch_counts())
    out.update(manifold.functor_launch_counts())
    out.update({f"graph:{k}": v for k, v in hmc.graph_counts().items()})
    return out


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class Slice:
    """The profiled transitions of one call: the counters' change over it,
    its transitions' indices among the call's, and the profiler."""

    def __init__(self):
        self.first = self.last = None
        self.counts = {}
        self.prof = None


class Tap:
    """An observer of ``judge.Capture`` in a traced run: snapshots the
    port's counters at each call's first sampling transition and at its
    end (``sampling_counts``, one dict a call), and in the call
    ``profile_call`` profiles transitions [burnin + skip, burnin + skip +
    length) with torch.profiler (CPU and CUDA)."""

    def __init__(self, burnin: int, profile_call: int | None = None,
                 skip: int = 10, length: int = 10):
        self.burnin = burnin
        self.profile_call = profile_call
        self.skip, self.length = skip, length
        self.sampling_counts = []
        self.slice = None
        self._at_sampling = None

    def before(self, call: int, n: int):
        if n == self.burnin:
            self._at_sampling = counters()
        if call == self.profile_call and n == self.burnin + self.skip:
            from torch.profiler import ProfilerActivity, profile

            sync()
            s = self.slice = Slice()
            s.first = n
            s.prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA]
                                if torch.cuda.is_available() else []))
            s.prof.start()
            s._c0 = counters()

    def after(self, call: int, n: int):
        s = self.slice
        if (s is not None and s.prof is not None and s.last is None
                and call == self.profile_call
                and n == s.first + self.length - 1):
            sync()
            s.counts = delta(counters(), s._c0)
            s.prof.stop()
            s.last = n

    def end_call(self, call: int):
        """The counters' change over the call's sampling phase."""
        self.sampling_counts.append(
            delta(counters(), self._at_sampling)
            if self._at_sampling is not None else {})
        self._at_sampling = None


# the trace of the slice ----------------------------------------------------


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_slice(s: Slice, top: int = 10) -> dict:
    """From the slice's trace: device seconds by kernel name; the traced
    window, from the first operation the trace holds (host or device) to
    the device's last end, so that the profiler's own start is outside
    it; the union of the device's busy intervals in it; and the idle gaps
    between busy intervals summed by the innermost host operation running
    at each gap's middle."""
    events = s.prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda]
    host = [e for e in events if e.device_type != cuda]
    by_kernel = {}
    for e in dev:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + (e.time_range.end - e.time_range.start) * 1e-6)
    busy = _merge([[e.time_range.start, e.time_range.end] for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    window_s = 0.0
    if busy:
        first = min([busy[0][0]] + [e.time_range.start for e in host])
        window_s = (busy[-1][1] - first) * 1e-6
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = (min(inner, key=lambda e: e.time_range.end
                    - e.time_range.start).name if inner else "(no host op)")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"kernel_s": by_kernel, "busy_s": busy_s, "window_s": window_s,
            "device_ops": rank(by_kernel),
            "idle_gaps": rank(gaps), "counts": s.counts, "first": s.first,
            "last": s.last}
