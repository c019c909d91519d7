"""Tracing and profiling (counterpart of magi_v2_tpu/utils/profiling.py):
the port's one trace recorder (``PhaseTimer``: spans with ids and
parents, counters, device markers and the named phase walls), a
``torch.profiler`` trace of the CPU and the card, and a structured
sampler report.

A span is (id, parent, name, t0_ns, t1_ns, attrs): host
``time.perf_counter_ns`` at its start and end, ``parent`` the id of the
innermost span open when it opened (None for a root), ids unique within
the recorder. Spans are kept in memory and exported once, at the end of a
call (``PhaseTimer.export``). Counters are name -> int on the recorder.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time

import numpy as np
import torch

_now = time.perf_counter_ns


class Span:
    """One span of a trace (see the module's docstring)."""

    __slots__ = ("id", "parent", "name", "t0_ns", "t1_ns", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.id = self.parent = self._rf = None
        self.name, self.attrs = name, attrs
        self.t0_ns = self.t1_ns = None

    def as_dict(self) -> dict:
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
                "attrs": dict(self.attrs)}


class PhaseTimer:
    """The trace recorder. ``with timer.phase(name):`` (or ``with
    timer(name):``, the callable that ``timer=`` arguments take) records
    a phase span: at its end the recorder waits for ``device`` when it is
    a card, so the wall includes the device work the block queued, and
    adds the span's seconds to ``phases[name]`` (the sum of that name's
    spans). ``span(name, wait=...)`` records a span outside ``phases``
    that waits or not; ``open``/``close`` a fine-grained one (a
    transition, a doubling, a device read), which never waits. A span
    with ``hold_gc`` holds Python's garbage collector off while it is
    open and the recorder traces: the spans a sampling phase records
    (thousands of objects kept to its end) would otherwise set off full
    collections (~0.3 s each on a fitted model's process) inside the walls
    they time, where an untraced run makes few objects and sets off none.

    With ``trace`` False only ``phases`` is kept: no span, counter or
    marker. With ``trace`` True every span is kept (``spans``); a span
    that waits also records the counters' change over it
    (``attrs["counts"]``) and, on a card, ``torch.cuda.memory_allocated``
    and ``max_memory_allocated`` at its end (``mem_bytes``,
    ``mem_peak_bytes``; the peak is never reset here); and while a
    ``torch.profiler`` is active each span opens a record function of its
    name, so that the spans show in the profiler's trace as host ranges,
    on its clock.

    Device markers (one card): ``anchor(n)`` makes ``n`` timing events
    and records a CUDA event beside the host clock on an idle card;
    ``mark(span, key)`` then records one of the events on the current
    stream and settles nothing, so that between a NUTS doubling's device
    read and the next doubling's marker the recorder's host work is two
    spans' close and one's open; ``resolve_marks()``,
    after a synchronize, stores each marker's time on the host clock (the
    anchor's host time plus the events' elapsed time) in
    ``span.attrs[key]`` and ends the markers. The error is the anchor's
    launch latency."""

    def __init__(self, device=None, trace: bool = False):
        self.device = None if device is None else torch.device(device)
        self.trace = trace
        self.phases: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.spans: list[Span] = []
        self._open: list[Span] = []
        self._anchor = self._stream = None
        self._marks, self._free = [], []

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def open(self, name: str, **attrs) -> Span:
        s = Span(name, attrs)
        if self.trace:
            s.id = len(self.spans)
            s.parent = self.innermost()
            self.spans.append(s)
            self._open.append(s)
            if torch.autograd._profiler_enabled():
                # a host range of the function scope: a user-scope range
                # (torch.profiler.record_function) is also drawn on the
                # device's timeline over the kernels it launched, gaps
                # included, which a reader of the device's busy intervals
                # would count as busy
                s._rf = torch._C._profiler._RecordFunctionFast(name)
                s._rf.__enter__()
        s.t0_ns = _now()
        return s

    def innermost(self):
        """The id of the innermost open span (None: none is open)."""
        return self._open[-1].id if self._open else None

    def close(self, s: Span) -> None:
        s.t1_ns = _now()
        if self.trace:
            self._open.pop()
            if s._rf is not None:
                s._rf.__exit__(None, None, None)
                s._rf = None

    @contextlib.contextmanager
    def span(self, name: str, wait: bool = False, hold_gc: bool = False,
             **attrs):
        s = self.open(name, **attrs)
        counts0 = dict(self.counts) if wait and self.trace else None
        held = hold_gc and self.trace and gc.isenabled()
        if held:
            gc.disable()
        try:
            yield s
        finally:
            if wait and self._on_card():
                torch.cuda.synchronize(self.device)
                if self.trace:
                    s.attrs["mem_bytes"] = torch.cuda.memory_allocated(
                        self.device)
                    s.attrs["mem_peak_bytes"] = (
                        torch.cuda.max_memory_allocated(self.device))
            if counts0 is not None:
                s.attrs["counts"] = {k: v - counts0.get(k, 0)
                                     for k, v in self.counts.items()
                                     if v != counts0.get(k, 0)}
            self.close(s)
            if held:
                gc.enable()

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        with self.span(name, wait=True, **attrs) as s:
            yield s
        self.phases[name] = (self.phases.get(name, 0.0)
                             + (s.t1_ns - s.t0_ns) * 1e-9)

    __call__ = phase

    def count(self, name: str, n: int = 1) -> None:
        if self.trace:
            self.counts[name] = self.counts.get(name, 0) + n

    def anchor(self, n_marks: int = 0) -> None:
        """Starts the device markers (see the class's docstring): makes
        ``n_marks`` timing events (each recorded once here, so that a
        marker creates none), waits for the card, and records the anchor
        event on it while it is idle. Once the markers run, it does
        nothing."""
        if self.trace and self._on_card() and self._anchor is None:
            self._stream = torch.cuda.current_stream(self.device)
            self._free = [torch.cuda.Event(enable_timing=True)
                          for _ in range(n_marks)]
            for ev in self._free:
                ev.record(self._stream)
            torch.cuda.synchronize(self.device)
            ev = torch.cuda.Event(enable_timing=True)
            t = _now()
            ev.record(self._stream)
            self._anchor = (t, ev)

    def mark(self, s: Span, key: str) -> None:
        if self._anchor is not None:
            ev = (self._free.pop() if self._free
                  else torch.cuda.Event(enable_timing=True))
            ev.record(self._stream)
            self._marks.append((s, key, ev))

    def resolve_marks(self) -> None:
        """Each marker's time on the host clock, into its span, and the
        markers' end; call it once the card has passed them (after a
        synchronize)."""
        if self._anchor is not None:
            t, anchor = self._anchor
            for s, key, ev in self._marks:
                s.attrs[key] = t + round(anchor.elapsed_time(ev) * 1e6)
        self._anchor = self._stream = None
        self._marks, self._free = [], []

    def export(self) -> dict:
        """The trace: {"spans": [span dicts in opening order], "counts":
        {...}}."""
        return {"spans": [s.as_dict() for s in self.spans],
                "counts": dict(self.counts)}

    def report(self) -> dict:
        total = sum(self.phases.values())
        return {**{k: round(v, 3) for k, v in self.phases.items()},
                "total_s": round(total, 3)}

    def __repr__(self):
        return f"PhaseTimer({json.dumps(self.report())})"


class _Untimed:
    """The recorder that records nothing (``untimed``)."""

    trace = False

    def span(self, name: str, wait: bool = False, hold_gc: bool = False,
             **attrs):
        return contextlib.nullcontext()

    def phase(self, name: str, **attrs):
        return contextlib.nullcontext()

    __call__ = phase

    def count(self, name: str, n: int = 1) -> None:
        pass


untimed = _Untimed()


def children(spans: list) -> dict:
    """{parent id: [its child span dicts, in opening order]} of exported
    spans."""
    out = {}
    for s in spans:
        out.setdefault(s["parent"], []).append(s)
    return out


def sampling_phase(spans: list, name: str) -> dict | None:
    """The predict's sampling phase ``name`` ("eps_init", "warmup" or
    "sample") in exported ``spans``: that child of its ``sampling`` span,
    or None."""
    sampling = {s["id"] for s in spans if s["name"] == "sampling"}
    return next((s for s in spans
                 if s["name"] == name and s["parent"] in sampling), None)


def marker_gaps(spans: list, phase: dict) -> dict | None:
    """The wall of ``phase`` (a ``warmup`` or ``sample`` span of the
    exported ``spans``) split by the device markers of its transitions and
    NUTS doublings, in ns on the host clock: "wall" (the span's),
    "transitions" (each transition's dev_t1_ns - dev_t0_ns, summed),
    "doublings" (the same of each doubling), "read_stalls" (over
    consecutive doublings of one transition, the next
    one's dev_t0_ns - this one's dev_t1_ns: the card's idle after the
    doubling's device read, as nothing is queued between the two) and
    "between" (over consecutive transitions, the next one's dev_t0_ns -
    this one's dev_t1_ns: the sampling loop's work between transitions
    and any wait for the host). None where the phase has no transition,
    or a transition or doubling carries no markers."""
    kids = children(spans)
    trans = [t for b in kids.get(phase["id"], []) if b["name"] == "block"
             for t in kids.get(b["id"], []) if t["name"] == "transition"]
    dbls = [[d["attrs"] for d in kids.get(t["id"], [])
             if d["name"] == "doubling"] for t in trans]
    marked = lambda a: "dev_t0_ns" in a and "dev_t1_ns" in a
    if not trans or not all(marked(t["attrs"]) for t in trans) or not all(
            marked(a) for dbl in dbls for a in dbl):
        return None
    out = {"wall": phase["t1_ns"] - phase["t0_ns"], "transitions": 0,
           "doublings": 0, "read_stalls": 0, "between": 0}
    for prev, t, dbl in zip([None] + trans, trans, dbls):
        a = t["attrs"]
        out["transitions"] += a["dev_t1_ns"] - a["dev_t0_ns"]
        if prev is not None:
            out["between"] += a["dev_t0_ns"] - prev["attrs"]["dev_t1_ns"]
        out["doublings"] += sum(d["dev_t1_ns"] - d["dev_t0_ns"] for d in dbl)
        out["read_stalls"] += sum(b["dev_t0_ns"] - a0["dev_t1_ns"]
                                  for a0, b in zip(dbl, dbl[1:]))
    return out


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
