"""The result line of a run and the numbers compared beside their limits."""

from __future__ import annotations

import math
import sys

from port_bench.harness import manifest


def is_correct(run, numbers: dict, limits: dict) -> bool:
    return (run.failed == 0 and bool(run.calls)
            and all(numbers[k] <= limits[k] for k in limits))


def metrics(run) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``), each by its reader; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    for m in (run.cell.per_layer if run.trace else run.cell.end_to_end):
        value = manifest.reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run, numbers: dict, limits: dict, device_kind: str,
           count: int) -> dict:
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": is_correct(run, numbers, limits),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics(run), "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["checked"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    return line


def print_checked(run, numbers: dict, limits: dict) -> None:
    print(f"check took {run.check_s:.1f} s after the window", file=sys.stderr)
    for k in limits:
        print(f"{k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
