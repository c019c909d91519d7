"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration in ``port_bench/configs/<name>.json``, a
traffic mix in ``port_bench/traffic/<name>.json``, the limits of a cell's
check in ``port_bench/limits/<cell>.json``, a field of the plain
reference in ``port_bench/reference/fields/<name>.py`` and a metric's
reader in ``port_bench/metrics/<name>.py``. Adding any of them is adding
a file; no code here names one."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, base: Path = BENCH) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str, base: Path = BENCH) -> dict:
    return load_json("configs", name, base)


def traffic(name: str, base: Path = BENCH) -> dict:
    return load_json("traffic", name, base)


def limits(cell: str, base: Path = BENCH) -> dict:
    return load_json("limits", cell, base)


def field(name: str):
    """The plain field f(t, X, thetas) of ``reference/fields/<name>.py``."""
    return importlib.import_module(f"port_bench.reference.fields.{name}").f_vec


def reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    return importlib.import_module(f"port_bench.metrics.{name}").read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, its traffic and
    the metrics that BENCHMARK.json assigns to it. ``base`` is the folder
    that holds configs/, traffic/ and limits/ (the benchmark's own unless
    a test gives another)."""

    def __init__(self, name: str, bench: dict | None = None,
                 base: Path = BENCH):
        bench = manifest() if bench is None else bench
        self.base = base
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload named {name!r}; BENCHMARK.json has "
                           f"{sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config_name = self.entry["config"]
        self.traffic_name = self.entry["traffic"]
        self.config = config(self.config_name, base)
        self.traffic = traffic(self.traffic_name, base)
        self.limits = limits(name, base)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]

    def recipe(self) -> dict:
        """predict()'s arguments: the traffic's, over the configuration's
        (such as a known noise variance)."""
        out = dict(self.config.get("predict", {}))
        out.update(self.traffic["predict"])
        for key in ("mass_window", "mass_window2"):
            if key in out:
                out[key] = tuple(out[key])
        return out
