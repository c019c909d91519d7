"""BENCHMARK.json keeps to the benchmark's rules, and every piece a cell
names is found by its name, so that a new configuration, traffic mix or
metric is a new file and no edit."""

import json
import re
import sys

import pytest

from port_bench.harness import judge, manifest

BENCH = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.setdefault(kind, []).append(e["name"])
    for kind, ns in names.items():
        assert len(ns) == len(set(ns)), kind
    metrics = names["end_to_end"] + names["per_layer"]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])


def test_each_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"] if manifest.applies(m, cell)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(manifest.applies(m, cell) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert manifest.applies(moved, cell), (m["name"], cell)


def test_each_config_has_a_cell_and_a_file():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert (manifest.ROOT / c["file"]).is_file()
        assert manifest.config(c["name"])["source"]


def test_every_cell_resolves_by_name():
    """Each cell's configuration, traffic, limits, field and every metric's
    reader are found from the names in BENCHMARK.json alone."""
    for w in BENCH["workloads"]:
        cell = manifest.Cell(w["name"])
        assert set(cell.limits) == set(judge.numbers(cell))
        assert callable(manifest.field(cell.config["field"]))
        assert cell.recipe()["num_chains"] >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A configuration, a traffic mix and limits in a folder of their own,
    a cell that names them, and a metric reader added as a file: all are
    picked up by name."""
    base = tmp_path
    for kind in ("configs", "traffic", "limits"):
        (base / kind).mkdir()
    cfg = manifest.config("seir-vignette")
    cfg["n_obs"] = 41
    (base / "configs" / "seir-new.json").write_text(json.dumps(cfg))
    traffic = manifest.traffic("hmc-dense")
    traffic["predict"]["num_chains"] = 64
    (base / "traffic" / "hmc-new.json").write_text(json.dumps(traffic))
    (base / "limits" / "new-cell.json").write_text(
        json.dumps({"fit_grad": 1e-2, "draw_gap": 1e-2, "stall": 3.0}))
    pkg = tmp_path / "metrics_extra"
    pkg.mkdir()
    (pkg / "new_metric.py").write_text("def read(run):\n    return 1.5\n")
    import port_bench.metrics as metrics

    monkeypatch.setattr(metrics, "__path__", list(metrics.__path__)
                        + [str(pkg)])
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "new-cell", "config": "seir-new", "traffic": "hmc-new",
         "chips": 1, "why": "a test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "new_metric", "unit": "s", "better": "lower",
         "source": "program_span", "layer": "facade", "moves": "predict_s",
         "workloads": ["new-cell"]}]
    cell = manifest.Cell("new-cell", bench, base)
    assert cell.config["n_obs"] == 41
    assert cell.recipe()["num_chains"] == 64
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert manifest.reader("new_metric")(None) == 1.5
    sys.modules.pop("port_bench.metrics.new_metric", None)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        manifest.Cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        manifest.config("no-such-config")
