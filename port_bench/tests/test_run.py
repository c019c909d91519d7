"""The command's refusals and what a run may load: without a card it exits
non-zero and prints no result; nothing the benchmark runs loads JAX or the
JAX package, and the plain reference loads nothing of the port."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "magi_v2_tpu"}


def run(args, cwd=ROOT, env=None):
    env = dict(os.environ if env is None else env)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = run(["port_bench/run.py", "--workload", "seir-hmc", "--seed",
               "2147483999", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: the run exits non-zero and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run(["port_bench/run.py", "--workload", "seir-hmc", "--seed", "3",
               "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def loaded_after(imports):
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] for m in "
              "sys.modules})))")
    out = run(["-c", code])
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout))


def test_the_harness_loads_no_jax():
    mods = ["port_bench.harness.core", "port_bench.harness.report",
            "port_bench.harness.faults", "port_bench.control",
            "port_bench.reference.magi_ref"]
    mods += [f"port_bench.metrics.{p.stem}"
             for p in (BENCH / "metrics").glob("*.py")
             if p.stem != "__init__"]
    mods += ["magi_v2_tpu_torch", "magi_v2_tpu_torch.api"]
    assert not loaded_after(mods) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = ["port_bench.reference.magi_ref"]
    mods += [f"port_bench.reference.fields.{p.stem}"
             for p in (BENCH / "reference" / "fields").glob("*.py")
             if p.stem != "__init__"]
    loaded = loaded_after(mods)
    assert not loaded & (FORBIDDEN | {"magi_v2_tpu_torch", "chip_smoke",
                                      "bench"})


def test_no_source_under_the_reference_imports_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "magi_v2_tpu_torch", "chip_smoke", "bench"}, (path, n)


def test_the_forbidden_check_compares_whole_names():
    from port_bench.harness import core

    saved = dict(sys.modules)
    try:
        sys.modules["magi_v2_tpu_torch_x"] = sys
        assert "magi_v2_tpu" not in core.forbidden_modules()
        sys.modules["magi_v2_tpu.sub"] = sys
        assert "magi_v2_tpu" in core.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """On a card: one short traced run of the first cell prints a correct
    result with per-layer metrics and the device's busy time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "seir-hmc",
         "--seed", "2147483777", "--seconds", "5", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert "sampler_mfu_pct" in line["metrics"]
