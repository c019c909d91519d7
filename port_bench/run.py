"""The benchmark of magi_v2_tpu_torch on NVIDIA cards.

    python3 port_bench/run.py --workload seir-hmc --seed 7 --seconds 30 --trace 0

Runs one cell of BENCHMARK.json (a configuration under a traffic mix) from
the root of a checkout: makes the observations from ``--seed``, fits the
model, warms up with a short predict, then drives whole ``predict`` calls
for ``--seconds`` and checks what they returned against the plain
reference. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. ``--trace 1`` profiles a slice of the first call's sampling phase
and reports the per-layer metrics instead of the end-to-end ones.

Without CUDA, or with fewer cards than the cell asks for, it exits with
code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness import manifest

    cell = manifest.Cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from port_bench.harness import core, report

    run, numbers, limits = core.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START)
    line = report.result(run, numbers, limits, device_kind=
                         torch.cuda.get_device_name(0), count=cell.chips)
    found = core.forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    report.print_checked(run, numbers, limits)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
