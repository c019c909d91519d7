"""The theta start's Adam on one CUDA card: the eager loop against the
graph path (``init.py:adam_minimize``) at several chunk sizes, on the fit
of the SEIR vignette's data (81 observations, N_I = 161).

    python3 scripts/adam_graph_probe.py [--iters 10000] [--chunks 25,50,100]

Prints the card's name and power limit, then, for the eager loop and for
each chunk size K (``init.GRAPH_CHUNK`` set to it), the wall of the
steps (host clock around a call that ends in a synchronize), ms a step,
and the graph path's largest relative difference from the eager loop in
theta and in the losses. Each K runs twice, in a forward and then a
reversed sweep, each run with its own capture; ``1+K`` rows time the
warm-up step, the capture and one replay alone.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from magi_v2_tpu_torch import MAGI_v2, MagiConfig  # noqa: E402
from magi_v2_tpu_torch import api  # noqa: E402
from magi_v2_tpu_torch import init as tinit  # noqa: E402
from magi_v2_tpu_torch.models import seir_f_vec  # noqa: E402


def theta_start_loss(device):
    """The loss and start of the theta start, as ``initial_fit`` builds
    them on ``device`` (its own theta start cut to 2 steps)."""
    seen = {}
    real = tinit.adam_minimize

    def spy(loss_fn, params, *args, **kwargs):
        seen["loss"], seen["params"] = loss_fn, params
        return real(loss_fn, params, *args, **kwargs)

    tinit.adam_minimize = spy
    try:
        ts, X, _ = chip_smoke.seir_data()
        cfg = MagiConfig(device=device, dtype=torch.float32,
                         hparam_optimizer="lbfgs", init_num_iters=2)
        MAGI_v2(3, ts, X, 80, seir_f_vec, cfg).initial_fit(1)
    finally:
        tinit.adam_minimize = real
    return seen["loss"], seen["params"]


def timed(loss, params, n, graph):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, losses = tinit.adam_minimize(loss, params, 0.01, n, graph=graph)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, p["th"], losses


def rel(a, b):
    return float(((a - b).abs() / b.abs()).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10_000)
    ap.add_argument("--chunks", default="25,50,100,200,400")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          flush=True)
    loss, params = theta_start_loss("cuda")
    n = args.iters
    s, th_e, l_e = timed(loss, params, n, graph=False)
    print(f"eager        n={n:6d} {s:8.3f} s {1e3 * s / n:.4f} ms/step",
          flush=True)
    chunks = [int(k) for k in args.chunks.split(",")]
    for k in chunks + chunks[::-1]:
        tinit.GRAPH_CHUNK = k
        s, th, losses = timed(loss, params, n, graph=True)
        s1, _, _ = timed(loss, params, 1 + k, graph=True)
        print(f"graph K={k:4d} n={n:6d} {s:8.3f} s {1e3 * s / n:.4f} "
              f"ms/step; theta rel {rel(th, th_e):.2e}, losses rel "
              f"{rel(losses, l_e):.2e}; 1+K {s1:.3f} s", flush=True)


if __name__ == "__main__":
    main()
