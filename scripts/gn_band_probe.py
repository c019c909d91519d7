"""Time of the banded Gauss-Newton precision at the Lorenz dense-grid
shapes: the port's assembly (dense float64 products, then one gather of
the band) on the CPU, and on the card when one is present, against the
JAX package's SciPy sparse assembly.

    python3 scripts/gn_band_probe.py

Inputs are ``chip_smoke.gn_band_inputs()``: synthetic symmetric
band-limited operators and their square roots at N_I = 1025, D = 3,
bandsize 100 (the precision's bandwidth 4 * D * bandsize = 1200, as
``build_gn_cholesky_banded`` takes it with the operators' square roots).
Prints one JSON line: the best of three walls of each assembly (the
card's after a warm-up call, from the inputs on the card to the band on
the host), and each band's largest difference from the reference band
over the reference's largest entry. The reference is the JAX package's
SciPy assembly (``magi_v2_tpu.sampler.precond``) where no card is
present; on the card's machine, where the JAX package does not run, the
card's band is held to the port's CPU band.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from magi_v2_tpu_torch.sampler import precond  # noqa: E402


def best_of(fn, reps=3, sync=lambda: None):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return out, min(walls)


def main():
    args, kw = chip_smoke.gn_band_inputs()
    line = {"shape": {"N_I": 1025, "D": 3, "bandsize": 100,
                      "bandwidth": args[-1]},
            "threads": torch.get_num_threads()}
    cpu, line["port_cpu_s"] = best_of(
        lambda: precond.gauss_newton_precision_band(*args, **kw))
    rel = lambda band, ref: float(np.abs(band - ref).max()
                                  / np.abs(ref).max())
    if torch.cuda.is_available():
        dev = torch.device("cuda:0")
        on_card = lambda a: (torch.as_tensor(a, device=dev)
                             if isinstance(a, np.ndarray) else a)
        cargs = tuple(on_card(a) for a in args)
        ckw = {k: on_card(v) for k, v in kw.items()}
        card = lambda: precond.gauss_newton_precision_band(*cargs, **ckw)
        card()
        band, line["port_card_s"] = best_of(
            card, sync=lambda: torch.cuda.synchronize(dev))
        line["card"] = torch.cuda.get_device_name(dev)
        line["card_vs_port_cpu"] = rel(band, cpu)
    else:
        from magi_v2_tpu.sampler import precond as jax_precond

        ref, line["scipy_sparse_s"] = best_of(
            lambda: jax_precond.gauss_newton_precision_band(*args, **kw),
            reps=1)
        line["port_cpu_vs_scipy"] = rel(cpu, ref)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
