"""The readings the check's limits are set from, on the card.

    python3 port_bench/control.py --workload seir-hmc --seeds 11 12 13
    python3 port_bench/control.py --workload seir-hmc --seeds 11 --data-seed 5

For each seed: the cell's observations and fit, then one predict call at
the cell's own recipe and size as the window drives it, with one of its
sampling transitions captured as a run captures them, judged as a run
judges its calls (``harness/judge.py``); the same call under each planted
fault (``harness/faults.py``: stuck, half, altered, energy, kick;
truncated and truncated_k in hybrid storage; unfitted, a fit of its own,
read by ``fit_grad`` alone); and the control:
the reference itself in the program's place, computed in the precision
below the configuration's (``judge.control_precision``: TF32 on the card
for float32), on the sound call's captured states and whitened draws.
``--data-seed`` draws the observations' noise from another seed than the
configuration's. One JSON line per seed. The benchmark's runs never run
this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell_name: str, seed: int, device: str = "cuda",
             bench=None, base=None, faults=None, data_seed=None) -> dict:
    from port_bench.harness import core, faults as planted, judge, manifest

    cell = manifest.Cell(cell_name, bench,
                         manifest.BENCH if base is None else base)
    cfg, recipe = dict(cell.config), cell.recipe()
    if data_seed is not None:
        cfg["data_seed"] = data_seed
    cell.config = cfg
    ts, X_obs = core.observations(cfg)
    model = core.fit(cfg, ts, X_obs, device, [])
    fit_out = core.fit_outputs(cfg, ts, X_obs, model)
    N, D = model.mag_I, model.D
    pick = judge.picks(seed, int(recipe["num_burnin_steps"]),
                       int(recipe["num_results"]), calls=(0,))
    known = planted.for_storage(recipe.get("storage", "dense"))
    names = tuple(known if faults is None else faults)
    calls = {}
    for name in ("sound",) + tuple(n for n in names if n != "unfitted"):
        capture = judge.Capture(pick)
        with (known[name]() if name != "sound"
              else contextlib.nullcontext()), capture.installed(), \
                capture.call_of(0):
            res = model.predict(seed=core.call_seed(seed, 0), **recipe)
        calls[name] = ([judge.keep(res, N, D, capture.factors.get(0))],
                       capture.taken)
        del res
    if "unfitted" in names:
        with planted.unfitted():
            unfit = core.fit(cfg, ts, X_obs, device, [])
        unfit_out = core.fit_outputs(cfg, ts, X_obs, unfit)
        del unfit
    del model
    ref = judge.reference(cell, fit_out, device)
    out = {"workload": cell_name, "seed": seed, "data_seed": cfg["data_seed"]}
    for name, (kept, taken) in calls.items():
        out[name] = judge.judge(cell, fit_out, kept, taken, device, ref=ref)
    if "unfitted" in names:
        out["unfitted"] = {"fit_grad": judge.fit_gradient(cell, unfit_out)}
    out["control"] = judge.judge(cell, fit_out, *calls["sound"], device,
                                 control=judge.control_precision(cfg),
                                 ref=ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=None)
    ap.add_argument("--data-seed", type=int, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, faults=args.faults,
                                  data_seed=args.data_seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
