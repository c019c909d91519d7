"""Per-chain acceptance through warmup and sampling, on the card, for the
benchmark's cells (``port_bench``): which chains stop accepting, and when.

    python3 scripts/warmup_accept_probe.py --workload lorenz1025-hybrid \
        --seed 2147485105 --calls 0 1 2 3 --out chiprun_out/accept

Fits the cell's configuration as a benchmark run does, then runs the
window's predict calls ``--calls`` (each at ``core.call_seed(seed, i)``)
and records, for every transition, each chain's acceptance statistic, the
step size and the last three coordinates of the state (the θ pre-images).
Each ``--extra`` (predict arguments over the recipe, such as
``reseat_accept_below=0``) is a variant that every call runs under.
Writes ``<out>/<workload>-<seed>-<call>[-v<variant>].npz`` (accept
(T, C), eps (T,), theta_pre (T, C, 3), burnin) and prints, per call, the
chains whose mean acceptance over the sampling phase is below 0.05 and,
for each, the last transition after which its acceptance never exceeds
0.05 again.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default="chiprun_out/accept")
    ap.add_argument("--extra", action="append", default=None,
                    help="predict arguments over the recipe, as k=v,...; "
                    "each --extra is a variant every call runs under")
    args = ap.parse_args()

    import torch

    from magi_v2_tpu_torch.sampler.hmc import BoundTransition
    from magi_v2_tpu_torch.sampler.nuts import BoundNuts
    from port_bench.harness import core, manifest

    cell = manifest.Cell(args.workload)
    cfg, recipe = cell.config, cell.recipe()
    variants = []
    for extra in args.extra or [""]:
        r = dict(recipe)
        for kv in filter(None, extra.split(",")):
            k, v = kv.split("=")
            r[k] = type(recipe[k])(v) if k in recipe else float(v)
        variants.append(r)
    ts, X_obs = core.observations(cfg)
    model = core.fit(cfg, ts, X_obs, "cuda", [])
    os.makedirs(args.out, exist_ok=True)
    rec = []

    def wrap(cls):
        call = cls.__call__

        def __call__(obj, q, step_size, *a, **kw):
            q_new, info = call(obj, q, step_size, *a, **kw)
            rec.append((info.accept_prob.detach().clone(),
                        torch.as_tensor(step_size).reshape(-1)[:1].clone(),
                        q[:, -3:].detach().clone()))
            return q_new, info
        cls.__call__ = __call__

    wrap(BoundTransition)
    wrap(BoundNuts)
    B = int(recipe["num_burnin_steps"])
    for i, (v, args_v) in ((i, va) for i in args.calls
                           for va in enumerate(variants)):
        rec.clear()
        res = model.predict(seed=core.call_seed(args.seed, i), **args_v)
        torch.cuda.synchronize()
        acc = torch.stack([t[0] for t in rec]).double().cpu().numpy()
        eps = torch.cat([t[1] for t in rec]).double().cpu().numpy()
        th = torch.stack([t[2] for t in rec]).double().cpu().numpy()
        name = f"{args.workload}-{args.seed}-{i}" + (f"-v{v}" if v else "")
        np.savez(os.path.join(args.out, f"{name}.npz"), accept=acc, eps=eps,
                 theta_pre=th, burnin=B,
                 thetas_samps=np.asarray(res["thetas_samps"]))
        samp = acc[B:].mean(axis=0)
        low = np.flatnonzero(samp < 0.05)
        print(f"{name}: {acc.shape[0]} transitions, sampling accept "
              f"median {np.median(samp):.3f} min {samp.min():.4f}; "
              f"warmup per-chain mean accept quantiles "
              f"{np.quantile(acc[:B].mean(0), [0, .01, .05, .5]).round(3)}",
              flush=True)
        for c in low:
            moving = np.flatnonzero(acc[:, c] > 0.05)
            last = int(moving.max()) if moving.size else -1
            print(f"  chain {c}: stuck after transition {last}; sampling "
                  f"mean {samp[c]:.4f}", flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
