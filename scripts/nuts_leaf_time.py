"""Time one replayed NUTS leaf of a checkout of this repository, on one CUDA
card.

    python3 scripts/nuts_leaf_time.py [--root DIR]

Imports ``magi_v2_tpu_torch`` from DIR (default: this checkout), so that
two commits can be timed in one call on one card (for example a
``git archive`` of the parent unpacked into a directory that .gitignore
lists, then this tree). Builds ``BoundNuts`` at the SEIR NUTS path's
shapes (256 chains, flat state 489, the full dense metric, float32, trees
up to depth 10) on a Gaussian target with a bound evaluation (one GEMM
with a fixed 489 x 489 precision and two elementwise kernels), settles it
for 10 transitions, then replays the captured leaf graph back to back with
every chain active at leaf 0 of doubling 4 (the leaf counter and the mask
restored before each replay): the wall a replay until the card finished,
and torch.profiler's device time of one leaf by kernel. Prints one JSON
line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--replays", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("nuts_leaf_time: no CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from magi_v2_tpu_torch.sampler.mass import mass_from_moments
    from magi_v2_tpu_torch.sampler.nuts import BoundNuts, NutsConfig, draw_noise

    dev = torch.device("cuda:0")
    C, dim = 256, 489
    g = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn((dim, dim), generator=g, dtype=torch.float64)
    cov = a @ a.T / dim + torch.eye(dim, dtype=torch.float64)
    prec = torch.linalg.inv(cov).to(dev, torch.float32)
    mass = mass_from_moments(torch.diagonal(cov).to(dev, torch.float32),
                             cov.to(dev, torch.float32))

    class Gaussian:
        """lp = -0.5 beta q P q^T, with a bound evaluation."""

        def bind(self, q, beta, lp, grad):
            def run():
                torch.matmul(q, prec, out=grad)
                grad.mul_(-beta)
                torch.sum(q * grad, dim=-1, out=lp).mul_(0.5)
            return run

        def __call__(self, q, beta):
            grad = -(q @ prec) * beta
            return 0.5 * torch.sum(q * grad, dim=-1), grad

    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((C, dim), generator=gen, device=dev)
    cfg = NutsConfig(10)
    bound = BoundNuts(Gaussian(), q, mass, cfg)
    eps = torch.tensor(0.3, device=dev)
    one = torch.ones((), device=dev)
    for _ in range(10):
        noise = draw_noise(gen, C, dim, cfg.max_tree_depth, torch.float32,
                           dev)
        q, _ = bound(q, eps, mass, one, noise)
    ctr0 = torch.tensor([4, 0], dtype=torch.int32, device=dev)
    leaf = bound.graphs["nuts_leaf"]

    def one_leaf():
        bound.ctr.copy_(ctr0)
        bound.active.fill_(True)
        leaf.replay()

    for _ in range(5):
        one_leaf()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.replays):
        one_leaf()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.replays * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_leaf()
        torch.cuda.synchronize()
    kernels = {e.key[:60]: round(e.self_device_time_total, 2)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    print(json.dumps({"root": args.root, "ms_per_leaf": wall_ms,
                      "device_us": round(sum(kernels.values()), 2),
                      "kernels_us": kernels}))


if __name__ == "__main__":
    main()
