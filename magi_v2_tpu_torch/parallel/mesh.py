"""Chain sharding: the chain axis split over a list of devices
(counterpart of magi_v2_tpu/parallel/mesh.py).

Chains are independent but for the statistics that pool them: dual
averaging's mean acceptance, the Welford moments of the mass windows and
the parallel-tempering swap rounds. The JAX package lays the chain axis
over a 1-D device mesh and lets XLA partition the run. Here one host
process drives every shard: ``sampler/run.py:Stepper`` runs each
transition over its shards, each a contiguous range of chains on its
device with its own copy of the target, workspaces and bound transition
(CUDA graphs on the card), and gathers the states on the first device,
where the pooled statistics are computed with the unsharded arithmetic.
The noise of all chains is drawn there once a transition and sliced, so a
sharded run draws what the unsharded one does.

A mesh is a tuple of devices, one entry per shard; an entry may repeat
(two shards of one card, or eight of the CPU as in the tests).
"""

from __future__ import annotations

import torch

from magi_v2_tpu_torch.sampler.run import SamplerConfig, make_shards, run_chains
from magi_v2_tpu_torch.utils.profiling import untimed


def chain_mesh(devices=None) -> tuple:
    """The mesh of ``devices`` (a sequence of devices or names), or of
    every visible CUDA device. Raises when no device is given and no card
    is visible: the CPU is never taken in its place."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "chain_mesh() found no CUDA device; pass devices= to shard "
                "over others (e.g. (torch.device('cpu'),) * 8)")
        devices = [f"cuda:{i}" for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_chain_states(q0, mesh) -> list:
    """(C, dim) chain states as contiguous (C / k, dim) pieces, piece i on
    ``mesh[i]`` (k = len(mesh)). C must be a multiple of k."""
    C, k = q0.shape[0], len(mesh)
    if C % k:
        raise ValueError(f"num chains {C} must be a multiple of mesh size {k}")
    M = C // k
    return [q0[i * M:(i + 1) * M].to(d) for i, d in enumerate(mesh)]


def run_chains_sharded(tempered_logp_grad, q0, seed: int,
                       config: SamplerConfig = SamplerConfig(), mesh=None,
                       timer=untimed):
    """``run_chains`` with the chain axis split over ``mesh`` (default:
    ``chain_mesh()``): the same arguments and the same result, (samples
    (num_results, C, dim), ChainStats), gathered on the mesh's first
    device (in host memory when the draws are staged). C must be a
    multiple of the mesh size. ``tempered_logp_grad`` is copied to each
    shard's device with its ``to`` where it has one (a plain callable is
    shared)."""
    if mesh is None:
        mesh = chain_mesh()
    shards = make_shards(tempered_logp_grad, q0.shape[0], mesh)
    return run_chains(tempered_logp_grad, q0, seed, config, shards=shards,
                      timer=timer)
