"""Warmup's re-seat rule (``SamplerConfig.reseat_accept_below``,
``sampler/run.py:reseat_stuck``), a port-side rule the JAX package does
not have: chains whose mean acceptance since the last boundary is below
the threshold move to the state of a chain drawn from the others, at the
start of each mass window and at the end of step-size adaptation, never
later than four fifths into burn-in.

On a trap target (a standard normal, and far out a well so narrow that no
step the bulk tunes can move a chain in it) the trapped chains are moved
and every draw is in the bulk, for HMC, NUTS, parallel tempering and a
sharded run; the same seed gives the same draws; with the rule off they
never leave the well. Where no chain is flagged, the draws are the bits
the rule off gives."""

import numpy as np
import pytest
import torch

from magi_v2_tpu_torch.sampler.run import (
    SamplerConfig,
    make_shards,
    reseat_stretches,
    reseat_stuck,
    run_chains,
)
from magi_v2_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(2)

C, DIM, WELL = 16, 2, 20.0
TRAPPED = (5, 11)
KINDS = {
    "nuts": {"max_tree_depth": 5},
    "hmc": {"algorithm": "hmc", "hmc_num_leapfrogs": 8},
    "pt": {"algorithm": "hmc", "hmc_num_leapfrogs": 8,
           "pt_betas": (1.0, 0.5), "pt_swap_every": 2},
}


def _trap(q, beta_temp):
    """A standard normal in each coordinate below 10; from 10 on, a well
    of curvature 1e6 around WELL (-100 at its floor): a chain placed at
    its floor stays put, as every move the bulk's step makes ends far up
    its walls."""
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    inside = q >= 10.0
    f = torch.where(inside, -0.5e6 * (q - WELL) ** 2 - 100.0, -0.5 * q * q)
    g = torch.where(inside, -1e6 * (q - WELL), -q)
    return beta_temp * f.sum(-1), b * g


def _q0():
    q0 = 0.3 * torch.randn((C, DIM), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(1))
    q0[list(TRAPPED), 0] = WELL
    return q0


def _cfg(kind, **kw):
    base = dict(num_results=40, num_burnin_steps=60, use_annealing=False,
                profile_timings=True, **KINDS[kind])
    base.update(kw)
    return SamplerConfig(**base)


def _run(cfg, target=_trap, q0=None, seed=3, shards=None):
    """(samples, the warmup span's attrs) of one traced run."""
    timer = PhaseTimer("cpu", trace=True)
    samples, _ = run_chains(target, _q0() if q0 is None else q0, seed, cfg,
                            shards=shards, timer=timer)
    (warmup,) = [s for s in timer.spans if s.name == "warmup"]
    return samples, warmup.attrs


def test_boundaries_leave_a_fifth_of_burn_in():
    """Each boundary leaves a fifth of burn-in after it and none is step
    0; each stretch is the last twentieth of burn-in before its boundary,
    from the boundary before it at the earliest."""
    for B in (1, 3, 4, 10, 60, 200, 1000):
        for frac in (0.5, 0.8, 1.0):
            num_adapt = int(frac * B)
            starts = (int(0.25 * B), int(0.45 * B), int(0.5 * B))
            st = reseat_stretches(B, num_adapt, starts)
            assert all(0 < b <= min(num_adapt, B - -(-B // 5))
                       for b in st), (B, st)
            prev = 0
            for b in sorted(st):
                assert st[b] == max(prev, b - -(-B // 20))
                prev = b
    assert reseat_stretches(200, 160, (90,)) == {90: 80, 160: 150}
    assert reseat_stretches(150, 120, (37, 75)) == {37: 29, 75: 67,
                                                    120: 112}
    assert reseat_stretches(500, 400, (225,)) == {225: 200, 400: 375}
    assert reseat_stretches(200, 200, (10, 12)) == {10: 0, 12: 10, 160: 150}


def test_reseat_stuck_moves_the_flagged_chains_to_others():
    qs = torch.arange(12, dtype=torch.float64).reshape(6, 2)
    acc = torch.tensor([9.0, 0.1, 8.0, 0.0, 7.0, 9.0], dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    out, moved = reseat_stuck(qs, acc, 10, 0.05, gen)
    assert moved == 2
    kept = [0, 2, 4, 5]
    assert torch.equal(out[kept], qs[kept])
    for c in (1, 3):
        assert any(torch.equal(out[c], qs[d]) for d in kept)
    # nothing flagged, or half the chains or more (the shared step fails,
    # not the chains): nothing drawn, nothing moved
    half = torch.tensor([0.0, 9.0, 0.0, 9.0, 0.0, 9.0], dtype=torch.float64)
    for a in (torch.full((6,), 5.0, dtype=torch.float64),
              torch.zeros(6, dtype=torch.float64), half):
        state = gen.get_state()
        same, moved = reseat_stuck(qs, a, 10, 0.05, gen)
        assert moved == 0 and same is qs
        assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_trapped_chains_are_reseated_in_warmup(kind):
    cfg = _cfg(kind)
    samples, attrs = _run(cfg)
    B = cfg.num_burnin_steps
    bounds = [b for b, _ in attrs["reseats"]]
    assert bounds == sorted(reseat_stretches(B, int(0.8 * B),
                                             (int(0.45 * B),)))
    assert max(bounds) <= B - B // 5
    assert attrs["chains_reseated"] == len(TRAPPED)
    assert sum(n for _, n in attrs["reseats"]) == len(TRAPPED)
    # every draw of every chain is in the bulk
    assert float(samples[..., 0].max()) < 10.0
    # the same seed, the same draws
    again, attrs2 = _run(cfg)
    assert torch.equal(samples, again)
    assert attrs2["reseats"] == attrs["reseats"]
    # with the rule off a trapped chain stays in the well to the end
    off, attrs_off = _run(cfg._replace(reseat_accept_below=0.0))
    assert attrs_off["chains_reseated"] == 0 and attrs_off["reseats"] == []
    assert bool((off[:, list(TRAPPED), 0] > 19.0).all(0).any())


def test_donors_come_from_every_shard():
    """A sharded run (two shards of eight chains) re-seats as the
    unsharded one does, bit for bit: one trapped chain in each shard."""
    cfg = _cfg("hmc")
    ref, attrs = _run(cfg)
    shards = make_shards(_trap, C, ["cpu", "cpu"])
    out, attrs_sh = _run(cfg, shards=shards)
    assert attrs_sh["reseats"] == attrs["reseats"]
    assert attrs["chains_reseated"] == 2
    assert torch.equal(out, ref)


def _gaussian(q, beta_temp):
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    return -0.5 * beta_temp * (q * q).sum(-1), -b * q


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_no_chain_flagged_gives_the_bits_of_the_rule_off(kind):
    cfg = _cfg(kind, use_annealing=True, anneal_mode="warmup_only")
    q0 = 0.5 * torch.randn((C, DIM), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(2))
    on, attrs = _run(cfg, _gaussian, q0)
    off, attrs_off = _run(cfg._replace(reseat_accept_below=0.0), _gaussian,
                          q0)
    assert attrs["chains_reseated"] == 0 and len(attrs["reseats"]) == 2
    assert attrs_off["reseats"] == []
    assert torch.equal(on, off)


def test_worst_chain_accept_on_the_sample_span():
    """The sample span's worst_chain_accept is the lowest mean acceptance
    of a chain over the phase's draws: 0 for a chain left in the well."""
    cfg = _cfg("hmc")
    for thr, trapped in ((0.0, True), (cfg.reseat_accept_below, False)):
        timer = PhaseTimer("cpu", trace=True)
        _, stats = run_chains(_trap, _q0(), 3,
                              cfg._replace(reseat_accept_below=thr),
                              timer=timer)
        (sample,) = [s for s in timer.spans if s.name == "sample"]
        worst = sample.attrs["worst_chain_accept"]
        assert worst == pytest.approx(float(
            stats.accept_probs.mean(0).min()), abs=0.0)
        assert (worst < 0.01) if trapped else (worst > 0.3)
