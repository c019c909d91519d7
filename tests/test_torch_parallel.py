"""Chain sharding (``magi_v2_tpu_torch.parallel``), the counterparts of
tests/test_parallel.py: the mesh and shard layout over eight CPU shards
(the JAX tests' eight virtual host devices), and sharded runs against
unsharded ones, for NUTS, HMC with a dense tail, parallel tempering and a
bound ``GNTarget`` of a small SEIR fit, in float64 on the CPU.

The analytic targets are written per chain, with no product across the
chain axis, as the JAX tests' vmapped targets are: a GEMM's bits may
depend on how many rows it is given, which a sharded run changes. No
wall-clock test: the JAX package's records one such test as flaky."""

import numpy as np
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.parallel import (
    chain_mesh,
    run_chains_sharded,
    shard_chain_states,
)
from magi_v2_tpu_torch.sampler.run import SamplerConfig, run_chains
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

F64 = torch.float64
CPU8 = (torch.device("cpu"),) * 8


def _gaussian(q, beta_temp):
    """A standard normal at beta_temp (0-dim, or one per chain)."""
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    return -0.5 * beta_temp * (q * q).sum(-1), -b * q


def test_mesh_of_eight_shards():
    mesh = chain_mesh(CPU8)
    assert len(mesh) == 8 and all(d.type == "cpu" for d in mesh)


def test_shard_chain_states_layout():
    q0 = torch.arange(80, dtype=F64).reshape(16, 5)
    parts = shard_chain_states(q0, chain_mesh(CPU8))
    assert len(parts) == 8
    assert {tuple(p.shape) for p in parts} == {(2, 5)}
    assert torch.equal(torch.cat(parts), q0)


def test_sharded_nuts_matches_unsharded():
    cfg = SamplerConfig(num_results=20, num_burnin_steps=20,
                        use_annealing=False, max_tree_depth=4)
    q0 = torch.zeros((8, 3), dtype=F64) + 0.5
    s_ref, st_ref = run_chains(_gaussian, q0, 0, cfg)
    s_sh, st = run_chains_sharded(_gaussian, q0, 0, cfg, mesh=CPU8)
    np.testing.assert_allclose(s_sh.numpy(), s_ref.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(st.num_leapfrogs, st_ref.num_leapfrogs)
    assert np.isfinite(float(st.step_size))


def test_sharded_tail_dense_hmc_matches_unsharded():
    """The dense tail's Welford covariance pools over every shard's
    chains; a pooling fault would move the metric by O(1)."""
    rho = 0.9
    prec = torch.linalg.inv(torch.tensor([[1.0, rho], [rho, 1.0]],
                                         dtype=F64))

    def logp_grad(q, beta_temp):
        head, tail = q[:, :2], q[:, 2:]
        g_tail = -(tail[:, :1] * prec[0] + tail[:, 1:] * prec[1])
        return (-0.5 * (head ** 2).sum(-1) + 0.5 * (g_tail * tail).sum(-1),
                torch.cat([-head, g_tail], dim=1))

    cfg = SamplerConfig(num_results=20, num_burnin_steps=60,
                        use_annealing=False, adapt_mass_matrix=True,
                        dense_tail_size=2, algorithm="hmc",
                        hmc_num_leapfrogs=8)
    q0 = torch.zeros((8, 4), dtype=F64) + 0.3
    s_ref, _ = run_chains(logp_grad, q0, 2, cfg)
    s_sh, stats = run_chains_sharded(logp_grad, q0, 2, cfg, mesh=CPU8)
    np.testing.assert_allclose(s_sh.numpy(), s_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert stats.tail_inv_mass.shape == (2, 2)
    assert np.isfinite(float(stats.step_size))


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_sharded_pt_matches_unsharded(algorithm):
    """A 2-rung ladder, one rung a shard: the swap rounds run on the
    gathered chains."""
    cfg = SamplerConfig(num_results=20, num_burnin_steps=20,
                        use_annealing=False, max_tree_depth=4,
                        algorithm=algorithm, hmc_num_leapfrogs=6,
                        pt_betas=(1.0, 0.4), pt_swap_every=2)
    q0 = torch.zeros((8, 3), dtype=F64) + 0.5
    s_ref, st_ref = run_chains(_gaussian, q0, 3, cfg)
    s_sh, st = run_chains_sharded(_gaussian, q0, 3, cfg,
                                  mesh=chain_mesh(CPU8[:2]))
    np.testing.assert_allclose(s_sh.numpy(), s_ref.numpy(), rtol=0,
                               atol=1e-12)
    assert torch.equal(st.pt_swap_accept, st_ref.pt_swap_accept)
    assert float(st.pt_swap_accept[0]) > 0.0


@pytest.fixture(scope="module")
def seir_model():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, None, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    return from_fit_arrays(arrays, tseir, 3, config=MagiConfig(device="cpu"))


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_sharded_gn_target_matches_unsharded(seir_model, algorithm):
    """predict's dense GN target, bound per shard (its own copy, with its
    own workspace of 2 chains): the draws agree with the one-shard run's
    to the last bits of float64 (its GEMMs see fewer rows a shard)."""
    tm = seir_model
    mode = tm._build_sampling_setup("precond", "dense", F64)[0]
    ND = tm.mag_I * tm.D
    q0 = torch.cat([mode.X0.reshape(1, -1), torch.full((1, 3), -3.0,
                                                        dtype=F64),
                    torch.tensor([[1.8, -0.5, 0.6]], dtype=F64)], dim=1)
    q0 = q0.repeat(8, 1)
    q0[:, :ND] += 0.01 * torch.randn((8, ND), dtype=F64,
                                     generator=torch.Generator().manual_seed(0))
    cfg = SamplerConfig(num_results=10, num_burnin_steps=10,
                        algorithm=algorithm, hmc_num_leapfrogs=8,
                        max_tree_depth=4)
    s_ref, _ = run_chains(mode.logp_grad, q0, 5, cfg)
    s_sh, _ = run_chains_sharded(mode.logp_grad, q0, 5, cfg,
                                 mesh=chain_mesh(CPU8[:4]))
    scale = s_ref.abs().max()
    assert (s_sh - s_ref).abs().max() <= 1e-10 * scale
    # each shard bound its own copy of the target
    assert mode.logp_grad._workspaces.keys() <= {1, 8}


def test_sharded_rejects_uneven_chains():
    with pytest.raises(ValueError, match="multiple of mesh size 8"):
        run_chains_sharded(_gaussian, torch.zeros((6, 3), dtype=F64), 0,
                           SamplerConfig(num_results=2, num_burnin_steps=2),
                           mesh=CPU8)
    with pytest.raises(ValueError, match="multiple of mesh size 4"):
        shard_chain_states(torch.zeros((6, 3)), CPU8[:4])


def test_chain_mesh_needs_a_card(monkeypatch):
    """No devices given and no card visible: an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_mesh()
