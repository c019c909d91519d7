"""Host staging of draws (``SamplerConfig.stage_above_bytes``), HMC
without a jittered length (``hmc_jitter``) and the row-blocked pairwise
Matern build (``ops/kernels.py:_rowblocked``), in float64 on the CPU,
against the unstaged and direct forms and against the JAX package's
row-blocked build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu.ops.kernels as JK
import magi_v2_tpu_torch.ops.kernels as TK
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.sampler.run import (
    SamplerConfig,
    _ckpt_fingerprint,
    run_chains,
)
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

F64 = torch.float64
V = 2.01
KINDS = {
    "nuts": {"max_tree_depth": 4},
    "hmc": {"algorithm": "hmc", "hmc_num_leapfrogs": 8,
            "dense_tail_size": 2},
    "pt": {"algorithm": "hmc", "hmc_num_leapfrogs": 6,
           "pt_betas": (1.0, 0.5), "pt_swap_every": 2, "thin": 2},
}


def _gaussian(q, beta_temp):
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    return -0.5 * beta_temp * (q * q).sum(-1), -b * q


def _run(kind, **kw):
    base = dict(num_results=30, num_burnin_steps=20, use_annealing=False,
                dispatch_block_steps=8, profile_timings=True, **KINDS[kind])
    cfg = SamplerConfig(**{**base, **kw})
    return run_chains(_gaussian, torch.full((4, 3), 0.7, dtype=F64), 11, cfg)


@pytest.mark.parametrize("kind", list(KINDS))
def test_staged_draws_are_the_same_bits(kind):
    s_dev, st_dev = _run(kind)
    s_host, st_host = _run(kind, stage_above_bytes=0)
    assert s_host.device.type == "cpu"
    assert torch.equal(s_host, s_dev)
    for f in ("accept_probs", "divergences", "step_size", "inv_mass"):
        assert torch.equal(getattr(st_host, f), getattr(st_dev, f)), f
    for f in ("num_leapfrogs", "depths"):
        np.testing.assert_array_equal(getattr(st_host, f),
                                      getattr(st_dev, f))
    assert st_dev.timings["staged_bytes"] == 0
    # every draw and per-draw statistic crossed once
    per_draw = 4 * 3 * 8 + 4 * 8 + 4 + 4 * 4 + (4 * 4 if kind == "nuts"
                                                 else 0)
    assert st_host.timings["staged_bytes"] == 30 * per_draw


def test_no_staging_without_blocks():
    """The budget applies to blocked runs only, as in the JAX package."""
    _, st = _run("nuts", stage_above_bytes=0, dispatch_block_steps=0)
    assert st.timings["staged_bytes"] == 0


@pytest.fixture(scope="module")
def seir_model():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    return from_fit_arrays(arrays, tseir, 3, bandsize=20,
                           config=MagiConfig(device="cpu"))


@pytest.mark.parametrize("storage", ["dense", "hybrid"])
def test_predict_staged_matches_unstaged(seir_model, storage):
    kw = dict(num_results=12, num_burnin_steps=12, num_chains=4, seed=2,
              storage=storage, dispatch_block_steps=5, algorithm="hmc",
              hmc_num_leapfrogs=8, profile_timings=True)
    a = seir_model.predict(**kw)
    b = seir_model.predict(stage_above_bytes=0, **kw)
    for k in ("X_samps", "thetas_samps", "sigma_sqs_samps",
              "sample_results"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for k in ("accept_probs", "divergences", "num_leapfrogs"):
        np.testing.assert_array_equal(b["kernel_results"][k],
                                      a["kernel_results"][k], err_msg=k)
    assert a["timings"]["staged_bytes"] == 0
    assert b["timings"]["staged_bytes"] > 0


@pytest.mark.parametrize("pt", [False, True])
def test_hmc_without_jitter_takes_the_full_length(pt):
    kw = {"pt_betas": (1.0, 0.5)} if pt else {}
    _, st = _run("hmc", hmc_jitter=False, hmc_num_leapfrogs=5, **kw)
    assert np.all(st.num_leapfrogs == 5)
    assert np.all(st.depths == 3)
    _, st = _run("hmc", hmc_num_leapfrogs=5, **kw)
    assert len(np.unique(st.num_leapfrogs)) > 1


def test_hmc_jitter_fingerprinted_and_staging_not():
    q0 = torch.ones((4, 3), dtype=F64)
    fp = lambda **kw: _ckpt_fingerprint(SamplerConfig(**kw), 4, 3, 0, q0)
    assert fp(hmc_jitter=False) != fp()
    assert fp(stage_above_bytes=0) == fp()


# --- the row-blocked pairwise build -----------------------------------------

@pytest.fixture
def small_tiles(monkeypatch):
    """Both packages' row-blocked builds from 16 points up, in tiles of 16
    (37 points: two full tiles and a padded one)."""
    for mod in (JK, TK):
        monkeypatch.setattr(mod, "ROW_BLOCK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "ROW_BLOCK", 16)


GRID = np.sort(np.random.default_rng(3).uniform(0.0, 4.0, 37))


def test_rowblocked_matches_direct_and_jax(small_tiles):
    direct = TK._matern_parts(*TK._pairwise(torch.as_tensor(GRID)), 1.3,
                              0.7, V)
    blocked = TK.matern_derivative_matrices(torch.as_tensor(GRID), 1.3, 0.7,
                                            V)
    jblocked = JK.matern_derivative_matrices(jnp.asarray(GRID), 1.3, 0.7, V)
    for t, d, j in zip(blocked, direct, jblocked):
        assert t.shape == (37, 37)
        np.testing.assert_allclose(t.numpy(), d.numpy(), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-13)
    gram = TK.matern_gram(torch.as_tensor(GRID), 1.3, 0.7, V)
    assert torch.equal(gram, blocked[0])


def test_rowblocked_batched_over_components(small_tiles):
    phi1 = torch.tensor([1.3, 0.4], dtype=F64)
    phi2 = torch.tensor([0.7, 1.9], dtype=F64)
    blocked = TK.matern_derivative_matrices(torch.as_tensor(GRID), phi1,
                                            phi2, V)
    for d in range(2):
        one = TK._matern_parts(*TK._pairwise(torch.as_tensor(GRID)),
                               float(phi1[d]), float(phi2[d]), V)
        for t, o in zip(blocked, one):
            np.testing.assert_allclose(t[d].numpy(), o.numpy(), rtol=1e-12,
                                       atol=1e-13)


def test_rowblocked_phi_gradient(small_tiles):
    """d/dphi of a sum through the tiles, against the direct build's and
    JAX's row-blocked gradient."""
    def grads(build):
        p1 = torch.tensor(1.3, dtype=F64, requires_grad=True)
        p2 = torch.tensor(0.7, dtype=F64, requires_grad=True)
        build(p1, p2).sum().backward()
        return float(p1.grad), float(p2.grad)

    s = torch.as_tensor(GRID)
    g_blocked = grads(lambda a, b: TK.matern_gram(s, a, b, V))
    g_direct = grads(lambda a, b: TK._matern_parts(*TK._pairwise(s), a, b,
                                                   V)[0])
    g_jax = jax.grad(lambda a, b: jnp.sum(JK.matern_gram(
        jnp.asarray(GRID), a, b, V)), argnums=(0, 1))(1.3, 0.7)
    np.testing.assert_allclose(g_blocked, g_direct, rtol=1e-12)
    np.testing.assert_allclose(g_blocked, [float(g) for g in g_jax],
                               rtol=1e-12)
