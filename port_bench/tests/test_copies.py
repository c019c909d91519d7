"""The benchmark's frozen copies give their originals' numbers at fixed
inputs: the bounds and peaks of chip_smoke.py, the ESS and split R-hat of
magi_v2_tpu_torch/utils/diagnostics.py, the RK4 simulator of
magi_v2_tpu_torch/utils/data.py, and the reference's fields against the
port's."""

import numpy as np
import pytest
import torch

import chip_smoke
from magi_v2_tpu_torch import models
from magi_v2_tpu_torch.utils import data, diagnostics
from port_bench.reference.fields import lorenz, seir
from port_bench.yardstick import bounds, simulate
from port_bench.yardstick import diagnostics as frozen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kname", ["manifold_fwd", "manifold_energy",
                                   "manifold_bwd", "manifold_fwd_whitened"])
@pytest.mark.parametrize("given,per_chain", [(False, False), (True, False),
                                             (False, True)])
def test_k1_bound(kname, dtype, given, per_chain):
    for shape in ((256, 161, 3, 3), (37, 333, 2, 4)):
        assert (bounds.k1_bound(kname, *shape, dtype, given, per_chain)
                == chip_smoke.k1_bound(kname, *shape, dtype, given,
                                       per_chain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_bounds(dtype):
    for C, dim, k in ((256, 489, 489), (64, 3081, 0), (257, 3081, 8)):
        assert bounds.k2_bound(C, dim, k, dtype) == chip_smoke.k2_bound(
            C, dim, k, dtype)
        for on in (0, C // 2, C):
            assert (bounds.k2_nuts_bound(C, on, dim, k, dtype)
                    == chip_smoke.k2_nuts_bound(C, on, dim, k, dtype))


def test_nuts_leaf_bound():
    for C, on, dim, k in ((256, 208, 489, 489), (64, 55, 397, 0)):
        for d, n in ((4, 7), (4, 8), (0, 0), (6, 31)):
            for taken in (0, 3):
                assert (bounds.nuts_leaf_bound(C, on, dim, k, torch.float32,
                                               d, n, taken)
                        == chip_smoke.nuts_leaf_bound(
                            C, on, dim, k, torch.float32, d, n, taken))


def test_nuts_leaves_bound_is_below_the_exact_sum():
    """One doubling of depth 3 at 256 chains, every chain running every
    leaf and no proposal taken: the lower bound is at most the exact sum."""
    C, dim, k, d = 256, 489, 489, 3
    exact = sum(bounds.nuts_leaf_bound(C, C, dim, k, torch.float32, d, n, 0)
                ["bound_ms"] for n in range(1 << d))
    low = bounds.nuts_leaves_bound(C, C * (1 << d), 1 << d, 1, dim, k,
                                   torch.float32)["bound_ms"]
    assert 0.5 * exact < low <= exact


def test_peaks_and_bound():
    assert bounds.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    assert bounds.PEAK_BYTES == chip_smoke.PEAK_BYTES
    assert bounds.K1_FLOPS == chip_smoke.K1_FLOPS
    assert bounds.K1_GIVEN_FLOPS == chip_smoke.K1_GIVEN_FLOPS
    for nbytes, flops in ((1e6, 1e3), (1e3, 1e9)):
        assert bounds.bound(nbytes, flops) == chip_smoke.bound(nbytes, flops)


def test_band_nonzeros_counts_a_dense_band():
    a = np.ones((50, 50))
    for lo, up in ((0, 7), (3, 3), (49, 49), (60, 0)):
        mask = np.triu(np.tril(a, up), -lo)
        assert bounds.band_nonzeros(50, lo, up) == int(mask.sum())


def test_diagnostics_copy():
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((300, 8)), axis=0) * 0.1 + \
        rng.standard_normal((300, 8))
    assert frozen.effective_sample_size(x) == \
        diagnostics.effective_sample_size(x)
    assert frozen.potential_scale_reduction(x) == \
        diagnostics.potential_scale_reduction(x)
    s = rng.standard_normal((100, 4, 3))
    assert frozen.summarize_chains(s, 2.0) == diagnostics.summarize_chains(
        s, 2.0)


def test_simulator_copy():
    kw = dict(x0=np.array([0.1, 0.05, 0.0]), thetas=np.array([6.0, 0.6, 1.8]),
              t_max=1.0, n_obs=11, noise_sd=0.005, seed=4, substeps=10)
    ts, X, Xt = simulate.simulate_ode(models.seir_f_vec, **kw)
    ts0, X0, Xt0 = data.simulate_ode(models.seir_f_vec, **kw)
    np.testing.assert_array_equal(ts, ts0)
    np.testing.assert_array_equal(X, X0)
    np.testing.assert_array_equal(Xt, Xt0)


@pytest.mark.parametrize("plain,port", [(seir.f_vec, models.seir_f_vec),
                                        (lorenz.f_vec, models.lorenz_f_vec)])
def test_reference_fields(plain, port):
    g = torch.Generator().manual_seed(0)
    t = torch.linspace(0, 1, 7, dtype=torch.float64)[:, None]
    X = torch.rand((5, 7, 3), generator=g, dtype=torch.float64)
    th = torch.rand((5, 3), generator=g, dtype=torch.float64) + 0.5
    if plain is lorenz.f_vec:
        X, th = 40.0 * X - 20.0, 10.0 * th
    torch.testing.assert_close(plain(t, X, th), port(t, X, th), rtol=1e-14,
                               atol=1e-14)
