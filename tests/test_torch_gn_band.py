"""The port's banded Gauss-Newton precision (dense float64 products on the
operators' device, then one gather of the band) against the JAX package's
SciPy sparse assembly, on synthetic operators (``chip_smoke.gn_band_inputs``),
from NumPy arrays and from CPU tensors."""

import numpy as np
import pytest
import torch

import chip_smoke
from magi_v2_tpu.sampler import precond as jpc
from magi_v2_tpu_torch.sampler import precond as tpc

torch.set_num_threads(2)

CASES = {
    # N_I = 1025, D = 3, bandsize 100, the natural bandwidth 1200
    "lorenz_shapes": dict(),
    # operators dense, read at bandsize 5; the band cut at 10 of 60
    "truncated": dict(N=40, D=3, b=5, bw=10, width=40),
    # C^{-1}, K^{-1} themselves (no square roots), read at bandsize 6
    "no_sqrts": dict(N=40, D=2, b=6, bw=14, width=40, sqrts=False),
}

_REF = {}


def _case(name):
    if name not in _REF:
        args, kw = chip_smoke.gn_band_inputs(**CASES[name])
        _REF[name] = args, kw, jpc.gauss_newton_precision_band(*args, **kw)
    return _REF[name]


@pytest.mark.parametrize("inputs", ["numpy", "tensor"])
@pytest.mark.parametrize("case", list(CASES))
def test_gn_precision_band_matches_jax_sparse_assembly(case, inputs):
    args, kw, ref = _case(case)
    if inputs == "tensor":
        as_t = lambda a: (torch.as_tensor(a) if isinstance(a, np.ndarray)
                          else a)
        args = tuple(as_t(a) for a in args)
        kw = {k: as_t(v) for k, v in kw.items()}
    band = tpc.gauss_newton_precision_band(*args, **kw)
    assert isinstance(band, np.ndarray) and band.dtype == np.float64
    assert band.shape == ref.shape
    np.testing.assert_allclose(band, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # entries past the matrix's corners stay zero, as the sparse band's
    bw, n = (band.shape[0] - 1) // 2, band.shape[1]
    k = np.arange(-bw, bw + 1)[:, None]
    off = (np.arange(n)[None, :] + k < 0) | (np.arange(n)[None, :] + k >= n)
    assert not band[off].any()
