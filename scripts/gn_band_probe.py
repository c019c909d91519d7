"""Host time of the banded Gauss-Newton precision at the Lorenz dense-grid
shapes, with its band taken in one scatter of the nonzeros and with the
diagonal-by-diagonal extraction it replaced.

    python3 scripts/gn_band_probe.py

Builds synthetic symmetric band-limited operators at N_I = 1025, D = 3,
bandsize 100 (the precision's bandwidth 4 * D * bandsize = 1200, as
``build_gn_cholesky_banded`` takes it with the operators' square roots)
and runs ``magi_v2_tpu_torch.sampler.precond.gauss_newton_precision_band``
under cProfile twice: as it is (``sparse_band``), then with
``sparse_band`` swapped for one ``lam.diagonal(k)`` a row of the band
(2 * 1200 + 1 passes over the nonzeros). Checks that the two bands are
equal bit for bit and prints one JSON line of host seconds. Runs on the
CPU; no card is needed.
"""

import cProfile
import json
import pstats
import time

import numpy as np

from magi_v2_tpu_torch.sampler import precond


def by_diagonal(lam, bw):
    lam = lam.tocsr()
    n = lam.shape[0]
    band = np.zeros((2 * bw + 1, n), np.float64)
    for k in range(-bw, bw + 1):
        diag = lam.diagonal(k)
        if k >= 0:
            band[bw + k, : n - k] = diag
        else:
            band[bw + k, -k:] = diag
    return band


def profiled(args, kw):
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    band = precond.gauss_newton_precision_band(*args, **kw)
    prof.disable()
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    cum = lambda name: sum(v[3] for k, v in stats.items() if k[2] == name)
    return band, total, cum("__matmul__"), cum(precond.sparse_band.__name__)


def main():
    N, D, b = 1025, 3, 100
    rng = np.random.default_rng(0)
    A = rng.standard_normal((D, N, N))
    A = A + A.transpose(0, 2, 1)
    i = np.arange(N)
    A = A * (np.abs(i[:, None] - i[None, :]) <= b)
    J = rng.standard_normal((N, D, D))
    args = (A, A, A, 1.0, np.ones((N, D)), np.ones(D), J, 4 * D * b)
    kw = dict(comp_bandwidth=b, C_inv_sqrts=A, K_inv_sqrts=A)
    band, total, products, scatter = profiled(args, kw)
    scatter_fn = precond.sparse_band
    precond.sparse_band = by_diagonal
    try:
        old, old_total, _, extraction = profiled(args, kw)
    finally:
        precond.sparse_band = scatter_fn
    print(json.dumps({
        "shape": {"N_I": N, "D": D, "bandsize": b, "bandwidth": 4 * D * b},
        "band_equal": bool(np.array_equal(old, band)),
        "total_s": total, "sparse_products_s": products,
        "band_scatter_s": scatter, "total_by_diagonal_s": old_total,
        "band_by_diagonal_s": extraction}))


if __name__ == "__main__":
    main()
