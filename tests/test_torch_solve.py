"""The form of the factor that K4 reads (ops/banded.py: ``fold_factor``,
the diagonal-tile inverses folded into the tiles) and the recurrence the
kernel runs on it (``block_banded_solve_folded_plain``), against the JAX
package's block_banded_triangular_solve_upper and
banded_diag_tile_inverses, on the CPU: x = U^{-1} y and its adjoint
U^{-T} g, in float64 and in float32 (the folded tiles formed in float64
and cast, as the sampler does), over part-filled last tiles (N = 300,
600), one and three components and one and seven chains. The kernel
itself is held against the plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SOLVE_TOL
from magi_v2_tpu.ops import banded as jb
from magi_v2_tpu.ops import banded_host as jbh
from magi_v2_tpu_torch.ops import banded as tb

torch.set_num_threads(2)

# N -> the factor's half-bandwidth: 3 and 4 tile columns
BANDS = {300: 200, 600: 300}


@functools.lru_cache(maxsize=None)
def _factor(N):
    """A well-conditioned upper band in the JAX package's block form, its
    diagonal-tile inverses from the JAX package, both float64 numpy."""
    rng = np.random.default_rng(N)
    U = np.triu(rng.standard_normal((N, N)) * 0.1) + np.eye(N) * 3.0
    band = jbh.dense_to_banded_np(U, BANDS[N])
    blocks = jb.banded_to_blocks_upper(jnp.asarray(band), 128)
    dinv = jb.banded_diag_tile_inverses(blocks, N)
    return np.array(blocks), np.array(dinv)


@functools.lru_cache(maxsize=None)
def _jax_solution(N, C, adjoint):
    """(rhs, solution) in natural order, (C, N): U^{-1} y from the JAX
    lax.scan, or U^{-T} g as the vector-Jacobian product of that solve."""
    blocks, dinv = (jnp.asarray(a) for a in _factor(N))
    rhs = np.random.default_rng(C).standard_normal((C, N))
    solve = lambda v: jb.block_banded_triangular_solve_upper(  # noqa: E731
        blocks, v, diag_inv=dinv)
    if adjoint:
        _, vjp = jax.vjp(solve, jnp.zeros((C, N)))
        return rhs, np.asarray(vjp(jnp.asarray(rhs))[0])
    return rhs, np.asarray(solve(jnp.asarray(rhs)))


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("C", [1, 7])
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("N", [300, 600])
def test_folded_solve_matches_jax(N, D, C, dtype, adjoint):
    """The right-hand side enters as the sampler hands it to K4: a
    component-major (D, C, M) block viewed (C, D, M), element m*D + d of
    the natural order."""
    blocks, dinv = _factor(N)
    rhs, ref = _jax_solution(N, C, adjoint)
    factor = tb.UpperFactor.make(torch.as_tensor(blocks),
                                 torch.as_tensor(dinv), N).to(dtype)
    assert factor.kt_fwd.dtype == factor.kt_adj.dtype == dtype
    M = N // D
    y_dcm = torch.as_tensor(rhs).view(C, M, D).permute(2, 0, 1).contiguous()
    y = y_dcm.to(dtype).permute(1, 0, 2)
    kt = factor.kt_adj if adjoint else factor.kt_fwd
    x = tb.block_banded_solve_folded_plain(
        kt, y.permute(0, 2, 1).reshape(C, N), adjoint=adjoint)
    err = np.abs(x.double().numpy() - ref).max() / np.abs(ref).max()
    assert err <= SOLVE_TOL[dtype], err


@pytest.mark.parametrize("N", [300, 600])
def test_folded_tiles_are_the_factor(N):
    """K[i,0] = D_i^{-1} and K[i,s] = -D_i^{-1} U[i,s] (forward), and
    K'[j,0] = D_j^{-T}, K'[j,s] = -D_j^{-T} U[j-s,s]^T (adjoint), every tile
    stored transposed; tiles beyond the matrix are zero."""
    blocks, dinv = (torch.as_tensor(a) for a in _factor(N))
    kt_fwd, kt_adj = tb.fold_factor(blocks, dinv)
    nb, nwu = blocks.shape[:2]
    for i in range(nb):
        assert torch.equal(kt_fwd[i, 0], dinv[i].T)
        assert torch.equal(kt_adj[i, 0], dinv[i])
        for s in range(1, nwu):
            fwd = -(dinv[i] @ blocks[i, s]) if i + s < nb else 0.0 * dinv[i]
            torch.testing.assert_close(kt_fwd[i, s], fwd.T, rtol=0,
                                       atol=1e-15)
            adj = (-(dinv[i].T @ blocks[i - s, s].T) if i >= s
                   else 0.0 * dinv[i])
            torch.testing.assert_close(kt_adj[i, s], adj.T, rtol=0,
                                       atol=1e-15)
