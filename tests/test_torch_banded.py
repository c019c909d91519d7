"""Parity of the port's block-banded operators (ops/banded.py,
ops/banded_host.py) with the JAX package, in float64 on the CPU: storage
conversions, the block-banded matvec (K3) in both windows and its adjoint,
the diagonal-tile inverses, and the block-banded triangular solve (K4) and
its gradient. The CPU wrappers run the kernels' plain versions; the
kernels themselves are held against these on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magi_v2_tpu.ops import banded as jb
from magi_v2_tpu.ops import banded_host as jbh
from magi_v2_tpu_torch.ops import banded as tb
from magi_v2_tpu_torch.ops import banded_host as tbh

torch.set_num_threads(2)

TOL = 1e-12
# (N, half-bandwidth b, tile T): N not a multiple of T, several windows
CASES = [(300, 40, 128), (200, 150, 128), (37, 5, 16)]


def _band(N, b, D=3, seed=0):
    """Random (D, N, N) matrices and their diagonal storage, made with the
    JAX package's host twin of dense_to_banded (its jnp version dispatches
    one eager op per diagonal)."""
    A = np.random.default_rng(seed).standard_normal((D, N, N))
    return A, np.stack([jbh.dense_to_banded_np(a, b) for a in A])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("N,b,T", CASES)
def test_storage_conversions_match_jax(N, b, T):
    A, band = _band(N, b)
    np.testing.assert_array_equal(
        tb.dense_to_banded(torch.as_tensor(A), b).numpy(), band)
    if b <= 5:
        np.testing.assert_array_equal(
            band, np.asarray(jb.dense_to_banded(jnp.asarray(A), b)))
    np.testing.assert_array_equal(
        tb.banded_to_blocks(torch.as_tensor(band), T).numpy(),
        np.asarray(jb.banded_to_blocks(jnp.asarray(band), T)))
    np.testing.assert_array_equal(
        tb.banded_to_blocks_upper(torch.as_tensor(band), T).numpy(),
        np.asarray(jb.banded_to_blocks_upper(jnp.asarray(band), T)))


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("N,b,T", CASES)
def test_block_banded_matvec_and_adjoint_match_jax(N, b, T, upper):
    """y = A x over a chain axis, and the vector-Jacobian product in x
    against jax.vjp (the transposed block band: A is not symmetric)."""
    A, band = _band(N, b, seed=1)
    if upper:
        band = np.stack([jbh.dense_to_banded_np(np.triu(a), b) for a in A])
        blocks = np.asarray(jb.banded_to_blocks_upper(jnp.asarray(band), T))
        jf, tf = jb.block_banded_matvec_upper, tb.block_banded_matvec_upper
    else:
        blocks = np.asarray(jb.banded_to_blocks(jnp.asarray(band), T))
        jf, tf = jb.block_banded_matvec, tb.block_banded_matvec
    rng = np.random.default_rng(2)
    x, g = rng.standard_normal((2, 5, 3, N))
    yj, vjp = jax.vjp(lambda v: jf(jnp.asarray(blocks), v), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    yt = tf(torch.as_tensor(blocks), xt)
    yt.backward(torch.as_tensor(g))
    assert _rel(yj, yt.detach()) <= TOL
    assert _rel(vjp(jnp.asarray(g))[0], xt.grad) <= TOL


def _upper_factor(N, b, T, seed=3):
    """A well-conditioned upper band (unit-ish diagonal) in block form."""
    rng = np.random.default_rng(seed)
    U = np.triu(rng.standard_normal((N, N)) * 0.1) + np.eye(N) * 3.0
    band = jbh.dense_to_banded_np(U, b) if b else np.diag(U)[None]
    return np.asarray(jb.banded_to_blocks_upper(jnp.asarray(band), T))


@pytest.mark.parametrize("N,b,nwu", [(300, 0, 1), (300, 100, 2),
                                     (600, 300, 4)])
def test_diag_tile_inverses_match_jax(N, b, nwu):
    blocks = _upper_factor(N, b, 128)
    assert blocks.shape[1] == nwu
    dj = np.asarray(jb.banded_diag_tile_inverses(jnp.asarray(blocks), N))
    dt = tb.banded_diag_tile_inverses(torch.as_tensor(blocks), N).numpy()
    assert _rel(dj, dt) <= TOL


@pytest.mark.parametrize("N,b,nwu", [(300, 0, 1), (300, 100, 2),
                                     (600, 300, 4)])
def test_triangular_solve_and_gradient_match_jax(N, b, nwu):
    """x = U^{-1} y over a chain axis against the JAX lax.scan, and the
    gradient (forward substitution with U') against jax.grad."""
    blocks = _upper_factor(N, b, 128)
    assert blocks.shape[1] == nwu
    rng = np.random.default_rng(4)
    y, w = rng.standard_normal((2, 4, N))
    Bj = jnp.asarray(blocks)

    def loss(v):
        return jnp.sum(jnp.asarray(w) * jb.block_banded_triangular_solve_upper(
            Bj, v))

    xj = jb.block_banded_triangular_solve_upper(Bj, jnp.asarray(y))
    gj = jax.grad(loss)(jnp.asarray(y))
    yt = torch.tensor(y, requires_grad=True)
    xt = tb.block_banded_triangular_solve_upper(torch.as_tensor(blocks), yt)
    torch.sum(torch.as_tensor(w) * xt).backward()
    assert _rel(xj, xt.detach()) <= TOL
    assert _rel(gj, yt.grad) <= TOL


def test_banded_host_copy_is_identical():
    A, _ = _band(90, 10, D=1, seed=5)
    S = A[0] @ A[0].T + 90 * np.eye(90)
    for b in (3, 10):
        band_j, band_t = jbh.dense_to_banded_np(S, b), tbh.dense_to_banded_np(
            S, b)
        np.testing.assert_array_equal(band_t, band_j)
        ab = tbh.band_to_scipy_upper(band_t)
        np.testing.assert_array_equal(ab, jbh.band_to_scipy_upper(band_j))
        np.testing.assert_array_equal(tbh.scipy_upper_to_band(ab),
                                      jbh.scipy_upper_to_band(ab))
        Ut, jt = tbh.banded_cholesky_upper(band_t)
        Uj, jj = jbh.banded_cholesky_upper(band_j)
        np.testing.assert_array_equal(Ut, Uj)
        assert jt == jj


def _operator(N=200, b=40, D=3, seed=6):
    A, band = _band(N, b, D, seed)
    return A, tb.BandedMatrix.make(tb.banded_to_blocks(torch.as_tensor(band)))


@pytest.mark.parametrize("adjoint", [False, True])
def test_matvec_wrapper_on_strided_views(adjoint):
    """K3's wrapper on the layouts the banded target hands it: x (C, D, N)
    and y a transposed (D, C, 2N) half, with alpha and accumulate, against
    the dense operator."""
    A, op = _operator()
    D, N = A.shape[0], A.shape[-1]
    C = 5
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((C, D, N)))
    i = np.arange(N)
    Ab = np.where(np.abs(i[:, None] - i[None, :]) <= 40, A, 0.0)
    if adjoint:
        Ab = Ab.transpose(0, 2, 1)
    ref = np.einsum("dnm,cdm->cdn", Ab, x.numpy())
    out = torch.ones((D, C, 2 * N), dtype=torch.float64)
    y = out[..., N:].transpose(0, 1)
    tb.banded_matvec(op, x, y, adjoint=adjoint, alpha=-2.0, accumulate=True)
    assert _rel(1.0 - 2.0 * ref, y) <= TOL
    assert torch.equal(out[..., :N], torch.ones((D, C, N), dtype=torch.float64))
    tb.banded_matvec(op, x, y, adjoint=adjoint)
    assert _rel(ref, y) <= TOL


@pytest.mark.parametrize("adjoint", [False, True])
def test_solve_wrapper_folds_the_interleaved_permutation(adjoint):
    """K4's wrapper reads and writes the sampler's component-major (C, D, N)
    and (D, C, N) blocks as views of the interleaved vector n*D + d."""
    N_I, D = 70, 3
    N = N_I * D
    blocks = _upper_factor(N, 50, 128, seed=8)
    U = torch.as_tensor(blocks)
    factor = tb.UpperFactor.make(U, tb.banded_diag_tile_inverses(U, N), N)
    rng = np.random.default_rng(9)
    y_nat = torch.as_tensor(rng.standard_normal((4, N)))
    solve = (tb.block_banded_triangular_solve_upper_adjoint_plain if adjoint
             else tb.block_banded_triangular_solve_upper_plain)
    ref = solve(factor.tiles, y_nat, factor.dinv)
    # y as a (D, C, N_I) block viewed (C, D, N_I); x into (C, D, N_I)
    y_dcn = y_nat.view(4, N_I, D).permute(2, 0, 1).contiguous()
    x = torch.empty((4, D, N_I), dtype=torch.float64)
    tb.banded_solve(factor, y_dcn.permute(1, 0, 2), x, adjoint=adjoint)
    assert _rel(ref, x.permute(0, 2, 1).reshape(4, N)) <= TOL


def test_wrappers_check_their_arguments():
    _, op = _operator(N=60, b=5)
    x = torch.zeros((2, 3, 60), dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        tb.banded_matvec(op, x.float(), torch.empty_like(x))
    with pytest.raises(ValueError, match="do not match"):
        tb.banded_matvec(op, x[:, :2], torch.empty_like(x[:, :2]))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        meta = op.to("meta")
        tb.banded_matvec(meta, x.to("meta"), x.to("meta"))
    blocks = torch.as_tensor(_upper_factor(60, 5, 128))
    f = tb.UpperFactor.make(blocks, tb.banded_diag_tile_inverses(blocks, 60),
                            60)
    with pytest.raises(ValueError, match="do not match"):
        tb.banded_solve(f, torch.zeros((2, 1, 59), dtype=torch.float64),
                        torch.zeros((2, 1, 59), dtype=torch.float64))


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    _, op = _operator(N=60, b=5)
    x = torch.as_tensor(np.random.default_rng(10).standard_normal((2, 3, 60)))
    tb.reset_launch_counts()
    y = tb.banded_matvec(op, x, torch.empty_like(x))
    ref = tb.block_banded_matvec_plain(op.tiles, x, op.hw_lo, op.hw_hi)
    assert torch.equal(y, ref)
    assert tb.launch_counts() == {k: 0 for k in tb.KERNELS}


def test_transpose_blocks_is_the_transposed_band():
    A, band = _band(150, 30, D=1, seed=11)
    tiles = tb.banded_to_blocks(torch.as_tensor(band), 32)
    i = np.arange(150)
    At = np.where(np.abs(i[:, None] - i[None, :]) <= 30, A[0], 0.0).T
    ref = tb.banded_to_blocks(tb.dense_to_banded(torch.as_tensor(At)[None],
                                                 30), 32)
    hw = (tiles.shape[-3] - 1) // 2
    assert torch.equal(tb.transpose_blocks(tiles, hw, hw), ref)
