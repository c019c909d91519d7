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


def _pair_operands(N, b, upper, dt, seed=12):
    """Two random banded operators of one window (JAX tiles, port
    operators), chains-major x (C, D, N) and strided (D, C, 2N) buffers."""
    D, C = 3, 5
    rng = np.random.default_rng(seed)
    blocks, ops = [], []
    for k in range(2):
        A = rng.standard_normal((D, N, N))
        if upper:
            band = np.stack([jbh.dense_to_banded_np(np.triu(a), b) for a in A])
            bl = np.asarray(jb.banded_to_blocks_upper(jnp.asarray(band)))
            hw = (0, bl.shape[-3] - 1)
        else:
            band = np.stack([jbh.dense_to_banded_np(a, b) for a in A])
            bl = np.asarray(jb.banded_to_blocks(jnp.asarray(band)))
            hw = (None, None)
        blocks.append(bl)
        ops.append(tb.BandedMatrix.make(torch.as_tensor(bl).to(dt), *hw))
    jf = jb.block_banded_matvec_upper if upper else jb.block_banded_matvec
    return D, C, rng, blocks, ops, jf


# float64: the same sums in another order; float32: one rounding per term
# of a ~2b-term sum, relative to max |y|
@pytest.mark.parametrize("dt,tol", [(torch.float64, 1e-12),
                                    (torch.float32, 2e-5)])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("N,b", [(300, 40), (200, 150)])
def test_paired_matvec_matches_jax(N, b, upper, dt, tol):
    """banded_matvec_pair (y1 = a1 A1 x, y2 = a2 A2 x on one x, into the
    strided halves of a (D, C, 2N) buffer) and its adjoint form against
    the JAX matvec and its jax.vjp; N is no multiple of 128."""
    D, C, rng, blocks, ops, jf = _pair_operands(N, b, upper, dt)
    x = rng.standard_normal((C, D, N))
    xt = torch.as_tensor(x).to(dt)
    for adjoint in (False, True):
        refs = []
        for bl in blocks:
            y, vjp = jax.vjp(lambda v: jf(jnp.asarray(bl), v), jnp.asarray(x))
            refs.append(np.asarray(vjp(jnp.asarray(x))[0] if adjoint else y))
        out = torch.full((D, C, 2 * N), 7.0, dtype=dt)
        y1, y2 = (out[..., :N].transpose(0, 1), out[..., N:].transpose(0, 1))
        got = tb.banded_matvec_pair(ops[0], ops[1], xt, y1, y2,
                                    adjoint=adjoint, alpha=(1.0, -0.5))
        assert got[0] is y1 and got[1] is y2
        assert _rel(refs[0], y1.double()) <= tol
        assert _rel(-0.5 * refs[1], y2.double()) <= tol
        tb.banded_matvec_pair(ops[0], ops[1], xt, y1, y2, adjoint=adjoint,
                              accumulate=True)
        assert _rel(2.0 * refs[0], y1.double()) <= 2 * tol
        assert _rel(0.5 * refs[1], y2.double()) <= 2 * tol


@pytest.mark.parametrize("dt,tol", [(torch.float64, 1e-12),
                                    (torch.float32, 2e-5)])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("N,b", [(300, 40), (200, 150)])
def test_summed_matvec_matches_jax(N, b, upper, dt, tol):
    """banded_matvec_sum (y (+)= a1 op(A1) x1 + a2 op(A2) x2, the two
    inputs the strided halves of a (D, C, 2N) buffer, y a transposed
    (D, C, N) block) against the JAX matvec and its jax.vjp."""
    D, C, rng, blocks, ops, jf = _pair_operands(N, b, upper, dt, seed=13)
    xcat = rng.standard_normal((D, C, 2 * N))
    y0 = rng.standard_normal((D, C, N))
    xt = torch.as_tensor(xcat).to(dt)
    x1, x2 = xt[..., :N].transpose(0, 1), xt[..., N:].transpose(0, 1)
    for adjoint in (False, True):
        refs = []
        for bl, xs in zip(blocks, (x1, x2)):
            v = jnp.asarray(xs.double().numpy())
            y, vjp = jax.vjp(lambda u: jf(jnp.asarray(bl), u), v)
            refs.append(np.asarray(vjp(v)[0] if adjoint else y))
        ref = refs[0] - refs[1]                        # (C, D, N)
        out = torch.as_tensor(y0).to(dt).clone()
        y = tb.banded_matvec_sum(ops[0], ops[1], x1, x2, out.transpose(0, 1),
                                 adjoint=adjoint, alpha=(1.0, -1.0),
                                 accumulate=True)
        assert _rel(y0.transpose(1, 0, 2) + ref, y.double()) <= tol
        tb.banded_matvec_sum(ops[0], ops[1], x1, x2, out.transpose(0, 1),
                             adjoint=adjoint, alpha=(1.0, -1.0))
        assert _rel(ref, out.transpose(0, 1).double()) <= tol


def test_bound_matvec_reads_its_tensors_at_each_call():
    """bind_matvec checks once and returns the call: it sees what x holds
    when it runs, and counts nothing on the CPU."""
    _, op = _operator(N=60, b=5)
    x = torch.zeros((2, 3, 60), dtype=torch.float64)
    y = torch.empty_like(x)
    run = tb.bind_matvec((op,), (x,), (y,))
    x.copy_(torch.as_tensor(np.random.default_rng(14).standard_normal(
        (2, 3, 60))))
    tb.reset_launch_counts()
    run(0)
    assert torch.equal(y, tb.block_banded_matvec_plain(op.tiles, x, op.hw_lo,
                                                       op.hw_hi))
    assert tb.launch_counts() == {k: 0 for k in tb.KERNELS}


def test_paired_wrappers_check_their_arguments():
    _, op = _operator(N=60, b=5)
    _, wide = _operator(N=60, b=5, D=2)
    x = torch.zeros((2, 3, 60), dtype=torch.float64)
    y = torch.empty_like(x)
    with pytest.raises(ValueError, match="one shape and window"):
        tb.banded_matvec_pair(op, wide, x, y, y.clone())
    with pytest.raises(TypeError, match="dtype"):
        tb.banded_matvec_sum(op, op, x, x.float(), y)
    with pytest.raises(ValueError, match="do not match"):
        tb.banded_matvec_pair(op, op, x, y, y[:1])
    with pytest.raises(ValueError, match="not a matvec"):
        tb.bind_matvec((op, op), (x, x), (y, y))
    with pytest.raises(ValueError, match="contiguous last"):
        tb.banded_matvec(op, x.transpose(1, 2).contiguous().transpose(1, 2),
                         y)


def test_slab_order_is_the_kernels_layout():
    """slab_order[..., k, c, r] = tile[..., 32k + r, c]; the adjoint form is
    the slab order of the transposed band."""
    A, op = _operator(N=300, b=40, D=2, seed=15)
    t = op.tiles
    assert op.kt_fwd.shape == t.shape[:-2] + (4, 128, 32)
    assert torch.equal(op.kt_fwd[1, 2, 1, 3, 17, 5],
                       t[1, 2, 1, 3 * 32 + 5, 17])
    assert torch.equal(op.kt_adj, tb.slab_order(
        tb.transpose_blocks(t, op.hw_lo, op.hw_hi)))
    small = tb.banded_to_blocks(tb.dense_to_banded(torch.as_tensor(A), 40), 32)
    assert tb.slab_order(small) is small
