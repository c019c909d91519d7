"""Block-banded operators of the large-grid sampler: storage, the
block-banded matvec (K3) and the block-banded triangular solve (K4)
(counterpart of the block forms of magi_v2_tpu/ops/banded.py).

A banded (N, N) matrix is stored as (..., nb, nw, T, T) tiles, T = 128:
``tile[q, s, r, c] = A[q*T + r, (q + s - hw_lo)*T + c]`` over the nw =
hw_lo + hw_hi + 1 tile columns around the diagonal, zero outside the band
and the matrix. The symmetric window has hw_lo = hw_hi; the upper window
(a triangular factor) has hw_lo = 0, so s = 0 is the diagonal tile.

Three groups of functions:

- storage, run once at setup: ``dense_to_banded``, ``banded_to_blocks``,
  ``banded_to_blocks_upper``, ``banded_diag_tile_inverses``, and
  ``fold_factor`` (the diagonal-tile inverses folded into the tiles, the
  form K4 reads);
- plain PyTorch versions of the two kernels (the CPU path and the
  kernels' oracle): ``block_banded_matvec_plain`` and
  ``block_banded_triangular_solve_upper_plain``, with their adjoints, and
  ``block_banded_solve_folded_plain``, K4's recurrence on the folded form;
- the kernel wrappers ``banded_matvec`` (y = alpha op(A) x [+ y]), its
  paired forms ``banded_matvec_pair`` (y1 = a1 op(A1) x, y2 = a2 op(A2) x)
  and ``banded_matvec_sum`` (y = a1 op(A1) x1 + a2 op(A2) x2 [+ y]), one
  launch each, and ``banded_solve`` (x = U^{-1} y or U^{-T} y) on prepared
  operators (``BandedMatrix``, ``UpperFactor``), and the JAX package's
  functions ``block_banded_matvec``, ``block_banded_matvec_upper`` and
  ``block_banded_triangular_solve_upper`` as ``torch.autograd.Function``s
  whose backward is the adjoint kernel (gradients flow to x or y, not to
  the tiles).

Each wrapper takes the plain version for tensors on the CPU and, on a
CUDA tensor, launches the hand-written kernel of csrc/banded.cu or raises:
there is no fallback on the card. ``LAUNCH_COUNTS`` counts kernel
launches only.

What is checked when. A wrapper checks its arguments (dtype, device,
shapes, strides) on every call. ``bind_matvec`` and ``bind_solve`` check
once and return the call bound to those tensors: on the card a launch
whose argument list is already converted (``_build.Launch``), on the CPU
the plain version; calling it takes the stream and checks nothing. The
sampler's target binds its stages to fixed buffers this way
(sampler/precond.py), so a bound call reads and writes the tensors it was
given at binding time, whatever they hold by then. The wrappers are a
bind followed by one call.

The kernels read a tile element A[r][c] at ``[c][r]``, so that four rows
are one 16-byte read. K3 reads the slab-ordered tiles of ``slab_order``
(each 32-row chunk of a tile contiguous, the copy engine's unit), of A for
the forward form and of A^T (``transpose_blocks``) for the adjoint, both
built once when an operator is prepared; K4 reads the transposed tiles of
``fold_factor``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 128

KERNELS = ("banded_matvec", "banded_matvec_adjoint", "banded_matvec_pair",
           "banded_matvec_adjoint_pair", "banded_solve",
           "banded_solve_adjoint")
LAUNCH_COUNTS = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCH_COUNTS[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCH_COUNTS)


# --------------------------------------------------------------------------
# storage (setup)
# --------------------------------------------------------------------------


def dense_to_banded(A, bandwidth: int):
    """(..., N, N) dense -> (..., 2b+1, N) diagonal-offset storage,
    band[..., b + k, i] = A[..., i, i + k], zero outside the matrix."""
    N = A.shape[-1]
    b = bandwidth
    rows = []
    for k in range(-b, b + 1):
        diag = torch.diagonal(A, offset=k, dim1=-2, dim2=-1)
        pad = (0, k) if k >= 0 else (-k, 0)
        rows.append(torch.nn.functional.pad(diag, pad))
    return torch.stack(rows, dim=-2)


def banded_to_blocks(band, T: int = TILE):
    """(..., 2b+1, N) diagonal storage -> (..., nb, nw, T, T) tiles,
    tile[q, s, r, c] = A[q*T + r, (q + s - hw)*T + c], hw = ceil(b/T)."""
    two_b1, N = band.shape[-2], band.shape[-1]
    b = (two_b1 - 1) // 2
    hw = -(-b // T)
    nw = 2 * hw + 1
    nb = -(-N // T)
    dev = band.device
    q = torch.arange(nb, device=dev)[:, None, None, None]
    s = torch.arange(nw, device=dev)[None, :, None, None]
    r = torch.arange(T, device=dev)[None, None, :, None]
    c = torch.arange(T, device=dev)[None, None, None, :]
    i = q * T + r
    j = (q + s - hw) * T + c
    k = j - i
    valid = (k.abs() <= b) & (i < N) & (j >= 0) & (j < N)
    diag_idx = torch.clamp(b + k, 0, two_b1 - 1)
    row_idx = torch.clamp(i, 0, N - 1)
    blocks = band[..., diag_idx, row_idx]
    return torch.where(valid, blocks, torch.zeros((), dtype=band.dtype,
                                                  device=dev))


def banded_to_blocks_upper(band, T: int = TILE):
    """Tiles of an upper-triangular band (the rows k < 0 of ``band`` are
    zero): (..., nb, hw+1, T, T), s = 0 the diagonal tile."""
    full = banded_to_blocks(band, T)
    hw = (full.shape[-3] - 1) // 2
    return full[..., hw:, :, :]


def banded_diag_tile_inverses(blocks, N: int | None = None):
    """(nb, T, T) inverses of the diagonal tiles of an upper factor in
    ``banded_to_blocks_upper`` layout, for the triangular solve. Compute
    them once at setup in float64 and cast: an in-graph float32 solve
    collapsed the sampler's step size on the TPU (see the JAX function).
    Rows at global index >= N (tile padding) get a unit diagonal, so the
    padded solution stays exactly 0."""
    nb, T = blocks.shape[-4], blocks.shape[-2]
    if N is None:
        N = nb * T
    dev = blocks.device
    q = torch.arange(nb, device=dev)[:, None]
    r = torch.arange(T, device=dev)[None, :]
    pad_fix = ((q * T + r) >= N).to(blocks.dtype)
    eye = torch.eye(T, dtype=blocks.dtype, device=dev)
    return torch.linalg.inv(blocks[:, 0] + eye[None] * pad_fix[:, :, None])


def transpose_blocks(tiles, hw_lo: int, hw_hi: int):
    """Tiles of A^T from the tiles of A (window (hw_lo, hw_hi)); A^T has
    the window (hw_hi, hw_lo): AT[p, s'] = A[p + s' - hw_hi, nw-1-s']^T."""
    nb, nw = tiles.shape[-4], tiles.shape[-3]
    out = torch.zeros_like(tiles)
    for sp in range(nw):
        off = sp - hw_hi
        lo, hi = max(0, -off), min(nb, nb - off)
        if lo < hi:
            out[..., lo:hi, sp, :, :] = tiles[
                ..., lo + off:hi + off, nw - 1 - sp, :, :].transpose(-1, -2)
    return out


# --------------------------------------------------------------------------
# plain versions (the CPU path and the oracle of the kernels)
# --------------------------------------------------------------------------


def block_banded_matvec_plain(tiles, x, hw_lo: int, hw_hi: int):
    """y = A x for tiles covering tile columns [q - hw_lo, q + hw_hi];
    tiles (*B, nb, nw, T, T), x (*E, *B, N) (the leading *E are free
    dimensions, e.g. chains). As _block_banded_matvec_core of the JAX
    package: the windows of the zero-padded x against the tiles, with the
    tiles kept free of *E so that each tile row is one (T, nw*T) x
    (nw*T, E) GEMM."""
    nb, nw, T = tiles.shape[-4], tiles.shape[-3], tiles.shape[-2]
    B = tuple(tiles.shape[:-4])
    nB = 1
    for b in B:
        nB *= b
    N = x.shape[-1]
    E = x.shape[: x.dim() - 1 - len(B)]
    x = x.expand(E + B + (N,)).reshape(-1, nB, N)
    xp = torch.nn.functional.pad(x, (hw_lo * T, nb * T - N + hw_hi * T))
    xb = xp.reshape(-1, nB, nb + hw_lo + hw_hi, T)
    windows = torch.stack([xb[:, :, s: s + nb, :] for s in range(nw)],
                          dim=3)                       # (E, B, nb, nw, T)
    w = windows.permute(1, 2, 3, 4, 0).reshape(nB * nb, nw * T, -1)
    a = tiles.reshape(nB, nb, nw, T, T).permute(0, 1, 3, 2, 4)
    y = torch.bmm(a.reshape(nB * nb, T, nw * T), w)    # (B*nb, T, E)
    y = y.reshape(nB, nb * T, -1).permute(2, 0, 1)[..., :N]
    return y.reshape(E + B + (N,))


def block_banded_matvec_adjoint_plain(tiles, x, hw_lo: int, hw_hi: int):
    """y = A^T x, A in the layout of ``block_banded_matvec_plain``."""
    return block_banded_matvec_plain(transpose_blocks(tiles, hw_lo, hw_hi),
                                     x, hw_hi, hw_lo)


def _pad_rows(y, nb, T):
    B, N = y.shape
    return torch.nn.functional.pad(y, (0, nb * T - N)).reshape(B, nb, T)


def block_banded_triangular_solve_upper_plain(tiles, y, diag_inv):
    """x = U^{-1} y by back substitution over the nb block rows, as the
    JAX lax.scan: each row one diagonal-tile-inverse product and nwu-1
    off-diagonal tile products against the already solved rows.
    tiles (nb, nwu, T, T), y (B, N) -> x (B, N)."""
    nb, nwu, T = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    N = y.shape[-1]
    yb = _pad_rows(y, nb, T)
    xb = torch.zeros_like(yb)
    for i in range(nb - 1, -1, -1):
        acc = yb[:, i]
        for s in range(1, min(nwu, nb - i)):
            acc = acc - torch.einsum("rc,bc->br", tiles[i, s], xb[:, i + s])
        xb[:, i] = torch.einsum("rc,bc->br", diag_inv[i], acc)
    return xb.reshape(y.shape[0], nb * T)[:, :N]


def block_banded_triangular_solve_upper_adjoint_plain(tiles, g, diag_inv):
    """gy = U^{-T} g by forward substitution with the transposed tiles:
    the adjoint of ``block_banded_triangular_solve_upper_plain``."""
    nb, nwu, T = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    N = g.shape[-1]
    gb = _pad_rows(g, nb, T)
    out = torch.zeros_like(gb)
    for j in range(nb):
        acc = gb[:, j]
        for s in range(1, min(nwu, j + 1)):
            acc = acc - out[:, j - s] @ tiles[j - s, s]
        out[:, j] = acc @ diag_inv[j]
    return out.reshape(g.shape[0], nb * T)[:, :N]


def fold_factor(tiles, diag_inv):
    """The forms of U that K4 reads: the diagonal-tile inverses folded
    into the tiles, computed in float64 and cast to the tiles' dtype, so
    that the solve and its adjoint are each one recurrence over the block
    rows, ``x_i = K[i,0] y_i + sum_{s>=1} K[i,s] x_{i+s}`` (forward, i
    descending) and ``x_j = K'[j,0] y_j + sum_{s>=1} K'[j,s] x_{j-s}``
    (adjoint, j ascending), with

        K[i,0]  = D_i^{-1},   K[i,s]  = -D_i^{-1} U[i,s],
        K'[j,0] = D_j^{-T},   K'[j,s] = -D_j^{-T} U[j-s,s]^T.

    Returns (kt_fwd, kt_adj), each (nb, nwu, T, T) with every tile stored
    transposed (``kt[i, s, k, r] = K[i,s][r, k]``): a CTA's share of a
    tile, 16 of its columns, is then one contiguous slab."""
    dt = tiles.dtype
    U, Di = tiles.double(), diag_inv.double()
    nb, nwu = U.shape[0], U.shape[1]
    fwd = -(Di[:, None] @ U)
    fwd[:, 0] = Di
    DiT = Di.transpose(-1, -2)
    adj = torch.zeros_like(U)
    adj[:, 0] = DiT
    for s in range(1, min(nwu, nb)):
        adj[s:, s] = -(DiT[s:] @ U[: nb - s, s].transpose(-1, -2))
    return tuple(k.transpose(-1, -2).to(dt).contiguous() for k in (fwd, adj))


def block_banded_solve_folded_plain(kt, y, adjoint: bool = False):
    """The recurrence K4 runs, in plain PyTorch, on a form of
    ``fold_factor`` (``kt``, transposed tiles): x = U^{-1} y, or U^{-T} y
    for ``adjoint`` with the adjoint form. y (B, N) -> x (B, N)."""
    nb, nwu, T = kt.shape[0], kt.shape[1], kt.shape[2]
    N = y.shape[-1]
    yb = _pad_rows(y, nb, T)
    xb = torch.zeros_like(yb)
    for i in (range(nb) if adjoint else range(nb - 1, -1, -1)):
        acc = yb[:, i] @ kt[i, 0]
        for s in range(1, nwu):
            j = i - s if adjoint else i + s
            if not 0 <= j < nb:
                break
            acc = acc + xb[:, j] @ kt[i, s]
        xb[:, i] = acc
    return xb.reshape(y.shape[0], nb * T)[:, :N]


# --------------------------------------------------------------------------
# prepared operators
# --------------------------------------------------------------------------


# K3 gives one CTA _MV_ROWS rows of a tile row (csrc/banded.cu: kMvRows)
_MV_ROWS = 32


def slab_order(tiles):
    """The layout K3 reads: each tile cut into chunks of _MV_ROWS rows,
    every chunk stored column-major and contiguous,
    ``out[..., k, c, r] = tile[..., k*_MV_ROWS + r, c]``, so that a CTA's
    share of a tile is one contiguous slab. Tiles of another width than
    TILE, which the kernel does not take, are returned as they are."""
    T = tiles.shape[-1]
    if T != TILE:
        return tiles
    lead = tuple(tiles.shape[:-2])
    chunks = tiles.reshape(lead + (T // _MV_ROWS, _MV_ROWS, T))
    return chunks.transpose(-1, -2).contiguous()


class BandedMatrix(NamedTuple):
    """A block-banded operator ready for K3: tiles (B, nb, nw, T, T) (what
    the plain versions read) and the slab-ordered tiles of A and of A^T
    (what the forward and the adjoint kernel read)."""

    tiles: torch.Tensor
    kt_fwd: torch.Tensor
    kt_adj: torch.Tensor
    hw_lo: int
    hw_hi: int

    @classmethod
    def make(cls, tiles, hw_lo: int | None = None, hw_hi: int | None = None):
        """From (*B, nb, nw, T, T) tiles; the window defaults to the
        symmetric one."""
        nw = tiles.shape[-3]
        if hw_lo is None:
            hw_lo = hw_hi = (nw - 1) // 2
        if hw_lo + hw_hi + 1 != nw:
            raise ValueError(f"window ({hw_lo}, {hw_hi}) does not match "
                             f"{nw} tile columns")
        tiles = tiles.reshape((-1,) + tuple(tiles.shape[-4:])).contiguous()
        return cls(tiles, slab_order(tiles),
                   slab_order(transpose_blocks(tiles, hw_lo, hw_hi)),
                   hw_lo, hw_hi)

    def to(self, *args, **kwargs) -> "BandedMatrix":
        return self._replace(**{k: getattr(self, k).to(*args, **kwargs)
                                for k in ("tiles", "kt_fwd", "kt_adj")})


class UpperFactor(NamedTuple):
    """An upper block-banded factor ready for K4: tiles (nb, nwu, T, T) and
    the float64-computed diagonal-tile inverses (nb, T, T) (what the plain
    versions read), the two folded forms of ``fold_factor`` (what the
    kernel reads), and N. Make it from float64 tiles and cast it with
    ``to``, so that the folding is done in float64."""

    tiles: torch.Tensor
    dinv: torch.Tensor
    kt_fwd: torch.Tensor
    kt_adj: torch.Tensor
    N: int

    @classmethod
    def make(cls, tiles, dinv, N: int):
        return cls(tiles.contiguous(), dinv.contiguous(),
                   *fold_factor(tiles, dinv), int(N))

    def to(self, *args, **kwargs) -> "UpperFactor":
        return self._replace(**{k: getattr(self, k).to(*args, **kwargs)
                                for k in ("tiles", "dinv", "kt_fwd",
                                          "kt_adj")})


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_dtype_device(name, t, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"banded kernels take float32 or float64, not {dtype}")


_ENTRIES = {}


def _entry(kernel, dtype):
    name = f"magi_{kernel}_{_suffix(dtype)}"
    fn = _ENTRIES.get(name)
    if fn is None:
        from magi_v2_tpu_torch.ops._build import load_library

        fn = _ENTRIES[name] = load_library().entry(
            name, kernel.replace("_adjoint", ""))
    return fn


def _takes_plain(device) -> bool:
    """Whether a call on ``device`` runs the plain version: on the CPU
    only."""
    return device.type == "cpu"


def launch_stream(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as the integer a launch
    takes (0 on the CPU, where nothing is launched)."""
    return (torch.cuda.current_stream(device).cuda_stream
            if device.type == "cuda" else 0)


def banded_matvec_plain(op: BandedMatrix, x, y, adjoint: bool = False,
                        alpha: float = 1.0, accumulate: bool = False):
    """``banded_matvec`` in plain PyTorch, on any device."""
    fn = (block_banded_matvec_adjoint_plain if adjoint
          else block_banded_matvec_plain)
    r = alpha * fn(op.tiles, x, op.hw_lo, op.hw_hi)
    if accumulate:
        y.add_(r)
    else:
        y.copy_(r)
    return y


def banded_matvec_pair_plain(op1, op2, x, y1, y2, adjoint: bool = False,
                             alpha=(1.0, 1.0), accumulate: bool = False):
    """``banded_matvec_pair`` in plain PyTorch, on any device."""
    banded_matvec_plain(op1, x, y1, adjoint, alpha[0], accumulate)
    banded_matvec_plain(op2, x, y2, adjoint, alpha[1], accumulate)
    return y1, y2


def banded_matvec_sum_plain(op1, op2, x1, x2, y, adjoint: bool = False,
                            alpha=(1.0, 1.0), accumulate: bool = False):
    """``banded_matvec_sum`` in plain PyTorch, on any device."""
    banded_matvec_plain(op1, x1, y, adjoint, alpha[0], accumulate)
    banded_matvec_plain(op2, x2, y, adjoint, alpha[1], True)
    return y


def banded_solve_plain(factor: UpperFactor, y, x, adjoint: bool = False):
    """``banded_solve`` in plain PyTorch, on any device."""
    C, D, M = y.shape
    fn = (block_banded_triangular_solve_upper_adjoint_plain if adjoint
          else block_banded_triangular_solve_upper_plain)
    out = fn(factor.tiles, y.permute(0, 2, 1).reshape(C, M * D), factor.dinv)
    x.copy_(out.reshape(C, M, D).permute(0, 2, 1))
    return x


def bind_matvec(ops, xs, ys, adjoint: bool = False, alpha=(1.0, 1.0),
                accumulate: bool = False):
    """K3 bound to its operands, checked here once: a callable of the
    stream that runs one launch (on the CPU the plain version) on the
    tensors given now.

    ``ops`` one or two ``BandedMatrix`` of one shape and window; with one,
    y = alpha[0] op(A) x; with two and one x, ys[o] = alpha[o] op(A_o) x
    (``banded_matvec_pair``); with two and two xs, y = alpha[0] op(A_0)
    x_0 + alpha[1] op(A_1) x_1 (``banded_matvec_sum``); each added to what
    y holds when ``accumulate``. op(A) = A^T when ``adjoint``."""
    ops, xs, ys = tuple(ops), tuple(xs), tuple(ys)
    shape = (len(ops), len(xs), len(ys))
    if shape not in ((1, 1, 1), (2, 1, 2), (2, 2, 1)):
        raise ValueError(f"{shape} operators, inputs and outputs are not a "
                         "matvec, a pair or a sum")
    mode = {(1, 1, 1): 0, (2, 1, 2): 1, (2, 2, 1): 2}[shape]
    tiles = ops[0].tiles
    Bn, nb, nw, T = tiles.shape[:4]
    E, B, N = xs[0].shape
    dev, dt = tiles.device, tiles.dtype
    for i, op in enumerate(ops):
        for name in ("tiles", "kt_fwd", "kt_adj"):
            _check_dtype_device(f"{name} of operator {i}", getattr(op, name),
                                dt, dev)
        if (tuple(op.tiles.shape) != tuple(tiles.shape)
                or (op.hw_lo, op.hw_hi) != (ops[0].hw_lo, ops[0].hw_hi)):
            raise ValueError("paired operators need one shape and window")
        if not (op.tiles.is_contiguous() and op.kt_fwd.is_contiguous()
                and op.kt_adj.is_contiguous()):
            raise ValueError("tiles need a contiguous layout")
    for name, t in [(f"x{i}", t) for i, t in enumerate(xs)] + [
            (f"y{i}", t) for i, t in enumerate(ys)]:
        _check_dtype_device(name, t, dt, dev)
        if B != Bn or tuple(t.shape) != (E, B, N) or N > nb * T or (
                N <= (nb - 1) * T):
            raise ValueError(
                f"{name} {tuple(t.shape)} (x {tuple(xs[0].shape)}) do not "
                f"match tiles {tuple(tiles.shape)}")
        if t.stride(-1) != 1:
            raise ValueError("x and y need a contiguous last dimension")
    alpha = tuple(float(a) for a in alpha)
    accumulate = bool(accumulate)
    if _takes_plain(dev):
        if mode == 0:
            return lambda stream=None: banded_matvec_plain(
                ops[0], xs[0], ys[0], adjoint, alpha[0], accumulate)
        if mode == 1:
            return lambda stream=None: banded_matvec_pair_plain(
                ops[0], ops[1], xs[0], ys[0], ys[1], adjoint, alpha,
                accumulate)
        return lambda stream=None: banded_matvec_sum_plain(
            ops[0], ops[1], xs[0], xs[1], ys[0], adjoint, alpha, accumulate)
    if dev.type != "cuda":
        raise ValueError(f"banded_matvec runs on cpu or cuda, not {dev}")
    if T != TILE:
        raise ValueError(f"the kernel takes {TILE}-wide tiles, not {T}")
    from magi_v2_tpu_torch.ops._build import Launch

    two = lambda seq: (seq[0], seq[-1])
    kt = [op.kt_adj if adjoint else op.kt_fwd for op in ops]
    x2, y2 = two(xs), two(ys)
    name = "banded_matvec" + ("_adjoint" if adjoint else "")
    return Launch(
        _entry("banded_matvec", dt),
        [*two(kt), *x2, *y2, mode, E, B, N, nb, nw,
         ops[0].hw_hi if adjoint else ops[0].hw_lo,
         x2[0].stride(0), x2[0].stride(1), x2[1].stride(0), x2[1].stride(1),
         y2[0].stride(0), y2[0].stride(1), y2[1].stride(0), y2[1].stride(1),
         *two(alpha), int(accumulate)],
        LAUNCH_COUNTS, name + ("_pair" if mode else ""))


def banded_matvec(op: BandedMatrix, x, y, adjoint: bool = False,
                  alpha: float = 1.0, accumulate: bool = False):
    """K3: y = alpha * op(A) x (+ y when ``accumulate``), op(A) = A or A^T,
    over x, y of shape (E, B, N) (E a free dimension such as chains, B the
    operator's batch); the last dimension must be contiguous, the other
    two may have any strides. Writes y and returns it."""
    bind_matvec((op,), (x,), (y,), adjoint, (alpha,), accumulate)(
        launch_stream(y.device))
    return y


def banded_matvec_pair(op1: BandedMatrix, op2: BandedMatrix, x, y1, y2,
                       adjoint: bool = False, alpha=(1.0, 1.0),
                       accumulate: bool = False):
    """K3 on two operators and one x in one launch: y1 = alpha[0] op(A1) x,
    y2 = alpha[1] op(A2) x (each + y when ``accumulate``); shapes and
    strides as ``banded_matvec``. Writes and returns (y1, y2)."""
    bind_matvec((op1, op2), (x,), (y1, y2), adjoint, alpha, accumulate)(
        launch_stream(y1.device))
    return y1, y2


def banded_matvec_sum(op1: BandedMatrix, op2: BandedMatrix, x1, x2, y,
                      adjoint: bool = False, alpha=(1.0, 1.0),
                      accumulate: bool = False):
    """K3 on two operators and two inputs in one launch:
    y = alpha[0] op(A1) x1 + alpha[1] op(A2) x2 (+ y when ``accumulate``);
    shapes and strides as ``banded_matvec``. Writes y and returns it."""
    bind_matvec((op1, op2), (x1, x2), (y,), adjoint, alpha, accumulate)(
        launch_stream(y.device))
    return y


# K4 runs one cluster of _SOLVE_CLUSTER CTAs per group of up to
# _SOLVE_MAX_CHAINS chains, each CTA owning TILE // _SOLVE_CLUSTER columns
# of every tile (csrc/banded.cu picks the group size)
_SOLVE_CLUSTER = 8
_SOLVE_OWN = TILE // _SOLVE_CLUSTER
_SOLVE_MAX_CHAINS = 20
_SMEM_LIMIT = 227 * 1024


def _solve_smem(ch: int, nwu: int, elem: int) -> int:
    """The least shared memory of one K4 CTA (csrc/banded.cu: solve_smem):
    a ring of two tile slabs (own x TILE each), the received partials
    (2 x 2*cluster x own x ch), four y rows and the last nwu - 1 solved
    rows (own x ch each), own = _SOLVE_OWN."""
    rows = 4 * _SOLVE_CLUSTER + 4 + max(nwu - 1, 1)
    return (2 * _SOLVE_OWN * TILE + rows * _SOLVE_OWN * ch) * elem


def bind_solve(factor: UpperFactor, y, x, adjoint: bool = False):
    """K4 bound to its operands, checked here once: ``run(stream, x=None)``
    runs one launch (on the CPU the plain version) reading y as given now
    and writing x, or another tensor of x's shape and strides passed to the
    call (the caller keeps it alive until the launch has run)."""
    tiles = factor.tiles
    nb, nwu, T = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    C, D, M = y.shape
    N = factor.N
    dev, dt = tiles.device, tiles.dtype
    for name, t in (("y", y), ("x", x), ("dinv", factor.dinv),
                    ("kt_fwd", factor.kt_fwd), ("kt_adj", factor.kt_adj)):
        _check_dtype_device(name, t, dt, dev)
    if M * D != N or tuple(x.shape) != (C, D, M) or not (
            (nb - 1) * T < N <= nb * T):
        raise ValueError(
            f"y {tuple(y.shape)} / x {tuple(x.shape)} do not match a "
            f"factor of size {N} with tiles {tuple(tiles.shape)}")
    if _takes_plain(dev):
        return lambda stream=None, x=x: banded_solve_plain(factor, y, x,
                                                           adjoint)
    if dev.type != "cuda":
        raise ValueError(f"banded_solve runs on cpu or cuda, not {dev}")
    if T != TILE:
        raise ValueError(f"the kernel takes {TILE}-wide tiles, not {T}")
    smem = _solve_smem(_SOLVE_MAX_CHAINS, nwu, tiles.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{nwu} tile columns need {smem} bytes of shared "
                         f"memory, above the card's {_SMEM_LIMIT}")
    from magi_v2_tpu_torch.ops._build import Launch

    kernel = "banded_solve_adjoint" if adjoint else "banded_solve"
    launch = Launch(
        _entry(kernel, dt),
        [factor.kt_adj if adjoint else factor.kt_fwd, y, x, C, D, N, nb,
         nwu, y.stride(0), y.stride(1), y.stride(2), x.stride(0),
         x.stride(1), x.stride(2)], LAUNCH_COUNTS, kernel)

    def run(stream, x=None):
        if x is not None:
            launch.rebind(2, x)
        launch(stream)

    return run


def banded_solve(factor: UpperFactor, y, x, adjoint: bool = False):
    """K4: x = U^{-1} y (``adjoint``: x = U^{-T} y) for each of C chains.
    y and x are (C, D, M) views with any strides: entry (c, d, m) is
    element g = m*D + d of chain c's length-N vector, N = M*D (D = 1 for
    a plain (C, 1, N) vector). So the interleaved-to-component-major
    permutation of the sampler's state is folded into the loads and
    stores. Writes x and returns it."""
    bind_solve(factor, y, x, adjoint)(launch_stream(x.device))
    return x


# --------------------------------------------------------------------------
# the JAX package's functions, differentiable in x / y
# --------------------------------------------------------------------------


def _matvec3(op: BandedMatrix, x, adjoint: bool):
    B, N = op.tiles.shape[0], x.shape[-1]
    lead = x.shape[:-1]
    x3 = x.reshape(-1, B, N).contiguous()
    y = torch.empty_like(x3)
    banded_matvec(op, x3, y, adjoint=adjoint)
    return y.reshape(lead + (N,))


class _Matvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _matvec3(op, x, adjoint=False)

    @staticmethod
    def backward(ctx, g):
        return _matvec3(ctx.op, g, adjoint=True), None


def _solve2(factor: UpperFactor, y, adjoint: bool):
    lead, N = y.shape[:-1], y.shape[-1]
    y3 = y.reshape(-1, 1, N)
    x = torch.empty_like(y3)
    banded_solve(factor, y3, x, adjoint=adjoint)
    return x.reshape(lead + (N,))


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, factor):
        ctx.factor = factor
        return _solve2(factor, y, adjoint=False)

    @staticmethod
    def backward(ctx, g):
        return _solve2(ctx.factor, g, adjoint=True), None


def _batched(x, B: tuple):
    """x (*E, *B, N) with *B broadcast in."""
    N = x.shape[-1]
    E = x.shape[: x.dim() - 1 - len(B)]
    return x.expand(E + B + (N,))


def block_banded_matvec(blocks, x):
    """y = A x, A in symmetric-window tiles (*B, nb, 2hw+1, T, T),
    x (*E, *B, N)."""
    B = tuple(blocks.shape[:-4])
    return _Matvec.apply(_batched(x, B), BandedMatrix.make(blocks))


def block_banded_matvec_upper(blocks, x):
    """y = A x, A upper-triangular in ``banded_to_blocks_upper`` tiles."""
    B = tuple(blocks.shape[:-4])
    nw = blocks.shape[-3]
    return _Matvec.apply(_batched(x, B), BandedMatrix.make(blocks, 0, nw - 1))


def block_banded_triangular_solve_upper(blocks, y, diag_inv=None):
    """x = U^{-1} y, U upper in ``banded_to_blocks_upper`` tiles
    (nb, nwu, T, T), y (*E, N); ``diag_inv`` from
    ``banded_diag_tile_inverses`` (computed here when None)."""
    N = y.shape[-1]
    if diag_inv is None:
        diag_inv = banded_diag_tile_inverses(blocks, N)
    return _Solve.apply(y, UpperFactor.make(blocks, diag_inv.to(blocks.dtype),
                                            N))
