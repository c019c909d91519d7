"""Roofline bounds of the port's kernels, frozen for the benchmark.

Copied from chip_smoke.py (``PEAK_FLOPS``, ``PEAK_BYTES``, ``K1_FLOPS``,
``K1_GIVEN_FLOPS``, ``bound``, ``k1_bound``, ``k2_bound``,
``k2_nuts_bound``, ``nuts_leaf_bound``; ``trailing_ones`` from
magi_v2_tpu_torch/ops/nuts.py) as they stood when the benchmark was
defined; the banded bounds follow chip_smoke.py's ``banded_yardsticks``
with the band's nonzeros counted from its shape. Each bound counts every
input byte read once and every output byte written once, and the
operations the inputs need, against the published peaks of one H100 SXM.
A later change to the program does not move these numbers.
"""

from __future__ import annotations

import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet), for the
# bounds: float32 and float64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# K1's operations per (chain, grid point, component), counted from
# csrc/manifold.cu: fwd (x, f, dr, the t1 seed, the t1 and t4 sums), energy
# (the t2 sum and the g_Ds seed), bwd (the VJPs in x and theta, the
# residual, gpart)
K1_FLOPS = {"manifold_fwd": 16, "manifold_energy": 5, "manifold_bwd": 17}
# the same for the given kernels of a field with no functor, which read the
# field's values (fwd) and its VJPs (bwd) that PyTorch computed
K1_GIVEN_FLOPS = {"manifold_fwd": 14, "manifold_energy": 5,
                  "manifold_bwd": 9}


def bound(nbytes, flops, dtype=torch.float32):
    """The least time (ms) the card could take to move ``nbytes`` (each
    input read once, each output written once) and do ``flops`` operations
    of ``dtype``, and which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k1_bound(kname, C, N, D, P, dtype, given=False, per_chain=False):
    """The bound of one K1 kernel at C chains, N grid points, D
    components and P parameters: what it reads and writes per
    csrc/manifold.cu (the (C, D, N) blocks, the (D, N) reference rows, the
    sigma/theta entries of q and grad, t14 and lp; for the given kernels
    also the field's values or its VJPs; with a temperature per chain its
    C temperatures)."""
    # the whitened fwd reads dz and z0 in place of R delta and a0: the
    # same bytes and operations as the GN form's
    kname = kname.replace("_whitened", "")
    pts, row, tail = C * N * D, D * N, C * (D + P)
    elems = {"manifold_fwd": 5 * pts + 5 * row + tail + 2 * C,
             "manifold_energy": 2 * pts + row + tail + 3 * C,
             "manifold_bwd": 4 * pts + 3 * row + 2 * tail}[kname]
    if given:
        elems += {"manifold_fwd": pts, "manifold_energy": 0,
                  "manifold_bwd": pts + C * P}[kname]
    if per_chain:
        elems += C
    size = torch.finfo(dtype).bits // 8
    flops = (K1_GIVEN_FLOPS if given else K1_FLOPS)[kname]
    return bound(elems * size, flops * pts, dtype)


def k2_bound(C, dim, k, dtype):
    """K2's bound for the leapfrog the sampler replays (two kicks, the
    velocity, the drift): q, p, g read and q, p written once, the
    diagonal and the dense block read once; 7 operations an element of
    the diagonal head (two kicks as FMAs, the velocity, the drift), and
    2k an element of the dense block's velocity plus its kicks and drift."""
    size = torch.finfo(dtype).bits // 8
    head = dim - k
    return bound((5 * C * dim + head + k * k) * size,
                 7 * C * head + C * k * (2 * k + 6), dtype)


def k2_kinetic_bound(C, dim, k, dtype, nkick):
    """K2's bound for a kinetic launch (no drift; ``nkick`` 0 or 1 kicks,
    then the velocity and 0.5 p.v per chain): p read (g read and p written
    with a kick), the mass read once, a scalar a chain written; 2k + 2
    operations an element of the dense block, 4 of the diagonal head, and
    two more with a kick. Not in chip_smoke.py: the HMC transition's two
    kinetic launches are counted with this bound, not the leapfrog's."""
    size = torch.finfo(dtype).bits // 8
    head = dim - k
    rows = 1 + 2 * nkick
    return bound((rows * C * dim + head + k * k + C) * size,
                 C * (4 * head + k * (2 * k + 2) + 2 * nkick * dim), dtype)


def k2_nuts_bound(C, on, dim, k, dtype):
    """The bound of K2's opening NUTS launch (one kick, the velocity, the
    drift) at C chains of which ``on`` move: their q, p, g read and q, p
    written once, the mass read once, a step and a flag a chain; 5
    operations an element of the diagonal head, 2k + 4 an element of the
    dense block, for the chains that move (a masked chain's q and p are
    left as they are and it has no velocity out)."""
    size = torch.finfo(dtype).bits // 8
    head = dim - k
    return bound((5 * on * dim + head + k * k + C) * size + C,
                 5 * on * head + on * k * (2 * k + 4), dtype)


def trailing_ones(n: int) -> int:
    m = n + 1
    return bin((m & -m) - 1).count("1")


def nuts_leaf_bound(C, on, dim, k, dtype, d, n, taken):
    """The leaf kernel's bound at C chains of which ``on`` run the leaf,
    from this leaf's outcome: for each running chain its q, p, g rows read
    and p, v written (q too where the next leaf opens), the slot rows read
    (q and v of t slots at an odd n) or written (an even n); the proposal
    rows taken written; the mass read once; ten scalars a chain.
    Operations for each running chain: the products with the dense block
    (2k FMAs an element, one product at a doubling's last leaf, two
    otherwise), the kicks, velocity, drift and kinetic sum (10 an element)
    and 6 an element a slot checked."""
    size = torch.finfo(dtype).bits // 8
    t = trailing_ones(n) if n % 2 else 0
    opens = n + 1 < (1 << d)
    rows = on * (5 + opens + (2 * t if n % 2 else 2)) + taken
    products = 2 if opens else 1
    return bound((rows * dim + dim + k * k + 10 * C) * size,
                 on * (products * 2 * k * k + 10 * dim + 6 * t * dim), dtype)


def nuts_leaves_bound(C, chain_leaves, leaf_replays, doublings, dim, k,
                      dtype):
    """A lower bound on the summed bounds of ``leaf_replays`` leaf launches
    whose running chains add up to ``chain_leaves``, of which ``doublings``
    were a doubling's last leaf: ``nuts_leaf_bound`` summed with the
    fewest rows it can have (five a running chain, the mass and ten scalars
    a chain a launch), two products a running chain except at a
    doubling's last leaf (where at most C chains run), ten operations an
    element, and no slot checked; the larger of bytes and operations. The
    per-leaf outcome (running chains, slots) is not observed from outside
    the program, and this sum is never above the exact one."""
    size = torch.finfo(dtype).bits // 8
    nbytes = (5 * chain_leaves * dim
              + leaf_replays * (dim + k * k + 10 * C)) * size
    products = max(2 * chain_leaves - C * doublings, chain_leaves)
    flops = products * 2 * k * k + chain_leaves * 10 * dim
    return bound(nbytes, flops, dtype)


def band_nonzeros(n, lower, upper):
    """The entries of an n x n band with ``lower`` diagonals below and
    ``upper`` above the main one."""
    lo, up = min(lower, n - 1), min(upper, n - 1)
    return n * (lo + up + 1) - lo * (lo + 1) // 2 - up * (up + 1) // 2


def k3_bound(C, N, D, b, dtype, pair=False, adjoint=False):
    """One K3 launch at C chains: the band's nonzeros read once (D
    components of an N x N band of half-width b; R and m for a pair), the
    vectors in and out once (three for a pair, four for its adjoint), two
    operations a nonzero and chain (chip_smoke.py's banded_yardsticks)."""
    size = torch.finfo(dtype).bits // 8
    nnz = D * band_nonzeros(N, b, b) * (2 if pair else 1)
    nvec = (4 if adjoint else 3) if pair else 2
    return bound((nnz + nvec * D * C * N) * size, 2 * C * nnz, dtype)


def k4_bound(C, n, w, dtype):
    """One K4 launch (the solve or its adjoint) at C right-hand sides: the
    n x n upper factor of bandwidth w read once, the right-hand sides in
    and out once, two operations a nonzero and right-hand side."""
    size = torch.finfo(dtype).bits // 8
    nnz = band_nonzeros(n, 0, w)
    return bound((nnz + 2 * C * n) * size, 2 * C * nnz, dtype)
