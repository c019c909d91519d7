"""Operations of one sampler evaluation, counted from shapes alone.

``sampler_mfu_pct`` multiplies this count by the evaluations the chains
needed and divides by the sampling phase's wall and the float32 peak. The
count depends only on the shapes of the storage (dense, or hybrid: a
banded GN factor around the exact operators), never on which kernel or
library computes the work, so it still bounds a gain once a kernel is
fused or a library call replaced.
"""

from __future__ import annotations

from port_bench.yardstick.bounds import K1_FLOPS, band_nonzeros


def evaluation_flops(N: int, D: int, P: int, k: int, algorithm: str) -> int:
    """Operations of one target evaluation and its update, for one chain,
    in dense storage.

    - whitening, x = mu + L z and the gradient through it: two dense
      products of the (N D)^2 factor;
    - operators, for each of D components: R delta, m delta and S r
      forward and their adjoints backward, six products of N x N;
    - K1's epilogue work per grid point and component;
    - the update: HMC's leapfrog (two kicks, the velocity through a dense
      block of k columns, the drift) or a NUTS leaf (two products with the
      dense block, ten operations an element).
    """
    n = N * D
    return 4 * n * n + _rest(N, D, P, k, algorithm)


def hybrid_evaluation_flops(N: int, D: int, P: int, k: int, algorithm: str,
                            w: int) -> int:
    """``evaluation_flops`` in hybrid storage: the whitening is two banded
    triangular solves (x = mu + U^{-1} z and U^{-T} back), two operations
    a nonzero of the (N D) x (N D) upper factor U of bandwidth ``w``; the
    six exact N x N operator products a component, K1's epilogue and the
    update as in dense storage."""
    return (4 * band_nonzeros(N * D, 0, w)
            + _rest(N, D, P, k, algorithm))


def _rest(N: int, D: int, P: int, k: int, algorithm: str) -> int:
    """The operators, K1's epilogue and the update (``evaluation_flops``)."""
    n = N * D
    dim = n + D + P
    ops = D * 6 * 2 * N * N
    k1 = sum(K1_FLOPS.values()) * n
    head = dim - k
    if algorithm == "hmc":
        update = 7 * head + k * (2 * k + 6)
    else:
        update = 2 * 2 * k * k + 10 * dim
    return ops + k1 + update
