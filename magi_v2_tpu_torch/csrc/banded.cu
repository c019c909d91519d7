// Block-banded matvec (kernel K3) and block-banded triangular solve (kernel
// K4) of the large-grid MAGI sampler, for NVIDIA Hopper (sm_90a).
//
// Replaces: the XLA-compiled einsums of magi_v2_tpu/ops/banded.py —
// _block_banded_matvec_core (behind block_banded_matvec and
// block_banded_matvec_upper) and block_banded_triangular_solve_upper (a
// lax.scan back substitution) — and their reverse-mode adjoints, which
// jax.value_and_grad derived from them.
//
// Storage (ops/banded.py): a banded matrix is (nb, nw, T, T) tiles, T = 128,
// tile[q, s, r, c] = A[q*T + r, (q + s - hw_lo)*T + c]. Every kernel here
// reads a tile element A[r][c] at tile[c*T + r]: the T threads of a block,
// one per row r, then read consecutive addresses. The forward forms get
// per-tile transposed copies made once at setup; the adjoint forms read the
// tiles as stored, since A^T[r][c] = A[c][r] is exactly that access.
//
// K3  y = alpha op(A) x (+ y), op(A) = A or A^T, x, y (E, B, N) with chains
//     (E) as the free dimension. One block per (chain tile, tile row,
//     component): it sums its nw tile products into registers, with no
//     atomics. The source rows of x are staged in shared memory (one T-long
//     row per chain), each tile element is read once per block from L2 and
//     used for kMvChains chains. At the Lorenz shapes (B = 3, nb = 9,
//     nw = 3, 256 chains) that is 432 blocks reading 83 MB of tiles from L2
//     and 0.3 GFMA: L2-bandwidth bound.
//
// K4  x = U^{-1} y (back substitution) and its adjoint U^{-T} (forward
//     substitution), U upper in (nb, nwu, T, T) tiles with the diagonal-tile
//     inverses precomputed in float64 at setup (an in-graph float32 solve
//     collapsed the TPU sampler's step size). One block per group of
//     kSolveChains chains walks the nb block rows in order; per row it
//     subtracts nwu-1 off-diagonal tile products against a ring buffer of
//     the nwu-1 rows it solved last (shared memory), then applies the
//     diagonal-tile inverse. The chain of rows is sequential, so blocks
//     never wait on each other. Each block streams the whole factor through
//     L2 (18 MB in float32 at Lorenz N_I = 1025), so what bounds it is how
//     many tile loads one block keeps in flight: kSolveSplit thread groups
//     each take a quarter of every tile's columns, issue their 32 loads
//     before the FMAs, and meet in shared memory per row (a design with one
//     128-thread group and 4 loads in flight measured ~8 GB/s of L2 reads
//     per block on the H100). Plain FP32/FP64
//     FMAs: no TF32 tensor cores, which would cost the solve its accuracy.
//     The sampler's interleaved (n*D + d) to component-major permutation is
//     folded into the loads and stores through three strides per side.
//     Padded rows (index >= N) solve to exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;          // tile width = threads per block
constexpr int kMvChains = 16;    // K3 chains per block
constexpr int kSolveChains = 4;  // K4 chains per block
constexpr int kSolveSplit = 4;   // K4 thread groups, one per column quarter

template <typename T, bool kAdjoint>
__global__ void __launch_bounds__(kT)
banded_matvec_kernel(const T* __restrict__ tiles, const T* __restrict__ x,
                     T* __restrict__ y, int E, int B, int N, int nb, int nw,
                     int hw, long long xs_e, long long xs_b, long long ys_e,
                     long long ys_b, T alpha, int accumulate) {
  __shared__ T xs[kMvChains][kT];
  const int r = threadIdx.x;
  const int e0 = blockIdx.x * kMvChains;
  const int p = blockIdx.y;  // output tile row
  const int b = blockIdx.z;  // component
  T acc[kMvChains];
#pragma unroll
  for (int c = 0; c < kMvChains; ++c) acc[c] = T(0);

  for (int j = 0; j < nw; ++j) {
    const int q = p + j - hw;  // source tile (block-uniform)
    if (q < 0 || q >= nb) continue;
    // forward: A^T-stored tile (b, p, j); adjoint: tile (b, q, nw-1-j)
    const T* A = kAdjoint
        ? tiles + (((size_t)b * nb + q) * nw + (nw - 1 - j)) * kT * kT
        : tiles + (((size_t)b * nb + p) * nw + j) * kT * kT;
    __syncthreads();  // the previous source rows are consumed
    const int col = q * kT + r;
#pragma unroll
    for (int c = 0; c < kMvChains; ++c) {
      const int e = e0 + c;
      xs[c][r] = (e < E && col < N) ? x[e * xs_e + b * xs_b + col] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kT; ++t) {
      const T a = A[t * kT + r];
#pragma unroll
      for (int c = 0; c < kMvChains; ++c) acc[c] += a * xs[c][t];
    }
  }
  const int row = p * kT + r;
  if (row >= N) return;
#pragma unroll
  for (int c = 0; c < kMvChains; ++c) {
    const int e = e0 + c;
    if (e >= E) break;
    T* out = y + e * ys_e + b * ys_b + row;
    *out = accumulate ? *out + alpha * acc[c] : alpha * acc[c];
  }
}

// element g = m*D + d of chain c in a (C, D, M) view with strides s
__device__ __forceinline__ long long view_offset(int c, int g, int D,
                                                 long long s_c, long long s_d,
                                                 long long s_m) {
  return c * s_c + (g % D) * s_d + (g / D) * s_m;
}

template <typename T, bool kAdjoint>
__global__ void __launch_bounds__(kT * kSolveSplit)
banded_solve_kernel(const T* __restrict__ tiles, const T* __restrict__ dinv,
                    const T* __restrict__ y, T* __restrict__ x, int C, int D,
                    int N, int nb, int nwu, long long ys_c, long long ys_d,
                    long long ys_m, long long xs_c, long long xs_d,
                    long long xs_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring[slot][k][c]: the last nbuf solved rows; rhs[k][c]: this row's
  // right-hand side before the diagonal-tile inverse; part[ks][r][c]: the
  // partial sums of the kSolveSplit column quarters
  constexpr int kCols = kT / kSolveSplit;
  constexpr int kRow = kT * kSolveChains;
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int nbuf = nwu > 1 ? nwu - 1 : 1;
  T* rhs = ring + (size_t)nbuf * kRow;
  T* part = rhs + kRow;
  const int r = threadIdx.x % kT;
  const int k0 = (threadIdx.x / kT) * kCols;
  const bool lead = threadIdx.x < kT;
  const int c0 = blockIdx.x * kSolveChains;

  for (int step = 0; step < nb; ++step) {
    const int i = kAdjoint ? step : nb - 1 - step;
    const int g = i * kT + r;
    T acc[kSolveChains];
#pragma unroll
    for (int c = 0; c < kSolveChains; ++c) acc[c] = T(0);
    for (int s = 1; s < nwu; ++s) {
      const int k_blk = kAdjoint ? i - s : i + s;  // block-uniform
      if (k_blk < 0 || k_blk >= nb) break;
      // forward: U[i, s][r][k] from the transposed copy; adjoint:
      // U[i-s, s][k][r] from the tile as stored
      const T* A = tiles + ((size_t)(kAdjoint ? i - s : i) * nwu + s)
                               * kT * kT;
      const T* buf = ring + (size_t)(k_blk % nbuf) * kRow;
      T a[kCols];
#pragma unroll
      for (int kk = 0; kk < kCols; ++kk) a[kk] = A[(k0 + kk) * kT + r];
#pragma unroll
      for (int kk = 0; kk < kCols; ++kk)
#pragma unroll
        for (int c = 0; c < kSolveChains; ++c)
          acc[c] += a[kk] * buf[(k0 + kk) * kSolveChains + c];
    }
#pragma unroll
    for (int c = 0; c < kSolveChains; ++c)
      part[(size_t)threadIdx.x * kSolveChains + c] = acc[c];
    __syncthreads();  // partials complete; every ring read of this row done
    if (lead) {
#pragma unroll
      for (int c = 0; c < kSolveChains; ++c) {
        T v = (g < N && c0 + c < C)
            ? y[view_offset(c0 + c, g, D, ys_c, ys_d, ys_m)] : T(0);
        for (int ks = 0; ks < kSolveSplit; ++ks)
          v -= part[((size_t)ks * kT + r) * kSolveChains + c];
        rhs[r * kSolveChains + c] = g < N ? v : T(0);
      }
    }
    __syncthreads();  // rhs complete
    const T* Di = dinv + (size_t)i * kT * kT;
    T a[kCols];
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk) a[kk] = Di[(k0 + kk) * kT + r];
#pragma unroll
    for (int c = 0; c < kSolveChains; ++c) acc[c] = T(0);
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk)
#pragma unroll
      for (int c = 0; c < kSolveChains; ++c)
        acc[c] += a[kk] * rhs[(k0 + kk) * kSolveChains + c];
#pragma unroll
    for (int c = 0; c < kSolveChains; ++c)
      part[(size_t)threadIdx.x * kSolveChains + c] = acc[c];
    __syncthreads();  // partials of the diagonal-tile product complete
    if (lead) {
      T* slot = ring + (size_t)(i % nbuf) * kRow;
#pragma unroll
      for (int c = 0; c < kSolveChains; ++c) {
        T v = T(0);
        for (int ks = 0; ks < kSolveSplit; ++ks)
          v += part[((size_t)ks * kT + r) * kSolveChains + c];
        slot[r * kSolveChains + c] = v;
        if (g < N && c0 + c < C)
          x[view_offset(c0 + c, g, D, xs_c, xs_d, xs_m)] = v;
      }
    }
    __syncthreads();  // the new ring row visible, part and rhs free
  }
}

template <typename T, bool kAdjoint>
int launch_solve(const T* tiles, const T* dinv, const T* y, T* x, int C,
                 int D, int N, int nb, int nwu, long long ys_c, long long ys_d,
                 long long ys_m, long long xs_c, long long xs_d,
                 long long xs_m, cudaStream_t stream) {
  const int nbuf = nwu > 1 ? nwu - 1 : 1;
  const size_t smem = (size_t)(nbuf + 1 + kSolveSplit) * kT * kSolveChains
                      * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_solve_kernel<T, kAdjoint>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (C + kSolveChains - 1) / kSolveChains;
  banded_solve_kernel<T, kAdjoint>
      <<<blocks, kT * kSolveSplit, smem, stream>>>(
          tiles, dinv, y, x, C, D, N, nb, nwu, ys_c, ys_d, ys_m, xs_c, xs_d,
          xs_m);
  return (int)cudaGetLastError();
}

}  // namespace

#define MAGI_BANDED_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int magi_banded_matvec_##SUF(                                    \
      const T* tiles, const T* x, T* y, int E, int B, int N, int nb, int nw,  \
      int hw, long long xs_e, long long xs_b, long long ys_e, long long ys_b, \
      double alpha, int accumulate, void* stream) {                           \
    const dim3 grid((E + kMvChains - 1) / kMvChains, nb, B);                  \
    banded_matvec_kernel<T, false><<<grid, kT, 0, (cudaStream_t)stream>>>(    \
        tiles, x, y, E, B, N, nb, nw, hw, xs_e, xs_b, ys_e, ys_b, (T)alpha,   \
        accumulate);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_banded_matvec_adjoint_##SUF(                            \
      const T* tiles, const T* x, T* y, int E, int B, int N, int nb, int nw,  \
      int hw, long long xs_e, long long xs_b, long long ys_e, long long ys_b, \
      double alpha, int accumulate, void* stream) {                           \
    const dim3 grid((E + kMvChains - 1) / kMvChains, nb, B);                  \
    banded_matvec_kernel<T, true><<<grid, kT, 0, (cudaStream_t)stream>>>(     \
        tiles, x, y, E, B, N, nb, nw, hw, xs_e, xs_b, ys_e, ys_b, (T)alpha,   \
        accumulate);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_banded_solve_##SUF(                                     \
      const T* tiles, const T* dinv, const T* y, T* x, int C, int D, int N,   \
      int nb, int nwu, long long ys_c, long long ys_d, long long ys_m,        \
      long long xs_c, long long xs_d, long long xs_m, void* stream) {         \
    return launch_solve<T, false>(tiles, dinv, y, x, C, D, N, nb, nwu, ys_c,  \
                                  ys_d, ys_m, xs_c, xs_d, xs_m,               \
                                  (cudaStream_t)stream);                      \
  }                                                                           \
  extern "C" int magi_banded_solve_adjoint_##SUF(                             \
      const T* tiles, const T* dinv, const T* y, T* x, int C, int D, int N,   \
      int nb, int nwu, long long ys_c, long long ys_d, long long ys_m,        \
      long long xs_c, long long xs_d, long long xs_m, void* stream) {         \
    return launch_solve<T, true>(tiles, dinv, y, x, C, D, N, nb, nwu, ys_c,   \
                                 ys_d, ys_m, xs_c, xs_d, xs_m,                \
                                 (cudaStream_t)stream);                       \
  }

MAGI_BANDED_ENTRY_POINTS(float, f32)
MAGI_BANDED_ENTRY_POINTS(double, f64)
