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
// reads a tile element A[r][c] at [c][r], so that a thread's four rows are
// one 16-byte read. K3 reads the slab order of ops/banded.py:slab_order
// (every 32-row chunk of a tile contiguous, column-major: the unit one CTA
// copies), of A for the forward form and of A^T (transpose_blocks) for the
// adjoint, so that both directions are one kernel; K4 reads the transposed
// tiles of fold_factor. All are made once, when an operator is prepared.
//
// K3  y = alpha op(A) x (+ y), op(A) = A or A^T, x, y (E, B, N) with chains
//     (E) as the free dimension, and two paired forms in one launch:
//     y1 = a1 A1 x, y2 = a2 A2 x ([R; m] delta of the sampler's target) and
//     y (+)= a1 A1 x1 + a2 A2 x2 ([R' | -m'] gcat).
//
//     What bounds it. At the banded run's shapes (64 chains, B = 3, nb = 9,
//     nw = 3) one product is 85 MFMA on 2.4 MB of tiles and 1.6 MB of
//     vectors: 1.2 us of HBM traffic, 2.5 us of float32 FMAs on an H100
//     SXM. So it is a question of filling the card for a few microseconds:
//     enough CTAs, all their bytes in flight at once, and an inner loop
//     that keeps the FMA units fed. The first port of this kernel (108
//     CTAs of 128 threads, a thread per row reading its tile elements one
//     4-byte load at a time from L2, one shared load per FMA) took 31 us,
//     more than torch.bmm with the densified operator (29 us).
//
//     Design. One CTA of 256 threads per (32 chains, 32 rows of a tile
//     row, component): 198 CTAs with work at 64 chains, two on an SM (16
//     warps), 864 at 256 chains. The tiles of the window (of both operators
//     for a pair) pass through a ring of three stages in shared memory: the
//     CTA's 16 KB slab of a tile by one cp.async.bulk on the stage's
//     mbarrier, the 32 x 128 source block of x by 4-byte cp.async, chain-
//     major as it lies in memory (x's rows are not 16-byte aligned: N =
//     1025), with 16 bytes of padding a row so that a warp's eight chains
//     hit distinct banks. With nw = 3 every byte the CTA needs is in flight
//     before the first FMA; a wider window (the upper window of a factor)
//     refills a stage when all threads have left it. Each thread holds 4
//     rows x 4 chains and one column quarter of every tile: per four
//     columns, four 16-byte reads of the slab and four of x feed 64 FMAs
//     (one shared load per 8 FMAs). The four column quarters are summed
//     through shared memory in a fixed order and written by threads on
//     consecutive rows: no atomics, results independent of timing. A pair
//     on one x keeps the x blocks of the first operator in the ring for the
//     second where the window fills it. Rows and chains of padding (N =
//     1025 leaves the ninth tile row one row; 257 chains a ninth chain
//     tile of one) are zero-filled on the way in and skipped on the way
//     out; a chunk of 32 rows that holds no row of the matrix returns at
//     once. Measured on an H100 SXM at 700 W, float32 (PERF.md): 0.012 ms
//     per product at 64 chains and 0.031 ms at 256 (torch.bmm 0.029 and
//     0.063), the pairs 0.019 and 0.023 ms at 64 chains; bounds 0.0012 and
//     0.0045 ms. What holds it now: at 64 chains the launch and the one
//     round trip to L2 before the first FMA; at 256 chains the FMA stream
//     (about a third of the float32 peak) behind 3.3 waves of CTAs.
//
// K4  x = U^{-1} y (back substitution) and its adjoint x = U^{-T} y (forward
//     substitution), U upper in (nb, nwu, T, T) tiles. Setup folds the
//     float64-computed diagonal-tile inverses into the tiles (fold_factor in
//     ops/banded.py), so that both directions are one recurrence over the
//     block rows,
//         x_i = K[i,0] y_i + sum_{s=1}^{nwu-1} K[i,s] x_{i+-s},
//     with K[i,0] = D_i^{-1}, K[i,s] = -D_i^{-1} U[i,s] (forward) or
//     K[j,0] = D_j^{-T}, K[j,s] = -D_j^{-T} U[j-s,s]^T (adjoint, i = j).
//
//     What bounds it. At Lorenz N_I = 1025 (N = 3075, nb = 25, nwu = 11, a
//     factor band 1200 wide) and 256 chains the solve needs 0.76 GFMA on a
//     12 MB band, ~23 us of float32 FMAs on an H100 SXM, behind a chain of
//     25 dependent block rows. A design that gives each block a few chains
//     and the whole factor (the first port of this kernel: 64 blocks of 4
//     chains) reads the factor from L2 once per block, 1.2 GB per solve.
//
//     Design. One thread-block cluster of kSolveCluster = 8 CTAs per group
//     of CH chains: CH = 8 where the card runs all the groups of 8 at once
//     (cudaOccupancyMaxActiveClusters: 15 clusters of 8 on the H100 SXM;
//     the banded run's 64 chains take 8 clusters), else CH = 20 (the hybrid
//     run's 256 chains take 13 clusters on 104 SMs; unwhiten_draws' chunks
//     of draws x chains take many waves of them). CTA j owns tile
//     columns [16j, 16j+16), i.e. rows [16j, 16j+16) of every solved block:
//     it streams only its 8 KB slab of each tile (the cluster reads the
//     factor once for CH chains) and keeps its rows of the last nwu - 1
//     solved blocks in shared memory. Per block row each CTA forms the
//     partial products of its columns for all 128 rows and sends each
//     16-row part to the CTA that owns it by st.async into that CTA's
//     shared memory, counted as bytes on the owner's mbarrier: no cluster
//     barrier, whose release waits for the stores (~1200 cycles a row). The
//     owner sums the 16 partials (8 CTAs x 2 column halves) in a fixed
//     order, so results do not depend on timing. Look-ahead: only the
//     product with x_{i+-1} waits for the previous row; K[i,0] y_i and the
//     products with x_{i+-2..} are formed while the partials travel. A
//     loader warp streams the CTA's slabs, in the order they are used, into
//     a ring of up to kMaxRing slabs in shared memory (cp.async.bulk, with
//     full and empty mbarriers per slot); y arrives by cp.async three rows
//     ahead. Each thread holds 4 rows x 4 chains and half of the CTA's
//     columns: per column, one 16-byte read of the slab and one of the
//     solved rows feed 16 FMAs. What holds it back now is that FMA stream
//     on the 104 SMs the hybrid run's 13 clusters occupy, plus the per-row
//     and per-slab synchronisation, not the delivery of the slabs: on an
//     H100 SXM at 700 W, 256 chains in float32 take 0.13 ms per launch
//     against a 0.023 ms bound, and variants built only to time it took the
//     same 0.13 ms with the slab copies removed and 0.055 ms with the FMAs
//     removed (PERF.md). Since then every thread fences its reads of a
//     slab before the slot's release (fence_proxy_async below: the refill
//     comes through the async proxy), which made it 0.14 ms. Plain
//     FP32/FP64 FMAs: no TF32 tensor cores, which would cost the solve its
//     accuracy. The sampler's interleaved (n*D + d)
//     to component-major permutation is folded into the loads of y and the
//     stores of x through three strides per side. Padded rows (index >= N)
//     and padded chains solve to exactly 0. A launch the card refuses
//     returns its error; the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 128;          // tile width
constexpr int kSolveCluster = 8;                  // K4 CTAs per cluster
constexpr int kOwn = kT / kSolveCluster;          // tile columns per CTA
constexpr int kHalf = kOwn / 2;                   // columns per thread
constexpr int kRows = 4;                          // rows per thread

// element g = m*D + d of chain c in a (C, D, M) view with strides s
__device__ __forceinline__ long long view_offset(int c, int g, int D,
                                                 long long s_c, long long s_d,
                                                 long long s_m) {
  return c * s_c + (g % D) * s_d + (g / D) * s_m;
}

// L values of type T, loaded and stored as one (or, for 32 bytes, two)
// vector accesses
template <typename T, int L>
struct alignas(sizeof(T) * L > 16 ? 16 : sizeof(T) * L) Vec {
  T v[L];
};

// one element of type T, or a zero when !valid (the source is then not read)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem,
                                              bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group complete but the most recent one
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[r][c] += sum_kk w[kk][r] * src[kk][c]: w a thread's rows of a slab
// in shared memory (consecutive columns kT apart), src rows CH apart
template <typename T, int CH>
__device__ __forceinline__ void fma_slab(T (&acc)[kRows][4], const T* w,
                                         const T* src) {
#pragma unroll
  for (int kk = 0; kk < kHalf; ++kk) {
    const Vec<T, kRows> wv =
        *reinterpret_cast<const Vec<T, kRows>*>(w + kk * kT);
    const Vec<T, 4> xv = *reinterpret_cast<const Vec<T, 4>*>(src + kk * CH);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += wv.v[r] * xv.v[c];
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the shared::cluster address of the same location in CTA `rank`
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// four values into another CTA's shared memory, counted as bytes complete
// on that CTA's mbarrier
__device__ __forceinline__ void st_async4(unsigned addr, const float* v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async4(unsigned addr, const double* v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "d"(v[0]), "d"(v[1]), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr + 16),
      "d"(v[2]), "d"(v[3]), "r"(bar)
      : "memory");
}

// `bytes` from global memory into this CTA's shared memory by the bulk
// copy engine, counted as bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the local arrival of a phase, expecting `bytes` of copies or stores
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the phase of `parity` to complete; kCluster: data stored by
// other CTAs of the cluster is then visible
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (kCluster)
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, "
        "[%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// Orders this thread's reads of shared memory before a bulk copy that a
// later synchronisation lets overwrite them: the copy engine writes through
// the async proxy, which an mbarrier arrival or a barrier alone does not
// order against reads under way through the generic one. (Without it,
// one float64 solve in some 500 at 20 chains a cluster, where the ring
// holds 6 slabs, read a slab half refilled.)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the first n threads of the CTA (the loader warp is not in it)
__device__ __forceinline__ void sync_threads(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// K3: the block-banded matvec
// ---------------------------------------------------------------------------

constexpr int kMvRows = 32;      // rows of a tile row per CTA
constexpr int kMvChunks = kT / kMvRows;
constexpr int kMvChains = 32;    // chains per CTA
constexpr int kMvStages = 3;     // ring of (tile slab, x block) stages
constexpr int kMvThreads = 256;
constexpr int kMvSplit = 4;      // column quarters of a tile, 64 threads each
constexpr int kMvCols = kT / kMvSplit;

// Row stride of a staged x block: 16 bytes of padding, so that the eight
// chains a warp reads at one column lie in distinct banks.
template <typename T>
__host__ __device__ constexpr int mv_x_stride() {
  return kT + 16 / (int)sizeof(T);
}

// One stage: a slab (kT columns x kMvRows rows) and an x block (kMvChains
// chains x kT columns, padded).
template <typename T>
__host__ __device__ constexpr int mv_stage_elems() {
  return kMvRows * kT + kMvChains * mv_x_stride<T>();
}

// mode 0: y[0] = alpha[0] A0 x[0]; mode 1: y[o] = alpha[o] A_o x[0] for
// o = 0, 1; mode 2: y[0] = alpha[0] A0 x[0] + alpha[1] A1 x[1]; each added
// to what y holds when `accumulate`.
template <typename T>
struct MvArgs {
  const T* k[2];   // slab-ordered tiles of each operator
  const T* x[2];
  T* y[2];
  long long xs_e[2], xs_b[2], ys_e[2], ys_b[2];
  T alpha[2];
  int mode, E, B, N, nb, nw, hw, accumulate;
};

// every committed cp.async group complete but the kPending most recent
template <int kPending>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One CTA per (kMvChains chains, kMvRows rows of a tile row, component). The
// window's tiles (of both operators in modes 1 and 2) pass through the ring
// as items: the CTA's slab of the tile by the bulk copy engine on the
// stage's mbarrier, the source rows of x by cp.async, chain-major as they
// lie in memory. The slab-ordered tiles hold element (row r, column c) of
// the CTA's chunk at [c][r], so four rows are one 16-byte read. Thread
// (ks, rg, cq) owns rows 4rg..4rg+3, chains cq, cq+8, cq+16, cq+24 and the
// column quarter ks of every tile: per four columns, four 16-byte reads of
// the slab and four of x feed 64 FMAs. The quarters are summed through
// shared memory in the order ks = 0..3.
template <typename T, int kMode>
__global__ void __launch_bounds__(kMvThreads, sizeof(T) == 4 ? 2 : 1)
banded_matvec_kernel(const MvArgs<T> a) {
  constexpr int kSums = kMode == 0 ? 1 : 2;  // operators, and their sums
  constexpr int XS = mv_x_stride<T>();
  constexpr int kStage = mv_stage_elems<T>();
  constexpr int kRed = kMvRows + 4;  // padded row of the partial sums
  extern __shared__ __align__(128) unsigned char mv_smem[];
  __shared__ unsigned long long full[kMvStages];
  T* stages = reinterpret_cast<T*>(mv_smem);

  const int t = threadIdx.x;
  const int e0 = blockIdx.x * kMvChains;
  const int p = blockIdx.y / kMvChunks;   // output tile row
  const int rc = blockIdx.y % kMvChunks;  // its chunk of rows
  const int b = blockIdx.z;               // component
  const int row0 = p * kT + rc * kMvRows;
  if (row0 >= a.N) return;  // a chunk of padding only
  // the window slots whose source tile lies in the matrix
  const int j_lo = a.hw - p > 0 ? a.hw - p : 0;
  const int j_hi = a.nb + a.hw - p < a.nw ? a.nb + a.hw - p : a.nw;
  const int nvalid = j_hi - j_lo;
  const int nitems = kSums * nvalid;
  // mode 1 with a window that fills the ring: the second operator finds
  // each x block where the first one staged it
  const bool reuse_x = kMode == 1 && nvalid == kMvStages;

  auto fetch = [&](int n) {  // item n into stage n % kMvStages
    const int o = n / nvalid, j = j_lo + n % nvalid;
    const int s = n % kMvStages;
    T* st = stages + (size_t)s * kStage;
    if (t == 0) {
      mbar_expect(&full[s], kMvRows * kT * sizeof(T));
      bulk_load(st,
                a.k[o] + ((((size_t)b * a.nb + p) * a.nw + j) * kMvChunks +
                          rc) * (kMvRows * kT),
                kMvRows * kT * sizeof(T), &full[s]);
    }
    if (reuse_x && o == 1) return;
    const int xo = kMode == 2 ? o : 0;
    const T* xsrc = a.x[xo];
    const int col = (p + j - a.hw) * kT + t % kT;
    T* xd = st + kMvRows * kT + t % kT;
#pragma unroll
    for (int i = 0; i < kMvChains * kT / kMvThreads; ++i) {
      const int c = t / kT + (kMvThreads / kT) * i;
      const int e = e0 + c;
      const bool in = e < a.E && col < a.N;
      cp_async_elem(xd + c * XS,
                    in ? xsrc + e * a.xs_e[xo] + b * a.xs_b[xo] + col : xsrc,
                    in);
    }
  };

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < kMvStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one cp.async group per item, empty where there is none, so that the
  // group of item n is always the kMvStages-th most recent at its wait
#pragma unroll
  for (int n = 0; n < kMvStages; ++n) {
    if (n < nitems) fetch(n);
    cp_async_commit();
  }

  const int ks = t / 64;
  const int rg = (t % 64) / 8;
  const int cq = t % 8;
  T acc[kSums][4][4];
#pragma unroll
  for (int o = 0; o < kSums; ++o)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[o][r][i] = T(0);

  auto run = [&](T (&sum)[4][4], int n_begin, int n_end) {
    for (int n = n_begin; n < n_end; ++n) {
      const int s = n % kMvStages;
      cp_async_wait_pending<kMvStages - 1>();
      __syncthreads();  // the x block, staged by every thread, is visible
      mbar_wait<false>(&full[s], (n / kMvStages) & 1);
      const T* As =
          stages + (size_t)s * kStage + ks * kMvCols * kMvRows + rg * 4;
      const T* Xs = stages + (size_t)s * kStage + kMvRows * kT + cq * XS +
                    ks * kMvCols;
#pragma unroll 2
      for (int c4 = 0; c4 < kMvCols; c4 += 4) {
        Vec<T, 4> xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[i] = *reinterpret_cast<const Vec<T, 4>*>(Xs + 8 * i * XS + c4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const Vec<T, 4> av = *reinterpret_cast<const Vec<T, 4>*>(
              As + (c4 + kk) * kMvRows);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[r][i] += av.v[r] * xv[i].v[kk];
        }
      }
      if (n + kMvStages < nitems) {
        fence_proxy_async();
        __syncthreads();  // every thread is done with stage s
        fetch(n + kMvStages);
      }
      cp_async_commit();
    }
  };
  run(acc[0], 0, nvalid);
  if constexpr (kMode != 0) run(acc[1], nvalid, nitems);

  // the column quarters through shared memory (the ring is free: every
  // item was waited for by every thread), summed in the order ks = 0..3
  __syncthreads();
  T* red = stages;  // [kSums][kMvSplit][kMvChains][kRed]
#pragma unroll
  for (int o = 0; o < kSums; ++o) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Vec<T, 4> v;
#pragma unroll
      for (int r = 0; r < 4; ++r) v.v[r] = acc[o][r][i];
      *reinterpret_cast<Vec<T, 4>*>(
          red + ((size_t)(o * kMvSplit + ks) * kMvChains + cq + 8 * i) *
                    kRed + rg * 4) = v;
    }
  }
  __syncthreads();
  const int row = row0 + t % kMvRows;
  if (row >= a.N) return;
#pragma unroll
  for (int i = 0; i < kMvChains * kMvRows / kMvThreads; ++i) {
    const int c = t / kMvRows + (kMvThreads / kMvRows) * i;
    const int e = e0 + c;
    if (e >= a.E) break;
    T sum[kSums];
#pragma unroll
    for (int o = 0; o < kSums; ++o) {
      sum[o] = T(0);
#pragma unroll
      for (int q = 0; q < kMvSplit; ++q)
        sum[o] += red[((size_t)(o * kMvSplit + q) * kMvChains + c) * kRed +
                      t % kMvRows];
    }
    if constexpr (kMode == 1) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        T* out = a.y[o] + e * a.ys_e[o] + b * a.ys_b[o] + row;
        const T v = a.alpha[o] * sum[o];
        *out = a.accumulate ? *out + v : v;
      }
    } else {
      T* out = a.y[0] + e * a.ys_e[0] + b * a.ys_b[0] + row;
      T v = a.alpha[0] * sum[0];
      if constexpr (kMode == 2) v += a.alpha[1] * sum[1];
      *out = a.accumulate ? *out + v : v;
    }
  }
}

template <typename T, int kMode>
int launch_matvec_mode(const MvArgs<T>& a, cudaStream_t stream) {
  constexpr size_t smem = (size_t)kMvStages * mv_stage_elems<T>() * sizeof(T);
  auto kernel = banded_matvec_kernel<T, kMode>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    ready = true;
  }
  const dim3 grid((a.E + kMvChains - 1) / kMvChains, a.nb * kMvChunks, a.B);
  kernel<<<grid, kMvThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_matvec(const MvArgs<T>& a, cudaStream_t stream) {
  switch (a.mode) {
    case 0: return launch_matvec_mode<T, 0>(a, stream);
    case 1: return launch_matvec_mode<T, 1>(a, stream);
    case 2: return launch_matvec_mode<T, 2>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K4: the block-banded triangular solve
// ---------------------------------------------------------------------------

constexpr int kMaxRing = 24;               // slabs in the ring, at most
constexpr int kSlab = kOwn * kT;           // elements of one CTA's slab
constexpr int kSolveSmem = 226 * 1024;     // dynamic shared memory to fill

// two column halves x kT / kRows row groups x CH / 4 chain quads
__host__ __device__ constexpr int solve_threads(int CH) {
  return 2 * (kT / kRows) * (CH / 4);
}

// Shared memory of one K4 CTA besides the slab ring, in elements: the
// received partials (2 x 2*kSolveCluster x kOwn x CH), four rows of this
// CTA's y (kOwn x CH each, a ring over the steps) and the ring of its rows
// of the last nbuf solved blocks (nbuf x kOwn x CH).
__host__ __device__ constexpr size_t solve_fixed_elems(int CH, int nbuf) {
  return (size_t)(4 * kSolveCluster + 4 + nbuf) * kOwn * CH;
}

// solve_threads(CH) threads multiply, one more warp loads the slabs
template <typename T, int CH, bool kAdjoint>
__global__ void __launch_bounds__(solve_threads(CH) + 32, 1)
banded_solve_kernel(const T* __restrict__ kt, const T* __restrict__ y,
                    T* __restrict__ x, int C, int D, int N, int nb, int nwu,
                    int S, long long ys_c, long long ys_d, long long ys_m,
                    long long xs_c, long long xs_d, long long xs_m) {
  constexpr int kThreads = solve_threads(CH);
  constexpr int CQ = CH / 4;         // chain quads
  constexpr int kSlot = kOwn * CH;   // this CTA's rows of one block = threads
  static_assert(kSlot == kThreads, "one owned element per thread");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long bars[2];  // partials received, by parity
  __shared__ unsigned long long full[kMaxRing], empty[kMaxRing];
  T* slabs = reinterpret_cast<T*>(smem_raw);           // [S][kOwn][kT]
  T* recv = slabs + (size_t)S * kSlab;                  // [2][2*cluster][kSlot]
  T* ybuf = recv + 4 * kSolveCluster * kSlot;           // [4][kSlot]
  T* ring = ybuf + 4 * kSlot;                           // [nbuf][kSlot]
  const int nbuf = nwu > 1 ? nwu - 1 : 1;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / kSolveCluster) * CH;  // first chain
  const int t = threadIdx.x;
  constexpr unsigned kBytes = 2 * kSolveCluster * kSlot * sizeof(T);

  // Step k of the walk solves block row row_of(k): the product with
  // x_{i+-1} (the slab K[i,1]) waits for step k - 1; the look-ahead part
  // K[i,0] y_i + sum_{s>=2} K[i,s] x_{i+-s} (slabs K[i,0], K[i,2..]) is
  // done during step k - 1. Each CTA reads its slabs in one fixed order:
  // look-ahead of step 0, then per step k the K[.,1] slab of step k and the
  // look-ahead slabs of step k + 1.
  auto row_of = [&](int k) { return kAdjoint ? k : nb - 1 - k; };
  auto reach = [&](int i) {  // the last s with a neighbour block
    const int room = kAdjoint ? i : nb - 1 - i;
    return room < nwu - 1 ? room : nwu - 1;
  };

  if (t == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bars[0], kBytes);
    if (nb > 1) mbar_expect(&bars[1], kBytes);
  }
  cluster.sync();  // every CTA runs, its mbarriers armed, before any send

  if (t >= kThreads) {
    // the loader: slab n into ring slot n % S once the consumers have
    // released what the slot held (pass n / S - 1)
    if (t == kThreads) {
      int n = 0;
      auto put = [&](int i, int s) {
        const int q = n % S, pass = n / S;
        if (pass > 0) mbar_wait<false>(&empty[q], (pass - 1) & 1);
        mbar_expect(&full[q], kSlab * sizeof(T));
        bulk_load(slabs + (size_t)q * kSlab,
                  kt + ((size_t)(i * nwu + s) * kT + rank * kOwn) * kT,
                  kSlab * sizeof(T), &full[q]);
        ++n;
      };
      auto put_look_ahead = [&](int k) {
        const int i = row_of(k);
        put(i, 0);
        for (int s = 2; s <= reach(i); ++s) put(i, s);
      };
      put_look_ahead(0);
      for (int k = 0; k < nb; ++k) {
        if (reach(row_of(k)) >= 1) put(row_of(k), 1);
        if (k + 1 < nb) put_look_ahead(k + 1);
      }
    }
    __syncwarp();
    cluster.sync();
    return;
  }

  const int ks = t / (kThreads / 2);   // column half
  const int u = t % (kThreads / 2);
  const int cq = u % CQ;               // chains 4cq .. 4cq+3
  const int rg = u / CQ;               // rows rg*kRows .. +kRows-1
  const int lr = t / CH, lc = t % CH;  // the owned element: row lr, chain lc
  const int w_off = ks * kHalf * kT + rg * kRows;  // in a slab
  const int src_off = ks * kHalf * CH + 4 * cq;    // in a row of kSlot

  // where this thread's partial sums go: the CTA that owns its rows, slot
  // (rank, ks), row (rg*kRows) % kOwn, chains 4cq..; with its mbarriers
  const int dest = (rg * kRows) / kOwn;
  const unsigned send = cluster_addr(
      recv + (size_t)(rank * 2 + ks) * kSlot + ((rg * kRows) % kOwn) * CH +
          4 * cq, dest);
  const unsigned send_bar0 = cluster_addr(&bars[0], dest);
  const unsigned send_bar1 = cluster_addr(&bars[1], dest);

  auto slot_of = [&](int i, int s) {  // the ring slot of block i +- s
    const int j = kAdjoint ? i - s : i + s;
    return ring + (size_t)(j % nbuf) * kSlot;
  };
  // y of step k into ybuf slot k % 4 (cp.async, zero outside y), copied
  // during step k - 3 and waited for at the end of step k - 2, so that a
  // copy never lands in a slot that a thread may still read
  auto stage_y = [&](int k) {
    const int g = row_of(k) * kT + rank * kOwn + lr;
    const int c = c0 + lc;
    const bool in = g < N && c < C;
    cp_async_elem(ybuf + (size_t)(k % 4) * kSlot + t,
                  in ? y + view_offset(c, g, D, ys_c, ys_d, ys_m) : y, in);
  };

  T acc[kRows][4];
  int n = 0;  // the next slab of the fixed order
  auto use_slab = [&](const T* src) {
    const int q = n % S;
    mbar_wait<false>(&full[q], (n / S) & 1);
    fma_slab<T, CH>(acc, slabs + (size_t)q * kSlab + w_off, src + src_off);
    fence_proxy_async();  // the slot is refilled once every warp arrived
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&empty[q]);
    ++n;
  };
  auto look_ahead = [&](int k) {
    const int i = row_of(k);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
    use_slab(ybuf + (size_t)(k % 4) * kSlot);
    for (int s = 2; s <= reach(i); ++s) use_slab(slot_of(i, s));
  };

  for (int k = 0; k < 3 && k < nb; ++k) stage_y(k);
  cp_async_wait_all();
  sync_threads(kThreads);
  look_ahead(0);

  for (int k = 0; k < nb; ++k) {
    const int i = row_of(k);
    const int par = k & 1;
    if (reach(i) >= 1) use_slab(slot_of(i, 1));  // the one product on the chain
    const unsigned dst =
        send + (unsigned)(par * 2 * kSolveCluster * kSlot * sizeof(T));
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      st_async4(dst + (unsigned)(r * CH * sizeof(T)), acc[r],
                par ? send_bar1 : send_bar0);
    // until the partials of step k are in: y of step k + 3 and the
    // look-ahead part of step k + 1
    if (k + 3 < nb) stage_y(k + 3);
    cp_async_commit();
    if (k + 1 < nb) look_ahead(k + 1);
    mbar_wait<true>(&bars[par], (k >> 1) & 1);
    const T* src = recv + (size_t)par * 2 * kSolveCluster * kSlot + t;
    T part[4] = {T(0), T(0), T(0), T(0)};  // a fixed order: deterministic
#pragma unroll
    for (int p = 0; p < 2 * kSolveCluster; ++p) part[p % 4] += src[p * kSlot];
    const T v = (part[0] + part[1]) + (part[2] + part[3]);
    ring[(size_t)(i % nbuf) * kSlot + t] = v;
    const int g = i * kT + rank * kOwn + lr;
    if (g < N && c0 + lc < C)
      x[view_offset(c0 + lc, g, D, xs_c, xs_d, xs_m)] = v;
    cp_async_wait_prior();  // y of step k + 2 has landed
    sync_threads(kThreads);  // x_i and y visible to every thread; every
                             // thread past the wait on bars[par]
    if (t == 0 && k + 2 < nb) mbar_expect(&bars[par], kBytes);
  }
  cp_async_wait_all();
  cluster.sync();  // no CTA leaves while a partial sent to it is in flight
}

// the slab ring of one CTA (S slabs, as many as fit kSolveSmem with the
// rest, at least 2) and its shared memory in bytes
template <typename T, int CH>
size_t solve_smem(int nwu, int* S) {
  const size_t fixed =
      solve_fixed_elems(CH, nwu > 1 ? nwu - 1 : 1) * sizeof(T);
  const size_t slab = kSlab * sizeof(T);
  const int fit = fixed < (size_t)kSolveSmem
      ? (int)(((size_t)kSolveSmem - fixed) / slab) : 0;
  *S = fit > kMaxRing ? kMaxRing : fit < 2 ? 2 : fit;
  return fixed + (size_t)*S * slab;
}

template <typename T, int CH, bool kAdjoint>
cudaLaunchConfig_t solve_config(int C, size_t smem, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((C + CH - 1) / CH) * kSolveCluster);
  cfg.blockDim = dim3(solve_threads(CH) + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSolveCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of this kernel that the card runs at once (0: none), for the
// given shared memory; counted once per size
template <typename T, int CH, bool kAdjoint>
int max_clusters(size_t smem) {
  static size_t known_smem = 0;
  static int known = -1;
  if (known >= 0 && smem == known_smem) return known;
  auto kernel = banded_solve_kernel<T, CH, kAdjoint>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        solve_config<T, CH, kAdjoint>(CH, smem, 0, attr);
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      n = 0;
  }
  cudaGetLastError();  // a refused query leaves no error behind
  known_smem = smem;
  known = n;
  return n;
}

struct SolveArgs {
  int C, D, N, nb, nwu;
  long long ys_c, ys_d, ys_m, xs_c, xs_d, xs_m;
};

template <typename T, int CH, bool kAdjoint>
int launch_solve(const T* kt, const T* y, T* x, const SolveArgs& a, int S,
                 size_t smem, cudaStream_t stream) {
  auto kernel = banded_solve_kernel<T, CH, kAdjoint>;
  // set once per size, so that a launch captured into a CUDA graph (after
  // one eager launch of the same shape) makes no other runtime call
  static size_t allowed = 0;
  cudaError_t err = cudaSuccess;
  if (smem != allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed = smem;
  }
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        solve_config<T, CH, kAdjoint>(a.C, smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, kt, y, x, a.C, a.D, a.N, a.nb,
                             a.nwu, S, a.ys_c, a.ys_d, a.ys_m, a.xs_c, a.xs_d,
                             a.xs_m);
  }
  // clear the error a refused call leaves behind, so that it is reported
  // here and not by the next launch's check
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// The chains per cluster: the first of kSolveChains whose clusters the card
// runs in one wave (it runs 15 clusters of 8 CTAs on the H100 SXM, not the
// 16.5 that 132 SMs would suggest), else the last. 8 serves the banded
// run's 64 chains, 20 the hybrid run's 256 and any larger count.
constexpr int kSolveChains[] = {8, 20};

template <typename T, bool kAdjoint, int I = 0>
int launch_solve_fit(const T* kt, const T* y, T* x, const SolveArgs& a,
                     cudaStream_t stream) {
  constexpr int CH = kSolveChains[I];
  int S;
  const size_t smem = solve_smem<T, CH>(a.nwu, &S);
  constexpr int kLast = sizeof(kSolveChains) / sizeof(int) - 1;
  if constexpr (I < kLast) {
    if ((a.C + CH - 1) / CH > max_clusters<T, CH, kAdjoint>(smem))
      return launch_solve_fit<T, kAdjoint, I + 1>(kt, y, x, a, stream);
  }
  return launch_solve<T, CH, kAdjoint>(kt, y, x, a, S, smem, stream);
}

}  // namespace

#define MAGI_BANDED_ENTRY_POINTS(T, SUF)                                      \
  extern "C" int magi_banded_matvec_##SUF(                                    \
      const T* k0, const T* k1, const T* x0, const T* x1, T* y0, T* y1,       \
      int mode, int E, int B, int N, int nb, int nw, int hw,                  \
      long long x0s_e, long long x0s_b, long long x1s_e, long long x1s_b,     \
      long long y0s_e, long long y0s_b, long long y1s_e, long long y1s_b,     \
      double alpha0, double alpha1, int accumulate, void* stream) {           \
    const MvArgs<T> a = {{k0, k1},       {x0, x1},       {y0, y1},            \
                         {x0s_e, x1s_e}, {x0s_b, x1s_b}, {y0s_e, y1s_e},      \
                         {y0s_b, y1s_b}, {(T)alpha0, (T)alpha1},              \
                         mode, E, B, N, nb, nw, hw, accumulate};              \
    return launch_matvec<T>(a, (cudaStream_t)stream);                         \
  }                                                                           \
  extern "C" int magi_banded_solve_##SUF(                                     \
      const T* kt, const T* y, T* x, int C, int D, int N, int nb, int nwu,    \
      long long ys_c, long long ys_d, long long ys_m, long long xs_c,         \
      long long xs_d, long long xs_m, void* stream) {                         \
    const SolveArgs a = {C, D, N, nb, nwu, ys_c, ys_d, ys_m, xs_c, xs_d,      \
                         xs_m};                                               \
    return launch_solve_fit<T, false>(kt, y, x, a, (cudaStream_t)stream);     \
  }                                                                           \
  extern "C" int magi_banded_solve_adjoint_##SUF(                             \
      const T* kt, const T* y, T* x, int C, int D, int N, int nb, int nwu,    \
      long long ys_c, long long ys_d, long long ys_m, long long xs_c,         \
      long long xs_d, long long xs_m, void* stream) {                         \
    const SolveArgs a = {C, D, N, nb, nwu, ys_c, ys_d, ys_m, xs_c, xs_d,      \
                         xs_m};                                               \
    return launch_solve_fit<T, true>(kt, y, x, a, (cudaStream_t)stream);      \
  }

MAGI_BANDED_ENTRY_POINTS(float, f32)
MAGI_BANDED_ENTRY_POINTS(double, f64)
