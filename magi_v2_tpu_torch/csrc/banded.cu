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
// reads a tile element A[r][c] at tile[c*T + r]: threads on consecutive rows
// r then read consecutive addresses. K3's forward form gets per-tile
// transposed copies made once at setup and its adjoint reads the tiles as
// stored, since A^T[r][c] = A[c][r] is exactly that access; K4 reads the
// transposed tiles of fold_factor.
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
//     removed (PERF.md). Plain FP32/FP64 FMAs: no TF32 tensor cores, which
//     would cost the solve its accuracy. The sampler's interleaved (n*D + d)
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
constexpr int kMvChains = 16;    // K3 chains per block
constexpr int kSolveCluster = 8;                  // K4 CTAs per cluster
constexpr int kOwn = kT / kSolveCluster;          // tile columns per CTA
constexpr int kHalf = kOwn / 2;                   // columns per thread
constexpr int kRows = 4;                          // rows per thread

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

// a barrier of the first n threads of the CTA (the loader warp is not in it)
__device__ __forceinline__ void sync_threads(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
