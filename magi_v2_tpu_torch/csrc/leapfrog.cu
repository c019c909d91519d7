// The HMC leapfrog update (kernel K2) for NVIDIA Hopper (sm_90a).
//
// Replaces: the elementwise body of the leapfrog loop of
// magi_v2_tpu/sampler/hmc.py:make_hmc_step (p + eps/2 g, q + eps v) with
// the velocity and kinetic energy of magi_v2_tpu/sampler/mass.py
// (mass_vel, mass_kinetic), which XLA fused into the loop body.
//
// One launch per leapfrog, for every mass form (a diagonal, a diagonal
// head with a dense inverse-mass block over the last k coordinates, and
// the full dense metric k = dim), does for every coordinate of every chain:
//   p <- p + (eps/2) g, nkick times (2 = the closing half-kick of the last
//        leapfrog and the opening half-kick of this one, rounded in that
//        order),
//   v  = M^{-1} p,
//   q <- q + eps v (when drift), and the per-chain kinetic energy 0.5 p.v
//        (when kinetic is given).
// The step size is read from device memory; the kernel allocates nothing
// (the caller gives the scratch of the kinetic sums).
//
// Two kinds of CTA share one grid:
// - Stream CTAs: the diagonal head, columns [0, dim - k) of each row, as
//   aligned quads of the flat (C, dim) arrays: one 16-byte load of each of
//   q, p and g a quad (two in float64), all issued before any is used, so
//   a launch pays about one round trip to memory. A row of 3081 floats
//   starts on no 16-byte boundary; the quads at a row's ends are shared
//   with the neighbouring row and store only their own elements. Rows are
//   cut into segments of kThreads x kQuad = 1024 elements, so that 64
//   chains give 256 CTAs and 256 chains 1024, one wave on the card's 132
//   SMs.
// - Tail CTAs: the dense block, one thread-block cluster of `jb` CTAs per
//   kTailChains chains, CTA r owning tail columns [r nb, r nb + nb). Each
//   CTA kicks the momenta of its own columns, stores them to global memory
//   and to its shared memory, and reads the other columns' kicked momenta
//   from its peers' shared memory (so no CTA reads a momentum that another
//   has already overwritten). Then each thread multiplies the kicked tail
//   momenta of 4 chains by 4 `cpt` columns of M^{-1} over a quarter of the
//   rows on the CUDA cores in full precision (no TF32), and the quarters
//   are added in a fixed order. M^{-1} arrives with its rows padded to the
//   `ld` = jb nb columns the cluster covers (the caller's layout), so each
//   CTA's slab of a row is 16-byte aligned and moves by 16-byte cp.async.
//
// The kinetic energy: each CTA sums its chain's (or chains') products p v in
// a fixed order and stores the sum in the chain's row of `part`; the CTA
// that draws the chain's last ticket (an integer atomic) adds the row in
// order and resets the ticket, as K1 does (csrc/manifold.cu: chain_sum). No
// float atomics, so the result does not depend on scheduling.
//
// What bounds it: device-memory bandwidth for the head (it reads q, p, g
// and writes q, p once: 5 x 3.2 MB at 256 chains x 3081 coordinates in
// float32, 4.7 us at 3.35 TB/s) and the float32 FMA rate for the full
// dense metric (256 x 489 x 489 FMAs, 1.8 us at 67 TFLOP/s), each next to
// its launch. Measured in the replayed leapfrogs of chip_smoke.py (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): the diagonal at 3081 coordinates
// 6.7 us at 256 chains and 3.4 us at 64 (the first design: 18.6 and
// 16.1); the full dense metric at 489 about 22 us at 256 chains (the
// first design: two launches and a GEMM) -- its cluster's time grows
// with the block's width at any chain count (16.8 us for one cluster of 8
// CTAs), far above its FMAs' share.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;                   // elements of a stream thread
constexpr int kTailChains = 16;            // chains of a tail cluster
constexpr int kTailCols = 64;              // columns of a tail column group
constexpr int kChainsPerThread = 4;        // chains of a tail thread
constexpr int kMaxCluster = 8;
// dynamic shared memory a CTA may take (of the 227 KB, the static arrays'
// share kept aside)
constexpr int kMaxSmem = 226 * 1024;
constexpr int kChunk = 4096;               // elements of M^{-1} a chunk
constexpr int kSplitK = 4;                 // a tail CTA's row quarters

template <typename T>
struct Args {
  T* q;
  T* p;
  const T* g;
  const T* diag;
  const T* tail_inv;
  const T* step_size;
  T* kinetic;
  T* part;
  int* ticket;
  int k, ld, C, dim, head, nkick, drift;
  int segs, n_stream, jb, S;
};

template <typename T> struct V16;
template <> struct V16<float> { using type = float4; static constexpr int n = 4; };
template <> struct V16<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// the kicks of one momentum: the one expression every CTA uses
template <typename T>
__device__ __forceinline__ T kick(T p, T g, T half, int nkick) {
  for (int n = 0; n < nkick; ++n) p = fmadd(half, g, p);
  return p;
}

// the quad at flat index f (a multiple of 4): each 16-byte piece that holds
// an element of [lo, hi) is loaded (so no load leaves the allocation)
template <typename T>
__device__ __forceinline__ void load_quad(const T* base, size_t f, size_t lo,
                                          size_t hi, T (&out)[kQuad]) {
  using V = typename V16<T>::type;
  constexpr int n = V16<T>::n;
#pragma unroll
  for (int h = 0; h < kQuad; h += n) {
    if (f + h + n > lo && f + h < hi) {
      const V v = *reinterpret_cast<const V*>(base + f + h);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < n; ++i) out[h + i] = e[i];
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) out[h + i] = T(0);
    }
  }
}

// the elements of the quad at f that lie in [lo, hi): one vector store when
// all four do, else one store each
template <typename T>
__device__ __forceinline__ void store_quad(T* base, size_t f, size_t lo,
                                           size_t hi, const T (&v)[kQuad]) {
  using V = typename V16<T>::type;
  constexpr int n = V16<T>::n;
  if (f >= lo && f + kQuad <= hi) {
#pragma unroll
    for (int h = 0; h < kQuad; h += n)
      *reinterpret_cast<V*>(base + f + h) = *reinterpret_cast<const V*>(v + h);
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i)
    if (f + i >= lo && f + i < hi) base[f + i] = v[i];
}

// One of chain c's S partial kinetic sums, stored by one thread. The thread
// that stores the last one adds the row in order and writes 0.5 * total.
template <typename T>
__device__ void deposit(const Args<T>& a, int c, int slot, T v) {
  if (a.S == 1) {
    a.kinetic[c] = T(0.5) * v;
    return;
  }
  T* row = a.part + (size_t)c * a.S;
  __stcg(row + slot, v);
  __threadfence();
  if (atomicAdd(a.ticket + c, 1) != a.S - 1) return;
  __threadfence();
  T sum = T(0);
  for (int h = 0; h < a.S; ++h) sum += __ldcg(row + h);
  a.kinetic[c] = T(0.5) * sum;
  a.ticket[c] = 0;
}

template <typename T>
__device__ void stream_part(const Args<T>& a, int cta, T eps, T half,
                            bool need_v) {
  __shared__ T red[kThreads / 32];
  const int c = cta / a.segs, s = cta % a.segs;
  const size_t lo = (size_t)c * a.dim, hi = lo + a.head;
  const size_t f = (lo & ~size_t(kQuad - 1)) +
                   (size_t)kQuad * (s * kThreads + threadIdx.x);
  T acc = T(0);
  if (f < hi) {
    T pv[kQuad], gv[kQuad], qv[kQuad], dv[kQuad];
    load_quad(a.p, f, lo, hi, pv);
    if (a.nkick) load_quad(a.g, f, lo, hi, gv);
    if (a.drift) load_quad(a.q, f, lo, hi, qv);
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
      dv[i] = need_v && f + i >= lo && f + i < hi ? __ldg(a.diag + (f + i - lo))
                                                  : T(0);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      // an element of the neighbouring row is neither used nor stored
      if (f + i < lo || f + i >= hi) continue;
      if (a.nkick) pv[i] = kick(pv[i], gv[i], half, a.nkick);
      const T v = pv[i] * dv[i];
      if (a.drift) qv[i] = fmadd(eps, v, qv[i]);
      acc += pv[i] * v;
    }
    if (a.nkick) store_quad(a.p, f, lo, hi, pv);
    if (a.drift) store_quad(a.q, f, lo, hi, qv);
  }
  if (a.kinetic == nullptr) return;
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  T sum = T(0);
  for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
  deposit(a, c, s, sum);
}

// a row of 4 values from shared memory (one or two 16-byte loads)
template <typename T>
__device__ __forceinline__ void load4(const T* src, T (&out)[4]) {
  using V = typename V16<T>::type;
  constexpr int n = V16<T>::n;
#pragma unroll
  for (int h = 0; h < 4; h += n) {
    const V v = *reinterpret_cast<const V*>(src + h);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int w = 0; w < n; ++w) out[h + w] = e[w];
  }
}

// A tail CTA: kTailChains chains x the nb = 64 CPT tail columns of cluster
// rank r. Its 256 threads are (kq, cg, jg): rows of M^{-1} split in
// kSplitK quarters, 4 groups of 4 chains, 16 groups of 4 adjacent columns
// (CPT such groups a thread, 64 columns apart), so that a row costs a
// thread two or three 16-byte shared loads for 16 CPT FMAs.
template <typename T, int CPT, int STAGES>
__device__ void tail_part(const Args<T>& a, int cta, T eps, T half,
                          bool need_v, T* stage) {
  __shared__ T red[kThreads / 32][kChainsPerThread];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blk = cta / a.jb;
  constexpr int nb = kTailCols * CPT;
  const int c_blk = blk * kTailChains;

  // 1. the kicks of this CTA's own columns, stored to p and to the stage
  //    (row j of the stage: the kicked momentum of tail column j of the
  //    block's kTailChains chains)
  for (int e = threadIdx.x; e < kTailChains * nb; e += kThreads) {
    const int ch = e / nb, j = rank * nb + e % nb;
    if (j >= a.k) continue;
    T pv = T(0);
    if (c_blk + ch < a.C) {
      const size_t o = (size_t)(c_blk + ch) * a.dim + a.head + j;
      pv = a.p[o];
      if (a.nkick) {
        pv = kick(pv, __ldg(a.g + o), half, a.nkick);
        a.p[o] = pv;
      }
    }
    if (need_v) stage[(size_t)j * kTailChains + ch] = pv;
  }
  if (!need_v) return;

  // 2. the other columns' kicked momenta, from the cluster's peers
  cluster.sync();
  {
    using V = typename V16<T>::type;
    constexpr int n = V16<T>::n;
    for (int src = 0; src < a.jb; ++src) {
      if (src == rank) continue;
      const int rows = min(nb, a.k - src * nb);
      if (rows <= 0) continue;
      const size_t off = (size_t)src * nb * kTailChains;
      const V* from = reinterpret_cast<const V*>(
          cluster.map_shared_rank(stage + off, src));
      V* to = reinterpret_cast<V*>(stage + off);
      for (int e = threadIdx.x; e < rows * kTailChains / n; e += kThreads)
        to[e] = from[e];
    }
  }
  // peers have read this CTA's columns and the local copy is complete
  cluster.sync();

  // 3. v = M^{-1} p over the tail. The CTA's columns of M^{-1} pass
  //    through a ring of STAGES shared-memory buffers in chunks of
  //    kChunk / nb rows, the copies (16-byte cp.async from the padded
  //    rows) of the next STAGES - 1 chunks in flight while one is
  //    multiplied; each quarter kq of the threads takes a quarter of every
  //    chunk's rows.
  const int jg = threadIdx.x % 16, cgp = (threadIdx.x / 16) % 4;
  const int kq = threadIdx.x / 64;
  T acc[CPT][4][kChainsPerThread];
#pragma unroll
  for (int r = 0; r < CPT; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < kChainsPerThread; ++c) acc[r][u][c] = T(0);
  constexpr int rows = kChunk / nb, quarter = rows / kSplitK;
  const int chunks = (a.k + rows - 1) / rows;
  T* mbuf = stage + (size_t)a.k * kTailChains;
  auto fetch = [&](int ch) {
    if (ch < chunks) {
      T* dst = mbuf + (size_t)(ch % STAGES) * kChunk;
      const int n_r = min(rows, a.k - ch * rows);
      constexpr int W = V16<T>::n;
      for (int e = threadIdx.x; e < n_r * nb / W; e += kThreads) {
        const int i = ch * rows + e / (nb / W);
        const int j = rank * nb + e % (nb / W) * W;
        copy16_async(dst + e * W, a.tail_inv + (size_t)i * a.ld + j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int ch = 0; ch < STAGES - 1; ++ch) fetch(ch);
  const T* st = stage + cgp * kChainsPerThread;
  for (int ch = 0; ch < chunks; ++ch) {
    fetch(ch + STAGES - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
    __syncthreads();
    const T* mb = mbuf + (size_t)(ch % STAGES) * kChunk + jg * 4;
    const int r0 = kq * quarter;
    const int n_i = min(quarter, a.k - ch * rows - r0);
#pragma unroll 2
    for (int ii = 0; ii < n_i; ++ii) {
      const int i = r0 + ii;
      T ps[kChainsPerThread];
      load4(st + (size_t)(ch * rows + i) * kTailChains, ps);
#pragma unroll
      for (int r = 0; r < CPT; ++r) {
        T m[4];
        load4(mb + i * nb + kTailCols * r, m);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < kChainsPerThread; ++c)
            acc[r][u][c] = fmadd(ps[c], m[u], acc[r][u][c]);
      }
    }
    // the buffer is refilled at the next iteration
    __syncthreads();
  }
  // the quarters' sums, added in the order kq = 0, 1, 2, 3 by the first
  // quarter's threads, one column group of 64 at a time through the ring
  // (free now)
  constexpr int kPart = kTailChains * kTailCols;
#pragma unroll
  for (int r = 0; r < CPT; ++r) {
    if (kq > 0)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < kChainsPerThread; ++c)
          mbuf[(kq - 1) * kPart + (cgp * 4 + c) * kTailCols + jg * 4 + u] =
              acc[r][u][c];
    __syncthreads();
    if (kq == 0)
      for (int q = 0; q < kSplitK - 1; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < kChainsPerThread; ++c)
            acc[r][u][c] +=
                mbuf[q * kPart + (cgp * 4 + c) * kTailCols + jg * 4 + u];
    __syncthreads();
  }

  // 4. the drift and the kinetic partial sums of the own columns, by the
  //    first quarter's 64 threads (warps 0 and 1)
  if (kq > 0) {
    __syncthreads();  // the kinetic reduction's barrier below
    return;
  }
  T kin[kChainsPerThread];
#pragma unroll
  for (int c = 0; c < kChainsPerThread; ++c) kin[c] = T(0);
#pragma unroll
  for (int r = 0; r < CPT; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = rank * nb + kTailCols * r + jg * 4 + u;
#pragma unroll
      for (int c = 0; c < kChainsPerThread; ++c) {
        const int ch = cgp * kChainsPerThread + c;
        if (j >= a.k || c_blk + ch >= a.C) continue;
        const T v = acc[r][u][c];
        if (a.drift) {
          const size_t o = (size_t)(c_blk + ch) * a.dim + a.head + j;
          a.q[o] = fmadd(eps, v, a.q[o]);
        }
        kin[c] += stage[(size_t)j * kTailChains + ch] * v;
      }
    }
  // over the 16 column groups of each chain group: the two halves of a
  // warp
#pragma unroll
  for (int c = 0; c < kChainsPerThread; ++c)
    for (int off = 8; off > 0; off >>= 1)
      kin[c] += __shfl_down_sync(0xffffffffu, kin[c], off, 16);
  if (jg == 0)
#pragma unroll
    for (int c = 0; c < kChainsPerThread; ++c) red[cgp][c] = kin[c];
  __syncthreads();
  if (a.kinetic == nullptr || threadIdx.x >= kTailChains) return;
  const int chain = c_blk + threadIdx.x;
  if (chain < a.C)
    deposit(a, chain, a.segs + rank,
            red[threadIdx.x / kChainsPerThread][threadIdx.x % kChainsPerThread]);
}

template <typename T, int CPT, int STAGES>
__global__ void __launch_bounds__(kThreads) leapfrog_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T eps = a.step_size[0];
  const T half = T(0.5) * eps;
  const bool need_v = a.drift || a.kinetic != nullptr;
  const int b = blockIdx.x;
  if (b < a.n_stream) {
    if (b < a.C * a.segs) stream_part(a, b, eps, half, need_v);
    return;
  }
  tail_part<T, CPT, STAGES>(a, b - a.n_stream, eps, half, need_v,
                    reinterpret_cast<T*>(smem_raw));
}

template <typename T, int CPT, int STAGES>
int launch(Args<T> a, cudaStream_t stream) {
  const int nb = kTailCols * CPT;
  a.jb = a.k > 0 ? (a.k + nb - 1) / nb : 0;
  a.S = a.segs + a.jb;
  const int cluster = a.k > 0 ? a.jb : 1;
  a.n_stream = (a.C * a.segs + cluster - 1) / cluster * cluster;
  const int n_tail = a.k > 0 ? (a.C + kTailChains - 1) / kTailChains * a.jb
                             : 0;
  const bool need_v = a.drift || a.kinetic != nullptr;
  // the kicked tail momenta, then the ring of chunks of M^{-1}
  const size_t smem =
      a.k > 0 && need_v
          ? ((size_t)a.k * kTailChains + STAGES * kChunk) * sizeof(T)
          : 0;
  if (smem > (size_t)kMaxSmem || a.jb > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  auto kernel = leapfrog_kernel<T, CPT, STAGES>;
  // the largest dynamic shared memory asked for so far (set once per size,
  // before a launch that a CUDA graph captures)
  static size_t allowed = 0;
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed = smem;
  }
  if (err == cudaSuccess && a.n_stream + n_tail > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.n_stream + n_tail, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
  }
  // clear the error a refused call leaves behind, so that it is reported
  // here and not by the next launch's check
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T>
int leapfrog_update(T* q, T* p, const T* g, const T* diag,
                    const T* tail_inv, const T* step_size, int k, int ld,
                    int C, int dim, int nkick, int drift, T* kinetic,
                    T* part, int part_cols, int* ticket,
                    cudaStream_t stream) {
  if (C < 1 || k < 0 || k > dim || nkick < 0 || (k < dim && !diag) ||
      (k > 0 && !tail_inv))
    return (int)cudaErrorInvalidValue;
  Args<T> a = {q, p, g, diag, tail_inv, step_size, kinetic, part, ticket,
               k, ld, C, dim, dim - k, nkick, drift, 0, 0, 0, 0};
  const int head = dim - k;
  a.segs = head > 0 ? ((head + kQuad - 1 + kQuad - 1) / kQuad + kThreads - 1) /
                          kThreads
                    : 0;
  // columns a tail thread owns: as few as keep a cluster within 8 CTAs
  const int cpt = (k + kMaxCluster * kTailCols - 1) / (kMaxCluster * kTailCols);
  // rounded up to a power of two (the kernel's template argument)
  const int CPT = cpt <= 1 ? 1 : cpt <= 2 ? 2 : cpt <= 4 ? 4 : 8;
  if (cpt > 8) return (int)cudaErrorInvalidValue;
  const int jb = (k + CPT * kTailCols - 1) / (CPT * kTailCols);
  // the dense block's rows padded to the columns its cluster covers, so
  // that every CTA's slab of a row is 16-byte aligned
  if (k > 0 && (ld != jb * CPT * kTailCols ||
                reinterpret_cast<uintptr_t>(tail_inv) % 16))
    return (int)cudaErrorInvalidValue;
  if (kinetic && a.segs + jb > 1 &&
      (part_cols != a.segs + jb || !part || !ticket))
    return (int)cudaErrorInvalidValue;
  // a ring of four chunks where it fits beside the momenta, else two
  const bool deep = ((size_t)k * kTailChains + 4 * kChunk) * sizeof(T) <=
                    (size_t)kMaxSmem;
  switch (CPT * (deep ? 1 : -1)) {
    case 1: return launch<T, 1, 4>(a, stream);
    case 2: return launch<T, 2, 4>(a, stream);
    case 4: return launch<T, 4, 4>(a, stream);
    case 8: return launch<T, 8, 4>(a, stream);
    case -1: return launch<T, 1, 2>(a, stream);
    case -2: return launch<T, 2, 2>(a, stream);
    case -4: return launch<T, 4, 2>(a, stream);
  }
  return launch<T, 8, 2>(a, stream);
}

}  // namespace

#define MAGI_LEAPFROG_ENTRY_POINT(T, SUF)                                     \
  extern "C" int magi_leapfrog_update_##SUF(                                  \
      T* q, T* p, const T* g, const T* diag, const T* tail_inv,               \
      const T* step_size, int k, int ld, int C, int dim, int nkick,           \
      int drift, T* kinetic, T* part, int part_cols, int* ticket,             \
      void* stream) {                                                         \
    return leapfrog_update<T>(q, p, g, diag, tail_inv, step_size, k, ld, C,   \
                              dim, nkick, drift, kinetic, part, part_cols,    \
                              ticket, (cudaStream_t)stream);                  \
  }

MAGI_LEAPFROG_ENTRY_POINT(float, f32)
MAGI_LEAPFROG_ENTRY_POINT(double, f64)
