// The leapfrog update (kernel K2) of HMC and of NUTS's leaves, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: the elementwise body of the leapfrog loop of
// magi_v2_tpu/sampler/hmc.py:make_hmc_step (p + eps/2 g, q + eps v) and of
// magi_v2_tpu/sampler/nuts.py:_leapfrog, with the velocity and kinetic
// energy of magi_v2_tpu/sampler/mass.py (mass_vel, mass_kinetic), which XLA
// fused into the loop bodies.
//
// One launch per leapfrog, for every mass form (a diagonal, a diagonal
// head with a dense inverse-mass block over the last k coordinates, and
// the full dense metric k = dim, of any width), does for every coordinate
// of every chain:
//   p <- p + (eps/2) g, nkick times (2 = the closing half-kick of the last
//        leapfrog and the opening half-kick of this one, rounded in that
//        order),
//   v  = M^{-1} p, stored when `vel` is given,
//   q <- q + eps v (when drift), and the per-chain kinetic energy 0.5 p.v
//        (when kinetic is given).
// The step is read from device memory: one for all chains (HMC,
// step_stride 0) or one signed step per chain (a NUTS leaf, step_stride 1:
// the sign is the chain's direction). With an `active` mask, a chain whose
// flag is 0 keeps its q and p bit for bit (nothing is stored to them, so
// a non-finite g there changes nothing); its v and kinetic energy are those
// of its p. The kernel allocates nothing (the caller gives the scratch of
// the kinetic sums).
//
// Two kinds of CTA share one grid (a launch compiles only the kinds its
// grid holds, kHead and kTail below):
// - Stream CTAs: the diagonal head, columns [0, dim - k) of each row, as
//   aligned quads of the flat (C, dim) arrays: one 16-byte load of each of
//   q, p and g a quad (two in float64), all issued before any is used, so
//   a launch pays about one round trip to memory. A row of 3081 floats
//   starts on no 16-byte boundary; the quads at a row's ends are shared
//   with the neighbouring row and store only their own elements. Rows are
//   cut into segments of kThreads x kQuad = 1024 elements, so that 64
//   chains give 256 CTAs and 256 chains 1024, one wave on the card's 132
//   SMs.
// - Tail CTAs: the dense block, one thread-block cluster of `jb` <= 8 CTAs
//   per kTailChains chains. The block's columns are cut into column blocks
//   of nb = 64 CPT (CPT <= 8); CTA r owns `npass` of them, one after the
//   other (npass > 1 only above 8 x 512 = 4096 columns). Each CTA kicks
//   the momenta of its own columns and stores them to global memory; after
//   the cluster's barrier every CTA streams the kicked momenta of all k
//   rows back from L2 (ld.global.cg), beside the rows of M^{-1} (16-byte
//   cp.async.cg from rows padded to the `ld` = jb npass nb columns the
//   cluster covers, the caller's layout), through one ring of four
//   shared-memory slots (the first chunks of M^{-1} are copied before the
//   kicks, so that they arrive while the cluster waits). So the shared
//   memory a CTA needs does not grow with k, and no CTA reads a momentum
//   before its owner has kicked it.
//   Each thread multiplies the kicked tail momenta of 4 chains by 4 CPT
//   columns of M^{-1} over a quarter of the rows on the CUDA cores in full
//   precision (no TF32), and the quarters are added in a fixed order.
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
// its launch. The times on an H100 (chip_smoke.py, and by width and part
// scripts/k2_dense_probe.py) are in PERF.md, beside those of the design
// before this one, which exchanged the kicked momenta through distributed
// shared memory, held all k of them and refused widths above 1296
// (float64).
//
// Registers: a float32 tail thread of up to 4 column groups is held to
// 128 registers (two CTAs an SM), so that the 16 clusters of 8 CTAs of 256
// chains at k = 489 run in one wave; above 128 the card holds one CTA an
// SM and the clusters take two waves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTailChains = 16;            // chains of a tail cluster
constexpr int kTailCols = 64;              // columns of a tail column group
constexpr int kChainsPerThread = 4;        // chains of a tail thread
constexpr int kMaxCluster = 8;
constexpr int kMaxCpt = 8;                 // column groups of a tail thread
constexpr int kChunk = 4096;               // elements of M^{-1} a chunk
constexpr int kStages = 4;                 // slots of a tail CTA's ring
constexpr int kSplitK = 4;                 // a tail CTA's row quarters

template <typename T>
struct Args {
  T* q;
  T* p;
  const T* g;
  const T* diag;
  const T* tail_inv;
  const T* step;
  const unsigned char* active;
  T* vel;
  T* kinetic;
  T* part;
  int* ticket;
  int k, ld, C, dim, head, nkick, drift, step_stride;
  int segs, n_stream, jb, npass, S;
};

// the kicks of one momentum: the one expression every CTA uses
template <typename T>
__device__ __forceinline__ T kick(T p, T g, T half, int nkick) {
  for (int n = 0; n < nkick; ++n) p = fmadd(half, g, p);
  return p;
}

// chain c's step and whether it moves
template <typename T>
__device__ __forceinline__ T step_of(const Args<T>& a, int c) {
  return a.step[(size_t)c * a.step_stride];
}
template <typename T>
__device__ __forceinline__ bool moves(const Args<T>& a, int c) {
  return a.active == nullptr || a.active[c] != 0;
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
__device__ void stream_part(const Args<T>& a, int cta, bool need_v) {
  __shared__ T red[kThreads / 32];
  const int c = cta / a.segs, s = cta % a.segs;
  const T eps = step_of(a, c);
  const T half = T(0.5) * eps;
  const bool on = moves(a, c);
  const int nkick = on ? a.nkick : 0;
  const bool drift = on && a.drift;
  const size_t lo = (size_t)c * a.dim, hi = lo + a.head;
  const size_t f = (lo & ~size_t(kQuad - 1)) +
                   (size_t)kQuad * (s * kThreads + threadIdx.x);
  T acc = T(0);
  if (f < hi) {
    T pv[kQuad], gv[kQuad], qv[kQuad], dv[kQuad], vv[kQuad];
    load_quad(a.p, f, lo, hi, pv);
    if (nkick) load_quad(a.g, f, lo, hi, gv);
    if (drift) load_quad(a.q, f, lo, hi, qv);
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
      dv[i] = need_v && f + i >= lo && f + i < hi ? __ldg(a.diag + (f + i - lo))
                                                  : T(0);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      vv[i] = T(0);
      // an element of the neighbouring row is neither used nor stored
      if (f + i < lo || f + i >= hi) continue;
      if (nkick) pv[i] = kick(pv[i], gv[i], half, nkick);
      vv[i] = pv[i] * dv[i];
      if (drift) qv[i] = fmadd(eps, vv[i], qv[i]);
      acc += pv[i] * vv[i];
    }
    if (nkick) store_quad(a.p, f, lo, hi, pv);
    if (drift) store_quad(a.q, f, lo, hi, qv);
    if (a.vel) store_quad(a.vel, f, lo, hi, vv);
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

// A tail CTA: kTailChains chains x the npass column blocks of nb = 64 CPT
// tail columns of cluster rank r. Its 256 threads are (kq, cg, jg): rows of
// M^{-1} split in kSplitK quarters, 4 groups of 4 chains, 16 groups of 4
// adjacent columns (CPT such groups a thread, 64 columns apart), so that a
// row costs a thread two or three 16-byte shared loads for 16 CPT FMAs.
template <typename T, int CPT>
__device__ void tail_part(const Args<T>& a, int cta, bool need_v, T* ring) {
  __shared__ T red[kChainsPerThread][kChainsPerThread];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blk = cta / a.jb;
  constexpr int nb = kTailCols * CPT;
  const int own = nb * a.npass;
  const int c_blk = blk * kTailChains;
  constexpr int rows = kChunk / nb, quarter = rows / kSplitK;
  constexpr int kSlot = kChunk + rows * kTailChains;
  constexpr int kPf = (rows * kTailChains + kThreads - 1) / kThreads;
  const int chunks = (a.k + rows - 1) / rows;
  // the rows of M^{-1} of chunk ch of the column block at col0, into slot
  // ch % kStages of the ring by cp.async, as one commit group
  auto fetch = [&](int col0, int ch) {
    if (ch < chunks) {
      T* dst = ring + (size_t)(ch % kStages) * kSlot;
      const int n_r = min(rows, a.k - ch * rows);
      constexpr int W = V16<T>::n;
      for (int e = threadIdx.x; e < n_r * nb / W; e += kThreads) {
        const int i = ch * rows + e / (nb / W);
        const int j = col0 + e % (nb / W) * W;
        copy16_async(dst + e * W, a.tail_inv + (size_t)i * a.ld + j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // M^{-1} does not change in a launch: the first block's first chunks
  // are copied while the momenta are kicked and the cluster waits
  const int first_col = rank * a.npass * nb;
  if (need_v && first_col < a.k)
    for (int ch = 0; ch < kStages - 1; ++ch) fetch(first_col, ch);

  // 1. the kicks of this CTA's own columns, stored to p
  if (a.nkick)
    for (int e = threadIdx.x; e < kTailChains * own; e += kThreads) {
      const int c = c_blk + e / own, j = rank * own + e % own;
      if (j >= a.k || c >= a.C || !moves(a, c)) continue;
      const size_t o = (size_t)c * a.dim + a.head + j;
      a.p[o] = kick(a.p[o], __ldg(a.g + o), T(0.5) * step_of(a, c), a.nkick);
    }
  if (!need_v) return;
  // every column's kicked momentum is in global memory, and visible to the
  // cluster's CTAs (the barrier releases and acquires at cluster scope)
  cluster.sync();

  // 2. v = M^{-1} p over the tail, one column block at a time. Chunk ch
  //    (kChunk / nb rows) passes through slot ch % kStages of the ring: the
  //    rows of M^{-1} of the block's columns by cp.async, the kicked
  //    momenta of the chunk's rows (row-major, kTailChains a row) by loads
  //    issued a chunk ahead and stored after the chunk before is done; the
  //    copies of the next kStages - 1 chunks are in flight while one is
  //    multiplied. Each quarter kq of the threads takes a quarter of every
  //    chunk's rows.
  const int jg = threadIdx.x % 16, cgp = (threadIdx.x / 16) % 4;
  const int kq = threadIdx.x / 64;
  // the momenta of chunk ch. Element e of the chunk is row row_of(e) of
  // chain chain_of(e): a warp reads 8 consecutive rows of 4 chains (one
  // 32-byte sector of each chain). In the slot, row i holds its 16 chains
  // in groups of 4, group g at position g ^ ((i >> 1) & 3) (at_of), so that
  // a warp's 32 stores fall in 32 different banks (float32).
  auto row_of = [](int e) { return e / 32 % (rows / 8) * 8 + e % 8; };
  auto chain_of = [](int e) { return e / 32 / (rows / 8) * 4 + e % 32 / 8; };
  auto at_of = [](int i, int g) { return i * kTailChains + (g ^ (i >> 1 & 3)) * 4; };
  auto load_p = [&](int ch, T (&pf)[kPf]) {
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int c = c_blk + chain_of(e), i = ch * rows + row_of(e);
      pf[u] = e < rows * kTailChains && ch < chunks && i < a.k && c < a.C
                  ? __ldcg(a.p + (size_t)c * a.dim + a.head + i)
                  : T(0);
    }
  };
  // (a chunk past the last has no slot: the ring holds min(kStages,
  // chunks) of them)
  auto store_p = [&](int ch, const T (&pf)[kPf]) {
    if (ch >= chunks) return;
    T* dst = ring + (size_t)(ch % kStages) * kSlot + kChunk;
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < rows * kTailChains)
        dst[at_of(row_of(e), chain_of(e) / 4) + chain_of(e) % 4] = pf[u];
    }
  };
  T kin[kChainsPerThread];
#pragma unroll
  for (int c = 0; c < kChainsPerThread; ++c) kin[c] = T(0);
  for (int pass = 0; pass < a.npass; ++pass) {
    const int col0 = (rank * a.npass + pass) * nb;
    if (col0 >= a.k) break;
    T acc[CPT][4][kChainsPerThread];
#pragma unroll
    for (int r = 0; r < CPT; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < kChainsPerThread; ++c) acc[r][u][c] = T(0);
    {
      // the first chunks' momenta: every load issued before any is stored
      // (the first block's rows of M^{-1} are already under way)
      T pf[kStages - 1][kPf];
#pragma unroll
      for (int ch = 0; ch < kStages - 1; ++ch) {
        if (pass > 0) fetch(col0, ch);
        load_p(ch, pf[ch]);
      }
#pragma unroll
      for (int ch = 0; ch < kStages - 1; ++ch) store_p(ch, pf[ch]);
    }
    for (int ch = 0; ch < chunks; ++ch) {
      fetch(col0, ch + kStages - 1);
      T pf[kPf];
      load_p(ch + kStages - 1, pf);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
      __syncthreads();
      const T* slot = ring + (size_t)(ch % kStages) * kSlot;
      const T* mb = slot + jg * 4;
      const T* st = slot + kChunk;
      const int r0 = kq * quarter;
      const int n_i = min(quarter, a.k - ch * rows - r0);
#pragma unroll 2
      for (int ii = 0; ii < n_i; ++ii) {
        const int i = r0 + ii;
        T ps[kChainsPerThread];
        load4(st + at_of(i, cgp), ps);
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
      // the slot of chunk ch - 1 is free since the last barrier
      store_p(ch + kStages - 1, pf);
      // this chunk's slot is refilled at the next iteration
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
            ring[(kq - 1) * kPart + (cgp * 4 + c) * kTailCols + jg * 4 + u] =
                acc[r][u][c];
      __syncthreads();
      if (kq == 0)
        for (int q = 0; q < kSplitK - 1; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < kChainsPerThread; ++c)
              acc[r][u][c] +=
                  ring[q * kPart + (cgp * 4 + c) * kTailCols + jg * 4 + u];
      __syncthreads();
    }

    // 3. the velocity, the drift and the kinetic partial sums of the
    //    block's columns, by the first quarter's 64 threads (warps 0, 1)
    if (kq == 0)
#pragma unroll
      for (int c = 0; c < kChainsPerThread; ++c) {
        const int chain = c_blk + cgp * kChainsPerThread + c;
        if (chain >= a.C) continue;
        const T eps = step_of(a, chain);
        const bool drift = a.drift && moves(a, chain);
#pragma unroll
        for (int r = 0; r < CPT; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = col0 + kTailCols * r + jg * 4 + u;
            if (j >= a.k) continue;
            const T v = acc[r][u][c];
            const size_t o = (size_t)chain * a.dim + a.head + j;
            if (a.vel) a.vel[o] = v;
            if (drift) a.q[o] = fmadd(eps, v, a.q[o]);
            if (a.kinetic) kin[c] += __ldcg(a.p + o) * v;
          }
      }
  }
  if (a.kinetic == nullptr) return;
  // over the 16 column groups of each chain group: the two halves of a
  // warp
  if (kq == 0) {
#pragma unroll
    for (int c = 0; c < kChainsPerThread; ++c)
      for (int off = 8; off > 0; off >>= 1)
        kin[c] += __shfl_down_sync(0xffffffffu, kin[c], off, 16);
    if (jg == 0)
#pragma unroll
      for (int c = 0; c < kChainsPerThread; ++c) red[cgp][c] = kin[c];
  }
  __syncthreads();
  if (threadIdx.x >= kTailChains) return;
  const int chain = c_blk + threadIdx.x;
  if (chain < a.C)
    deposit(a, chain, a.segs + rank,
            red[threadIdx.x / kChainsPerThread][threadIdx.x % kChainsPerThread]);
}

// The parts a grid holds, as template flags: a launch compiles only the
// code of its own parts, so that the registers of the tail code do not
// bound the occupancy of a grid of stream CTAs alone.
constexpr int kHead = 1, kTail = 2;

template <typename T, int CPT, int kParts>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 && CPT <= 4 ? 2 : 1)
    leapfrog_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool need_v = a.drift || a.kinetic != nullptr || a.vel != nullptr;
  const int b = blockIdx.x;
  if constexpr ((kParts & kHead) != 0) {
    if (b < a.n_stream) {
      if (b < a.C * a.segs) stream_part(a, b, need_v);
      return;
    }
  }
  if constexpr ((kParts & kTail) != 0)
    tail_part<T, CPT>(a, b - a.n_stream, need_v,
                      reinterpret_cast<T*>(smem_raw));
}

template <typename T, int CPT, int kParts>
int launch(Args<T> a, cudaStream_t stream) {
  const int cluster = a.k > 0 ? a.jb : 1;
  a.n_stream = (a.C * a.segs + cluster - 1) / cluster * cluster;
  const int n_tail = a.k > 0 ? (a.C + kTailChains - 1) / kTailChains * a.jb
                             : 0;
  const bool need_v = a.drift || a.kinetic != nullptr || a.vel != nullptr;
  // the ring of min(kStages, chunks) slots of kChunk elements of M^{-1}
  // and the chunk's kicked momenta: at most 160 KB in float64, whatever k
  // is, and one slot when the block's rows fit one chunk (the stream CTAs
  // of the same grid are not held back by a ring they do not use)
  constexpr int rows = kChunk / (kTailCols * CPT);
  const int chunks = (a.k + rows - 1) / rows;
  const int slots = chunks < kStages ? chunks : kStages;
  const size_t smem =
      a.k > 0 && need_v
          ? (size_t)slots * (kChunk + rows * kTailChains) * sizeof(T)
          : 0;
  auto kernel = leapfrog_kernel<T, CPT, kParts>;
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

template <typename T, int kParts>
int launch_tail(const Args<T>& a, int cpt, cudaStream_t stream) {
  switch (cpt) {
    case 1: return launch<T, 1, kParts>(a, stream);
    case 2: return launch<T, 2, kParts>(a, stream);
    case 4: return launch<T, 4, kParts>(a, stream);
  }
  return launch<T, kMaxCpt, kParts>(a, stream);
}

template <typename T>
int leapfrog_update(T* q, T* p, const T* g, const T* diag,
                    const T* tail_inv, const T* step, int k, int ld, int C,
                    int dim, int nkick, int drift, int step_stride,
                    const unsigned char* active, T* vel, T* kinetic,
                    T* part, int part_cols, int* ticket,
                    cudaStream_t stream) {
  if (C < 1 || k < 0 || k > dim || nkick < 0 || (k < dim && !diag) ||
      (k > 0 && !tail_inv) || (step_stride != 0 && step_stride != 1))
    return (int)cudaErrorInvalidValue;
  Args<T> a = {q, p, g, diag, tail_inv, step, active, vel, kinetic, part,
               ticket, k, ld, C, dim, dim - k, nkick, drift, step_stride,
               0, 0, 0, 1, 0};
  const int head = dim - k;
  a.segs = head > 0 ? ((head + kQuad - 1 + kQuad - 1) / kQuad + kThreads - 1) /
                          kThreads
                    : 0;
  // columns a tail thread owns: as few as keep a cluster within 8 CTAs,
  // rounded up to a power of two (the kernel's template argument), at
  // most kMaxCpt; a wider block takes more than one column block a CTA
  const int cpt = (k + kMaxCluster * kTailCols - 1) / (kMaxCluster * kTailCols);
  const int CPT = cpt <= 1 ? 1 : cpt <= 2 ? 2 : cpt <= 4 ? 4 : kMaxCpt;
  const int nblk = (k + CPT * kTailCols - 1) / (CPT * kTailCols);
  a.npass = nblk > 0 ? (nblk + kMaxCluster - 1) / kMaxCluster : 1;
  a.jb = (nblk + a.npass - 1) / a.npass;
  a.S = a.segs + a.jb;
  // the dense block's rows padded to the columns its cluster covers, so
  // that every CTA's slab of a row is 16-byte aligned
  if (k > 0 && (ld != a.jb * a.npass * CPT * kTailCols ||
                reinterpret_cast<uintptr_t>(tail_inv) % 16))
    return (int)cudaErrorInvalidValue;
  if (kinetic && a.S > 1 && (part_cols != a.S || !part || !ticket))
    return (int)cudaErrorInvalidValue;
  if (k == 0) return launch<T, 1, kHead>(a, stream);
  return head > 0 ? launch_tail<T, kHead | kTail>(a, CPT, stream)
                  : launch_tail<T, kTail>(a, CPT, stream);
}

}  // namespace

#define MAGI_LEAPFROG_ENTRY_POINT(T, SUF)                                     \
  extern "C" int magi_leapfrog_update_##SUF(                                  \
      T* q, T* p, const T* g, const T* diag, const T* tail_inv,               \
      const T* step, int k, int ld, int C, int dim, int nkick, int drift,     \
      int step_stride, const unsigned char* active, T* vel, T* kinetic,       \
      T* part, int part_cols, int* ticket, void* stream) {                    \
    return leapfrog_update<T>(q, p, g, diag, tail_inv, step, k, ld, C, dim,   \
                              nkick, drift, step_stride, active, vel,         \
                              kinetic, part, part_cols, ticket,               \
                              (cudaStream_t)stream);                          \
  }

MAGI_LEAPFROG_ENTRY_POINT(float, f32)
MAGI_LEAPFROG_ENTRY_POINT(double, f64)
