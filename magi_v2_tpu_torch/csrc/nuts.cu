// The NUTS leaf (kernel nuts_leaf) for NVIDIA Hopper (sm_90a): after a
// leaf's evaluation, one launch closes the leaf, runs its epilogue,
// advances the leaf counter and opens the next leaf.
//
// Replaces: the leapfrog of magi_v2_tpu/sampler/nuts.py:_leapfrog
// (nuts.py:56-62: the closing half-kick of this leaf, the opening
// half-kick and drift of the next) with the velocity and kinetic energy of
// magi_v2_tpu/sampler/mass.py (mass_vel, mass_kinetic), and the body of
// the leaf loop of _build_subtree after the leapfrog (nuts.py:130-176: the
// energy error, the divergence flag, the multinomial weight and proposal,
// the checkpoint store and the U-turn checks against the checkpoint
// slots), which XLA compiled into the while-loop body, vmapped over chains.
//
// One launch per leaf for all C chains in masked lockstep. For every chain
// c whose `active` flag is set when the launch starts, with leaf n =
// ctr[1] of doubling d = ctr[0] and h = eps_c / 2 (eps_c the chain's
// signed step; its sign is the direction):
//   p_end = p + h g, v_end = M^{-1} p_end, kin = 0.5 p_end.v_end,
//   dH = -lp + kin - H0 (a non-finite dH counts as +inf),
//   diverging = dH > max, lw = -dH, sum_alpha += exp(min(0, -dH)),
//   lsw' = logaddexp(lsw, lw), prop_q <- q when log(u) < lw - lsw'
//   (u = leaf_u[c, 2^d - 1 + n]),
//   for even n: checkpoint slot popcount(n) <- (q, v_end),
//   for odd n: turning = any over slots s in [popcount(n) - t,
//   popcount(n)) (t the trailing ones of n) of dq.v_s < 0 or
//   dq.v_end < 0, with dq = sign(eps_c) (q - q_s), so that a backward
//   subtree is checked in trajectory-time order,
//   lsw <- lsw', n_leaves += 1, active <- !(turning || diverging),
//   v <- v_end; and unless n + 1 = 2^d (the doubling's last leaf) the next
//   leaf's opening: p_half = p_end + h g (rounded after p_end, as two
//   kicks), v_half = M^{-1} p_half, q <- q + eps_c v_half, p <- p_half;
//   at the last leaf p <- p_end and q stays.
// The grid's last CTA, found by a ticket, advances ctr[1]. A chain whose
// flag is 0 at the start is left untouched (a non-finite g there changes
// nothing). The slots hold v_end beside q, so no product with M^{-1} is
// made for them (the JAX loop recomputes one per slot and leaf).
//
// Design (b), drift then decide. Every chain active at the start is
// closed, decided and opened in the same pass over its row; the decision
// needs the row's sums (the kinetic energy, the U-turn dots), which the
// chain's CTAs leave as partial sums, added in a fixed order (no float
// atomics: a launch is deterministic, graph and eager alike) by the CTA
// that draws the chain's last ticket (an integer atomic) or, on the full
// dense metric, by every CTA of the chain's cluster; the proposal is
// copied from q_end, which every CTA stored to the scratch row `qe`
// before it drifted q. A chain that turns or diverges at
// leaf n < 2^d - 1 has so been drifted once more; nothing reads that
// state (the epilogue copies the trajectory's ends only for chains that
// neither turned nor diverged, and the proposal reads q_end).
//
// The grid is K2's (csrc/leapfrog.cu), so a launch compiles only the CTA
// kinds its grid holds:
// - Stream CTAs take the diagonal head, columns [0, dim - k), as aligned
//   quads of the flat (C, dim) rows, one 1024-element segment a CTA.
// - Tail CTAs take the dense block: one thread-block cluster of jb <= 8
//   CTAs per kTailChains = 16 chains (K2's clusters). Each CTA kicks its
//   own columns (p_end to the scratch `pe`, p_half to p); after the
//   cluster's barrier every CTA streams both kicked rows of all k columns
//   back from L2 beside the rows of M^{-1} (cp.async, a ring of four
//   slots, the rows padded to the cluster's width), and multiplies: 16
//   chains x 2 right-hand sides are 32 momentum columns, 4 a thread (K2's
//   accumulators a thread, with the rows in halves in place of K2's
//   quarters), so M^{-1} is streamed once for both products of a chain,
//   on the CUDA cores in full precision (no TF32). (512 threads a CTA,
//   the rows in quarters, is faster up to 64 chains but takes two waves
//   at 256: PERF.md.)
// - On the full dense metric all of a chain's CTAs are one cluster: its
//   sums are added from the cluster's shared memory, and every CTA decides
//   the cluster's chains alike and copies its own columns of the
//   proposals; elsewhere the CTA that draws a chain's last ticket does.
// - A cluster or stream CTA whose chains are all inactive at the start
//   does nothing but draw its grid ticket.
//
// What bounds it: the float32 FMA rate on the full dense metric (two
// products: 2 x 256 x 489 x 489 FMAs, 3.7 us at 67 TFLOP/s), device
// memory for the diagonal (q, p, g read, q, p, v written). The times on
// an H100 are in PERF.md beside those of the three launches it replaces
// (K2's closing and opening launches and K5's epilogue).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // threads of a stream CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTailChains = 16;            // chains of a tail cluster
constexpr int kVirt = 2 * kTailChains;     // its momentum columns (p_end,
                                           // p_half of each chain)
constexpr int kTailCols = 64;              // columns of a tail column group
constexpr int kMomPerThread = 4;           // momentum columns of a thread
constexpr int kMaxCluster = 8;
constexpr int kMaxCpt = 8;                 // column groups of a tail thread
constexpr int kChunk = 2048;               // elements of M^{-1} a chunk,
                                           // at least 8 rows
constexpr int kStages = 4;                 // slots of a tail CTA's ring
constexpr int kSplitK = 2;                 // a tail CTA's row halves
constexpr int kMaxDepth = 16;              // the deepest tree taken
constexpr int kMaxW = 1 + 2 * kMaxDepth;   // sums of a chain: kin, x_s, y_s

template <typename T>
struct Args {
  T* q;
  T* p;
  const T* g;
  const T* diag;
  const T* tail_inv;
  const T* eps;
  const T* lp;
  const T* H0;
  const T* leaf_u;
  int* ctr;
  T* lsw;
  T* sum_alpha;
  T* prop_q;
  T* ckpt_q;
  T* ckpt_v;
  unsigned char* active;
  unsigned char* turning;
  unsigned char* diverging;
  int* n_leaves;
  T* vel;
  T* qe;
  T* pe;
  T* part;
  int* ticket;
  int* grid_ticket;
  T max_energy_diff;
  int U, k, ld, C, dim, head, segs, n_stream, jb, npass, S, W;
};

// the rows of M^{-1} a chunk holds: kChunk elements, or 8 rows of a wider
// column block (the momenta's stream takes 8 rows at a time)
template <int CPT>
__host__ __device__ constexpr int chunk_rows() {
  return kChunk / (kTailCols * CPT) >= 8 ? kChunk / (kTailCols * CPT) : 8;
}

// the leaf: doubling d, index n, slot popcount(n), the first slot checked
// (slots [s0, pc) at an odd n; none at an even one) and whether the next
// leaf opens here
struct Leaf {
  int d, n, pc, s0;
  bool open;
};

template <typename T>
__device__ __forceinline__ Leaf leaf_of(const Args<T>& a) {
  // read once, before the grid's ticket: the last CTA advances ctr[1]
  const volatile int* ctr = a.ctr;
  Leaf l;
  l.d = ctr[0];
  l.n = ctr[1];
  l.pc = __popc(l.n);
  const int m = l.n + 1;
  l.s0 = (l.n & 1) ? l.pc - __popc((m & -m) - 1) : l.pc;
  l.open = l.n + 1 < (1 << l.d);
  return l;
}

// log(exp(a) + exp(b)), as jnp.logaddexp: a + b where a - b is NaN (two
// infinities of one sign)
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  const T d = a - b;
  if (isnan(d)) return a + b;
  return fmax(a, b) + log1p(exp(-fabs(d)));
}

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : x < T(0) ? T(-1) : T(0);
}

// the sum over a warp, in a fixed order, in lane 0
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Chain c's leaf from its kinetic energy and U-turn flag: whether the
// proposal moves to q_end; with `store`, the chain's scalars and flags are
// updated
template <typename T>
__device__ bool decide(const Args<T>& a, const Leaf& l, int c, T kin,
                       bool turn, bool store) {
  const T lp = a.lp[c], H0 = a.H0[c], lsw = a.lsw[c];
  const T sa = a.sum_alpha[c];
  const T u = a.leaf_u[(size_t)c * a.U + (1 << l.d) - 1 + l.n];
  T dH = (-lp + kin) - H0;
  if (!isfinite(dH)) dH = T(INFINITY);
  const bool div = dH > a.max_energy_diff;
  const T lw = -dH;
  const T lsw_new = logaddexp(lsw, lw);
  if (store) {
    a.sum_alpha[c] = sa + exp(fmin(T(0), -dH));
    a.lsw[c] = lsw_new;
    a.n_leaves[c] += 1;
    a.turning[c] = turn;
    a.diverging[c] = div;
    a.active[c] = !(turn || div);
  }
  return log(u) < lw - lsw_new;
}

// Chain c's partial sums from this CTA (vals: the kinetic sum p_end.v_end,
// then x_s = dq.v_s and y_s = dq.v_end of each slot checked), stored as row
// `slot` of the chain's S rows by the lanes of one warp (a lane a value).
// The warp that stores the last row adds the rows in order, a lane a value
// and four loads in flight, decides the chain's leaf and resets the ticket.
// Returns, to every lane, 0 when another CTA finishes the chain, 1 when
// this warp did, 2 when it did and the proposal moves to q_end.
template <typename T>
__device__ int finish_chain(const Args<T>& a, const Leaf& l, int c, int slot,
                            const T* vals) {
  const int lane = threadIdx.x & 31;
  const int nv = 1 + 2 * (l.pc - l.s0);
  T* row = a.part + (size_t)c * a.S * a.W;
  if (lane < nv) __stcg(row + (size_t)slot * a.W + lane, vals[lane]);
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(a.ticket + c, 1) == a.S - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return 0;
  __threadfence();
  T sum = T(0);
  if (lane < nv)
    for (int h0 = 0; h0 < a.S; h0 += 4) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = h0 + u < a.S ? __ldcg(row + (size_t)(h0 + u) * a.W + lane)
                            : T(0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (h0 + u < a.S) sum += v[u];
    }
  const bool turn =
      __any_sync(0xffffffffu, lane >= 1 && lane < nv && sum < T(0));
  const T kin = T(0.5) * __shfl_sync(0xffffffffu, sum, 0);
  int result = 0;
  if (lane == 0) {
    a.ticket[c] = 0;
    result = decide(a, l, c, kin, turn, true) ? 2 : 1;
  }
  return __shfl_sync(0xffffffffu, result, 0);
}

// prop_q <- q_end for each chain c0 + i (i < n) with flags[i] == 2, by the
// whole CTA, eight loads in flight a thread (the rows' CTAs stored q_end to
// qe before their tickets; the chains' rows are adjacent)
template <typename T>
__device__ void take_proposals(const Args<T>& a, int c0, const int* flags,
                               int n) {
  const int total = n * a.dim;
  const size_t base = (size_t)c0 * a.dim;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < total && flags[e / a.dim] == 2 ? __ldcg(a.qe + base + e)
                                                : T(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total && flags[e / a.dim] == 2) a.prop_q[base + e] = v[u];
    }
  }
}

template <typename T>
__device__ void stream_part(const Args<T>& a, const Leaf& l, int cta,
                            T* vals, int* flags) {
  const int c = cta / a.segs, s = cta % a.segs;
  if (!a.active[c]) return;
  const T eps = a.eps[c];
  const T half = T(0.5) * eps, sign = sign_of(eps);
  const size_t lo = (size_t)c * a.dim, hi = lo + a.head;
  const size_t f = (lo & ~size_t(kQuad - 1)) +
                   (size_t)kQuad * (s * kThreads + threadIdx.x);
  const size_t slot = (size_t)a.C * a.dim;
  T kin = T(0), qv[kQuad], ve[kQuad];
  if (f < hi) {
    T pv[kQuad], gv[kQuad], dv[kQuad], qn[kQuad];
    load_quad(a.p, f, lo, hi, pv);
    load_quad(a.g, f, lo, hi, gv);
    load_quad(a.q, f, lo, hi, qv);
#pragma unroll
    for (int i = 0; i < kQuad; ++i)
      dv[i] = f + i >= lo && f + i < hi ? __ldg(a.diag + (f + i - lo)) : T(0);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      ve[i] = T(0);
      qn[i] = qv[i];
      // an element of the neighbouring row is neither used nor stored
      if (f + i < lo || f + i >= hi) continue;
      const T pe = fmadd(half, gv[i], pv[i]);
      ve[i] = pe * dv[i];
      kin += pe * ve[i];
      const T ph = fmadd(half, gv[i], pe);
      qn[i] = fmadd(eps, ph * dv[i], qv[i]);
      pv[i] = l.open ? ph : pe;
    }
    store_quad(a.p, f, lo, hi, pv);
    store_quad(a.vel, f, lo, hi, ve);
    store_quad(a.qe, f, lo, hi, qv);
    if (l.open) store_quad(a.q, f, lo, hi, qn);
    // the slots' rows start on no 16-byte boundary in general: one store
    // an element
    if ((l.n & 1) == 0)
#pragma unroll
      for (int i = 0; i < kQuad; ++i)
        if (f + i >= lo && f + i < hi) {
          a.ckpt_q[l.pc * slot + f + i] = qv[i];
          a.ckpt_v[l.pc * slot + f + i] = ve[i];
        }
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) qv[i] = ve[i] = T(0);
  }
  // the CTA's sums: each warp's by shuffles, then the 8 warps' in order
  __shared__ T by_warp[kWarps][kMaxW];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  kin = warp_sum(kin);
  if (lane == 0) by_warp[w][0] = kin;
  for (int sl = l.s0; sl < l.pc; ++sl) {
    T x = T(0), y = T(0);
    if (f < hi)
#pragma unroll
      for (int i = 0; i < kQuad; ++i)
        if (f + i >= lo && f + i < hi) {
          const size_t o = sl * slot + f + i;
          const T dq = sign * (qv[i] - a.ckpt_q[o]);
          x += dq * a.ckpt_v[o];
          y += dq * ve[i];
        }
    x = warp_sum(x);
    y = warp_sum(y);
    if (lane == 0) {
      by_warp[w][1 + 2 * (sl - l.s0)] = x;
      by_warp[w][2 + 2 * (sl - l.s0)] = y;
    }
  }
  __syncthreads();
  if (threadIdx.x < 1 + 2 * (l.pc - l.s0)) {
    T v = T(0);
    for (int i = 0; i < kWarps; ++i) v += by_warp[i][threadIdx.x];
    vals[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int done = finish_chain(a, l, c, s, vals);
    if (threadIdx.x == 0) flags[0] = done;
  }
  __syncthreads();
  take_proposals(a, c, flags, 1);
}

// The full dense metric: all of a chain's CTAs are one cluster, so the
// chain's sums come from the cluster's shared memory, with no ticket. Every
// CTA adds the ranks' partial sums of the block's 16 chains in rank order
// (a warp a chain, a lane a value) and decides every chain alike (the same
// arithmetic on the same numbers); after the cluster's barrier (every CTA
// has read the chains' scalars) rank 0 stores them, and each CTA copies its
// own columns of the proposals taken.
template <typename T>
__device__ void cluster_decide(const Args<T>& a, const Leaf& l, int c_blk,
                               int rank, int own, unsigned on, T* vals,
                               int* flags, cg::cluster_group& cluster) {
  __shared__ T kin[kTailChains];
  __shared__ bool turned[kTailChains];
  // every CTA's sums are in its shared memory
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const int nv = 1 + 2 * (l.pc - l.s0);
  for (int i = threadIdx.x >> 5; i < kTailChains; i += kWarps) {
    if (!(on >> i & 1u)) {
      if (lane == 0) flags[i] = 0;
      continue;
    }
    T sum = T(0);
    if (lane < nv)
      for (int r = 0; r < a.jb; ++r)
        sum += cluster.map_shared_rank(vals, r)[i * kMaxW + lane];
    const bool turn =
        __any_sync(0xffffffffu, lane >= 1 && lane < nv && sum < T(0));
    if (lane == 0) {
      kin[i] = T(0.5) * sum;
      turned[i] = turn;
      flags[i] = decide(a, l, c_blk + i, kin[i], turn, false) ? 2 : 1;
    }
  }
  // no CTA's shared memory is read, nor a chain's scalars, after this
  cluster.sync();
  if (rank == 0 && threadIdx.x < kTailChains && flags[threadIdx.x])
    decide(a, l, c_blk + threadIdx.x, kin[threadIdx.x], turned[threadIdx.x],
           true);
  for (int e = threadIdx.x; e < kTailChains * own; e += kThreads) {
    const int i = e / own, j = rank * own + e % own;
    if (j >= a.k || flags[i] != 2) continue;
    const size_t o = (size_t)(c_blk + i) * a.dim + j;
    a.prop_q[o] = a.qe[o];
  }
}

// A tail CTA: kTailChains chains x the npass column blocks of nb = 64 CPT
// tail columns of cluster rank r. Its 256 threads are (kq, mg, jg): rows of
// M^{-1} split in kSplitK halves, 8 groups of 4 momentum columns (2 chains
// x (p_end, p_half)), 16 groups of 4 adjacent columns (CPT such groups a
// thread, 64 columns apart). The product is K2's (csrc/leapfrog.cu:
// tail_part) on the 32 momentum columns.
template <typename T, int CPT>
__device__ void tail_part(const Args<T>& a, const Leaf& l, int cta, T* ring,
                          T* vals, int* flags) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blk = cta / a.jb;
  constexpr int nb = kTailCols * CPT;
  const int own = nb * a.npass;
  const int c_blk = blk * kTailChains;
  constexpr int rows = chunk_rows<CPT>(), share = rows / kSplitK;
  constexpr int kM = rows * nb;  // M^{-1}'s elements in a slot
  constexpr int kSlot = kM + rows * kVirt;
  constexpr int kPf = (rows * kVirt + kThreads - 1) / kThreads;
  const int chunks = (a.k + rows - 1) / rows;
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
  // are copied while the chains' flags are read and the momenta kicked
  const int first_col = rank * a.npass * nb;
  if (first_col < a.k)
    for (int ch = 0; ch < kStages - 1; ++ch) fetch(first_col, ch);
  // the block's chains that run this leaf: the same set in every CTA of
  // the cluster (a chain's flag changes only after all its CTAs have
  // stored their sums)
  unsigned on = 0;
  for (int i = 0; i < kTailChains; ++i)
    if (c_blk + i < a.C && a.active[c_blk + i]) on |= 1u << i;
  if (on == 0) {
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  for (int e = threadIdx.x; e < kTailChains * kMaxW; e += kThreads)
    vals[e] = T(0);

  // 1. the kicks of this CTA's own columns: p_end to pe; p_half (p_end at
  //    the doubling's last leaf) to p
  for (int e = threadIdx.x; e < kTailChains * own; e += kThreads) {
    const int i = e / own, j = rank * own + e % own;
    if (j >= a.k || !(on >> i & 1u)) continue;
    const int c = c_blk + i;
    const size_t o = (size_t)c * a.dim + a.head + j;
    const T half = T(0.5) * a.eps[c];
    const T gj = __ldg(a.g + o);
    const T pe = fmadd(half, gj, a.p[o]);
    a.pe[o] = pe;
    a.p[o] = l.open ? fmadd(half, gj, pe) : pe;
  }
  // every kicked momentum is in global memory, and visible to the
  // cluster's CTAs
  cluster.sync();

  // 2. v_end and v_half over the tail, one column block at a time, as in
  //    K2: momentum column m is p_end (m even) or p_half (m odd) of chain
  //    c_blk + m / 2. In a slot, row i holds its 32 columns in groups of
  //    4, group g at position g ^ (i & 7), so that a warp's stores of 8
  //    consecutive rows fall in 32 different banks (float32).
  const int jg = threadIdx.x % 16, mg = (threadIdx.x / 16) % 8;
  const int kq = threadIdx.x / 128;
  auto row_of = [](int e) { return e / 32 % (rows / 8) * 8 + e % 8; };
  auto chain_of = [](int e) { return e / 32 / (rows / 8) * 4 + e % 32 / 8; };
  auto at_of = [](int i, int g) { return i * kVirt + (g ^ (i & 7)) * 4; };
  auto load_p = [&](int ch, T (&pf)[kPf]) {
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int m = chain_of(e), i = ch * rows + row_of(e);
      const int c = c_blk + m / 2;
      pf[u] = e < rows * kVirt && ch < chunks && i < a.k && c < a.C
                  ? __ldcg((m & 1 ? a.p : a.pe) + (size_t)c * a.dim +
                           a.head + i)
                  : T(0);
    }
  };
  auto store_p = [&](int ch, const T (&pf)[kPf]) {
    if (ch >= chunks) return;
    T* dst = ring + (size_t)(ch % kStages) * kSlot + kM;
#pragma unroll
    for (int u = 0; u < kPf; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < rows * kVirt)
        dst[at_of(row_of(e), chain_of(e) / 4) + chain_of(e) % 4] = pf[u];
    }
  };
  const size_t slot = (size_t)a.C * a.dim;
  T kin[2] = {T(0), T(0)};
  for (int pass = 0; pass < a.npass; ++pass) {
    const int col0 = (rank * a.npass + pass) * nb;
    if (col0 >= a.k) break;
    T acc[CPT][4][kMomPerThread];
#pragma unroll
    for (int r = 0; r < CPT; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < kMomPerThread; ++c) acc[r][u][c] = T(0);
    {
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
      const T* sl = ring + (size_t)(ch % kStages) * kSlot;
      const T* mb = sl + jg * 4;
      const T* st = sl + kM;
      const int r0 = kq * share;
      const int n_i = min(share, a.k - ch * rows - r0);
#pragma unroll 2
      for (int ii = 0; ii < n_i; ++ii) {
        const int i = r0 + ii;
        T ps[kMomPerThread];
        load4(st + at_of(i, mg), ps);
#pragma unroll
        for (int r = 0; r < CPT; ++r) {
          T m[4];
          load4(mb + i * nb + kTailCols * r, m);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < kMomPerThread; ++c)
              acc[r][u][c] = fmadd(ps[c], m[u], acc[r][u][c]);
        }
      }
      store_p(ch + kStages - 1, pf);
      __syncthreads();
    }
    // the halves' sums, added in the order kq = 0, 1 by the first half's
    // threads, one column group of 64 at a time through the ring
    constexpr int kPart = kVirt * kTailCols;
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      if (kq > 0)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < kMomPerThread; ++c)
            ring[(kq - 1) * kPart + (mg * 4 + c) * kTailCols + jg * 4 + u] =
                acc[r][u][c];
      __syncthreads();
      if (kq == 0)
        for (int q = 0; q < kSplitK - 1; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < kMomPerThread; ++c)
              acc[r][u][c] +=
                  ring[q * kPart + (mg * 4 + c) * kTailCols + jg * 4 + u];
      __syncthreads();
    }

    // 3. the close, the slot store and the opening drift of the block's
    //    columns by the first half's 128 threads (warps 0 to 3): chains
    //    c_blk + 2 mg + i, i = 0, 1
    if (kq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int chain = c_blk + mg * 2 + i;
        if (!(on >> (mg * 2 + i) & 1u)) continue;
        const T eps = a.eps[chain];
#pragma unroll
        for (int r = 0; r < CPT; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = col0 + kTailCols * r + jg * 4 + u;
            if (j >= a.k) continue;
            const T ve = acc[r][u][2 * i];
            const size_t o = (size_t)chain * a.dim + a.head + j;
            const T qo = a.q[o];
            kin[i] += __ldcg(a.pe + o) * ve;
            a.vel[o] = ve;
            a.qe[o] = qo;
            if ((l.n & 1) == 0) {
              a.ckpt_q[l.pc * slot + o] = qo;
              a.ckpt_v[l.pc * slot + o] = ve;
            }
            if (l.open) a.q[o] = fmadd(eps, acc[r][u][2 * i + 1], qo);
          }
      }
    }
    // the U-turn dots of the block's columns against slot s, by half
    // (s - s0) % 2 of the threads, from the rows of q_end and v_end just
    // stored
    __syncthreads();
    for (int s = l.s0 + kq; s < l.pc; s += kSplitK) {
      T x[2], y[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x[i] = y[i] = T(0);
        const int chain = c_blk + mg * 2 + i;
        if (!(on >> (mg * 2 + i) & 1u)) continue;
        const T sign = sign_of(a.eps[chain]);
#pragma unroll
        for (int r = 0; r < CPT; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = col0 + kTailCols * r + jg * 4 + u;
            if (j >= a.k) continue;
            const size_t o = (size_t)chain * a.dim + a.head + j;
            const T dq = sign * (a.qe[o] - a.ckpt_q[s * slot + o]);
            x[i] += dq * a.ckpt_v[s * slot + o];
            y[i] += dq * a.vel[o];
          }
      }
      // over the 16 column groups of each chain group: the two halves of
      // a warp
#pragma unroll
      for (int i = 0; i < 2; ++i)
        for (int off = 8; off > 0; off >>= 1) {
          x[i] += __shfl_down_sync(0xffffffffu, x[i], off, 16);
          y[i] += __shfl_down_sync(0xffffffffu, y[i], off, 16);
        }
      if (jg == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          T* v = vals + (mg * 2 + i) * kMaxW + 2 * (s - l.s0);
          v[1] += x[i];
          v[2] += y[i];
        }
    }
  }
  if (kq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      for (int off = 8; off > 0; off >>= 1)
        kin[i] += __shfl_down_sync(0xffffffffu, kin[i], off, 16);
    if (jg == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) vals[(mg * 2 + i) * kMaxW] = kin[i];
  }
  __syncthreads();
  if (a.head == 0) {
    cluster_decide(a, l, c_blk, rank, own, on, vals, flags, cluster);
    return;
  }
  // a warp a chain: warp w takes chains w and w + 8 of the block
  for (int i = threadIdx.x >> 5; i < kTailChains; i += kWarps) {
    const int done = on >> i & 1u ? finish_chain(a, l, c_blk + i,
                                                 a.segs + rank,
                                                 vals + i * kMaxW)
                                  : 0;
    if ((threadIdx.x & 31) == 0) flags[i] = done;
  }
  __syncthreads();
  take_proposals(a, c_blk, flags, min(kTailChains, a.C - c_blk));
}

// the grid's ticket: the last CTA advances the leaf counter (every CTA read
// it when it started) and resets the ticket
template <typename T>
__device__ void advance_leaf(const Args<T>& a) {
  __syncthreads();
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(a.grid_ticket, 1) != (int)gridDim.x - 1) return;
  a.ctr[1] += 1;
  *a.grid_ticket = 0;
}

constexpr int kHead = 1, kTail = 2;

// Registers: a float32 tail thread of one column group (k <= 512, the
// SEIR metric's 489) is held to 128 registers, two CTAs an SM, so that the
// 16 clusters of 8 CTAs of 256 chains run in one wave
template <typename T, int CPT, int kParts>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 && CPT == 1 ? 2 : 1)
    nuts_leaf_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T vals[kTailChains * kMaxW];
  __shared__ int flags[kTailChains];
  const Leaf l = leaf_of(a);
  const int b = blockIdx.x;
  T* ring = reinterpret_cast<T*>(smem_raw);
  if constexpr ((kParts & kHead) != 0) {
    if (b < a.n_stream) {
      if (b < a.C * a.segs) stream_part(a, l, b, vals, flags);
    } else if constexpr ((kParts & kTail) != 0) {
      tail_part<T, CPT>(a, l, b - a.n_stream, ring, vals, flags);
    }
  } else {
    tail_part<T, CPT>(a, l, b, ring, vals, flags);
  }
  advance_leaf(a);
}

template <typename T, int CPT, int kParts>
int launch(Args<T> a, cudaStream_t stream) {
  const int cluster = a.k > 0 ? a.jb : 1;
  a.n_stream = (a.C * a.segs + cluster - 1) / cluster * cluster;
  const int n_tail = a.k > 0 ? (a.C + kTailChains - 1) / kTailChains * a.jb
                             : 0;
  // the ring of min(kStages, chunks) slots of a chunk's rows of M^{-1}
  // and the chunk's 32 momentum columns (at least the second half's sums
  // of one column group)
  constexpr int rows = chunk_rows<CPT>();
  const int chunks = (a.k + rows - 1) / rows;
  const int slots = chunks < kStages ? chunks : kStages;
  const size_t smem =
      a.k > 0 ? (size_t)slots * rows * (kTailCols * CPT + kVirt) * sizeof(T)
              : 0;
  auto kernel = nuts_leaf_kernel<T, CPT, kParts>;
  static size_t allowed = 0;
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed = smem;
  }
  if (err == cudaSuccess) {
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
int nuts_leaf(T* q, T* p, const T* g, const T* diag, const T* tail_inv,
              const T* eps, const T* lp, const T* H0, const T* leaf_u, int U,
              int* ctr, T* lsw, T* sum_alpha, T* prop_q, T* ckpt_q, T* ckpt_v,
              unsigned char* active, unsigned char* turning,
              unsigned char* diverging, int* n_leaves, T* vel, T* qe, T* pe,
              T* part, int part_cols, int* ticket, int* grid_ticket,
              double max_energy_diff, int max_depth, int k, int ld, int C,
              int dim, cudaStream_t stream) {
  if (C < 1 || dim < 1 || k < 0 || k > dim || (k < dim && !diag) ||
      (k > 0 && (!tail_inv || !pe)) || max_depth < 1 ||
      max_depth > kMaxDepth || U < (1 << max_depth) - 1 || !part ||
      !ticket || !grid_ticket)
    return (int)cudaErrorInvalidValue;
  Args<T> a = {q, p, g, diag, tail_inv, eps, lp, H0, leaf_u, ctr, lsw,
               sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning, diverging,
               n_leaves, vel, qe, pe, part, ticket, grid_ticket,
               (T)max_energy_diff, U, k, ld, C, dim, dim - k,
               0, 0, 0, 1, 0, 1 + 2 * max_depth};
  const int head = dim - k;
  a.segs = head > 0 ? ((head + kQuad - 1 + kQuad - 1) / kQuad + kThreads - 1) /
                          kThreads
                    : 0;
  // the dense block's layout, as K2 picks it (csrc/leapfrog.cu)
  const int cpt = (k + kMaxCluster * kTailCols - 1) / (kMaxCluster * kTailCols);
  const int CPT = cpt <= 1 ? 1 : cpt <= 2 ? 2 : cpt <= 4 ? 4 : kMaxCpt;
  const int nblk = (k + CPT * kTailCols - 1) / (CPT * kTailCols);
  a.npass = nblk > 0 ? (nblk + kMaxCluster - 1) / kMaxCluster : 1;
  a.jb = (nblk + a.npass - 1) / a.npass;
  a.S = a.segs + a.jb;
  if (k > 0 && (ld != a.jb * a.npass * CPT * kTailCols ||
                reinterpret_cast<uintptr_t>(tail_inv) % 16))
    return (int)cudaErrorInvalidValue;
  if (part_cols != a.S * a.W) return (int)cudaErrorInvalidValue;
  if (k == 0) return launch<T, 1, kHead>(a, stream);
  return head > 0 ? launch_tail<T, kHead | kTail>(a, CPT, stream)
                  : launch_tail<T, kTail>(a, CPT, stream);
}

}  // namespace

#define MAGI_NUTS_ENTRY_POINT(T, SUF)                                          \
  extern "C" int magi_nuts_leaf_##SUF(                                         \
      T* q, T* p, const T* g, const T* diag, const T* tail_inv, const T* eps,  \
      const T* lp, const T* H0, const T* leaf_u, int U, int* ctr, T* lsw,      \
      T* sum_alpha, T* prop_q, T* ckpt_q, T* ckpt_v, unsigned char* active,    \
      unsigned char* turning, unsigned char* diverging, int* n_leaves,         \
      T* vel, T* qe, T* pe, T* part, int part_cols, int* ticket,               \
      int* grid_ticket, double max_energy_diff, int max_depth, int k, int ld,  \
      int C, int dim, void* stream) {                                          \
    return nuts_leaf<T>(q, p, g, diag, tail_inv, eps, lp, H0, leaf_u, U, ctr,  \
                        lsw, sum_alpha, prop_q, ckpt_q, ckpt_v, active,        \
                        turning, diverging, n_leaves, vel, qe, pe, part,       \
                        part_cols, ticket, grid_ticket, max_energy_diff,       \
                        max_depth, k, ld, C, dim, (cudaStream_t)stream);       \
  }

MAGI_NUTS_ENTRY_POINT(float, f32)
MAGI_NUTS_ENTRY_POINT(double, f64)
