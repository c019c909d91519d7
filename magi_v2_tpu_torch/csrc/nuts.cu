// The NUTS leaf epilogue (kernel K5) for NVIDIA Hopper (sm_90a).
//
// Replaces: the body of the leaf loop of
// magi_v2_tpu/sampler/nuts.py:_build_subtree after the leapfrog (the
// energy error, the divergence flag, the multinomial weight and proposal,
// the checkpoint store and the U-turn checks against the checkpoint
// slots, nuts.py:130-176), which XLA compiled into the while-loop body,
// vmapped over chains.
//
// One launch per leaf for all C chains, chains in masked lockstep: a chain
// whose `active` flag is 0 (its subtree has ended, or its trajectory) is
// left untouched. For an active chain c, with H = -lp + kin the leaf's
// energy and leaf index n = ctr[1] of doubling d = ctr[0]:
//   dH = H - H0 (a non-finite dH counts as +inf), diverging = dH > max,
//   lw = -dH, sum_alpha += exp(min(0, -dH)), lsw' = logaddexp(lsw, lw),
//   prop_q <- q when log(u) < lw - lsw' (u = leaf_u[c, 2^d - 1 + n]),
//   for even n: checkpoint slot popcount(n) <- (q, v),
//   for odd n: turning = any over slots s in [popcount(n) - t, popcount(n))
//   (t the trailing ones of n) of dq.v_s < 0 or dq.v < 0, with
//   dq = sign(eps) (q - q_s), so that a backward subtree is checked in
//   trajectory-time order,
//   lsw <- lsw', n_leaves += 1, active <- !(turning || diverging).
// The slots hold the velocity v = M^{-1} p that K2 computed with the leaf,
// so no product with M^{-1} is made here (the JAX loop recomputes one per
// slot and leaf).
//
// Design: one CTA of 256 threads per chain. Every thread computes the
// chain's scalars; the dot products over dim are summed by each thread in
// index order, then over the warp by shuffles and over the 8 warps in
// order, so every run gives the same bits (no float atomics). The leaf
// index and the uniforms are read from device memory, so a CUDA graph
// replays the same launch for every leaf.
//
// What bounds it: device-memory bandwidth. A leaf reads q and v (C x dim)
// and, at an odd n, t checkpoint rows of q and of v; it writes a proposal
// row where one is accepted and, at an even n, one slot row of q and of
// v. At 256 chains x 489 in float32 that is 1-12 x 0.5 MB, 0.15-2 us at
// 3.35 TB/s; a launch of this size takes a few us on its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Args {
  const T* q;
  const T* v;
  const T* lp;
  const T* kin;
  const T* H0;
  const T* eps;
  const T* leaf_u;
  int U;
  const int* ctr;
  T* lsw;
  T* sum_alpha;
  T* prop_q;
  T* ckpt_q;
  T* ckpt_v;
  unsigned char* active;
  unsigned char* turning;
  unsigned char* diverging;
  int* n_leaves;
  T max_energy_diff;
  int max_depth, C, dim;
};

// log(exp(a) + exp(b)), as jnp.logaddexp: a + b where a - b is NaN (two
// infinities of one sign)
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  const T d = a - b;
  if (isnan(d)) return a + b;
  return fmax(a, b) + log1p(exp(-fabs(d)));
}

// the sums over the CTA of a thread's pair (x, y), in a fixed order; every
// thread gets them
template <typename T>
__device__ void block_sum2(T& x, T& y, T (*red)[2]) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
  }
  const int w = threadIdx.x >> 5;
  __syncthreads();  // the last reader of red is done
  if ((threadIdx.x & 31) == 0) {
    red[w][0] = x;
    red[w][1] = y;
  }
  __syncthreads();
  x = T(0);
  y = T(0);
  for (int i = 0; i < kWarps; ++i) {
    x += red[i][0];
    y += red[i][1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) nuts_leaf_kernel(Args<T> a) {
  __shared__ T red[kWarps][2];
  const int c = blockIdx.x;
  if (!a.active[c]) return;
  const int d = a.ctr[0], n = a.ctr[1];
  T dH = (-a.lp[c] + a.kin[c]) - a.H0[c];
  if (!isfinite(dH)) dH = T(INFINITY);
  const bool div = dH > a.max_energy_diff;
  const T lw = -dH;
  const T sa = a.sum_alpha[c] + exp(fmin(T(0), -dH));
  const T lsw_new = logaddexp(a.lsw[c], lw);
  const T u = a.leaf_u[(size_t)c * a.U + (1 << d) - 1 + n];
  const bool take = log(u) < lw - lsw_new;
  const T sign = a.eps[c] > T(0) ? T(1) : a.eps[c] < T(0) ? T(-1) : T(0);
  const size_t row = (size_t)c * a.dim;
  const T* q = a.q + row;
  const T* v = a.v + row;
  if (take)
    for (int e = threadIdx.x; e < a.dim; e += kThreads) a.prop_q[row + e] = q[e];
  const int pc = __popc(n);
  const size_t slot = (size_t)a.C * a.dim;
  bool turn = false;
  if ((n & 1) == 0) {
    T* sq = a.ckpt_q + pc * slot + row;
    T* sv = a.ckpt_v + pc * slot + row;
    for (int e = threadIdx.x; e < a.dim; e += kThreads) {
      sq[e] = q[e];
      sv[e] = v[e];
    }
  } else {
    const int t = __popc(((n + 1) & -(n + 1)) - 1);  // trailing ones of n
    for (int s = pc - t; s < pc; ++s) {
      const T* sq = a.ckpt_q + s * slot + row;
      const T* sv = a.ckpt_v + s * slot + row;
      T x = T(0), y = T(0);
      for (int e = threadIdx.x; e < a.dim; e += kThreads) {
        const T dq = sign * (q[e] - sq[e]);
        x += dq * sv[e];
        y += dq * v[e];
      }
      block_sum2(x, y, red);
      turn = turn || x < T(0) || y < T(0);
    }
  }
  // every thread has read the chain's scalars before they change
  __syncthreads();
  if (threadIdx.x != 0) return;
  a.lsw[c] = lsw_new;
  a.sum_alpha[c] = sa;
  a.n_leaves[c] += 1;
  a.turning[c] = turn;
  a.diverging[c] = div;
  a.active[c] = !(turn || div);
}

template <typename T>
int nuts_leaf(const T* q, const T* v, const T* lp, const T* kin, const T* H0,
              const T* eps, const T* leaf_u, int U, const int* ctr, T* lsw,
              T* sum_alpha, T* prop_q, T* ckpt_q, T* ckpt_v,
              unsigned char* active, unsigned char* turning,
              unsigned char* diverging, int* n_leaves,
              double max_energy_diff, int max_depth, int C, int dim,
              cudaStream_t stream) {
  if (C < 1 || dim < 1 || max_depth < 1 || max_depth > 30 ||
      U < (1 << max_depth) - 1)
    return (int)cudaErrorInvalidValue;
  Args<T> a = {q, v, lp, kin, H0, eps, leaf_u, U, ctr, lsw, sum_alpha,
               prop_q, ckpt_q, ckpt_v, active, turning, diverging, n_leaves,
               (T)max_energy_diff, max_depth, C, dim};
  nuts_leaf_kernel<T><<<C, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define MAGI_NUTS_ENTRY_POINT(T, SUF)                                          \
  extern "C" int magi_nuts_leaf_##SUF(                                         \
      const T* q, const T* v, const T* lp, const T* kin, const T* H0,          \
      const T* eps, const T* leaf_u, int U, const int* ctr, T* lsw,            \
      T* sum_alpha, T* prop_q, T* ckpt_q, T* ckpt_v, unsigned char* active,    \
      unsigned char* turning, unsigned char* diverging, int* n_leaves,         \
      double max_energy_diff, int max_depth, int C, int dim, void* stream) {   \
    return nuts_leaf<T>(q, v, lp, kin, H0, eps, leaf_u, U, ctr, lsw,           \
                        sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning,    \
                        diverging, n_leaves, max_energy_diff, max_depth, C,    \
                        dim, (cudaStream_t)stream);                            \
  }

MAGI_NUTS_ENTRY_POINT(float, f32)
MAGI_NUTS_ENTRY_POINT(double, f64)
