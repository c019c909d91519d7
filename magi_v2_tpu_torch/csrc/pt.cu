// The replica exchange of parallel tempering (kernel K6), for NVIDIA
// Hopper (sm_90a).
//
// Replaces: the even-odd exchange of magi_v2_tpu/sampler/run.py:pt_swap
// (the loop over adjacent rung pairs after the beta = 1 evaluation), which
// XLA compiled into a chain of selects over the whole (R, M, dim) state.
//
// Chains are rung-major: chain r * M + m is replica m of rung r, at
// temperature beta_r, beta_0 = 1 > beta_1 > ... > beta_{R-1} > 0. A swap
// round of parity `par` proposes, for every pair (i, i + 1) with
// i % 2 == par and every replica m, to exchange the states of chains
// i M + m and (i + 1) M + m, with
//   log alpha = (beta_i - beta_{i+1}) (lp[(i+1) M + m] - lp[i M + m]),
// lp the log-posterior at beta = 1 (evaluated by the caller, value only),
// and accepts iff log alpha is finite and log u < log alpha, u the caller's
// uniform (R - 1, M), all in the sampling type T. An accepted pair swaps
// its two dim-wide rows of q and its two lp. Pairs of one parity are
// disjoint, so no two CTAs touch one row. `prop[i]` gains the M proposals
// and `accs[i]` the accepted ones of pair i, by integer atomics: the counts
// do not depend on scheduling.
//
// What bounds it: the bytes of the round's lp and u and of the rows it
// moves (each moved row read once and written once), a few KB to a few
// hundred KB on the paths; at 3.35 TB/s well under a microsecond, so a
// launch is its fixed cost. The design is simple for that reason: one CTA
// per (active pair, block of kWarps replicas), one warp a replica. Lane 0
// decides; an accepted replica's warp swaps the two rows with 16-byte loads
// and stores where the rows share their alignment (the head up to the
// 16-byte boundary and the tail element by element), and element by
// element where they do not (M * dim * sizeof(T) not a multiple of 16).
// The parity is read from device memory, so one CUDA graph serves both
// parities; the grid covers the larger parity's pairs, and a CTA of a
// pair that the round's parity does not have returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// a[i] <-> b[i] for i < dim, by one warp
template <typename T>
__device__ void swap_rows(T* a, T* b, int dim, int lane) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = 16 / sizeof(T);
  const unsigned ma = (unsigned)(reinterpret_cast<uintptr_t>(a) % 16);
  const unsigned mb = (unsigned)(reinterpret_cast<uintptr_t>(b) % 16);
  int head = dim;
  if (ma == mb) {
    head = ma ? (int)((16 - ma) / sizeof(T)) : 0;
    if (head > dim) head = dim;
  }
  for (int i = lane; i < head; i += 32) {
    const T x = a[i], y = b[i];
    a[i] = y;
    b[i] = x;
  }
  const int nv = (dim - head) / kPer;
  V* va = reinterpret_cast<V*>(a + head);
  V* vb = reinterpret_cast<V*>(b + head);
  for (int i = lane; i < nv; i += 32) {
    const V x = va[i], y = vb[i];
    va[i] = y;
    vb[i] = x;
  }
  for (int i = head + nv * kPer + lane; i < dim; i += 32) {
    const T x = a[i], y = b[i];
    a[i] = y;
    b[i] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
pt_swap_kernel(T* __restrict__ q, T* __restrict__ lp,
               const T* __restrict__ dlb, const T* __restrict__ u,
               const int* __restrict__ parity, int R, int M, int dim,
               int blocks_per_pair, int* __restrict__ prop,
               int* __restrict__ accs) {
  const int i = 2 * (blockIdx.x / blocks_per_pair) + *parity;
  if (i >= R - 1) return;
  const int blk = blockIdx.x % blocks_per_pair;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) atomicAdd(prop + i, min(kWarps, M - blk * kWarps));
  const int m = blk * kWarps + warp;
  if (m >= M) return;  // warp-uniform
  const size_t ci = (size_t)i * M + m, cj = ci + M;
  int take = 0;
  if (lane == 0) {
    const T li = lp[ci], lj = lp[cj];
    const T log_alpha = dlb[i] * (lj - li);
    take = isfinite(log_alpha) && lg(u[(size_t)i * M + m]) < log_alpha;
    if (take) {
      lp[ci] = lj;
      lp[cj] = li;
      atomicAdd(accs + i, 1);
    }
  }
  take = __shfl_sync(0xffffffffu, take, 0);
  if (take) swap_rows(q + ci * dim, q + cj * dim, dim, lane);
}

template <typename T>
int launch(T* q, T* lp, const T* dlb, const T* u, const int* parity, int R,
           int M, int dim, int* prop, int* accs, void* stream) {
  if (R < 2 || M < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int bpp = (M + kWarps - 1) / kWarps;
  // pairs of the larger parity: ceil((R - 1) / 2)
  const int pairs = R / 2;
  pt_swap_kernel<T><<<pairs * bpp, kWarps * 32, 0, (cudaStream_t)stream>>>(
      q, lp, dlb, u, parity, R, M, dim, bpp, prop, accs);
  return (int)cudaGetLastError();
}

}  // namespace

// q (C, dim) and lp (C,) updated in place, C = R M; dlb (R - 1,) the gaps
// beta_i - beta_{i+1} in T; u (R - 1, M); parity one int on the device;
// prop and accs (R - 1,) int counters, added to.
extern "C" int magi_pt_swap_f32(float* q, float* lp, const float* dlb,
                                const float* u, const int* parity, int R,
                                int M, int dim, int* prop, int* accs,
                                void* stream) {
  return launch(q, lp, dlb, u, parity, R, M, dim, prop, accs, stream);
}

extern "C" int magi_pt_swap_f64(double* q, double* lp, const double* dlb,
                                const double* u, const int* parity, int R,
                                int M, int dim, int* prop, int* accs,
                                void* stream) {
  return launch(q, lp, dlb, u, parity, R, M, dim, prop, accs, stream);
}
