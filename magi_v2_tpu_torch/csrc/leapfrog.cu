// The HMC leapfrog update (kernel K2) for NVIDIA Hopper (sm_90a).
//
// Replaces: the elementwise body of the leapfrog loop of
// magi_v2_tpu/sampler/hmc.py:make_hmc_step (p + eps/2 g, q + eps v) with
// the velocity and kinetic energy of magi_v2_tpu/sampler/mass.py
// (mass_vel, mass_kinetic), which XLA fused into the loop body.
//
// One launch per leapfrog does, for every coordinate of every chain:
//   p <- p + (eps/2) g, nkick times (2 = the closing half-kick of the last
//        leapfrog and the opening half-kick of this one, rounded in that
//        order),
//   v  = M^{-1} p: the diagonal head, and the dense inverse-mass block of
//        the last k <= kMaxTail coordinates (mass_matrix "tail_dense") from
//        the kicked tail momenta in shared memory; or v read from `vel`
//        when the caller computed it (the full dense metric, whose velocity
//        is one (C, dim) x (dim, dim) GEMM left to cuBLAS),
//   q <- q + eps v (when drift), and the per-chain kinetic energy
//        0.5 p.v (when kinetic is given).
// One block per chain reduces the kinetic energy in shared memory (no
// atomics). The step size is read from device memory, so the host never
// waits for it.
//
// What bounds it: device-memory bandwidth (it reads q, p, g and writes q, p
// once: 5 x 3 MB at 256 chains x 3081 coordinates in float32, ~5 us at
// 3.35 TB/s) and, at that size, its launch. It replaces the three to six
// eager elementwise launches of the plain leapfrog.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTail = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leapfrog_kernel(T* __restrict__ q, T* __restrict__ p,
                const T* __restrict__ g, const T* __restrict__ vel,
                const T* __restrict__ diag, const T* __restrict__ tail_inv,
                const T* __restrict__ step_size, int k, int dim, int nkick,
                int drift, T* __restrict__ kinetic) {
  __shared__ T ptail[kMaxTail];
  __shared__ T red[kThreads / 32];
  const int c = blockIdx.x;
  const size_t base = (size_t)c * dim;
  const T eps = step_size[0];
  const T half = T(0.5) * eps;
  const int head = dim - k;
  const bool need_v = drift || kinetic != nullptr;
  const bool own_v = need_v && vel == nullptr;

  if (own_v && k > 0) {
    if (threadIdx.x < k) {
      const size_t i = base + head + threadIdx.x;
      T pv = p[i];
      for (int n = 0; n < nkick; ++n) pv = pv + half * g[i];
      ptail[threadIdx.x] = pv;
    }
    __syncthreads();
  }
  T acc = T(0);
  for (int i = threadIdx.x; i < dim; i += kThreads) {
    const size_t o = base + i;
    T pv;
    if (own_v && i >= head) {
      pv = ptail[i - head];
    } else {
      pv = p[o];
      for (int n = 0; n < nkick; ++n) pv = pv + half * g[o];
    }
    p[o] = pv;
    if (!need_v) continue;
    T v;
    if (!own_v) {
      v = vel[o];
    } else if (i < head) {
      v = pv * diag[i];
    } else {
      v = T(0);
      for (int j = 0; j < k; ++j) v += ptail[j] * tail_inv[j * k + (i - head)];
    }
    if (drift) q[o] = q[o] + eps * v;
    acc += pv * v;
  }
  if (kinetic == nullptr) return;
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : T(0);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) kinetic[c] = T(0.5) * acc;
  }
}

}  // namespace

#define MAGI_LEAPFROG_ENTRY_POINT(T, SUF)                                     \
  extern "C" int magi_leapfrog_update_##SUF(                                  \
      T* q, T* p, const T* g, const T* vel, const T* diag,                    \
      const T* tail_inv, const T* step_size, int k, int C, int dim,           \
      int nkick, int drift, T* kinetic, void* stream) {                       \
    if (k < 0 || k > kMaxTail) return (int)cudaErrorInvalidValue;             \
    leapfrog_kernel<T><<<C, kThreads, 0, (cudaStream_t)stream>>>(             \
        q, p, g, vel, diag, tail_inv, step_size, k, dim, nkick, drift,        \
        kinetic);                                                             \
    return (int)cudaGetLastError();                                           \
  }

MAGI_LEAPFROG_ENTRY_POINT(float, f32)
MAGI_LEAPFROG_ENTRY_POINT(double, f64)
