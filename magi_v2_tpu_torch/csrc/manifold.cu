// Fused pointwise and per-chain work of the MAGI sampler's log-posterior
// and gradient (kernel K1), for NVIDIA Hopper (sm_90a).
//
// Replaces: the elementwise epilogues and reductions that XLA fused around
// the einsums of magi_v2_tpu/sampler/precond.py:make_tempered_logp_grad_gn
// (relative-energy branch) and magi_v2_tpu/posterior.py:
// log_posterior_given_t1 under jax.value_and_grad. The six matrix products
// of that function (L, [R; m], S forward; S^T, [R^T | -m^T], L^T backward)
// stay cuBLAS GEMMs issued by the caller; these three kernels run between
// them:
//
//   manifold_fwd     after [R; m] delta:  X = x0 + delta, f(X, softplus
//                    theta), dr = (f - f0) - m delta, the t1 seed
//                    g_Rd = -(beta_T/beta)(R delta + a0), partial sums t1, t4
//   manifold_energy  after Ds = S dr:     t2, t3, log-Jacobians, the
//                    tempered log-posterior, the seed g_Ds
//   manifold_bwd     after g_dr = S^T g_Ds: J_f(X)^T g_dr + the t4 term,
//                    the theta_pre and sigma_pre gradients, and g_dr copied
//                    beside g_Rd for the stacked [R^T | -m^T] product
//
// What bounds it on the card: latency and launch count, not bandwidth or
// flops. At the SEIR bench shapes (256 chains, N_I = 161, D = 3) each kernel
// moves 1-3 MB and does O(10) flops per element, which the H100 streams
// in under a microsecond; measured device time is 3-6 us per kernel
// (torch.profiler, H100 SXM), so a kernel is dominated by its launch and
// the short per-chain reductions. The design reads and writes every
// element once (each thread owns one (chain, n) point and all D
// components, so f and its Jacobian are evaluated once per point from
// registers), replaces some thirty small eager launches with three, and
// reduces per chain in one block's shared memory (no atomics, no second
// pass, results independent of scheduling).
//
// Layouts (row-major, contiguous): delta (C, D, N); RmD and gcat (D, C, 2N);
// dr, Ds, g_Ds, g_dr, gpart (D, C, N); q and grad (C, dim) with
// dim = N*D + D + P; x0T, a0, f0, s0, mask, y (D, N).
//
// The model enters as a functor (f, vjp_x, vjp_theta: the field and its
// vector-Jacobian products); a new ODE model adds a struct and one
// instantiation line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float lg1p(float x) { return log1pf(x); }
__device__ __forceinline__ double lg1p(double x) { return log1p(x); }

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus
template <typename T>
__device__ __forceinline__ T softplus(T x) {
  return (x > T(0) ? x : T(0)) + lg1p(ex(-(x > T(0) ? x : -x)));
}
template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + ex(-x));
}
template <typename T>
__device__ __forceinline__ T log_sigmoid(T x) {
  return -softplus(-x);
}

// Sum NV values over the block; the result is valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.
template <typename T, int NV>
__device__ void block_sum(T (&v)[NV]) {
  __shared__ T smem[NV][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    if (lane == 0) smem[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = lane < nwarps ? smem[i][lane] : T(0);
      for (int off = 16; off > 0; off >>= 1)
        v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    }
  }
}

// Reduced SEIR (magi_v2_tpu/models/odes.py:seir_f_vec): x = (E, I, R),
// theta = (beta, gamma, sigma), S = 1 - E - I - R.
struct Seir {
  static constexpr int D = 3;
  static constexpr int P = 3;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T E = x[0], I = x[1], R = x[2];
    const T S = T(1) - ((E + I) + R);
    out[0] = th[0] * S * I - th[2] * E;
    out[1] = th[2] * E - th[1] * I;
    out[2] = th[1] * I;
  }

  // gx = J_x^T g at (x, theta)
  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T E = x[0], I = x[1], R = x[2];
    const T S = T(1) - ((E + I) + R);
    const T b = th[0], ga = th[1], s = th[2];
    gx[0] = g[0] * (-b * I - s) + g[1] * s;
    gx[1] = g[0] * b * (S - I) + (g[2] - g[1]) * ga;
    gx[2] = -g[0] * b * I;
  }

  // gth = J_theta^T g at (x, theta)
  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T E = x[0], I = x[1], R = x[2];
    const T S = T(1) - ((E + I) + R);
    gth[0] = g[0] * S * I;
    gth[1] = (g[2] - g[1]) * I;
    gth[2] = (g[1] - g[0]) * E;
  }
};

// Lorenz (magi_v2_tpu/models/odes.py:lorenz_f_vec): x = (x, y, z),
// theta = (sigma, rho, beta).
struct Lorenz {
  static constexpr int D = 3;
  static constexpr int P = 3;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    out[0] = th[0] * (x[1] - x[0]);
    out[1] = x[0] * (th[1] - x[2]) - x[1];
    out[2] = x[0] * x[1] - th[2] * x[2];
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    gx[0] = -th[0] * g[0] + (th[1] - x[2]) * g[1] + x[1] * g[2];
    gx[1] = th[0] * g[0] - g[1] + x[0] * g[2];
    gx[2] = -x[0] * g[1] - th[2] * g[2];
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    gth[0] = g[0] * (x[1] - x[0]);
    gth[1] = g[1] * x[0];
    gth[2] = -g[2] * x[2];
  }
};

template <class M, typename T>
__global__ void __launch_bounds__(kThreads)
manifold_fwd_kernel(const T* __restrict__ delta, const T* __restrict__ RmD,
                    const T* __restrict__ q, const T* __restrict__ x0T,
                    const T* __restrict__ a0, const T* __restrict__ f0,
                    const T* __restrict__ mask, const T* __restrict__ y,
                    const T* __restrict__ lb, const T* __restrict__ beta_temp,
                    T beta, int C, int N, int dim, T* __restrict__ dr,
                    T* __restrict__ gcat, T* __restrict__ t14) {
  constexpr int D = M::D, P = M::P;
  const int c = blockIdx.x;
  const int ND = N * D;
  const T* qc = q + (size_t)c * dim;
  T th[P], inv_var[D];
#pragma unroll
  for (int k = 0; k < P; ++k) th[k] = softplus(qc[ND + D + k]);
#pragma unroll
  for (int d = 0; d < D; ++d) inv_var[d] = T(1) / (softplus(qc[ND + d]) + lb[d]);
  const T scale = beta_temp[0] / beta;

  T acc[2] = {T(0), T(0)};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    T x[D], f[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      x[d] = x0T[d * N + n] + delta[((size_t)c * D + d) * N + n];
    M::f(x, th, f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t row = (size_t)d * C + c;
      const T Rd = RmD[row * 2 * N + n];
      const T md = RmD[row * 2 * N + N + n];
      const T a = a0[d * N + n];
      dr[row * N + n] = (f[d] - f0[d * N + n]) - md;
      gcat[row * 2 * N + n] = -scale * (Rd + a);
      acc[0] += Rd * (Rd + T(2) * a);
      const T r = x[d] - y[d * N + n];
      acc[1] += mask[d * N + n] * r * r * inv_var[d];
    }
  }
  block_sum<T, 2>(acc);
  if (threadIdx.x == 0) {
    t14[2 * c] = acc[0];
    t14[2 * c + 1] = acc[1];
  }
}

template <class M, typename T>
__global__ void __launch_bounds__(kThreads)
manifold_energy_kernel(const T* __restrict__ Ds, const T* __restrict__ s0,
                       const T* __restrict__ t14, const T* __restrict__ q,
                       const T* __restrict__ lb, const T* __restrict__ n_ds,
                       const T* __restrict__ beta_temp, T beta, int C, int N,
                       int dim, T* __restrict__ lp, T* __restrict__ gDs) {
  constexpr int D = M::D, P = M::P;
  const int c = blockIdx.x;
  const T bt = beta_temp[0];
  const T scale = bt / beta;
  T acc[1] = {T(0)};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t o = ((size_t)d * C + c) * N + n;
      const T v = Ds[o];
      const T s = s0[d * N + n];
      acc[0] += v * (v + T(2) * s);
      gDs[o] = -scale * (v + s);
    }
  }
  block_sum<T, 1>(acc);
  if (threadIdx.x == 0) {
    const T* qc = q + (size_t)c * dim;
    const int ND = N * D;
    T t3 = T(0), lj = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const T sp = qc[ND + d];
      t3 += n_ds[d] * lg(T(2.0 * 3.14159265358979323846) * (softplus(sp) + lb[d]));
      lj += log_sigmoid(sp);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) lj += log_sigmoid(qc[ND + D + k]);
    lp[c] = bt * (T(-0.5) * ((t14[2 * c] + acc[0]) / beta + t3 + t14[2 * c + 1]) + lj);
  }
}

template <class M, typename T>
__global__ void __launch_bounds__(kThreads)
manifold_bwd_kernel(const T* __restrict__ gdr, const T* __restrict__ delta,
                    const T* __restrict__ q, const T* __restrict__ x0T,
                    const T* __restrict__ mask, const T* __restrict__ y,
                    const T* __restrict__ lb, const T* __restrict__ n_ds,
                    const T* __restrict__ beta_temp, int C, int N, int dim,
                    T* __restrict__ gcat, T* __restrict__ gpart,
                    T* __restrict__ grad) {
  constexpr int D = M::D, P = M::P;
  const int c = blockIdx.x;
  const int ND = N * D;
  const T* qc = q + (size_t)c * dim;
  const T bt = beta_temp[0];
  T th[P], inv_var[D];
#pragma unroll
  for (int k = 0; k < P; ++k) th[k] = softplus(qc[ND + D + k]);
#pragma unroll
  for (int d = 0; d < D; ++d) inv_var[d] = T(1) / (softplus(qc[ND + d]) + lb[d]);

  // acc[0..P) theta cotangent sums, acc[P..P+D) observed squared residuals
  T acc[P + D];
#pragma unroll
  for (int i = 0; i < P + D; ++i) acc[i] = T(0);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    T x[D], g[D], gx[D], gth[P];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t row = (size_t)d * C + c;
      x[d] = x0T[d * N + n] + delta[((size_t)c * D + d) * N + n];
      g[d] = gdr[row * N + n];
      gcat[row * 2 * N + N + n] = g[d];
    }
    M::vjp_x(x, th, g, gx);
    M::vjp_theta(x, th, g, gth);
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] += gth[k];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const T m = mask[d * N + n];
      const T r = x[d] - y[d * N + n];
      acc[P + d] += m * r * r;
      gpart[((size_t)d * C + c) * N + n] = gx[d] - bt * m * r * inv_var[d];
    }
  }
  block_sum<T, P + D>(acc);
  if (threadIdx.x == 0) {
    T* gc = grad + (size_t)c * dim;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const T tp = qc[ND + D + k];
      gc[ND + D + k] = acc[k] * sigmoid(tp) + bt * sigmoid(-tp);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const T sp = qc[ND + d];
      const T s2 = softplus(sp) + lb[d];
      const T g_s2 = T(-0.5) * bt * (n_ds[d] / s2 - acc[P + d] / (s2 * s2));
      gc[ND + d] = g_s2 * sigmoid(sp) + bt * sigmoid(-sp);
    }
  }
}

}  // namespace

#define MAGI_MANIFOLD_ENTRY_POINTS(MODEL, NAME, T, SUF)                        \
  extern "C" int magi_manifold_fwd_##NAME##_##SUF(                             \
      const T* delta, const T* RmD, const T* q, const T* x0T, const T* a0,    \
      const T* f0, const T* mask, const T* y, const T* lb,                    \
      const T* beta_temp, double beta, int C, int N, int dim, T* dr,          \
      T* gcat, T* t14, void* stream) {                                        \
    manifold_fwd_kernel<MODEL, T><<<C, kThreads, 0, (cudaStream_t)stream>>>(  \
        delta, RmD, q, x0T, a0, f0, mask, y, lb, beta_temp, (T)beta, C, N,    \
        dim, dr, gcat, t14);                                                  \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_energy_##NAME##_##SUF(                          \
      const T* Ds, const T* s0, const T* t14, const T* q, const T* lb,        \
      const T* n_ds, const T* beta_temp, double beta, int C, int N, int dim,  \
      T* lp, T* gDs, void* stream) {                                          \
    manifold_energy_kernel<MODEL, T>                                          \
        <<<C, kThreads, 0, (cudaStream_t)stream>>>(                           \
            Ds, s0, t14, q, lb, n_ds, beta_temp, (T)beta, C, N, dim, lp,      \
            gDs);                                                             \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_bwd_##NAME##_##SUF(                             \
      const T* gdr, const T* delta, const T* q, const T* x0T,                 \
      const T* mask, const T* y, const T* lb, const T* n_ds,                  \
      const T* beta_temp, int C, int N, int dim, T* gcat, T* gpart,           \
      T* grad, void* stream) {                                                \
    manifold_bwd_kernel<MODEL, T><<<C, kThreads, 0, (cudaStream_t)stream>>>(  \
        gdr, delta, q, x0T, mask, y, lb, n_ds, beta_temp, C, N, dim, gcat,    \
        gpart, grad);                                                         \
    return (int)cudaGetLastError();                                           \
  }

MAGI_MANIFOLD_ENTRY_POINTS(Seir, seir, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Seir, seir, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(Lorenz, lorenz, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Lorenz, lorenz, double, f64)
