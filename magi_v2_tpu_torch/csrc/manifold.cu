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
// What bounds it on the card. Each kernel streams a few (C, D, N) blocks
// once and does O(10) operations an element: at the Lorenz shapes (256
// chains, N_I = 1025) 6-16 MB, 1.9-4.7 us at the H100's memory rate; at the
// SEIR shapes (256 chains, N_I = 161) 1-3 MB, under a microsecond. So a
// kernel's time is its launch, one round trip to memory, and the chain's
// sums, and the design is about bytes in flight and a short tail. The first
// port gave a chain one CTA of 128 threads walking its points: at the
// Lorenz shapes 256 CTAs on 132 SMs, eight warps an SM with one 4-byte load
// each in flight, 24.6 + 7.3 + 14.6 us of device time.
//
// Design. A thread owns one (chain, n) point and all D components (f and
// its Jacobian are evaluated once per point from registers) and starts all
// of the point's loads before it uses any. A chain has ceil(N / 128) CTAs
// of 128 points (nine at Lorenz: 2304 CTAs), fewer where the card could not
// hold them all at once (then a thread walks two or more points, so that no
// CTA waits for a second wave: 1280 CTAs at 256 Lorenz chains), and one
// where a chain has at most 256 points (SEIR), which spares it the pass
// below. Loads are 4 bytes: the rows are N or 2N long, 1025 and 2050 at
// Lorenz, so only every fourth row is 16-byte aligned. What needs q alone
// (softplus theta, 1 / sigma^2, the log-Jacobians, the factors of the tail
// gradients) is made by the first P + D threads while the others load, so
// that after the sums only a few FMAs remain. A chain's sums: each CTA sums
// over its threads (block_sum), stores its partials in the chain's row of
// a scratch buffer and takes a ticket; the CTA that draws the chain's last
// ticket reads the rows in one round trip, adds them in a fixed order and
// writes the result (chain_sum). No float atomics: draws do not depend on
// scheduling. On an H100 SXM at 700 W, float32, device time in the
// sampler's leapfrog (PERF.md has the runs): Lorenz at 256 chains 8.2 + 7.0
// + 9.3 us against bounds of 4.7 + 1.9 + 3.8, of which some 5 us are the
// floor a launch with a ticket pass costs at any size (5.3 + 5.5 + 5.9 us
// at 64 chains); SEIR 3.2 + 3.6 + 4.4 us. The launch itself is prepared
// once (ops/manifold.py: ManifoldPlan), 5-11 us of host time a call.
//
// The temperature beta_T is read at beta_temp[c * beta_stride]: one for all
// chains (stride 0: annealing, or a fixed beta) or one per chain (stride 1:
// parallel tempering, where chain c samples at its rung's beta, replacing
// the per-chain beta of magi_v2_tpu/sampler/run.py's vmapped
// step_chains_pt). Each CTA serves one chain, so the read is one uniform
// load either way and costs nothing the kernels notice.
//
// Layouts (row-major, contiguous): delta (C, D, N); RmD and gcat (D, C, 2N);
// dr, Ds, g_Ds, g_dr, gpart (D, C, N); q and grad (C, dim) with
// dim = N*D + D + P; x0T, a0, f0, s0, mask, y (D, N).
//
// The model enters as a functor (f, vjp_x, vjp_theta: the field and its
// vector-Jacobian products), one for each field of magi_v2_tpu/models/
// odes.py; a new ODE model adds a struct and one instantiation line. A
// chain's per-CTA partial sums are P + D wide in manifold_bwd (11 at most
// here, protein transduction), within the 16 of a `part` row
// (ops/manifold.py: _PART_WIDTH). A field with no functor (an ODE model
// written in PyTorch alone) takes the given_* kernels below: PyTorch
// evaluates the field and its VJPs on the card, and the kernels do the rest
// of the same work, with D and P read at run time (D <= kMaxD).

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

// SIRW (magi_v2_tpu/models/odes.py:sirw_f_vec): x = (S, I, R, W),
// theta = (beta, phi, xi, chi, kappa).
struct Sirw {
  static constexpr int D = 4;
  static constexpr int P = 5;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T S = x[0], I = x[1], R = x[2], W = x[3];
    const T bsi = th[0] * S * I, ciw = th[3] * I * W;
    out[0] = -bsi + th[4] * W;
    out[1] = bsi - th[1] * I;
    out[2] = th[1] * I - th[2] * R + ciw;
    out[3] = th[2] * R - ciw - th[4] * W;
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T S = x[0], I = x[1], W = x[3];
    const T d10 = g[1] - g[0], d23 = g[2] - g[3];
    gx[0] = th[0] * I * d10;
    gx[1] = th[0] * S * d10 + th[1] * (g[2] - g[1]) + th[3] * W * d23;
    gx[2] = th[2] * (g[3] - g[2]);
    gx[3] = th[4] * (g[0] - g[3]) + th[3] * I * d23;
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T S = x[0], I = x[1], R = x[2], W = x[3];
    gth[0] = S * I * (g[1] - g[0]);
    gth[1] = I * (g[2] - g[1]);
    gth[2] = R * (g[3] - g[2]);
    gth[3] = I * W * (g[2] - g[3]);
    gth[4] = W * (g[0] - g[3]);
  }
};

// FitzHugh-Nagumo (magi_v2_tpu/models/odes.py:fitzhugh_nagumo_f_vec):
// x = (V, R), theta = (a, b, c).
struct FitzHughNagumo {
  static constexpr int D = 2;
  static constexpr int P = 3;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T V = x[0], R = x[1];
    out[0] = th[2] * (V - V * V * V / T(3) + R);
    out[1] = -(V - th[0] + th[1] * R) / th[2];
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T V = x[0], c = th[2];
    gx[0] = c * (T(1) - V * V) * g[0] - g[1] / c;
    gx[1] = c * g[0] - th[1] * g[1] / c;
  }

  // d f1 / d c = (V - a + b R) / c^2
  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T V = x[0], R = x[1], c = th[2];
    gth[0] = g[1] / c;
    gth[1] = -R * g[1] / c;
    gth[2] = g[0] * (V - V * V * V / T(3) + R) +
             g[1] * (V - th[0] + th[1] * R) / (c * c);
  }
};

// Hes1 (magi_v2_tpu/models/odes.py:hes1_f_vec): x = (P, M, H),
// theta = (a, b, c, d, e, f, g); q = 1 / (1 + P^2), dq/dP = -2 P q^2.
struct Hes1 {
  static constexpr int D = 3;
  static constexpr int P = 7;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T Pr = x[0], M = x[1], H = x[2];
    const T aph = th[0] * Pr * H, q = T(1) / (T(1) + Pr * Pr);
    out[0] = -aph + th[1] * M - th[2] * Pr;
    out[1] = -th[3] * M + th[4] * q;
    out[2] = -aph + th[5] * q - th[6] * H;
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T Pr = x[0], H = x[2];
    const T q = T(1) / (T(1) + Pr * Pr), g02 = g[0] + g[2];
    gx[0] = -th[0] * H * g02 - th[2] * g[0] -
            T(2) * Pr * q * q * (th[4] * g[1] + th[5] * g[2]);
    gx[1] = th[1] * g[0] - th[3] * g[1];
    gx[2] = -th[0] * Pr * g02 - th[6] * g[2];
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T Pr = x[0], M = x[1], H = x[2];
    const T q = T(1) / (T(1) + Pr * Pr);
    gth[0] = -Pr * H * (g[0] + g[2]);
    gth[1] = M * g[0];
    gth[2] = -Pr * g[0];
    gth[3] = -M * g[1];
    gth[4] = q * g[1];
    gth[5] = q * g[2];
    gth[6] = -H * g[2];
  }
};

// Hes1 on the log scale (magi_v2_tpu/models/odes.py:hes1_log_f_vec):
// x = (log P, log M, log H), theta = (a, b, c, d, e, f, g). With
// q = 1 / (1 + P^2), r = b M / P, u = e q / M, w = f q / H and
// s = 2 P^2 q (so that d q / d log P = -s q):
//   f = (-a H + r - c, -d + u, -a P + w - g),
//   d r / d log P = -r, d u / d log P = -s u, d w / d log P = -s w.
// The exponentials are the accurate exp/expf (no fast math in the build).
struct Hes1Log {
  static constexpr int D = 3;
  static constexpr int P = 7;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T Pr = ex(x[0]), M = ex(x[1]), H = ex(x[2]);
    const T q = T(1) / (T(1) + Pr * Pr);
    out[0] = -th[0] * H + th[1] * M / Pr - th[2];
    out[1] = -th[3] + th[4] * q / M;
    out[2] = -th[0] * Pr + th[5] * q / H - th[6];
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T Pr = ex(x[0]), M = ex(x[1]), H = ex(x[2]);
    const T q = T(1) / (T(1) + Pr * Pr);
    const T r = th[1] * M / Pr, u = th[4] * q / M, w = th[5] * q / H;
    const T s = T(2) * Pr * Pr * q;
    gx[0] = -r * g[0] - s * u * g[1] - (th[0] * Pr + s * w) * g[2];
    gx[1] = r * g[0] - u * g[1];
    gx[2] = -th[0] * H * g[0] - w * g[2];
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T Pr = ex(x[0]), M = ex(x[1]), H = ex(x[2]);
    const T q = T(1) / (T(1) + Pr * Pr);
    gth[0] = -H * g[0] - Pr * g[2];
    gth[1] = M / Pr * g[0];
    gth[2] = -g[0];
    gth[3] = -g[1];
    gth[4] = q / M * g[1];
    gth[5] = q / H * g[2];
    gth[6] = -g[2];
  }
};

// Lotka-Volterra (magi_v2_tpu/models/odes.py:lotka_volterra_f_vec):
// x = (u, v), theta = (a, b, c, d).
struct LotkaVolterra {
  static constexpr int D = 2;
  static constexpr int P = 4;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T uv = x[0] * x[1];
    out[0] = th[0] * x[0] - th[1] * uv;
    out[1] = th[2] * uv - th[3] * x[1];
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    gx[0] = (th[0] - th[1] * x[1]) * g[0] + th[2] * x[1] * g[1];
    gx[1] = -th[1] * x[0] * g[0] + (th[2] * x[0] - th[3]) * g[1];
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T uv = x[0] * x[1];
    gth[0] = x[0] * g[0];
    gth[1] = -uv * g[0];
    gth[2] = uv * g[1];
    gth[3] = -x[1] * g[1];
  }
};

// Protein transduction (magi_v2_tpu/models/odes.py:
// protein_transduction_f_vec): x = (S, S_d, R, S_R, R_pp),
// theta = (k1, k2, k3, k4, V, Km). The Michaelis-Menten term
// mm = V R_pp / (Km + R_pp) enters f_2 with + and f_4 with -; by the
// quotient rule d mm / d R_pp = V Km / (Km + R_pp)^2,
// d mm / d V = R_pp / (Km + R_pp), d mm / d Km = -V R_pp / (Km + R_pp)^2.
struct ProteinTransduction {
  static constexpr int D = 5;
  static constexpr int P = 6;

  template <typename T>
  __device__ static void f(const T* x, const T* th, T* out) {
    const T S = x[0], R = x[2], SR = x[3], Rpp = x[4];
    const T ksr = th[1] * S * R, mm = th[4] * Rpp / (th[5] + Rpp);
    out[0] = -th[0] * S - ksr + th[2] * SR;
    out[1] = th[0] * S;
    out[2] = -ksr + th[2] * SR + mm;
    out[3] = ksr - (th[2] + th[3]) * SR;
    out[4] = th[3] * SR - mm;
  }

  template <typename T>
  __device__ static void vjp_x(const T* x, const T* th, const T* g, T* gx) {
    const T S = x[0], R = x[2], Rpp = x[4];
    const T k = T(1) / (th[5] + Rpp);
    const T g302 = g[3] - g[0] - g[2];
    gx[0] = th[0] * (g[1] - g[0]) + th[1] * R * g302;
    gx[1] = T(0);
    gx[2] = th[1] * S * g302;
    gx[3] = th[2] * (g[0] + g[2] - g[3]) + th[3] * (g[4] - g[3]);
    gx[4] = th[4] * th[5] * k * k * (g[2] - g[4]);
  }

  template <typename T>
  __device__ static void vjp_theta(const T* x, const T* th, const T* g,
                                   T* gth) {
    const T S = x[0], R = x[2], SR = x[3], Rpp = x[4];
    const T k = T(1) / (th[5] + Rpp), g24 = g[2] - g[4];
    gth[0] = S * (g[1] - g[0]);
    gth[1] = S * R * (g[3] - g[0] - g[2]);
    gth[2] = SR * (g[0] + g[2] - g[3]);
    gth[3] = SR * (g[4] - g[3]);
    gth[4] = Rpp * k * g24;
    gth[5] = -th[4] * Rpp * k * k * g24;
  }
};

// The sums of one chain over its CTAs. Each CTA sums its NV values over
// its threads; its thread 0 stores them in the chain's row of `part` and
// takes a ticket (an integer atomic). The CTA that draws the last ticket
// adds the G stored rows: thread t takes rows t, t + blockDim, ... in that
// order and the block sums the threads' values as block_sum always does, so
// the total does not depend on which CTA came last, and the rows are read
// in one round trip. Returns true in thread 0 of that CTA, with the totals
// in v. `ticket` is 0 before the launch and is left 0.
template <typename T, int NV>
__device__ bool chain_sum(T (&v)[NV], T* part, int* ticket, int G, int g) {
  __shared__ int last;
  block_sum<T, NV>(v);
  if (G == 1) return threadIdx.x == 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) __stcg(part + g * NV + i, v[i]);
    __threadfence();
    last = atomicAdd(ticket, 1) == G - 1;
  }
  __syncthreads();  // also: block_sum's shared memory is free again
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = T(0);
  for (int h = threadIdx.x; h < G; h += blockDim.x)
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __ldcg(part + h * NV + i);
  block_sum<T, NV>(v);
  if (threadIdx.x != 0) return false;
  *ticket = 0;
  return true;
}

// softplus(theta) in par[0..P) and 1 / (softplus(sigma) + lb) in par[P..P+D),
// once per CTA; the caller synchronises
template <int D, int P, typename T>
__device__ __forceinline__ void stage_parameters(const T* qc, const T* lb,
                                                 int ND, T* par) {
  const int i = threadIdx.x;
  if (i < P)
    par[i] = softplus(qc[ND + D + i]);
  else if (i < P + D)
    par[i] = T(1) / (softplus(qc[ND + i - P]) + lb[i - P]);
}

// kWhitened: the whitened target's form (see the note above the entry
// points): the t1 operand u is dz (C, D, N), read where the target's
// difference z - z0 wrote it, and a is z0 (D, N); otherwise u is R delta,
// the first half of RmD, and a is a0 = R (x0 - mu). Either way
// t1 = sum u (u + 2 a) and the seed written to gcat[..., :N] is
// -(beta_T / beta)(u + a).
template <class M, typename T, bool kWhitened>
__global__ void __launch_bounds__(kThreads)
manifold_fwd_kernel(const T* __restrict__ delta, const T* __restrict__ RmD,
                    const T* __restrict__ dz,
                    const T* __restrict__ q, const T* __restrict__ x0T,
                    const T* __restrict__ a0, const T* __restrict__ f0,
                    const T* __restrict__ mask, const T* __restrict__ y,
                    const T* __restrict__ lb, const T* __restrict__ beta_temp,
                    int beta_stride,
                    T beta, int C, int N, int G, int dim, T* __restrict__ dr,
                    T* __restrict__ gcat, T* __restrict__ t14,
                    T* __restrict__ part, int* __restrict__ ticket) {
  constexpr int D = M::D, P = M::P;
  __shared__ T par[P + D];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const T* qc = q + (size_t)c * dim;
  const T scale = beta_temp[(size_t)c * beta_stride] / beta;
  stage_parameters<D, P>(qc, lb, N * D, par);

  T acc[2] = {T(0), T(0)};
  bool staged = false;
  // a block-uniform loop: the barrier inside is reached by every thread
  for (int base = g * kThreads; base < N; base += G * kThreads) {
    const int n = base + threadIdx.x;
    const bool in = n < N;
    // every load of the point first, so that all are in flight together
    // and under way while the parameters are staged
    T dl[D], u[D], md[D], xr[D], a[D], fr[D], yv[D], mk[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t row = (size_t)d * C + c;
      const size_t cdn = ((size_t)c * D + d) * N + n;
      dl[d] = in ? delta[cdn] : T(0);
      u[d] = in ? (kWhitened ? dz[cdn] : RmD[row * 2 * N + n]) : T(0);
      md[d] = in ? RmD[row * 2 * N + N + n] : T(0);
      xr[d] = in ? x0T[d * N + n] : T(0);
      a[d] = in ? a0[d * N + n] : T(0);
      fr[d] = in ? f0[d * N + n] : T(0);
      yv[d] = in ? y[d * N + n] : T(0);
      mk[d] = in ? mask[d * N + n] : T(0);
    }
    if (!staged) {
      __syncthreads();
      staged = true;
    }
    if (!in) continue;
    T x[D], f[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = xr[d] + dl[d];
    M::f(x, par, f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t row = (size_t)d * C + c;
      dr[row * N + n] = (f[d] - fr[d]) - md[d];
      gcat[row * 2 * N + n] = -scale * (u[d] + a[d]);
      acc[0] += u[d] * (u[d] + T(2) * a[d]);
      const T r = x[d] - yv[d];
      acc[1] += mk[d] * r * r * par[P + d];
    }
  }
  if (chain_sum<T, 2>(acc, part + (size_t)c * G * 2, ticket + c, G, g)) {
    t14[2 * c] = acc[0];
    t14[2 * c + 1] = acc[1];
  }
}

template <class M, typename T>
__global__ void __launch_bounds__(kThreads)
manifold_energy_kernel(const T* __restrict__ Ds, const T* __restrict__ s0,
                       const T* __restrict__ t14, const T* __restrict__ q,
                       const T* __restrict__ lb, const T* __restrict__ n_ds,
                       const T* __restrict__ beta_temp,
                    int beta_stride, T beta, int C, int N,
                       int G, int dim, T* __restrict__ lp,
                       T* __restrict__ gDs, T* __restrict__ part,
                       int* __restrict__ ticket) {
  constexpr int D = M::D, P = M::P;
  // what the log-posterior needs of q alone, one term a thread, while the
  // others load: t3's terms in [0, D), the log-Jacobians in [D, 2D + P)
  __shared__ T term[2 * D + P];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const T bt = beta_temp[(size_t)c * beta_stride];
  const T scale = bt / beta;
  if (threadIdx.x < D + P) {
    const int i = threadIdx.x;
    const T v = q[(size_t)c * dim + N * D + i];
    term[D + i] = log_sigmoid(v);
    if (i < D)
      term[i] = n_ds[i] * lg(T(2.0 * 3.14159265358979323846) *
                             (softplus(v) + lb[i]));
  }
  T acc[1] = {T(0)};
  for (int n = g * kThreads + threadIdx.x; n < N; n += G * kThreads) {
    T v[D], s[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      v[d] = Ds[((size_t)d * C + c) * N + n];
      s[d] = s0[d * N + n];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc[0] += v[d] * (v[d] + T(2) * s[d]);
      gDs[((size_t)d * C + c) * N + n] = -scale * (v[d] + s[d]);
    }
  }
  // (the barriers inside chain_sum order the terms before this read)
  if (chain_sum<T, 1>(acc, part + (size_t)c * G, ticket + c, G, g)) {
    T t3 = T(0), lj = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) t3 += term[d];
#pragma unroll
    for (int i = 0; i < D + P; ++i) lj += term[D + i];
    lp[c] = bt * (T(-0.5) * ((t14[2 * c] + acc[0]) / beta + t3 + t14[2 * c + 1]) + lj);
  }
}

template <class M, typename T>
__global__ void __launch_bounds__(kThreads)
manifold_bwd_kernel(const T* __restrict__ gdr, const T* __restrict__ delta,
                    const T* __restrict__ q, const T* __restrict__ x0T,
                    const T* __restrict__ mask, const T* __restrict__ y,
                    const T* __restrict__ lb, const T* __restrict__ n_ds,
                    const T* __restrict__ beta_temp,
                    int beta_stride, int C, int N, int G,
                    int dim, T* __restrict__ gcat, T* __restrict__ gpart,
                    T* __restrict__ grad, T* __restrict__ part,
                    int* __restrict__ ticket) {
  constexpr int D = M::D, P = M::P;
  __shared__ T par[P + D];
  // gradient entry i of the theta_pre (i < P) and sigma_pre tail is
  // c0[i] + c1[i] * (the chain's sum i): the factors need q alone and are
  // made while the other threads load
  __shared__ T c0[P + D], c1[P + D];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const int ND = N * D;
  const T* qc = q + (size_t)c * dim;
  const T bt = beta_temp[(size_t)c * beta_stride];
  stage_parameters<D, P>(qc, lb, ND, par);
  if (threadIdx.x < P) {
    const T tp = qc[ND + D + threadIdx.x];
    c1[threadIdx.x] = sigmoid(tp);
    c0[threadIdx.x] = bt * sigmoid(-tp);
  } else if (threadIdx.x < P + D) {
    // g_s2 = -bt/2 (n_d / s2 - ssr / s2^2), times d s2 / d sigma_pre
    const int d = threadIdx.x - P;
    const T sp = qc[ND + d];
    const T inv = T(1) / (softplus(sp) + lb[d]);
    const T half = T(0.5) * bt * sigmoid(sp) * inv;
    c1[P + d] = half * inv;
    c0[P + d] = bt * sigmoid(-sp) - half * n_ds[d];
  }

  // acc[0..P) theta cotangent sums, acc[P..P+D) observed squared residuals
  T acc[P + D];
#pragma unroll
  for (int i = 0; i < P + D; ++i) acc[i] = T(0);
  bool staged = false;
  for (int base = g * kThreads; base < N; base += G * kThreads) {
    const int n = base + threadIdx.x;
    const bool in = n < N;
    T x[D], gv[D], yv[D], mk[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = in ? x0T[d * N + n] + delta[((size_t)c * D + d) * N + n] : T(0);
      gv[d] = in ? gdr[((size_t)d * C + c) * N + n] : T(0);
      yv[d] = in ? y[d * N + n] : T(0);
      mk[d] = in ? mask[d * N + n] : T(0);
    }
    if (!staged) {
      __syncthreads();
      staged = true;
    }
    if (!in) continue;
    T gx[D], gth[P];
    M::vjp_x(x, par, gv, gx);
    M::vjp_theta(x, par, gv, gth);
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] += gth[k];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t row = (size_t)d * C + c;
      gcat[row * 2 * N + N + n] = gv[d];
      const T r = x[d] - yv[d];
      acc[P + d] += mk[d] * r * r;
      gpart[row * N + n] = gx[d] - bt * mk[d] * r * par[P + d];
    }
  }
  if (chain_sum<T, P + D>(acc, part + (size_t)c * G * (P + D), ticket + c, G,
                          g)) {
    T* gc = grad + (size_t)c * dim;
#pragma unroll
    for (int k = 0; k < P; ++k) gc[ND + D + k] = c0[k] + c1[k] * acc[k];
#pragma unroll
    for (int d = 0; d < D; ++d)
      gc[ND + d] = c0[P + d] + c1[P + d] * acc[P + d];
  }
}

// A temperature is read at beta_temp[c * beta_stride]: one for all chains
// (stride 0) or one per chain (stride 1, parallel tempering's rungs).
inline bool bad_stride(int s) { return s != 0 && s != 1; }

// The CTAs of one chain. A chain of at most two points a thread stays in
// one CTA, where the second point costs less than the pass of the sums
// through global memory. Otherwise one CTA per kThreads points, a point a
// thread, unless the card cannot hold all the CTAs at once (16 of kThreads
// threads on each SM): then as few points a thread as let it, so that no
// CTA waits for a second wave.
inline int chunks_of(int N, int C) {
  if (N <= 2 * kThreads) return 1;
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
    cudaGetLastError();
    slots = sms * (2048 / kThreads);
  }
  int G = (N + kThreads - 1) / kThreads;
  for (int ppt = 2; (long long)C * G > slots && ppt <= 8; ++ppt)
    G = (N + ppt * kThreads - 1) / (ppt * kThreads);
  return G;
}

// ---------------------------------------------------------------------------
// A field with no functor. PyTorch gives what the functor would compute:
// fv = f(x, softplus theta) (C, N, D) before manifold_fwd, and gx = J_x^T
// g_dr (C, N, D) and gth = J_theta^T g_dr (C, P), summed over the points,
// before manifold_bwd. D and P are arguments: the loops over D run to
// kMaxD, guarded, so that the per-component values stay in registers. A
// chain's sums pass through `part` rows of kMaxD values (ops/manifold.py:
// _PART_WIDTH), as above.

constexpr int kMaxD = 8;

template <typename T, bool kWhitened>
__global__ void __launch_bounds__(kThreads)
given_fwd_kernel(const T* __restrict__ delta, const T* __restrict__ RmD,
                 const T* __restrict__ dz,
                 const T* __restrict__ q, const T* __restrict__ x0T,
                 const T* __restrict__ a0, const T* __restrict__ f0,
                 const T* __restrict__ mask, const T* __restrict__ y,
                 const T* __restrict__ lb, const T* __restrict__ beta_temp,
                    int beta_stride,
                 const T* __restrict__ fv, T beta, int C, int N, int G,
                 int D, int dim, T* __restrict__ dr, T* __restrict__ gcat,
                 T* __restrict__ t14, T* __restrict__ part,
                 int* __restrict__ ticket) {
  __shared__ T inv[kMaxD];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const T* qc = q + (size_t)c * dim;
  const T scale = beta_temp[(size_t)c * beta_stride] / beta;
  if (threadIdx.x < D)
    inv[threadIdx.x] =
        T(1) / (softplus(qc[N * D + threadIdx.x]) + lb[threadIdx.x]);
  __syncthreads();
  T acc[2] = {T(0), T(0)};
  for (int n = g * kThreads + threadIdx.x; n < N; n += G * kThreads) {
    const T* fn = fv + ((size_t)c * N + n) * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d >= D) break;
      const size_t row = (size_t)d * C + c;
      const size_t cdn = ((size_t)c * D + d) * N + n;
      // the t1 operand, as in manifold_fwd_kernel
      const T u = kWhitened ? dz[cdn] : RmD[row * 2 * N + n];
      const T a = a0[d * N + n];
      const T x = x0T[d * N + n] + delta[cdn];
      dr[row * N + n] = (fn[d] - f0[d * N + n]) - RmD[row * 2 * N + N + n];
      gcat[row * 2 * N + n] = -scale * (u + a);
      acc[0] += u * (u + T(2) * a);
      const T r = x - y[d * N + n];
      acc[1] += mask[d * N + n] * r * r * inv[d];
    }
  }
  if (chain_sum<T, 2>(acc, part + (size_t)c * G * 2, ticket + c, G, g)) {
    t14[2 * c] = acc[0];
    t14[2 * c + 1] = acc[1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
given_energy_kernel(const T* __restrict__ Ds, const T* __restrict__ s0,
                    const T* __restrict__ t14, const T* __restrict__ q,
                    const T* __restrict__ lb, const T* __restrict__ n_ds,
                    const T* __restrict__ beta_temp,
                    int beta_stride, T beta, int C, int N,
                    int G, int D, int dim, T* __restrict__ lp,
                    T* __restrict__ gDs, T* __restrict__ part,
                    int* __restrict__ ticket) {
  // t3's terms and the sigma log-Jacobians, one component a thread
  __shared__ T term[2 * kMaxD];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const T* qc = q + (size_t)c * dim;
  const T bt = beta_temp[(size_t)c * beta_stride];
  const T scale = bt / beta;
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const T v = qc[N * D + d];
    term[d] = n_ds[d] * lg(T(2.0 * 3.14159265358979323846) *
                           (softplus(v) + lb[d]));
    term[kMaxD + d] = log_sigmoid(v);
  }
  T acc[1] = {T(0)};
  for (int n = g * kThreads + threadIdx.x; n < N; n += G * kThreads)
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d >= D) break;
      const size_t o = ((size_t)d * C + c) * N + n;
      const T v = Ds[o], s = s0[d * N + n];
      acc[0] += v * (v + T(2) * s);
      gDs[o] = -scale * (v + s);
    }
  if (chain_sum<T, 1>(acc, part + (size_t)c * G, ticket + c, G, g)) {
    T t3 = T(0), lj = T(0);
    for (int d = 0; d < D; ++d) t3 += term[d];
    for (int d = 0; d < D; ++d) lj += term[kMaxD + d];
    // the theta log-Jacobians, P of them, by this one thread
    for (int i = N * D + D; i < dim; ++i) lj += log_sigmoid(qc[i]);
    lp[c] = bt * (T(-0.5) * ((t14[2 * c] + acc[0]) / beta + t3 +
                             t14[2 * c + 1]) + lj);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
given_bwd_kernel(const T* __restrict__ gdr, const T* __restrict__ delta,
                 const T* __restrict__ q, const T* __restrict__ x0T,
                 const T* __restrict__ mask, const T* __restrict__ y,
                 const T* __restrict__ lb, const T* __restrict__ n_ds,
                 const T* __restrict__ beta_temp,
                    int beta_stride, const T* __restrict__ gx,
                 const T* __restrict__ gth, int C, int N, int G, int D,
                 int dim, T* __restrict__ gcat, T* __restrict__ gpart,
                 T* __restrict__ grad, T* __restrict__ part,
                 int* __restrict__ ticket) {
  // 1 / sigma^2 and the factors of the sigma_pre gradients, as
  // manifold_bwd_kernel makes them
  __shared__ T inv[kMaxD], c0[kMaxD], c1[kMaxD];
  const int c = blockIdx.x / G, g = blockIdx.x % G;
  const int ND = N * D;
  const T* qc = q + (size_t)c * dim;
  const T bt = beta_temp[(size_t)c * beta_stride];
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const T sp = qc[ND + d];
    inv[d] = T(1) / (softplus(sp) + lb[d]);
    const T half = T(0.5) * bt * sigmoid(sp) * inv[d];
    c1[d] = half * inv[d];
    c0[d] = bt * sigmoid(-sp) - half * n_ds[d];
  }
  __syncthreads();
  // the observed squared residuals of each component
  T acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = T(0);
  for (int n = g * kThreads + threadIdx.x; n < N; n += G * kThreads) {
    const T* gn = gx + ((size_t)c * N + n) * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d >= D) break;
      const size_t row = (size_t)d * C + c;
      const T gv = gdr[row * N + n];
      const T x = x0T[d * N + n] + delta[((size_t)c * D + d) * N + n];
      const T mk = mask[d * N + n], r = x - y[d * N + n];
      gcat[row * 2 * N + N + n] = gv;
      acc[d] += mk * r * r;
      gpart[row * N + n] = gn[d] - bt * mk * r * inv[d];
    }
  }
  if (chain_sum<T, kMaxD>(acc, part + (size_t)c * G * kMaxD, ticket + c, G,
                          g)) {
    T* gc = grad + (size_t)c * dim;
    for (int d = 0; d < D; ++d) gc[ND + d] = c0[d] + c1[d] * acc[d];
    for (int i = ND + D, k = 0; i < dim; ++i, ++k)
      gc[i] = gth[(size_t)c * (dim - ND - D) + k] * sigmoid(qc[i]) +
              bt * sigmoid(-qc[i]);
  }
}

}  // namespace

// The whitened form (reparam="whitened"; replaces the t1 = ||z||^2 of
// magi_v2_tpu/sampler/magi_state.py:make_tempered_logp_grad_whitened under
// jax.value_and_grad). There X = mu + L z with L = C^{1/2}, so relative to
// the reference point t1 = ||z||^2 - ||z0||^2 = sum dz (dz + 2 z0) over the
// chain's N*D coordinates, and its gradient in z, -(beta_T / beta) z, needs
// no operator: the target adds L' g_delta onto it. The fwd kernels take dz
// (C, D, N) and z0 (D, N) where the GN form takes R delta and a0, and are
// otherwise the same; the energy and bwd kernels serve both forms. The form
// is a template parameter (a separate instantiation and entry point, chosen
// when the target is made), so the GN form compiles as before. What bounds
// it does not change: one read of dz in place of R delta.

#define MAGI_MANIFOLD_ENTRY_POINTS(MODEL, NAME, T, SUF)                       \
  extern "C" int magi_manifold_fwd_##NAME##_##SUF(                            \
      const T* delta, const T* RmD, const T* q, const T* x0T, const T* a0,    \
      const T* f0, const T* mask, const T* y, const T* lb,                    \
      const T* beta_temp, int beta_stride, double beta, int C, int N,         \
      int dim, T* dr, T* gcat, T* t14, T* part, int* ticket, void* stream) {  \
    if (bad_stride(beta_stride)) return (int)cudaErrorInvalidValue;           \
    const int G = chunks_of(N, C);                                            \
    manifold_fwd_kernel<MODEL, T, false>                                      \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            delta, RmD, nullptr, q, x0T, a0, f0, mask, y, lb, beta_temp,      \
            beta_stride, (T)beta, C, N, G, dim, dr, gcat, t14, part,          \
            ticket);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_fwd_whitened_##NAME##_##SUF(                   \
      const T* delta, const T* RmD, const T* dz, const T* q, const T* x0T,    \
      const T* z0, const T* f0, const T* mask, const T* y, const T* lb,       \
      const T* beta_temp, int beta_stride, double beta, int C, int N,         \
      int dim, T* dr, T* gcat, T* t14, T* part, int* ticket, void* stream) {  \
    if (bad_stride(beta_stride)) return (int)cudaErrorInvalidValue;           \
    const int G = chunks_of(N, C);                                            \
    manifold_fwd_kernel<MODEL, T, true>                                       \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            delta, RmD, dz, q, x0T, z0, f0, mask, y, lb, beta_temp,           \
            beta_stride, (T)beta, C, N, G, dim, dr, gcat, t14, part,          \
            ticket);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_energy_##NAME##_##SUF(                         \
      const T* Ds, const T* s0, const T* t14, const T* q, const T* lb,        \
      const T* n_ds, const T* beta_temp, int beta_stride, double beta,        \
      int C, int N, int dim, T* lp, T* gDs, T* part, int* ticket,             \
      void* stream) {                                                         \
    if (bad_stride(beta_stride)) return (int)cudaErrorInvalidValue;           \
    const int G = chunks_of(N, C);                                            \
    manifold_energy_kernel<MODEL, T>                                          \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            Ds, s0, t14, q, lb, n_ds, beta_temp, beta_stride, (T)beta, C,     \
            N, G, dim, lp, gDs, part, ticket);                                \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_bwd_##NAME##_##SUF(                            \
      const T* gdr, const T* delta, const T* q, const T* x0T,                 \
      const T* mask, const T* y, const T* lb, const T* n_ds,                  \
      const T* beta_temp, int beta_stride, int C, int N, int dim, T* gcat,    \
      T* gpart, T* grad, T* part, int* ticket, void* stream) {                \
    if (bad_stride(beta_stride)) return (int)cudaErrorInvalidValue;           \
    const int G = chunks_of(N, C);                                            \
    manifold_bwd_kernel<MODEL, T>                                             \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            gdr, delta, q, x0T, mask, y, lb, n_ds, beta_temp, beta_stride,    \
            C, N, G, dim, gcat, gpart, grad, part, ticket);                   \
    return (int)cudaGetLastError();                                           \
  }

#define MAGI_MANIFOLD_GIVEN_ENTRY_POINTS(T, SUF)                              \
  extern "C" int magi_manifold_fwd_given_##SUF(                               \
      const T* delta, const T* RmD, const T* q, const T* x0T, const T* a0,    \
      const T* f0, const T* mask, const T* y, const T* lb,                    \
      const T* beta_temp, int beta_stride, const T* fv, double beta, int C,   \
      int N, int D, int dim, T* dr, T* gcat, T* t14, T* part, int* ticket,    \
      void* stream) {                                                         \
    if (D < 1 || D > kMaxD || bad_stride(beta_stride))                        \
      return (int)cudaErrorInvalidValue;                                      \
    const int G = chunks_of(N, C);                                            \
    given_fwd_kernel<T, false>                                                \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            delta, RmD, nullptr, q, x0T, a0, f0, mask, y, lb, beta_temp,      \
            beta_stride, fv, (T)beta, C, N, G, D, dim, dr, gcat, t14, part,   \
            ticket);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_fwd_whitened_given_##SUF(                      \
      const T* delta, const T* RmD, const T* dz, const T* q, const T* x0T,    \
      const T* z0, const T* f0, const T* mask, const T* y, const T* lb,       \
      const T* beta_temp, int beta_stride, const T* fv, double beta, int C,   \
      int N, int D, int dim, T* dr, T* gcat, T* t14, T* part, int* ticket,    \
      void* stream) {                                                         \
    if (D < 1 || D > kMaxD || bad_stride(beta_stride))                        \
      return (int)cudaErrorInvalidValue;                                      \
    const int G = chunks_of(N, C);                                            \
    given_fwd_kernel<T, true>                                                 \
        <<<C * G, kThreads, 0, (cudaStream_t)stream>>>(                       \
            delta, RmD, dz, q, x0T, z0, f0, mask, y, lb, beta_temp,           \
            beta_stride, fv, (T)beta, C, N, G, D, dim, dr, gcat, t14, part,   \
            ticket);                                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_energy_given_##SUF(                            \
      const T* Ds, const T* s0, const T* t14, const T* q, const T* lb,        \
      const T* n_ds, const T* beta_temp, int beta_stride, double beta,        \
      int C, int N, int D, int dim, T* lp, T* gDs, T* part, int* ticket,      \
      void* stream) {                                                         \
    if (D < 1 || D > kMaxD || bad_stride(beta_stride))                        \
      return (int)cudaErrorInvalidValue;                                      \
    const int G = chunks_of(N, C);                                            \
    given_energy_kernel<T><<<C * G, kThreads, 0, (cudaStream_t)stream>>>(     \
        Ds, s0, t14, q, lb, n_ds, beta_temp, beta_stride, (T)beta, C, N, G,   \
        D, dim, lp, gDs, part, ticket);                                       \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int magi_manifold_bwd_given_##SUF(                               \
      const T* gdr, const T* delta, const T* q, const T* x0T,                 \
      const T* mask, const T* y, const T* lb, const T* n_ds,                  \
      const T* beta_temp, int beta_stride, const T* gx, const T* gth, int C,  \
      int N, int D, int dim, T* gcat, T* gpart, T* grad, T* part,             \
      int* ticket, void* stream) {                                            \
    if (D < 1 || D > kMaxD || bad_stride(beta_stride))                        \
      return (int)cudaErrorInvalidValue;                                      \
    const int G = chunks_of(N, C);                                            \
    given_bwd_kernel<T><<<C * G, kThreads, 0, (cudaStream_t)stream>>>(        \
        gdr, delta, q, x0T, mask, y, lb, n_ds, beta_temp, beta_stride, gx,    \
        gth, C, N, G, D, dim, gcat, gpart, grad, part, ticket);               \
    return (int)cudaGetLastError();                                           \
  }

MAGI_MANIFOLD_ENTRY_POINTS(Seir, seir, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Seir, seir, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(Lorenz, lorenz, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Lorenz, lorenz, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(Sirw, sirw, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Sirw, sirw, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(FitzHughNagumo, fitzhugh_nagumo, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(FitzHughNagumo, fitzhugh_nagumo, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(Hes1, hes1, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Hes1, hes1, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(Hes1Log, hes1_log, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(Hes1Log, hes1_log, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(LotkaVolterra, lotka_volterra, float, f32)
MAGI_MANIFOLD_ENTRY_POINTS(LotkaVolterra, lotka_volterra, double, f64)
MAGI_MANIFOLD_ENTRY_POINTS(ProteinTransduction, protein_transduction, float,
                           f32)
MAGI_MANIFOLD_ENTRY_POINTS(ProteinTransduction, protein_transduction, double,
                           f64)
MAGI_MANIFOLD_GIVEN_ENTRY_POINTS(float, f32)
MAGI_MANIFOLD_GIVEN_ENTRY_POINTS(double, f64)
