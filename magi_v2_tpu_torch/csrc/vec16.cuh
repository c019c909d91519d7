// The 16-byte vector helpers of the leapfrog update (leapfrog.cu) and the
// NUTS leaf (nuts.cu): FMAs in full precision, 16-byte copies to shared
// memory, and the aligned quads of a flat (C, dim) array whose rows start
// on no 16-byte boundary.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kQuad = 4;                   // elements of a stream thread

template <typename T> struct V16;
template <> struct V16<float> { using type = float4; static constexpr int n = 4; };
template <> struct V16<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// 16 bytes from global to shared memory, asynchronously, through L2 only
// (cp.async.cg)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
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

}  // namespace
