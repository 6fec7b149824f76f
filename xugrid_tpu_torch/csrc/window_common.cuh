// Helpers shared by the window kernels (window_reduce.cu, window_select.cu).
//
// Both kernels read a PaddedCSR window table directly: for target t,
// slots k < w of idx[t * w + k] (int32, -1 padded) and wts[t * w + k]
// (0 padded), and the source slice-minor, srcT[i * E + e] for source
// face i and extra slice e.  A pad slot counts as a NaN value.  One
// thread owns one output (t, e), with e varying fastest across threads.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace xt {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T pos_inf() { return (T)INFINITY; }
template <typename T> __device__ __forceinline__ T qnan() { return (T)NAN; }

__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xfloor(float x) { return floorf(x); }
__device__ __forceinline__ double xfloor(double x) { return floor(x); }

template <typename T>
__device__ __forceinline__ bool is_valid(T v) { return v == v; }

// Value of window slot (i = source index) for slice e; NaN for a pad slot.
template <typename T>
__device__ __forceinline__ T window_value(const T* __restrict__ srcT, int32_t i, int e, int E) {
  return i < 0 ? qnan<T>() : srcT[(int64_t)i * E + e];
}

// reduce.py minimum (MAX = false) and maximum (MAX = true): the extreme
// valid value, NaN unless some valid slot has a positive weight.
template <typename T, bool MAX>
__device__ __forceinline__ T window_extreme(const T* __restrict__ srcT, const int32_t* ti,
                                            const T* tw, int w, int e, int E) {
  T best = MAX ? -pos_inf<T>() : pos_inf<T>();
  T wmax = -pos_inf<T>();
  for (int k = 0; k < w; ++k) {
    const T v = window_value(srcT, ti[k], e, E);
    const bool valid = is_valid(v);
    const T x = valid ? v : (MAX ? -pos_inf<T>() : pos_inf<T>());
    best = MAX ? (x > best ? x : best) : (x < best ? x : best);
    const T y = valid ? tw[k] : (T)0;
    wmax = y > wmax ? y : wmax;
  }
  return wmax > (T)0 ? best : qnan<T>();
}

// Grid of one thread per (target, slice); false when it does not fit.
inline bool grid_size(int64_t n, int E, unsigned* blocks) {
  const int64_t total = n * (int64_t)E;
  const int64_t b = (total + kThreads - 1) / kThreads;
  if (b <= 0 || b > 0x7fffffff) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace xt
