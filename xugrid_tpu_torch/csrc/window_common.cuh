// Helpers shared by the window kernels (window_reduce.cu, window_select.cu).
//
// Both kernels read a PaddedCSR window table directly: for target t,
// slots k < w of idx[t * w + k] (int32, -1 padded) and wts[t * w + k]
// (0 padded).  A pad slot counts as a NaN value.  The source layouts
// differ: window_reduce reads it slices-major, src[e * m + i], and
// window_select slice-minor, srcT[i * E + e], for source face i and extra
// slice e.
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

// Blocks of kThreads covering `threads` threads; false when they do not fit.
inline bool grid_size(int64_t threads, unsigned* blocks) {
  const int64_t b = (threads + kThreads - 1) / kThreads;
  if (b <= 0 || b > 0x7fffffff) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace xt
