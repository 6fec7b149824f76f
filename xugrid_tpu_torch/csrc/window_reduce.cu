// window_reduce: Hopper kernel #1 of xugrid_tpu_torch, the windowed
// reductions of the regrid apply.
//
// Replaces xugrid_tpu/regrid/aligned_apply.py:gather_aligned_apply and,
// by function, the stream, span, packet and pdot engines of
// xugrid_tpu/regrid/gather_apply.py.  The TPU plan formats (128-lane
// chunks, packets, Q_PACK banding, scalar prefetch) exist because Mosaic
// gathers only within 128 lanes and cannot scatter; Hopper gathers from
// anywhere, so this kernel reads the PaddedCSR window table directly.
//
// What bounds it on the H100: device memory.  A pass moves the window
// table (n * w_max * (4 + sizeof(T)) bytes, read once: the E threads of
// a target read the same row, which the warp broadcasts), the gathered
// source (every source row is read by the ~2-3 targets overlapping it,
// mostly from L2) and the output (n * E * sizeof(T)), with a handful of
// flops per byte.  The design keeps every byte on one path: one thread
// per (target, slice), slice fastest, so a warp's gathers of one source
// row are contiguous; no shared memory, no atomics, and each output has
// one owner that walks its window in slot order, so results do not
// depend on scheduling.
//
// The method is a template parameter.  Each method is a literal
// transcription of its formula in xugrid_tpu/regrid/reduce.py (NaN and
// pad slots, 0 * inf, the geometric-mean gates), so the kernel returns
// what reduce.py returns for NaN, inf, zero weights and negative values.

#include "window_common.cuh"

namespace xt {

enum ReduceMethod : int {
  kMean = 0,
  kSum = 1,
  kFirstOrderConservative = 2,
  kHarmonicMean = 3,
  kGeometricMean = 4,
  kMinimum = 5,
  kMaximum = 6,
  kMaxOverlap = 7,
};

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
window_reduce_kernel(const T* __restrict__ srcT, const int32_t* __restrict__ idx,
                     const T* __restrict__ wts, T* __restrict__ out, int64_t n, int w,
                     int E) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * E) return;
  const int64_t t = gid / E;
  const int e = (int)(gid - t * E);
  const int32_t* ti = idx + t * w;
  const T* tw = wts + t * w;
  T result;
  if constexpr (M == kMean || M == kFirstOrderConservative) {
    T vsum = 0, wsum = 0;
    for (int k = 0; k < w; ++k) {
      const T v = window_value(srcT, ti[k], e, E);
      const bool valid = is_valid(v);
      const T wk = valid ? tw[k] : (T)0;
      vsum += wk * (valid ? v : (T)0);
      wsum += wk;
    }
    if constexpr (M == kMean) {
      result = wsum > (T)0 ? vsum / wsum : qnan<T>();
    } else {
      result = wsum != (T)0 ? vsum : qnan<T>();
    }
  } else if constexpr (M == kSum) {
    T vsum = 0, wsum = 0;
    for (int k = 0; k < w; ++k) {
      const T v = window_value(srcT, ti[k], e, E);
      const bool valid = is_valid(v);
      vsum += valid ? v : (T)0;
      wsum += valid ? tw[k] : (T)0;
    }
    result = wsum != (T)0 ? vsum : qnan<T>();
  } else if constexpr (M == kHarmonicMean) {
    T wsum = 0, vagg = 0;
    for (int k = 0; k < w; ++k) {
      const T v = window_value(srcT, ti[k], e, E);
      const T wk = tw[k];
      const bool use = is_valid(v) && v != (T)0 && wk > (T)0;
      const T wu = use ? wk : (T)0;
      wsum += wu;
      vagg += use ? wu / v : (T)0;
    }
    const bool ok = vagg != (T)0 && wsum != (T)0;
    result = ok ? wsum / vagg : qnan<T>();
  } else if constexpr (M == kGeometricMean) {
    // Weights are normalized by their raw window sum first.
    T normsum = 0;
    for (int k = 0; k < w; ++k) normsum += tw[k];
    const T denom = normsum == (T)0 ? (T)1 : normsum;
    T vagg = 0, wsum = 0;
    bool any_negative = false;
    for (int k = 0; k < w; ++k) {
      const T v = window_value(srcT, ti[k], e, E);
      const bool valid = is_valid(v);
      const T wk = tw[k] / denom;
      const bool use = valid && v > (T)0 && wk > (T)0;
      vagg += use ? wk * xlog(xabs(v)) : (T)0;
      wsum += use ? wk : (T)0;
      any_negative = any_negative || (valid && v < (T)0);
    }
    const bool ok = wsum != (T)0 && !any_negative && normsum != (T)0;
    result = ok ? xexp(vagg / wsum) : qnan<T>();
  } else if constexpr (M == kMinimum || M == kMaximum) {
    result = window_extreme<T, M == kMaximum>(srcT, ti, tw, w, e, E);
  } else if constexpr (M == kMaxOverlap) {
    // Value of the valid slot with the largest weight; ties go to the
    // larger value.
    T wbest = -pos_inf<T>(), vbest = -pos_inf<T>();
    bool any_valid = false;
    for (int k = 0; k < w; ++k) {
      const T v = window_value(srcT, ti[k], e, E);
      if (!is_valid(v)) continue;
      any_valid = true;
      const T wk = tw[k];
      if (wk > wbest) {
        wbest = wk;
        vbest = v;
      } else if (wk == wbest && v > vbest) {
        vbest = v;
      }
    }
    result = (any_valid && wbest > (T)0) ? vbest : qnan<T>();
  }
  out[gid] = result;
}

template <typename T, int M>
cudaError_t launch_reduce(const void* srcT, const void* idx, const void* wts, void* out,
                          int64_t n, int w, int E, cudaStream_t stream) {
  unsigned blocks;
  if (!grid_size(n, E, &blocks)) return cudaErrorInvalidConfiguration;
  window_reduce_kernel<T, M><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(srcT), static_cast<const int32_t*>(idx),
      static_cast<const T*>(wts), static_cast<T*>(out), n, w, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_reduce(int method, const void* srcT, const void* idx, const void* wts,
                            void* out, int64_t n, int w, int E, cudaStream_t stream) {
  switch (method) {
    case kMean: return launch_reduce<T, kMean>(srcT, idx, wts, out, n, w, E, stream);
    case kSum: return launch_reduce<T, kSum>(srcT, idx, wts, out, n, w, E, stream);
    case kFirstOrderConservative:
      return launch_reduce<T, kFirstOrderConservative>(srcT, idx, wts, out, n, w, E, stream);
    case kHarmonicMean:
      return launch_reduce<T, kHarmonicMean>(srcT, idx, wts, out, n, w, E, stream);
    case kGeometricMean:
      return launch_reduce<T, kGeometricMean>(srcT, idx, wts, out, n, w, E, stream);
    case kMinimum: return launch_reduce<T, kMinimum>(srcT, idx, wts, out, n, w, E, stream);
    case kMaximum: return launch_reduce<T, kMaximum>(srcT, idx, wts, out, n, w, E, stream);
    case kMaxOverlap: return launch_reduce<T, kMaxOverlap>(srcT, idx, wts, out, n, w, E, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace xt

// dtype: 0 float32, 1 float64.  method: xt::ReduceMethod.  srcT (m, E),
// idx and wts (n, w), out (n, E), all contiguous on the current device.
// Returns the launch's cudaGetLastError().
extern "C" int xt_window_reduce(int dtype, int method, const void* srcT, const void* idx,
                                const void* wts, void* out, int64_t n, int32_t w, int32_t E,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)xt::dispatch_reduce<float>(method, srcT, idx, wts, out, n, w, E, s);
  if (dtype == 1) return (int)xt::dispatch_reduce<double>(method, srcT, idx, wts, out, n, w, E, s);
  return (int)cudaErrorInvalidValue;
}
