// window_select: Hopper kernel #2 of xugrid_tpu_torch, the order
// statistics of the regrid apply (mode, median, any percentile).
//
// Replaces xugrid_tpu/regrid/select_apply.py:gather_select_apply.  The
// TPU kernel sorts 32-slot windows in registers through one-hot matmuls
// and splits wider windows into a second plan (MAX_WINDOW = 32); here a
// thread ranks its own window by counting, so any w_max is taken.
//
// What bounds it on the H100: the window walk, not the device memory.
// A pass moves what kernel #1 moves (the window table once, the gathered
// source, the output once), but each thread reads its window O(w^2)
// times: percentile rank_k = #{j : v_j < v_k, or v_j == v_k and j < k},
// mode total_k = sum_j w_j [v_j == v_k].  The repeated reads of a
// target's E-wide source rows hit L1; at the overlap meshes' w ~ 10 the
// kernel is bound by those L1 loads and compares.  Like kernel #1 it
// runs one thread per (target, slice), slice fastest, with no shared
// memory and no atomics.
//
// Both reductions transcribe xugrid_tpu/regrid/reduce.py: percentiles
// skip NaN, interpolate lower * (1 - m) + upper * m between the closest
// ranks of rank = 1 + (n - 1) p / 100 (computed in T, as the plain
// version does), gate on the raw maximum weight, and reduce to minimum
// and maximum at p = 0 and p = 100; the mode is area weighted, ties go
// to the largest value, gated on the valid maximum weight.

#include "window_common.cuh"

namespace xt {

template <typename T, bool MODE>
__global__ void __launch_bounds__(kThreads)
window_select_kernel(const T* __restrict__ srcT, const int32_t* __restrict__ idx,
                     const T* __restrict__ wts, T* __restrict__ out, int64_t n, int w,
                     int E, double p) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * E) return;
  const int64_t t = gid / E;
  const int e = (int)(gid - t * E);
  const int32_t* ti = idx + t * w;
  const T* tw = wts + t * w;
  T result = qnan<T>();
  if constexpr (MODE) {
    T wmax = -pos_inf<T>();
    bool any_valid = false;
    T best_total = -pos_inf<T>(), best_value = -pos_inf<T>();
    for (int k = 0; k < w; ++k) {
      const T vk = window_value(srcT, ti[k], e, E);
      if (!is_valid(vk)) {
        wmax = wmax > (T)0 ? wmax : (T)0;
        continue;
      }
      any_valid = true;
      wmax = tw[k] > wmax ? tw[k] : wmax;
      // Group total in window order (equal values are valid values).
      T total = 0;
      for (int j = 0; j < w; ++j) {
        total += window_value(srcT, ti[j], e, E) == vk ? tw[j] : (T)0;
      }
      if (total > best_total) {
        best_total = total;
        best_value = vk;
      } else if (total == best_total && vk > best_value) {
        best_value = vk;
      }
    }
    if (any_valid && wmax > (T)0) result = best_value;
  } else {
    T wraw = -pos_inf<T>();
    int n_valid = 0;
    for (int k = 0; k < w; ++k) {
      wraw = tw[k] > wraw ? tw[k] : wraw;
      n_valid += is_valid(window_value(srcT, ti[k], e, E)) ? 1 : 0;
    }
    if (n_valid > 0 && wraw > (T)0) {
      if (p == 0.0) {
        result = window_extreme<T, false>(srcT, ti, tw, w, e, E);
      } else if (p == 100.0) {
        result = window_extreme<T, true>(srcT, ti, tw, w, e, E);
      } else {
        const T rank = (T)1 + ((T)n_valid - (T)1) * (T)(p / 100.0);
        const T f = xfloor(rank);
        const T m = rank - f;
        int lo = (int)f - 1;
        lo = lo < 0 ? 0 : (lo > w - 1 ? w - 1 : lo);
        int hi = lo + 1 > w - 1 ? w - 1 : lo + 1;
        hi = hi < n_valid - 1 ? hi : n_valid - 1;
        // Sorted positions by counting: NaN and pad slots sort last (+inf)
        // and equal values keep slot order, so the ranks are a permutation.
        T lower = qnan<T>(), upper = qnan<T>();
        for (int k = 0; k < w; ++k) {
          const T vk = window_value(srcT, ti[k], e, E);
          const T key = is_valid(vk) ? vk : pos_inf<T>();
          int r = 0;
          for (int j = 0; j < w; ++j) {
            const T vj = window_value(srcT, ti[j], e, E);
            const T other = is_valid(vj) ? vj : pos_inf<T>();
            r += (other < key || (other == key && j < k)) ? 1 : 0;
          }
          if (r == lo) lower = key;
          if (r == hi) upper = key;
        }
        result = lower * ((T)1 - m) + upper * m;
      }
    }
  }
  out[gid] = result;
}

template <typename T, bool MODE>
cudaError_t launch_select(const void* srcT, const void* idx, const void* wts, void* out,
                          int64_t n, int w, int E, double p, cudaStream_t stream) {
  unsigned blocks;
  if (!grid_size(n, E, &blocks)) return cudaErrorInvalidConfiguration;
  window_select_kernel<T, MODE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(srcT), static_cast<const int32_t*>(idx),
      static_cast<const T*>(wts), static_cast<T*>(out), n, w, E, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_select(int mode, const void* srcT, const void* idx, const void* wts,
                            void* out, int64_t n, int w, int E, double p,
                            cudaStream_t stream) {
  if (mode == 1) return launch_select<T, true>(srcT, idx, wts, out, n, w, E, p, stream);
  if (mode == 0) return launch_select<T, false>(srcT, idx, wts, out, n, w, E, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace xt

// dtype: 0 float32, 1 float64.  mode: 1 for the mode, 0 for the p-th
// percentile.  srcT (m, E), idx and wts (n, w), out (n, E), all
// contiguous on the current device.  Returns the launch's
// cudaGetLastError().
extern "C" int xt_window_select(int dtype, int mode, double p, const void* srcT,
                                const void* idx, const void* wts, void* out, int64_t n,
                                int32_t w, int32_t E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)xt::dispatch_select<float>(mode, srcT, idx, wts, out, n, w, E, p, s);
  if (dtype == 1) return (int)xt::dispatch_select<double>(mode, srcT, idx, wts, out, n, w, E, p, s);
  return (int)cudaErrorInvalidValue;
}
