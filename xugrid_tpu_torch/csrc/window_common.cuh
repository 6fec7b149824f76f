// Helpers shared by the window kernels (window_reduce.cu, window_select.cu).
//
// Both kernels read a PaddedCSR window table directly: for target t,
// slots k < w of idx[t * w + k] (int32, -1 padded) and wts[t * w + k]
// (0 padded).  A pad slot counts as a NaN value.  Both read the source
// slices-major, src[e * m + i] for source face i and extra slice e, as
// the caller holds it, and write out[e * n + t].
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace xt {

constexpr int kThreads = 256;
// Shared memory a block may stage its windows in without opting in to
// more (aligned_apply.STAGE_BYTES).
constexpr size_t kStageBytes = 48 * 1024;

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

// One lane's window in the tile layout of both window kernels.  A block
// of S * G warps owns the tile of 32 G consecutive targets [32 G
// blockIdx.x, ...); warp (g, s) takes targets 32 g + lane of the tile
// (lane = target) and walks slices s, s + S, ...  STAGED: the tile's
// windows sit in dynamic shared memory, weights then indices, slot-major
// with a row stride of 32 G + 1 (conflict-free writes from the coalesced
// row-major reads, and reads by lane); otherwise each lane reads its
// window in place.  Every thread of the block constructs it (the staging
// ends in __syncthreads) before any returns.
template <typename T, bool STAGED>
struct TileWindow {
  int t;                // this lane's target
  int s;                // this warp's first slice
  const int32_t* idx;   // slot k's source index at idx[k * ks]
  const T* wts;         // and its weight at wts[k * ks]
  int ks;

  __device__ __forceinline__ TileWindow(unsigned char* smem, const int32_t* __restrict__ gidx,
                                        const T* __restrict__ gwts, int n, int w,
                                        int target_warps) {
    const int warp = threadIdx.x >> 5;
    const int tile = 32 * target_warps;
    const int t0 = blockIdx.x * tile;
    const int tl = (warp % target_warps) * 32 + (threadIdx.x & 31);
    s = warp / target_warps;
    t = t0 + tl;
    if constexpr (STAGED) {
      const int stride = tile + 1;
      T* wts_s = reinterpret_cast<T*>(smem);
      int32_t* idx_s = reinterpret_cast<int32_t*>(wts_s + w * stride);
      const int rows = min(tile, n - t0);
      const int32_t* gi = gidx + (int64_t)t0 * w;
      const T* gw = gwts + (int64_t)t0 * w;
      for (int q = threadIdx.x; q < rows * w; q += blockDim.x) {
        const int r = q / w;
        const int k = q - r * w;
        idx_s[k * stride + r] = gi[q];
        wts_s[k * stride + r] = gw[q];
      }
      __syncthreads();
      idx = idx_s + tl;
      wts = wts_s + tl;
      ks = stride;
    } else {
      idx = gidx + (int64_t)t * w;
      wts = gwts + (int64_t)t * w;
      ks = 1;
    }
  }

  __device__ __forceinline__ int32_t index(int k) const { return idx[k * ks]; }
  __device__ __forceinline__ T weight(int k) const { return wts[k * ks]; }

  // Slots up to the last non-pad one (PaddedCSR pads at the end of a
  // row; a -1 before the last slot still counts as NaN).
  __device__ __forceinline__ int length(int w) const {
    int len = w;
    while (len > 0 && index(len - 1) < 0) --len;
    return len;
  }
};

}  // namespace xt
