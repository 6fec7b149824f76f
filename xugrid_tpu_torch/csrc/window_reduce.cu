// window_reduce: Hopper kernel #1 of xugrid_tpu_torch, the windowed
// reductions of the regrid apply.  The file also holds csr_matvec, the
// SpMV of the Laplace PCG (kernel #1's matvec mode), further down.
//
// Replaces xugrid_tpu/regrid/aligned_apply.py:gather_aligned_apply and,
// by function, the stream, span, packet and pdot engines of
// xugrid_tpu/regrid/gather_apply.py.  The TPU plan formats (128-lane
// chunks, packets, Q_PACK banding, scalar prefetch) exist because Mosaic
// gathers only within 128 lanes and cannot scatter; Hopper gathers from
// anywhere, so this kernel reads the PaddedCSR window table directly.
// Like the TPU kernel it reads the source slices-major, src (E, m), as
// the caller holds it, and writes out (E, n): no transpose pass.
//
// What bounds it on the H100: device memory.  A pass moves the window
// table (n * w_max * (4 + sizeof(T)) bytes), the source (E * m *
// sizeof(T); every face is gathered by the ~2-3 targets overlapping it,
// mostly from L1 and L2) and the output (E * n * sizeof(T)), with a
// handful of flops per byte.  The design keeps every byte on one path:
// - a block owns a tile of 32 * G consecutive targets.  When its warps
//   walk the windows more than once (E > 4 S) it stages them in shared
//   memory once, slot-major, so the window table is read from device
//   memory once per pass whatever E is; otherwise, or when the windows
//   are too wide for a 32-target tile, each lane reads its window in
//   place (STAGED false).  Each target stops at its last non-pad slot
//   (PaddedCSR pads at the end of a row; a pad slot adds nothing to any
//   method, and a -1 before the last slot still counts as NaN);
// - the block's S * G warps walk the slices: warp (g, s) takes slices
//   s, s + S, ... for its 32 targets, lane = target, so a warp's
//   gathers from source row e fall on neighbouring faces and its stores
//   of out[e, t] are coalesced.  The wrapper picks S from E (a warp
//   walks at most 32 slices) and G from what fits the shared memory
//   (aligned_apply.reduce_lanes, set from a sweep of block shapes on
//   the 1M regrid);
// - each thread reduces B of its warp's slices together (4 when staged,
//   else from E / S, at most 4), so each slot's index and weight are
//   read once for B gathers, and keeps kUnroll * B gathers in flight; it
//   indexes in 32 bits, with no division per output and no atomics, and
//   each output has one owner that walks its window in slot order, so
//   results do not depend on scheduling.
//
// Windows of at most 4 slots (a raster onto a finer mesh, barycentric
// weights, bilinear) take row tiles instead (window_reduce_kernel_rows,
// aligned_apply.row_tiles).  There the output is nearly all the bytes
// (w = 1 onto the 1.56M-face LHM mesh: 93 % of them), and a warp of the
// tile above stores 128 B of one slice row at a time, its next store 8
// rows away.  A row tile is 256 threads of V = 16 / sizeof(T) consecutive
// targets each: a thread loads its V windows once into registers (no
// shared memory, no __syncthreads), then walks the slices of its group,
// gathering U slices of its V targets together (U V W = 16 slots in
// flight) and writing each slice's V results with one 16-byte evict-first
// store, so a block writes 4 KB of one row at a time.  Tiles are fastest in the grid,
// so the blocks in flight cover about a million consecutive targets of the
// same slices.  Each output still walks its window in slot order through
// the same Reducer, so both tilings give the same bits.  Where n is no
// multiple of V or out's rows are not 16-byte aligned (a slab view), the
// same kernel stores each result alone.
//
// Each method is a literal transcription of its formula in
// xugrid_tpu/regrid/reduce.py (NaN and pad slots, 0 * inf, the
// geometric-mean gates), so the kernel returns what reduce.py returns for
// NaN, inf, zero weights and negative values.

#include <type_traits>

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

constexpr int kUnroll = 4;

// One output's running state: add() takes the window's slots in order,
// result() finishes.  `norm` is the window's raw weight sum (geometric
// mean only).
template <typename T, int M>
struct Reducer {
  T a, b;
  bool flag = false;

  __device__ __forceinline__ Reducer() {
    if constexpr (M == kMinimum) {
      a = pos_inf<T>();  // extreme valid value
      b = -pos_inf<T>();  // largest valid weight
    } else if constexpr (M == kMaximum || M == kMaxOverlap) {
      a = -pos_inf<T>();
      b = -pos_inf<T>();
    } else {
      a = 0;
      b = 0;
    }
  }

  __device__ __forceinline__ void add(T v, T wk, T denom) {
    const bool valid = is_valid(v);
    if constexpr (M == kMean || M == kFirstOrderConservative) {
      // a: sum of w * v, b: sum of w, over valid slots.
      const T wv = valid ? wk : (T)0;
      a += wv * (valid ? v : (T)0);
      b += wv;
    } else if constexpr (M == kSum) {
      a += valid ? v : (T)0;
      b += valid ? wk : (T)0;
    } else if constexpr (M == kHarmonicMean) {
      // a: sum of w, b: sum of w / v, over valid nonzero v with w > 0.
      const bool use = valid && v != (T)0 && wk > (T)0;
      const T wu = use ? wk : (T)0;
      a += wu;
      b += use ? wu / v : (T)0;
    } else if constexpr (M == kGeometricMean) {
      // Weights normalized by their raw window sum; a: sum of w log v,
      // b: sum of w, over valid v > 0; flag: a valid negative value.
      const T wn = wk / denom;
      const bool use = valid && v > (T)0 && wn > (T)0;
      a += use ? wn * xlog(xabs(v)) : (T)0;
      b += use ? wn : (T)0;
      flag = flag || (valid && v < (T)0);
    } else if constexpr (M == kMinimum || M == kMaximum) {
      const T x = valid ? v : (M == kMaximum ? -pos_inf<T>() : pos_inf<T>());
      a = M == kMaximum ? (x > a ? x : a) : (x < a ? x : a);
      const T y = valid ? wk : (T)0;
      b = y > b ? y : b;
    } else if constexpr (M == kMaxOverlap) {
      // Value of the valid slot with the largest weight (a: weight, b:
      // value); ties go to the larger value.  flag: any valid slot.
      if (!valid) return;
      flag = true;
      if (wk > a) {
        a = wk;
        b = v;
      } else if (wk == a && v > b) {
        b = v;
      }
    }
  }

  __device__ __forceinline__ T result(T norm) const {
    if constexpr (M == kMean) {
      return b > (T)0 ? a / b : qnan<T>();
    } else if constexpr (M == kSum || M == kFirstOrderConservative) {
      return b != (T)0 ? a : qnan<T>();
    } else if constexpr (M == kHarmonicMean) {
      return (b != (T)0 && a != (T)0) ? a / b : qnan<T>();
    } else if constexpr (M == kGeometricMean) {
      return (b != (T)0 && !flag && norm != (T)0) ? xexp(a / b) : qnan<T>();
    } else if constexpr (M == kMinimum || M == kMaximum) {
      return b > (T)0 ? a : qnan<T>();
    } else {
      return (flag && a > (T)0) ? b : qnan<T>();
    }
  }
};

// Block (S * G warps) for the tile of targets [32 G blockIdx.x, ...),
// in the layout of TileWindow (window_common.cuh).  B: slices a thread
// reduces together (e, e + S, ..., e + (B - 1) S), sharing each slot's
// index and weight reads and keeping kUnroll * B gathers in flight.
template <typename T, int M, bool STAGED, int B>
__global__ void __launch_bounds__(kThreads)
window_reduce_kernel(const T* __restrict__ src, const int32_t* __restrict__ idx,
                     const T* __restrict__ wts, T* __restrict__ out, int n, int m, int w,
                     int E, int slice_warps, int target_warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileWindow<T, STAGED> win(smem, idx, wts, n, w, target_warps);
  if (win.t >= n) return;
  const int len = win.length(w);
  T norm = 0, denom = 1;
  if constexpr (M == kGeometricMean) {
    for (int k = 0; k < w; ++k) norm += win.weight(k);
    denom = norm == (T)0 ? (T)1 : norm;
  }
  for (int e0 = win.s; e0 < E; e0 += slice_warps * B) {
    const T* se[B];
    bool on[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      on[b] = e0 + b * slice_warps < E;
      se[b] = src + (int64_t)(on[b] ? e0 + b * slice_warps : 0) * m;
    }
    Reducer<T, M> acc[B];
    for (int k0 = 0; k0 < len; k0 += kUnroll) {
      int32_t i[kUnroll];
      T wk[kUnroll], v[kUnroll][B];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = k0 + j;
        i[j] = k < len ? win.index(k) : -1;
        wk[j] = k < len ? win.weight(k) : (T)0;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
        for (int b = 0; b < B; ++b) v[j][b] = (i[j] < 0 || !on[b]) ? qnan<T>() : se[b][i[j]];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (k0 + j < len) {
#pragma unroll
          for (int b = 0; b < B; ++b) acc[b].add(v[j][b], wk[j], denom);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (on[b]) out[(int64_t)(e0 + b * slice_warps) * n + win.t] = acc[b].result(norm);
    }
  }
}

// A staged block (bytes > 0) walks its windows more than 4 times (E >
// 4 S), so it takes B = 4; in place, B follows the slices per warp,
// ceil(E / S).
template <typename T, int M>
void launch_batched(unsigned blocks, int threads, size_t bytes, cudaStream_t stream, const T* s,
                    const int32_t* i, const T* wt, T* o, int n, int m, int w, int E, int sw,
                    int tw) {
  const int per_warp = (E + sw - 1) / sw;
  if (bytes > 0) {
    window_reduce_kernel<T, M, true, 4><<<blocks, threads, bytes, stream>>>(s, i, wt, o, n, m, w, E, sw, tw);
  } else if (per_warp >= 4) {
    window_reduce_kernel<T, M, false, 4><<<blocks, threads, 0, stream>>>(s, i, wt, o, n, m, w, E, sw, tw);
  } else if (per_warp >= 2) {
    window_reduce_kernel<T, M, false, 2><<<blocks, threads, 0, stream>>>(s, i, wt, o, n, m, w, E, sw, tw);
  } else {
    window_reduce_kernel<T, M, false, 1><<<blocks, threads, 0, stream>>>(s, i, wt, o, n, m, w, E, sw, tw);
  }
}

template <typename T, int M>
cudaError_t launch_reduce(const void* src, const void* idx, const void* wts, void* out,
                          int n, int m, int w, int E, int slice_warps, int target_warps,
                          int staged, cudaStream_t stream) {
  const int warps = slice_warps * target_warps;
  if (n <= 0 || w < 0 || E <= 0 || slice_warps <= 0 || target_warps <= 0 ||
      32 * warps > kThreads) {
    return cudaErrorInvalidValue;
  }
  const int tile = 32 * target_warps;
  const unsigned blocks = (unsigned)(((int64_t)n + tile - 1) / tile);
  const size_t bytes = staged ? (size_t)(tile + 1) * w * (sizeof(T) + sizeof(int32_t)) : 0;
  if (bytes > kStageBytes) return cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(src);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* wt = static_cast<const T*>(wts);
  T* o = static_cast<T*>(out);
  launch_batched<T, M>(blocks, 32 * warps, bytes, stream, s, i, wt, o, n, m, w, E, slice_warps,
                       target_warps);
  return cudaGetLastError();
}

// Widest window a row tile holds in registers (aligned_apply.ROW_TILE_SLOTS).
constexpr int kRowSlots = 4;

// A row tile's stores are evict-first (st.global.cs): the output streams
// past the L2, which keeps the source rows and the windows.
__device__ __forceinline__ void store16(float* p, const float (&r)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
}
__device__ __forceinline__ void store16(double* p, const double (&r)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(r[0], r[1]));
}

// Row tile [256 V blockIdx.x, ...) of targets over slices [group
// blockIdx.y, ...), for windows of w <= W slots (W = 1, 2 or 4).  VEC:
// every row start out + e * n is 16-byte aligned and n a multiple of V.
template <typename T, int M, int W, bool VEC>
__global__ void __launch_bounds__(kThreads)
window_reduce_kernel_rows(const T* __restrict__ src, const int32_t* __restrict__ idx,
                          const T* __restrict__ wts, T* __restrict__ out, int n, int m, int w,
                          int E, int group) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = 16 / (V * W);
  const int64_t t0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (t0 >= n) return;
  // This thread's windows: slots past len (the last non-pad slot) are not
  // walked; a -1 before it still counts as NaN (TileWindow::length).
  int32_t ix[V][W];
  T wk[V][W], norm[V], denom[V];
  int len[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int64_t row = (t0 + q) * w;
    len[q] = 0;
    norm[q] = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const bool slot = t0 + q < n && k < w;
      ix[q][k] = slot ? idx[row + k] : -1;
      wk[q][k] = slot ? wts[row + k] : (T)0;
      if (ix[q][k] >= 0) len[q] = k + 1;
      if constexpr (M == kGeometricMean) {
        if (slot) norm[q] += wk[q][k];
      }
    }
    denom[q] = norm[q] == (T)0 ? (T)1 : norm[q];
  }
  const int e_begin = blockIdx.y * group;
  const int e_end = (int64_t)e_begin + group < E ? e_begin + group : E;
  for (int e0 = e_begin; e0 < e_end; e0 += U) {
    T v[U][V][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool on = e0 + u < e_end;
      const T* se = src + (int64_t)(on ? e0 + u : e0) * m;
#pragma unroll
      for (int q = 0; q < V; ++q) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          v[u][q][k] = (on && k < len[q] && ix[q][k] >= 0) ? se[ix[q][k]] : qnan<T>();
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u >= e_end) break;
      T r[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        Reducer<T, M> acc;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (k < len[q]) acc.add(v[u][q][k], wk[q][k], denom[q]);
        }
        r[q] = acc.result(norm[q]);
      }
      T* o = out + (int64_t)(e0 + u) * n + t0;
      if constexpr (VEC) {
        store16(o, r);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if (t0 + q < n) __stcs(o + q, r[q]);
        }
      }
    }
  }
}

template <typename T, int M, int W>
void launch_rows_vec(dim3 grid, bool vec, cudaStream_t stream, const T* s, const int32_t* i,
                     const T* wt, T* o, int n, int m, int w, int E, int group) {
  if (vec) {
    window_reduce_kernel_rows<T, M, W, true><<<grid, kThreads, 0, stream>>>(s, i, wt, o, n, m, w, E, group);
  } else {
    window_reduce_kernel_rows<T, M, W, false><<<grid, kThreads, 0, stream>>>(s, i, wt, o, n, m, w, E, group);
  }
}

template <typename T, int M>
cudaError_t launch_rows(const void* src, const void* idx, const void* wts, void* out, int n,
                        int m, int w, int E, int group, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (n <= 0 || w < 0 || w > kRowSlots || E <= 0 || group <= 0) return cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)n + kThreads * V - 1) / (kThreads * V);
  const int64_t groups = ((int64_t)E + group - 1) / group;
  if (tiles > 0x7fffffff || groups > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  const bool vec = n % V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* s = static_cast<const T*>(src);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* wt = static_cast<const T*>(wts);
  T* o = static_cast<T*>(out);
  if (w <= 1) {
    launch_rows_vec<T, M, 1>(grid, vec, stream, s, i, wt, o, n, m, w, E, group);
  } else if (w == 2) {
    launch_rows_vec<T, M, 2>(grid, vec, stream, s, i, wt, o, n, m, w, E, group);
  } else {
    launch_rows_vec<T, M, 4>(grid, vec, stream, s, i, wt, o, n, m, w, E, group);
  }
  return cudaGetLastError();
}

// f(T(), std::integral_constant<int, M>()) for the kernel dtype code (0
// float32, 1 float64) and method code (ReduceMethod); cudaErrorInvalidValue
// for any other code.
template <typename T, typename F>
cudaError_t by_method(int method, F& f) {
#define XT_METHOD(M) \
  case M: return f(T(), std::integral_constant<int, M>())
  switch (method) {
    XT_METHOD(kMean);
    XT_METHOD(kSum);
    XT_METHOD(kFirstOrderConservative);
    XT_METHOD(kHarmonicMean);
    XT_METHOD(kGeometricMean);
    XT_METHOD(kMinimum);
    XT_METHOD(kMaximum);
    XT_METHOD(kMaxOverlap);
    default: return cudaErrorInvalidValue;
  }
#undef XT_METHOD
}

template <typename F>
cudaError_t by_dtype_and_method(int dtype, int method, F f) {
  if (dtype == 0) return by_method<float>(method, f);
  if (dtype == 1) return by_method<double>(method, f);
  return cudaErrorInvalidValue;
}

// csr_matvec: the SpMV of the Laplace PCG, y[t, e] = sum_k data[k] *
// x[indices[k], e] over row t of a CSR matrix, for x of shape (m, E)
// with the right-hand sides on the minor axis.
//
// Replaces gather_aligned_apply in method="matvec" mode
// (xugrid_tpu/regrid/aligned_apply.py:1271) and, by function, the
// stream, span, packet and pdot engines in the same mode
// (gather_apply.py:1794, 1858, 1413, 975), the SpMV engines of
// xugrid_tpu/ugrid/interpolate.py:cg_solve.
//
// What bounds it on the H100: device memory.  A matvec reads the matrix
// once (nnz * (4 + sizeof(T)) + (n + 1) * 4 bytes), the iterate (m * E *
// sizeof(T), which at 1M unknowns fits the 50 MB L2, so its ~7 gathers
// per entry mostly hit there) and writes the output (n * E * sizeof(T)),
// with 2 flops per entry and slice.  It reads CSR row pointers, not a
// padded table: the Laplacian's rows hold 2-21 entries, 6.9 on average
// at 1M nodes, so a table padded to the widest row would read ~3x the
// bytes.  One thread per (row, slice), slice fastest, found by one 32-bit
// division: the E threads of a row read its entries together (one
// broadcast load per warp) and gather one contiguous run of x per entry,
// kUnroll entries in flight, summing in CSR order.  A group of lanes
// sharing a row (the entries read coalesced, combined by shuffles) was
// measured on the 1M CG system and was no faster at any E: the
// Laplacian of a planar mesh has rows of under 7 entries on average, too
// short to split.  No atomics and a fixed summation order, so two
// launches give the same bits, and csr_matvec_plain, which sums in the
// same order, gives them too.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_matvec_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                  const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                  int n, int E) {
  // n * E < 2^31 (the launcher checks), so 32-bit ids suffice.
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * E) return;
  const int row = gid / E;
  const int e = gid - row * E;
  const int end = indptr[row + 1];
  T acc = 0;
  for (int k0 = indptr[row]; k0 < end; k0 += kUnroll) {
    int32_t j[kUnroll];
    T a[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = k0 + u < end ? indices[k0 + u] : -1;
      a[u] = k0 + u < end ? data[k0 + u] : (T)0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = j[u] >= 0 ? x[(int64_t)j[u] * E + e] : (T)0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < end) acc += a[u] * v[u];
    }
  }
  y[gid] = acc;
}

template <typename T>
cudaError_t launch_matvec(const void* indptr, const void* indices, const void* data,
                          const void* x, void* y, int n, int E, cudaStream_t stream) {
  if (n <= 0 || E <= 0) return cudaErrorInvalidValue;
  const int64_t threads = (int64_t)n * E;
  unsigned blocks;
  if (threads > 0x7fffffff || !grid_size(threads, &blocks)) return cudaErrorInvalidConfiguration;
  csr_matvec_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), n, E);
  return cudaGetLastError();
}

}  // namespace xt

// dtype: 0 float32, 1 float64.  indptr (n + 1) and indices (nnz) int32,
// data (nnz) and x (m, E) of dtype, y (n, E), all contiguous on the
// current device, n * E < 2^31.  Returns the launch's cudaGetLastError().
extern "C" int xt_csr_matvec(int dtype, const void* indptr, const void* indices,
                             const void* data, const void* x, void* y, int32_t n, int32_t E,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)xt::launch_matvec<float>(indptr, indices, data, x, y, n, E, s);
  if (dtype == 1) return (int)xt::launch_matvec<double>(indptr, indices, data, x, y, n, E, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 float64.  method: xt::ReduceMethod.  src (E, m),
// idx and wts (n, w), out (E, n), all contiguous on the current device.
// slice_warps S and target_warps G: the block's warps (S * G <= 8);
// staged: stage each tile's windows in (32 G + 1) * w * (4 + sizeof(T))
// bytes of shared memory (at most 48 KiB).  Returns the launch's
// cudaGetLastError().
extern "C" int xt_window_reduce(int dtype, int method, const void* src, const void* idx,
                                const void* wts, void* out, int32_t n, int32_t m, int32_t w,
                                int32_t E, int32_t slice_warps, int32_t target_warps,
                                int32_t staged, void* stream) {
  return (int)xt::by_dtype_and_method(dtype, method, [&](auto t, auto M) {
    return xt::launch_reduce<decltype(t), decltype(M)::value>(
        src, idx, wts, out, n, m, w, E, slice_warps, target_warps, staged,
        static_cast<cudaStream_t>(stream));
  });
}

// xt_window_reduce in row tiles (window_reduce_kernel_rows), for windows of
// w <= 4 slots: each block takes `group` slices of its tile.  Returns the
// launch's cudaGetLastError().
extern "C" int xt_window_reduce_rows(int dtype, int method, const void* src, const void* idx,
                                     const void* wts, void* out, int32_t n, int32_t m, int32_t w,
                                     int32_t E, int32_t group, void* stream) {
  return (int)xt::by_dtype_and_method(dtype, method, [&](auto t, auto M) {
    return xt::launch_rows<decltype(t), decltype(M)::value>(
        src, idx, wts, out, n, m, w, E, group, static_cast<cudaStream_t>(stream));
  });
}
