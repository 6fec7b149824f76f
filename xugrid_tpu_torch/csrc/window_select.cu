// window_select: Hopper kernel #2 of xugrid_tpu_torch, the order
// statistics of the regrid apply (mode, median, any percentile).
//
// Replaces xugrid_tpu/regrid/select_apply.py:gather_select_apply.  Like
// that kernel, and like window_reduce, it reads the source slices-major,
// src (E, m), as the caller holds it, and writes out (E, n): no transpose
// pass.  The TPU kernel ranks 32-slot windows held in lanes by an
// all-pairs pass and splits wider windows into a second plan
// (MAX_WINDOW = 32); here each thread orders its own window in registers,
// and a window longer than the registers hold takes a counting walk over
// memory in the same launch, so any w_max is taken.
//
// What bounds it on the H100: the instructions that order each window
// and the latency of the gathers, not the device memory.  A pass moves
// what window_reduce moves (the window table once, the gathered source,
// the output once), but each (slice, target) window is ordered in
// registers before its output is known, and a warp waits for its gathers
// before it can order them.  The design keeps the ordering off memory and
// the registers few, so an SM holds enough warps to hide the gathers:
// - window_reduce's tile layout (window_common.cuh, TileWindow): lane =
//   target, a warp's 32 consecutive targets of one slice, so its gathers
//   from source row e fall on neighbouring faces and its stores of
//   out[e, t] are coalesced; the block's warps split the slices, and the
//   tile's windows are staged in shared memory when its warps walk them
//   more than once (E > S).  Each target stops at its last non-pad slot;
// - each thread loads its window's values for its slice once, into a
//   register array of K slots (8, 16 or 32; the wrapper picks K from
//   w_max).  NaN and pad slots become the +inf key, with a validity bit.
//   All work on the array runs in fully unrolled loops over the K slots,
//   so it stays in registers (no spills, no local memory);
// - a percentile sorts the K keys (slots from len up to K at +inf) by
//   Batcher's odd-even merge sort: 19 / 63 / 191 min / max pairs at depth
//   6 / 10 / 15 for K = 8 / 16 / 32, each layer's pairs independent, in
//   place of 120 counting compares with packed rank adds in long chains
//   at K = 16.  The sorted keys at the interpolation's two ranks are the
//   values the counting ranks select, whatever order ties took;
// - the median (p = 50, an instantiation of its own) gives the invalid
//   slots +inf and -inf in turn, so its two ranks always sort to slots
//   K / 2 - 1 and K / 2, and runs only the min / max outputs of Batcher's
//   pairs that feed those two: 28 / 92 / 284 of 38 / 126 / 382, and no
//   selects by a rank known at run time;
// - the mode keeps its group totals sum_j w_j [v_j == v_k], added in slot
//   order, 4 slots at a time up to len: sorting would change the order
//   of those additions, and so the bits.  float32 windows of up to 16
//   slots fit 64 registers, 4 blocks per SM;
// - a target with more than K slots takes a counting walk, which re-reads
//   its window from shared memory and the source from L1 for every slot;
// - 32-bit indices, no division per output, no atomics, one owner per
//   output.  One slice per window read: a second slice's register array
//   would halve the warps an SM holds.

// Both reductions transcribe xugrid_tpu/regrid/reduce.py: percentiles
// skip NaN, interpolate lower * (1 - m) + upper * m between the closest
// ranks of rank = 1 + (n - 1) p / 100 (computed in T, as the plain
// version does), gate on the raw maximum weight, and reduce to minimum
// and maximum at p = 0 and p = 100; the mode is area weighted, ties go
// to the largest value, gated on the valid maximum weight.  Pad slots
// past len change neither (a percentile's ranks below n_valid come from
// valid slots; a mode total adds +0 for them), so results are the plain
// version's bits, but that a percentile's zero may take the other sign
// (the network orders a tie of -0 and +0 either way).

#include "window_common.cuh"

namespace xt {

// What a launch computes: the p-th percentile by the full sort, the mode,
// or the median (p = 50) by the fixed-slot network.
enum SelectKind : int { kPercentile = 0, kMode = 1, kMedian = 2 };

// reduce.py minimum (MAX false) and maximum (MAX true): the extreme valid
// value, NaN unless some valid slot has a positive weight.
template <typename T, bool MAX>
struct Extreme {
  T best = MAX ? -pos_inf<T>() : pos_inf<T>();
  T wmax = -pos_inf<T>();

  __device__ __forceinline__ void add(T v, T wk) {
    const bool valid = is_valid(v);
    const T x = valid ? v : (MAX ? -pos_inf<T>() : pos_inf<T>());
    best = MAX ? (x > best ? x : best) : (x < best ? x : best);
    const T y = valid ? wk : (T)0;
    wmax = y > wmax ? y : wmax;
  }
  __device__ __forceinline__ T result() const { return wmax > (T)0 ? best : qnan<T>(); }
};

// The closest ranks lo, hi (0-based, clamped) of the p-th percentile of
// n_valid > 0 valid values, and the weight m of the upper one.
template <typename T>
struct Interpolation {
  int lo, hi;
  T m;

  __device__ __forceinline__ Interpolation(int n_valid, int w, double p) {
    const T rank = (T)1 + ((T)n_valid - (T)1) * (T)(p / 100.0);
    const T f = xfloor(rank);
    m = rank - f;
    lo = (int)f - 1;
    lo = lo < 0 ? 0 : (lo > w - 1 ? w - 1 : lo);
    hi = lo + 1 > w - 1 ? w - 1 : lo + 1;
    hi = hi < n_valid - 1 ? hi : n_valid - 1;
  }
  __device__ __forceinline__ T operator()(T lower, T upper) const {
    return lower * ((T)1 - m) + upper * m;
  }
};

// The mode's running state over slots in order: add() takes a valid
// slot's value, weight and group total, invalid() a NaN or pad slot.  The
// best (total, value) pair, lexicographically, gated on the valid
// maximum weight.
template <typename T>
struct ModeBest {
  T wmax = -pos_inf<T>();
  bool any_valid = false;
  T total = -pos_inf<T>(), value = -pos_inf<T>();

  __device__ __forceinline__ void invalid() { wmax = wmax > (T)0 ? wmax : (T)0; }
  __device__ __forceinline__ void add(T v, T wk, T t) {
    any_valid = true;
    wmax = wk > wmax ? wk : wmax;
    if (t > total) {
      total = t;
      value = v;
    } else if (t == total && v > value) {
      value = v;
    }
  }
  __device__ __forceinline__ T result() const {
    return (any_valid && wmax > (T)0) ? value : qnan<T>();
  }
};

// Slots [0, len) of the window for slice row `se` into registers, 4 at
// a time: v[k] is the value (NaN for a pad slot) for k below len rounded
// up to 4; later slots are left unset and never read.
template <typename T, int K, typename W>
__device__ __forceinline__ void load_window(const T* __restrict__ se, const W& win, int len,
                                            T (&v)[K]) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 4) {
    if (k0 >= len) break;
#pragma unroll
    for (int k = k0; k < k0 + 4; ++k) {
      const int32_t i = k < len ? win.index(k) : -1;
      v[k] = i < 0 ? qnan<T>() : se[i];
    }
  }
}

__device__ __forceinline__ float xmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double xmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) { return fmax(a, b); }

// Batcher's odd-even merge sort of K slots, the one source of its pairs:
// merge p = 1, 2, ..., K / 2, pass k = p, p / 2, ..., 1 compares slot x
// with x + k where x >= k % p, (x - k % p) mod 2k < k and both lie in one
// block of 2p slots.
__host__ __device__ constexpr bool batcher_pair(int K, int lp, int lk, int x) {
  const int p = 1 << lp, k = 1 << lk, r = k % p;
  return lk <= lp && x + k < K && x >= r && (x - r) % (2 * k) < k && x / (2 * p) == (x + k) / (2 * p);
}

template <int K>
__host__ __device__ constexpr int network_levels() {
  static_assert(K == 8 || K == 16 || K == 32, "register slots are 8, 16 or 32");
  return K == 8 ? 3 : (K == 16 ? 4 : 5);
}

// Sorts K keys that hold no NaN ascending, by Batcher's odd-even merge
// sort: 19 / 63 / 191 compare-exchanges at depth 6 / 10 / 15 for K = 8 /
// 16 / 32.  Every loop has a constant trip count and every condition
// folds once they unroll, so each pair is a fixed min / max on two
// registers.
template <typename T, int K>
__device__ __forceinline__ void sort_network(T (&key)[K]) {
  constexpr int L = network_levels<K>();
#pragma unroll
  for (int lp = 0; lp < L; ++lp) {
#pragma unroll
    for (int lk = L - 1; lk >= 0; --lk) {
      const int k = 1 << lk;
#pragma unroll
      for (int x = 0; x < K - 1; ++x) {
        if (batcher_pair(K, lp, lk, x)) {
          const T a = key[x], b = key[x + k];
          key[x] = xmin(a, b);
          key[x + k] = xmax(a, b);
        }
      }
    }
  }
}

// The outputs of Batcher's pairs that feed sorted slots K / 2 - 1 and
// K / 2: need[lp][lk][x] bit 0 the min (slot x), bit 1 the max (slot
// x + k), 0 for a pair that feeds neither and where no pair starts.
// Walked from the last pair back: a pair's inputs are live when one of
// its outputs is, and a pair of one layer is alone on its slots.  17 / 53 / 157 of the 19 / 63 /
// 191 pairs run, 28 / 92 / 284 min or max.
template <int K>
struct MedianPairs {
  static constexpr int L = network_levels<K>();
  unsigned char need[L][L][K] = {};

  __host__ __device__ constexpr MedianPairs() {
    bool live[K] = {};
    live[K / 2 - 1] = live[K / 2] = true;
    for (int lp = L - 1; lp >= 0; --lp) {
      for (int lk = 0; lk <= lp; ++lk) {
        for (int x = 0; x < K - 1; ++x) {
          if (!batcher_pair(K, lp, lk, x)) continue;
          const int k = 1 << lk;
          need[lp][lk][x] = (unsigned char)((live[x] ? 1 : 0) | (live[x + k] ? 2 : 0));
          live[x] = live[x + k] = need[lp][lk][x] != 0;
        }
      }
    }
  }
};

// Sorted slots K / 2 - 1 and K / 2 of K keys that hold no NaN, by the
// pairs of sort_network that feed them; the other slots are left
// unordered.
template <typename T, int K>
__device__ __forceinline__ void median_network(T (&key)[K]) {
  constexpr MedianPairs<K> pairs{};
  constexpr int L = MedianPairs<K>::L;
#pragma unroll
  for (int lp = 0; lp < L; ++lp) {
#pragma unroll
    for (int lk = L - 1; lk >= 0; --lk) {
      const int k = 1 << lk;
#pragma unroll
      for (int x = 0; x < K - 1; ++x) {
        const int need = pairs.need[lp][lk][x];
        if (need != 0) {
          const T a = key[x], b = key[x + k];
          if (need & 1) key[x] = xmin(a, b);
          if (need & 2) key[x + k] = xmax(a, b);
        }
      }
    }
  }
}

// The p-th percentile of a window of len <= K slots, sorted in registers;
// with MEDIAN, the median (p = 50) by the fixed-slot network.
template <typename T, int K, bool MEDIAN, typename W>
__device__ __forceinline__ T percentile_registers(const T* __restrict__ se, const W& win, int len,
                                                  int w, double p) {
  T key[K];
  load_window<T, K>(se, win, len, key);
  unsigned valid = 0;  // bit k: slot k holds a valid value
  int n_valid = 0;
  // NaN, pad and unloaded slots (len up to K) become +inf, so the
  // network sorts all K and the valid values come first.  The median's
  // take +inf and -inf in turn: of j such slots j / 2 (rounded down)
  // sort first, so the ranks (n_valid - 1) / 2 (rounded down) and one
  // above it of the valid values land on slots K / 2 - 1 and K / 2 for
  // either parity of j.  A real +-inf ties with a sentinel, which leaves
  // the sorted multiset, and so each slot's value, as it was.
  T sentinel = pos_inf<T>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool ok = k < len && is_valid(key[k]);
    valid |= (unsigned)ok << k;
    n_valid += ok ? 1 : 0;
    key[k] = ok ? key[k] : sentinel;
    if constexpr (MEDIAN) sentinel = ok ? sentinel : -sentinel;
  }
  if (n_valid == 0) return qnan<T>();
  if constexpr (MEDIAN) {
    const Interpolation<T> at(n_valid, w, 50.0);
    median_network<T, K>(key);
    const T lower = key[K / 2 - 1];
    return at(lower, n_valid > 1 ? key[K / 2] : lower);
  }
  if (p == 0.0 || p == 100.0) {
    Extreme<T, false> lo;
    Extreme<T, true> hi;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= len) break;
      const T v = (valid >> k) & 1u ? key[k] : qnan<T>();
      const T wk = win.weight(k);
      lo.add(v, wk);
      hi.add(v, wk);
    }
    return p == 0.0 ? lo.result() : hi.result();
  }
  const Interpolation<T> at(n_valid, w, p);
  // The value at sorted position r of a multiset does not depend on how
  // ties were ordered, so key[lo] and key[hi] are the counting walk's.
  sort_network<T, K>(key);
  T lower = key[0], upper = key[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    lower = k == at.lo ? key[k] : lower;
    upper = k == at.hi ? key[k] : upper;
  }
  return at(lower, upper);
}

// The mode of a window of len <= K slots, its group totals in registers.
template <typename T, int K, typename W>
__device__ __forceinline__ T mode_registers(const T* __restrict__ se, const W& win, int len) {
  T v[K], wk[K];
  load_window<T, K>(se, win, len, v);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 4) {
    if (k0 >= len) break;
#pragma unroll
    for (int k = k0; k < k0 + 4; ++k) wk[k] = k < len ? win.weight(k) : (T)0;
  }
  ModeBest<T> best;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= len) break;
    if (!is_valid(v[k])) {
      best.invalid();
      continue;
    }
    // Group total in slot order; the slots of the last group of 4 past
    // len hold NaN and add +0.
    T total = 0;
#pragma unroll
    for (int j0 = 0; j0 < K; j0 += 4) {
      if (j0 >= len) break;
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) total += v[j] == v[k] ? wk[j] : (T)0;
    }
    best.add(v[k], wk[k], total);
  }
  return best.result();
}

// Value of slot k for slice row `se`: NaN for a pad slot.
template <typename T, typename W>
__device__ __forceinline__ T slot_value(const T* __restrict__ se, const W& win, int k) {
  const int32_t i = win.index(k);
  return i < 0 ? qnan<T>() : se[i];
}

// The p-th percentile of a window of any length, by the counting walk.
template <typename T, typename W>
__device__ __forceinline__ T percentile_walk(const T* __restrict__ se, const W& win, int len, int w, double p) {
  int n_valid = 0;
  for (int k = 0; k < len; ++k) n_valid += is_valid(slot_value(se, win, k)) ? 1 : 0;
  if (n_valid == 0) return qnan<T>();
  if (p == 0.0 || p == 100.0) {
    Extreme<T, false> lo;
    Extreme<T, true> hi;
    for (int k = 0; k < len; ++k) {
      const T v = slot_value(se, win, k);
      lo.add(v, win.weight(k));
      hi.add(v, win.weight(k));
    }
    return p == 0.0 ? lo.result() : hi.result();
  }
  const Interpolation<T> at(n_valid, w, p);
  T lower = qnan<T>(), upper = qnan<T>();
  for (int k = 0; k < len; ++k) {
    const T vk = slot_value(se, win, k);
    const T key = is_valid(vk) ? vk : pos_inf<T>();
    int r = 0;
    for (int j = 0; j < len; ++j) {
      const T vj = slot_value(se, win, j);
      const T other = is_valid(vj) ? vj : pos_inf<T>();
      r += (other < key || (other == key && j < k)) ? 1 : 0;
    }
    if (r == at.lo) lower = key;
    if (r == at.hi) upper = key;
  }
  return at(lower, upper);
}

// The mode of a window of any length, by the counting walk.
template <typename T, typename W>
__device__ __forceinline__ T mode_walk(const T* __restrict__ se, const W& win, int len) {
  ModeBest<T> best;
  for (int k = 0; k < len; ++k) {
    const T vk = slot_value(se, win, k);
    if (!is_valid(vk)) {
      best.invalid();
      continue;
    }
    T total = 0;
    for (int j = 0; j < len; ++j) total += slot_value(se, win, j) == vk ? win.weight(j) : (T)0;
    best.add(vk, win.weight(k), total);
  }
  return best.result();
}

// Block (S * G warps) for the tile of targets [32 G blockIdx.x, ...), in
// the layout of TileWindow.  K: register slots; windows of more than K
// slots take the walk.  The launch bounds name the blocks per SM: given
// only the block size, ptxas spills registers to fit one more block (at
// 40, 64, 80 or 128 registers).  float32 windows of up to 16 slots fit
// 64 registers without spilling, so 4 blocks of 256 threads share an SM;
// the wider arrays take up to 255 registers in one block.
template <typename T, int KIND, int K, bool STAGED>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 4 && K <= 16) ? 4 : 1)
window_select_kernel(const T* __restrict__ src, const int32_t* __restrict__ idx,
                     const T* __restrict__ wts, T* __restrict__ out, int n, int m, int w,
                     int E, int slice_warps, int target_warps, double p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileWindow<T, STAGED> win(smem, idx, wts, n, w, target_warps);
  if (win.t >= n) return;
  const int len = win.length(w);
  // Percentiles gate on the raw maximum weight over all w slots, which
  // holds for every slice.
  bool gate = true;
  if constexpr (KIND != kMode) {
    T wraw = -pos_inf<T>();
    for (int k = 0; k < w; ++k) {
      const T wk = win.weight(k);
      wraw = wk > wraw ? wk : wraw;
    }
    gate = wraw > (T)0;
  }
  for (int e = win.s; e < E; e += slice_warps) {
    const T* se = src + (int64_t)e * m;
    T result = qnan<T>();
    if constexpr (KIND == kMode) {
      result = len <= K ? mode_registers<T, K>(se, win, len) : mode_walk<T>(se, win, len);
    } else if (gate) {
      result = len <= K ? percentile_registers<T, K, KIND == kMedian>(se, win, len, w, p)
                        : percentile_walk<T>(se, win, len, w, p);
    }
    out[(int64_t)e * n + win.t] = result;
  }
}

template <typename T, int KIND, int K>
void launch_slots(unsigned blocks, int threads, size_t bytes, cudaStream_t stream, const T* s,
                  const int32_t* i, const T* wt, T* o, int n, int m, int w, int E, int sw, int tw,
                  double p) {
  if (bytes > 0) {
    window_select_kernel<T, KIND, K, true><<<blocks, threads, bytes, stream>>>(s, i, wt, o, n, m, w, E, sw, tw, p);
  } else {
    window_select_kernel<T, KIND, K, false><<<blocks, threads, 0, stream>>>(s, i, wt, o, n, m, w, E, sw, tw, p);
  }
}

template <typename T, int KIND>
cudaError_t launch_select(const void* src, const void* idx, const void* wts, void* out, int n,
                          int m, int w, int E, int slice_warps, int target_warps, int staged,
                          int slots, double p, cudaStream_t stream) {
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
  const int threads = 32 * warps;
  switch (slots) {
    case 8: launch_slots<T, KIND, 8>(blocks, threads, bytes, stream, s, i, wt, o, n, m, w, E, slice_warps, target_warps, p); break;
    case 16: launch_slots<T, KIND, 16>(blocks, threads, bytes, stream, s, i, wt, o, n, m, w, E, slice_warps, target_warps, p); break;
    case 32: launch_slots<T, KIND, 32>(blocks, threads, bytes, stream, s, i, wt, o, n, m, w, E, slice_warps, target_warps, p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The kind from the caller's mode and p: the median at p = 50 exactly,
// which reduce.median and any Percentile(50) pass.
template <typename T>
cudaError_t dispatch_select(int mode, const void* src, const void* idx, const void* wts,
                            void* out, int n, int m, int w, int E, int sw, int tw, int st,
                            int slots, double p, cudaStream_t stream) {
  if (mode == 1) return launch_select<T, kMode>(src, idx, wts, out, n, m, w, E, sw, tw, st, slots, p, stream);
  if (mode != 0) return cudaErrorInvalidValue;
  if (p == 50.0) return launch_select<T, kMedian>(src, idx, wts, out, n, m, w, E, sw, tw, st, slots, p, stream);
  return launch_select<T, kPercentile>(src, idx, wts, out, n, m, w, E, sw, tw, st, slots, p, stream);
}

}  // namespace xt

// dtype: 0 float32, 1 float64.  mode: 1 for the mode, 0 for the p-th
// percentile (the median's kernel at p = 50).  src (E, m), idx and wts
// (n, w), out (E, n), all contiguous on the current device.  slice_warps
// S, target_warps G and staged as for xt_window_reduce; slots K: 8, 16 or
// 32 register slots.  Returns the launch's cudaGetLastError().
extern "C" int xt_window_select(int dtype, int mode, double p, const void* src, const void* idx,
                                const void* wts, void* out, int32_t n, int32_t m, int32_t w,
                                int32_t E, int32_t slice_warps, int32_t target_warps,
                                int32_t staged, int32_t slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)xt::dispatch_select<float>(mode, src, idx, wts, out, n, m, w, E, slice_warps,
                                           target_warps, staged, slots, p, s);
  }
  if (dtype == 1) {
    return (int)xt::dispatch_select<double>(mode, src, idx, wts, out, n, m, w, E, slice_warps,
                                            target_warps, staged, slots, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
