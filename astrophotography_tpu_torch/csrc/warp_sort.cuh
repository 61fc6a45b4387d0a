// The many-frame routes' sort: the 32 lanes of a warp sort one pixel's
// column together, shared by K2 (warp_combine.cu, route 'cols') and K3
// (clip_combine.cu, route 'cols').
//
// The column lies in shared memory, element e at col[swz(e, s)].  A run
// of up to 32 x 32 = 1024 samples is sorted in registers: each lane holds
// R consecutive elements (lane-blocked, R = 2 .. 32 by the column's
// length), sorts them with a network of its own, and the stages whose
// partner is in another lane exchange through __shfl_xor_sync.  A longer
// column is sorted in such runs, then merged on chip: the merge stages of
// partner distance >= 1024 are passes of the warp over the shared column,
// the rest run in registers again.  So the column never leaves the SM,
// and 32 threads share each column's ~n log^2 n / 4 compare-exchanges.
// Runs of 2048 (R = 64) were measured slower: K2's kernel holds 128
// registers a thread, and its sort at 1200 x 512^2 took 2.4 ms more
// (tools/cols_variants.py).
//
// The swizzle keeps both access patterns free of bank conflicts: lane L
// reading its element L * R + r (all lanes, one r) and consecutive lanes
// reading consecutive elements (the tile load, the passes).  It permutes
// the words inside each aligned group of 32, so a column of n samples
// takes n rounded up to 32 words.
//
// A compare-exchange is fminf / fmaxf: it only permutes its operands
// (-0 is ordered below +0), so the sorted column holds exactly the samples
// it was given.  A NaN sample is outside the contract (the twins' sorts
// place it otherwise).  The rank helpers below read the sorted column;
// every comparison there treats -0 and +0 as equal, as the twins do.
// kernels._library hashes this header into every library's name.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned WARP_ALL = 0xffffffffu;
constexpr int SORT_RUN = 1024;  // samples one warp sorts in registers

__host__ __device__ __forceinline__ int swz(int e, int s) {
  return e ^ ((e >> s) & 31);
}

// registers per lane for a column of L samples (2 .. 32), and the
// swizzle shift that goes with them (log2)
__host__ __device__ __forceinline__ int col_regs(int L) {
  int r = 2;
  while (32 * r < L && r < SORT_RUN / 32) r <<= 1;
  return r;
}
__host__ __device__ __forceinline__ int col_shift(int L) {
  int s = 1;
  while ((1 << s) < col_regs(L)) ++s;
  return s;
}

__device__ __forceinline__ void cmx(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// a full ascending network on one lane's R registers (the first stage of
// each merge compares mirrored partners, so every stage sorts upwards)
template <int R>
__device__ __forceinline__ void lane_sort(float (&v)[R]) {
#pragma unroll
  for (int k = 2; k <= R; k <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & (k >> 1))) cmx(v[i], v[i ^ (k - 1)]);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (!(i & j)) cmx(v[i], v[i ^ j]);
  }
}

// the merge stages of partner distance < R, inside one lane
template <int R>
__device__ __forceinline__ void lane_merge(float (&v)[R]) {
#pragma unroll
  for (int j = R >> 1; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(i & j)) cmx(v[i], v[i ^ j]);
}

// One stage whose partners are in lane ^ m.  Plain: element r with the
// partner's r (m is one bit).  Mirrored (the first stage of a merge of
// k = (m + 1) * R elements): element r with the partner's R - 1 - r.  The
// lower lane keeps the minimum.
template <int R>
__device__ __forceinline__ void cross_stage(float (&v)[R], int m, bool mirror,
                                            int lane) {
  if (mirror) {
    const bool up = (lane & ((m + 1) >> 1)) != 0;
#pragma unroll
    for (int r = 0; r < R / 2; ++r) {
      const float a = __shfl_xor_sync(WARP_ALL, v[R - 1 - r], m);
      const float b = __shfl_xor_sync(WARP_ALL, v[r], m);
      v[r] = up ? fmaxf(v[r], a) : fminf(v[r], a);
      v[R - 1 - r] = up ? fmaxf(v[R - 1 - r], b) : fminf(v[R - 1 - r], b);
    }
  } else {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float o = __shfl_xor_sync(WARP_ALL, v[r], m);
      v[r] = up ? fmaxf(v[r], o) : fminf(v[r], o);
    }
  }
}

// sort the warp's 32 x R registers (lane-blocked) ascending
template <int R>
__device__ __forceinline__ void warp_sort_regs(float (&v)[R], int lane) {
  lane_sort<R>(v);
#pragma unroll 1
  for (int k = 2 * R; k <= 32 * R; k <<= 1) {
    cross_stage<R>(v, k / R - 1, true, lane);
#pragma unroll 1
    for (int j = k >> 2; j >= R; j >>= 1) cross_stage<R>(v, j / R, false, lane);
    lane_merge<R>(v);
  }
}

// the last stages of a merge (partner distance < 32 R) on the registers
template <int R>
__device__ __forceinline__ void warp_merge_regs(float (&v)[R], int lane) {
#pragma unroll 1
  for (int j = 16 * R; j >= R; j >>= 1) cross_stage<R>(v, j / R, false, lane);
  lane_merge<R>(v);
}

// Sort col[0, L) (swizzle shift log2 R) ascending, the whole warp.  The
// network is that of L padded to a power of two with +inf; a comparator
// whose upper partner is padding never moves it (the minimum goes to the
// lower index), so it is skipped, and registers past L load +inf and are
// not stored.  Callers synchronise before (the column is complete); this
// ends in __syncwarp.
template <int R>
__device__ void sort_col_r(float* col, int L, int lane) {
  constexpr int C = 32 * R;
  constexpr int S = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4
                  : R == 32 ? 5 : 6;
  const float INF = __int_as_float(0x7f800000);
  float v[R];
  auto load = [&](int b0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = b0 + lane * R + r;
      v[r] = e < L ? col[swz(e, S)] : INF;
    }
  };
  auto store = [&](int b0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = b0 + lane * R + r;
      if (e < L) col[swz(e, S)] = v[r];
    }
  };
#pragma unroll 1
  for (int b0 = 0; b0 < L; b0 += C) {
    load(b0);
    warp_sort_regs<R>(v, lane);
    store(b0);
  }
  if (L > C) {  // R == SORT_RUN / 32: merge the sorted runs on chip
    int P = C;
    while (P < L) P <<= 1;
#pragma unroll 1
    for (int k = 2 * C; k <= P; k <<= 1) {
#pragma unroll 1
      for (int j = k >> 1; j >= C; j >>= 1) {
        const bool flip = j == (k >> 1);
        __syncwarp();
#pragma unroll 1
        for (int t = lane; t < P / 2; t += 32) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const int l = flip ? (i ^ (k - 1)) : (i + j);
          if (l < L) {
            float a = col[swz(i, S)], b = col[swz(l, S)];
            cmx(a, b);
            col[swz(i, S)] = a;
            col[swz(l, S)] = b;
          }
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int b0 = 0; b0 < L; b0 += C) {
        load(b0);
        warp_merge_regs<R>(v, lane);
        store(b0);
      }
    }
  }
  __syncwarp();
}

// sort_col for a column of one run (L <= 32 R), leaving the warp's
// sorted registers in v as well: lane L holds elements L R .. L R + R - 1
template <int R>
__device__ __forceinline__ void sort_run(float* col, int L, int lane,
                                         float (&v)[R]) {
  constexpr int S = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4
                  : R == 32 ? 5 : 6;
  const float INF = __int_as_float(0x7f800000);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    v[r] = e < L ? col[swz(e, S)] : INF;
  }
  warp_sort_regs<R>(v, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    if (e < L) col[swz(e, S)] = v[r];
  }
  __syncwarp();
}

// The sum of the sorted elements [b, e) (b < e) of a run held in the
// warp's registers, in ascending order, one add after another: the lanes
// that hold the range add their own elements in turn, each passing the
// running sum on by a shuffle.  Every lane returns it.
template <int R>
__device__ __forceinline__ float run_sum(const float (&v)[R], int b, int e,
                                         int lane) {
  float acc = 0.0f;
#pragma unroll 1
  for (int L = b / R; L <= (e - 1) / R; ++L) {
    if (lane == L) {
      const int rb = b - L * R, re = e - L * R;
      if (rb <= 0 && re >= R) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc = __fadd_rn(acc, v[r]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r >= rb && r < re) acc = __fadd_rn(acc, v[r]);
      }
    }
    acc = __shfl_sync(WARP_ALL, acc, L);
  }
  return acc;
}

__device__ __noinline__ void sort_col(float* col, int L, int lane) {
  switch (col_regs(L)) {
    case 2: sort_col_r<2>(col, L, lane); break;
    case 4: sort_col_r<4>(col, L, lane); break;
    case 8: sort_col_r<8>(col, L, lane); break;
    case 16: sort_col_r<16>(col, L, lane); break;
    default: sort_col_r<32>(col, L, lane); break;
  }
}

// A sorted swizzled column, read by index.
struct Sorted {
  const float* col;
  int s;
  __device__ __forceinline__ float operator[](int e) const {
    return col[swz(e, s)];
  }
};

// first index in [0, n) whose value is not below x (n if none)
__device__ __forceinline__ int lower_bound(const Sorted& c, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index in [0, n) whose value is above x (n if none)
__device__ __forceinline__ int upper_bound(const Sorted& c, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(x < c[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The k-th smallest (from 0) of the deviations |c[i] - med|, i in [0, end),
// where c[i] < med exactly for i < p.  Left of p the deviations fall, from
// p on they rise: two sorted runs, A(i) = |c[p-1-i] - med| and
// B(j) = |c[p+j] - med|.  The k-th of their union is found by bisecting how
// many of the first k + 1 come from A (ops.clip_combine.
// mad_ranks_by_search states the rule); a rank of a multiset does not
// depend on how ties were ordered, so this is the value the sorted
// deviations hold at rank k.  Needs k < end.
__device__ __forceinline__ float kth_dev(const Sorted& c, int p, int end,
                                         float med, int k) {
  const int na = p, nb = end - p;
  int lo = max(0, k + 1 - nb), hi = min(k + 1, na);
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (fabsf(c[p - 1 - i] - med) < fabsf(c[p + k - i] - med)) lo = i + 1;
    else hi = i;
  }
  const int j = k + 1 - lo;
  const float a = lo > 0 ? fabsf(c[p - lo] - med) : 0.0f;
  const float b = j > 0 ? fabsf(c[p + j - 1] - med) : 0.0f;
  return fmaxf(a, b);
}

// Monotone unsigned keys of floats: key(x) < key(y) exactly when x < y,
// with -0 and +0 one key (+0's).  float_of_key inverts it.
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned u = __float_as_uint(x == 0.0f ? 0.0f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of_key(unsigned t) {
  return __uint_as_float((t & 0x80000000u) ? (t & 0x7fffffffu) : ~t);
}

}  // namespace
