// The sigma-clip combines' sort: an ascending bitonic network over one
// thread's column of shared memory, shared by K2 (warp_combine.cu) and K3
// (clip_combine.cu).  An insertion sort's trip counts depend on the data,
// so the 32 lanes of a warp wait for the slowest; a network does the same
// compare-exchanges for every lane.  Stages of partner distance < 16 run
// in registers on 16-sample blocks, the others in shared memory.  The
// comparator only permutes its two values, so +-0 and NaN are never
// duplicated and the sorted column holds exactly the samples it was given.
// kernels._library hashes this header into every library's name.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SB = 16;  // samples per register block of the sort

// compare-exchange that permutes (never duplicates) its two values
__device__ __forceinline__ void cswap(float& a, float& b) {
  bool s = b < a;
  float lo = s ? b : a;
  b = s ? a : b;
  a = lo;
}

// stages k = 2..16 of the network on one register block: a full sort
__device__ __forceinline__ void sort16(float (&v)[SB]) {
#pragma unroll
  for (int k = 2; k <= SB; k <<= 1) {
#pragma unroll
    for (int i = 0; i < SB; ++i)
      if (!(i & (k >> 1))) cswap(v[i], v[i ^ (k - 1)]);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < SB; ++i)
        if (!(i & j)) cswap(v[i], v[i ^ j]);
  }
}

// stages j = 8, 4, 2, 1 of a merge, on one register block
__device__ __forceinline__ void merge16(float (&v)[SB]) {
#pragma unroll
  for (int j = SB >> 1; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < SB; ++i)
      if (!(i & j)) cswap(v[i], v[i ^ j]);
}

// Sort this thread's column col[0, n) (stride nt) ascending.  The
// network runs on n padded to a power of two P >= 16 with +inf; every
// comparator puts its minimum at the lower index, so the padding never
// moves and a comparator that touches it is skipped.
template <bool FULL>
__device__ __forceinline__ void sort_blocks(float* col, int n, int nt) {
  const float INF = __int_as_float(0x7f800000);
  for (int b0 = 0; b0 < n; b0 += SB) {
    float v[SB];
#pragma unroll
    for (int q = 0; q < SB; ++q) v[q] = b0 + q < n ? col[(b0 + q) * nt] : INF;
    if (FULL)
      sort16(v);
    else
      merge16(v);
#pragma unroll
    for (int q = 0; q < SB; ++q)
      if (b0 + q < n) col[(b0 + q) * nt] = v[q];
  }
}

__device__ void sort_column(float* col, int n, int nt) {
  sort_blocks<true>(col, n, nt);
  int P = SB;
  while (P < n) P <<= 1;
  for (int k = 2 * SB; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= SB; j >>= 1) {
      const bool flip = j == (k >> 1);  // first stage of a merge: mirror
#pragma unroll 4
      for (int t = 0; t < P / 2; ++t) {
        int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        int l = flip ? (i ^ (k - 1)) : (i + j);
        if (l < n) {
          float a = col[i * nt], b = col[l * nt];
          cswap(a, b);
          col[i * nt] = a;
          col[l * nt] = b;
        }
      }
    }
    sort_blocks<false>(col, n, nt);
  }
}

}  // namespace
