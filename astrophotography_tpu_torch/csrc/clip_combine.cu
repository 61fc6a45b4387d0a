// K3: masked sigma-clipped mean over the frame axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel astrophotography_tpu/ops/pallas_combine.py
// (pallas_sigma_clip_combine, body _combine_kernel).  Per output pixel of
// an (N, H, W) float32 stack with a uint8 validity mask: sort the samples
// (invalid ones are +3.4e38 and sort last), median = 0.5 * (lo + hi) at
// ranks max((c-1)/2, 0) and c/2 of the c valid samples; the MAD is the
// same two ranks of the deviations |x - med| (invalid ones +3.4e38);
// std = 1.4826 * MAD; keep valid samples inside
// [med - sigma_lo * std, med + sigma_hi * std]; the result is
// acc / max(cnt, 1) with acc += (keep ? x : 0) summed in frame order, or
// NaN where nothing is kept.  (The reference writes x * keep; XLA compiles
// a product with a converted predicate to that select, so a masked inf or
// NaN sample adds 0.)
//
// What bounds it on the H100: device memory.  The least time is the
// stack, the mask and the image once at 3.35 TB/s, 0.31 ms at
// 24 x 2048 x 4096 with a mask; the ~10 operations per sample of a
// sorting network stay under that at the f32 rate.  The first design read
// the stack and the mask three times (the sorted column had lost frame
// order) and ran two insertion sorts per pixel, whose data-dependent trip
// counts made the 32 lanes of a warp wait for the slowest: 2.1 ms at that
// shape, of which the sorts were 1.25 ms and the re-reads 0.43 ms.
//
// Design.  One thread per output pixel, neighbouring threads on
// neighbouring pixels, so each frame's row read is coalesced.  Every
// sample and every mask byte is read once.  The thread keeps two copies
// of its pixel's samples: one in frame order, where an invalid sample is
// stored as NaN (it fails both clip tests, as the twin's `valid &` does),
// and one to sort, where it is +3.4e38.  The sort is a bitonic network
// (the comparator only permutes).  There is no second sort: the
// deviations of the sorted samples fall to the median and rise again, so
// they are two monotone runs, and the MAD's two ranks come from merging
// them.  |x - med| has the same value wherever x stands, and a rank of a
// multiset does not depend on how it was ordered, so the bits are the
// twin's.  The clip and the frame-order sum then read the first copy.
//
// Routes, chosen by N in kernels._clip_route (clip_combine_launch takes
// the route the wrapper names):
//  * N <= 8, 16, 24 (the unfused path's N) and 32 ('regs8' .. 'regs32'):
//    the copy to sort lives in M = 8, 16, 24 or 32 registers, N padded
//    to M with +inf; the frame-order copy is the thread's column of
//    shared memory (12 KB a block at M = 24), which keeps the registers
//    near 55 and the SM at 8-9 blocks of 128 threads to hide the loads
//    with.  The network is that of the next power of two, fully
//    unrolled, without the comparators whose upper partner would be
//    padding past M (every comparator puts its minimum at the lower
//    index, so that padding never moves): 168 comparators at M = 24
//    against 240 at 32, two instructions each (min, max).  The
//    deviations of the sorted registers form one bitonic sequence, which
//    a single bitonic merge (log2 P stages, 52 comparators at M = 24)
//    sorts; the ranks are picked with a select tree, so no register
//    array is indexed at run time.
//  * 'smem' (33 frames to kernels._CLIP_COLS_FRAMES): one thread per
//    pixel in blocks of 128, both copies columns of shared memory (2 x N
//    x 4 B per thread), the thread sorts its column alone with
//    sort_column of sort_network.cuh.  Past ~200 frames its blocks would
//    have to shrink, and 'cols' wins from 192 frames (the route sweep of
//    chip_smoke.py's deep phase).
//  * 'cols' (kernels._CLIP_COLS_FRAMES up to _CLIP_COLS_REACH): a block of W
//    warps owns W neighbouring pixels of a row (W = 8, 4, 2 or 1, the
//    most whose columns fit).  It reads their N x W samples and mask
//    bytes once, W x 4 B per frame row, into two columns per pixel of
//    shared memory (frame order with NaN for an invalid sample, and a
//    copy to sort with +3.4e38); each warp sorts one pixel's copy with
//    all 32 lanes (warp_sort.cuh: registers, shuffles, and on-chip
//    merges past 1024 samples), finds the median at its ranks and the
//    MAD by bisecting the two runs of deviations around it (kth_dev);
//    then W lanes of one warp sum the W frame-order copies, one pixel
//    each (the sum is serial, so one instruction stream should carry
//    several).  No scratch: the stack and the mask are read once and
//    nothing else touches device memory but the image.
//  * 'select' (past the reach, where one pixel's two columns outgrow a
//    block's shared memory; clip_select_kernel): a block of 8 warps owns
//    32 neighbouring pixels of a row, so every frame row it reads is one
//    128 B line.  Each rank pair (the median's lo, hi; the MAD's) is an
//    exact MSB-first radix select over the 32-bit monotone keys, one
//    8-bit digit a pass with per-pixel histograms in shared memory (the
//    two ranks share the walk until hi leaves lo's bucket, then hi is the
//    least key of its bucket, taken with an atomicMin in the next pass;
//    ops/clip_combine.pair_by_radix states the rule), and the clip pass
//    stages chunks of frame rows in shared memory for one warp's serial
//    frame-order sums: 9 coalesced passes over the stack whatever the
//    data, no limit on N but the card's memory.  H100: 241.5-243.3 ms at
//    30000 x 480 x 640 masked (46.1 GB; bisecting each rank over the
//    stack, ~130 uncoalesced passes, took 8642 ms), 17.6x the 13.8 ms
//    bound: the 9 passes would take 124 ms at 3.35 TB/s, so they move
//    their bytes at about half the rate.
// What is left over the bound at N = 24 is the load phase of a
// thread-per-pixel layout (tools/k1_variants.py: without either network
// the kernel is only a fifth faster); on 'cols' at 1200 x 256 x 1024
// masked (7.4 ms, bound 0.47) the warps' sorts take ~3.2 ms, the serial
// frame-order sums ~1.6 and the loads with the rest ~2.6
// (tools/cols_variants.py, H100).
//
// Every value operation rounds op by op (__fmul_rn / __fadd_rn /
// __fsub_rn, IEEE division), in the plain twin's order, so kernel and twin
// agree bit for bit: a contraction would move a clip bound by an ulp and
// flip samples that sit on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_network.cuh"  // sort_column: the 'smem' route
#include "warp_sort.cuh"     // sort_col and the ranks: 'cols'

namespace {

constexpr int NT = 128;  // threads per block of the register routes
constexpr float BIG = 3.4e38f;
constexpr float MAD_TO_STD = 1.482602218505602f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// compare-exchange of the register networks: two instructions.  min and
// max order -0 below +0, so they permute their operands like cswap; they
// would drop a NaN, but a valid NaN sample is outside the contract (the
// twin's sort and any comparison network place it differently) and an
// invalid one never reaches the networks.
__device__ __forceinline__ void cswap_mm(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__host__ __device__ constexpr int pow2_at_least(int m) {
  return m <= 1 ? 1 : 2 * pow2_at_least((m + 1) / 2);
}

// ascending bitonic sort of M registers: the network of P = the next power
// of two, without the comparators that would touch the padding [M, P)
template <int M>
__device__ __forceinline__ void sort_regs(float (&v)[M]) {
  constexpr int P = pow2_at_least(M);
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (!(i & (k >> 1)) && (i ^ (k - 1)) < M) cswap_mm(v[i], v[i ^ (k - 1)]);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < M; ++i)
        if (!(i & j) && (i ^ j) < M) cswap_mm(v[i], v[i ^ j]);
  }
}

// bitonic merge: sorts M registers that fall and then rise (with the
// padding [M, P) standing for a maximum) in log2 P stages
template <int M>
__device__ __forceinline__ void merge_regs(float (&v)[M]) {
  constexpr int P = pow2_at_least(M);
#pragma unroll
  for (int j = P >> 1; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (!(i & j) && (i ^ j) < M) cswap_mm(v[i], v[i ^ j]);
}

// v[k], k < M, without indexing the registers at run time: a select tree
// over the bits of k
template <int M>
__device__ __forceinline__ float pick(const float (&v)[M], int k) {
  constexpr int P = pow2_at_least(M);
  float r[P];
#pragma unroll
  for (int i = 0; i < P; ++i) r[i] = v[i < M ? i : M - 1];
#pragma unroll
  for (int bit = 1; bit < P; bit <<= 1) {
    const bool up = (k & bit) != 0;
#pragma unroll
    for (int i = 0; i + bit < P; i += 2 * bit) r[i] = up ? r[i + bit] : r[i];
  }
  return r[0];
}

// the clip bounds and the result, from the median and the MAD
struct Clip {
  float lo, hi;
  __device__ __forceinline__ Clip(float med, float mad, float sigma_lo,
                                  float sigma_hi) {
    const float sdev = mul(MAD_TO_STD, mad);
    lo = sub(med, mul(sigma_lo, sdev));
    hi = add(med, mul(sigma_hi, sdev));
  }
  // one sample in frame order; NaN (an invalid sample) is never kept.
  // The count is an integer: the twin's float count of ones is exact up
  // to 2^24 frames, so the quotient is the same.
  __device__ __forceinline__ void take(float s, float& acc, int& cnt) const {
    const bool keep = s >= lo && s <= hi;
    acc = add(acc, keep ? s : 0.0f);
    cnt += keep;
  }
  static __device__ __forceinline__ float result(float acc, int cnt) {
    return cnt > 0 ? __fdiv_rn(acc, (float)cnt) : __int_as_float(0x7fc00000);
  }
};

// N <= M: the copy to sort in registers, the frame-order copy in the
// thread's column of shared memory ([M][NT]: 12 KB a block at M = 24), so
// that registers (about 60) leave the SM 8 blocks to hide the loads with
template <int M>
__global__ void __launch_bounds__(NT)
clip_regs_kernel(const float* __restrict__ stack,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int n, int h, int w, float sigma_lo, float sigma_hi) {
  __shared__ float ord_cols[M * NT];
  const float INF = __int_as_float(0x7f800000);
  const float QNAN = __int_as_float(0x7fc00000);
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= w) return;  // no block-wide sync below
  float* ord = ord_cols + threadIdx.x;
  const size_t plane = (size_t)h * w;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t pix = (size_t)y * w + x;
    float srt[M];
    int count = 0;
#pragma unroll
    for (int f = 0; f < M; ++f) {
      srt[f] = INF;
      if (f < n) {
        const bool v = mask == nullptr || mask[f * plane + pix] != 0;
        const float s = stack[f * plane + pix];
        ord[f * NT] = v ? s : QNAN;
        srt[f] = v ? s : BIG;
        count += v;
      }
    }
    sort_regs<M>(srt);
    const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
    const float med = mul(0.5f, add(pick<M>(srt, lo), pick<M>(srt, hi)));
    // deviations of the sorted samples: falling to the median, rising
    // after it, +3.4e38 from the first invalid one on
#pragma unroll
    for (int i = 0; i < M; ++i)
      srt[i] = i < count ? fabsf(sub(srt[i], med)) : BIG;
    merge_regs<M>(srt);
    const float mad = mul(0.5f, add(pick<M>(srt, lo), pick<M>(srt, hi)));
    const Clip clip(med, mad, sigma_lo, sigma_hi);
    float acc = 0.0f;
    int cnt = 0;
#pragma unroll
    for (int f = 0; f < M; ++f)
      if (f < n) clip.take(ord[f * NT], acc, cnt);
    out[pix] = Clip::result(acc, cnt);
  }
}

// 'smem': both copies [n][nt] each, nt = blockDim.x, in shared memory;
// one thread per pixel
__global__ void __launch_bounds__(NT)
clip_smem_kernel(const float* __restrict__ stack,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int n, int h, int w, float sigma_lo, float sigma_hi) {
  extern __shared__ float smem_cols[];
  const float QNAN = __int_as_float(0x7fc00000);
  const int nt = blockDim.x;
  const int x = blockIdx.x * nt + threadIdx.x;
  if (x >= w) return;  // no block-wide sync below
  float* ord = smem_cols + threadIdx.x;
  float* srt = smem_cols + (size_t)n * nt + threadIdx.x;
  const size_t plane = (size_t)h * w;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t pix = (size_t)y * w + x;
    int count = 0;
#pragma unroll 8
    for (int f = 0; f < n; ++f) {
      const bool v = mask == nullptr || mask[f * plane + pix] != 0;
      const float s = stack[f * plane + pix];
      ord[f * nt] = v ? s : QNAN;
      srt[f * nt] = v ? s : BIG;
      count += v;
    }
    sort_column(srt, n, nt);
    const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
    const float med = mul(0.5f, add(srt[lo * nt], srt[hi * nt]));
    // merge the run left of p (walking down) with the run from p (walking
    // up) over the valid samples; past them a deviation is +3.4e38
    int p = 0;
    while (p < count && srt[p * nt] < med) ++p;
    int a = p - 1, b = p;
    float d_lo = BIG, d_hi = BIG;
    for (int k = 0; k <= hi; ++k) {
      const float da = a >= 0 ? fabsf(sub(srt[a * nt], med)) : BIG;
      const float db = b < count ? fabsf(sub(srt[b * nt], med)) : BIG;
      float d;
      if (da <= db) {
        d = da;
        --a;
      } else {
        d = db;
        ++b;
      }
      if (k == lo) d_lo = d;
      if (k == hi) d_hi = d;
    }
    const Clip clip(med, mul(0.5f, add(d_lo, d_hi)), sigma_lo, sigma_hi);
    float acc = 0.0f;
    int cnt = 0;
    for (int f = 0; f < n; ++f) clip.take(ord[f * nt], acc, cnt);
    out[pix] = Clip::result(acc, cnt);
  }
}

// 'cols': words of one pixel's column (n rounded up to 32, plus a pad
// that puts the W columns of a tile load on distinct banks); kernels.py
// mirrors it (_clip_cols_smem_bytes)
__host__ __device__ inline int cols_stride(int n, int W) {
  const int pad = W >= 8 ? 4 : W >= 4 ? 8 : W >= 2 ? 16 : 0;
  return ((n + 31) & ~31) + pad;
}
__host__ __device__ inline size_t cols_smem_bytes(int n, int W) {
  return sizeof(float) * (2 * (size_t)W * cols_stride(n, W) + W * W + 2 * W);
}

// 'cols': a block of (32, W) threads, W in {1, 2, 4, 8}, owns pixels
// blockIdx.x * W + [0, W) of a row; shared memory holds ord [W][CS], srt
// [W][CS], each warp's count of valid samples per pixel [W][W] and each
// pixel's clip bounds [W][2].  Warp w sorts pixel w's copy and finds its
// bounds; then lane p of warp 0 sums pixel p's frame-order column, so
// that one instruction stream carries W pixels' serial sums.
__global__ void __launch_bounds__(256, 2)
clip_warp_kernel(const float* __restrict__ stack,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int n, int h, int w, float sigma_lo, float sigma_hi) {
  extern __shared__ float smem_cols[];
  const float QNAN = __int_as_float(0x7fc00000);
  const int W = blockDim.y, lane = threadIdx.x, wp = threadIdx.y;
  const int tid = wp * 32 + lane;
  const int CS = cols_stride(n, W), s = col_shift(n);
  float* ord = smem_cols;
  float* srt = ord + (size_t)W * CS;
  int* parts = reinterpret_cast<int*>(srt + (size_t)W * CS);
  float* bounds = reinterpret_cast<float*>(parts + W * W);
  const int x0 = blockIdx.x * W;
  // the load: thread tid takes frames tid / W + 32 k of pixel p (the
  // stride 32 W keeps p fixed), so a warp reads 32 / W frame rows of W
  // neighbouring pixels at once
  const int p = lane % W;
  const bool in = x0 + p < w;
  const size_t plane = (size_t)h * w;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    __syncthreads();  // the previous row's columns are read
    const size_t pix = (size_t)y * w + x0 + p;
    int cnt = 0;
#pragma unroll 8
    for (int f = tid / W; f < n; f += 32) {
      float v = QNAN, sv = BIG;
      if (in) {
        const bool ok = mask == nullptr || mask[f * plane + pix] != 0;
        const float sx = stack[f * plane + pix];
        v = ok ? sx : QNAN;
        sv = ok ? sx : BIG;
        cnt += ok;
      }
      ord[p * CS + swz(f, s)] = v;
      srt[p * CS + swz(f, s)] = sv;
    }
    for (int m = 16; m >= W; m >>= 1) cnt += __shfl_xor_sync(WARP_ALL, cnt, m);
    if (lane < W) parts[wp * W + lane] = cnt;
    __syncthreads();
    int count = 0;
    for (int q = 0; q < W; ++q) count += parts[q * W + wp];
    if (x0 + wp < w && count > 0) {  // warp-uniform
      float* col = srt + (size_t)wp * CS;
      sort_col(col, n, lane);
      const Sorted c{col, s};
      const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
      const float med = mul(0.5f, add(c[lo], c[hi]));
      // the valid samples are the first `count` of the sorted copy; the
      // deviations of those below the median fall, the others rise
      const int pm = lower_bound(c, count, med);
      const float mad = mul(0.5f, add(kth_dev(c, pm, count, med, lo),
                                      kth_dev(c, pm, count, med, hi)));
      const Clip clip(med, mad, sigma_lo, sigma_hi);
      if (lane == 0) {
        bounds[2 * wp] = clip.lo;
        bounds[2 * wp + 1] = clip.hi;
      }
    }
    __syncthreads();
    if (wp == 0 && lane < W && x0 + lane < w) {
      int count_p = 0;
      for (int q = 0; q < W; ++q) count_p += parts[q * W + lane];
      float res = __int_as_float(0x7fc00000);
      if (count_p > 0) {
        Clip clip(0.0f, 0.0f, 0.0f, 0.0f);
        clip.lo = bounds[2 * lane];
        clip.hi = bounds[2 * lane + 1];
        float acc = 0.0f;
        int kept = 0;
        const float* o = ord + (size_t)lane * CS;
#pragma unroll 8
        for (int f = 0; f < n; ++f) clip.take(o[swz(f, s)], acc, kept);
        res = Clip::result(acc, kept);
      }
      out[(size_t)y * w + x0 + lane] = res;
    }
  }
}

// 'select': a block of SEL_WARPS warps owns SEL_PIX = 32 neighbouring
// pixels of a row, lane p on pixel p, so each frame row a warp reads is one
// 128 B line of the stack and 32 B of the mask.  Each rank is an exact
// MSB-first radix select over the 32-bit monotone keys (float_key), one
// 8-bit digit a pass: a pass counts, per pixel, the digits of the samples
// whose key matches the digits found so far (a histogram [256][SEL_PIX] in
// shared memory, bank = pixel), then one warp per pixel walks the
// histogram to the bucket that holds the rank.  The median's two ranks
// lo <= hi = lo or lo + 1 share the walk while they share a bucket; where
// hi leaves lo's bucket it is the first sample of the next non-empty one,
// the least key with that prefix, which the next pass takes with an
// atomicMin beside the counts (a split at the last digit names the key
// itself).  Invalid samples are key(+3.4e38), as in the twin's sort, so
// the ranks are the sorted column's elements.  Four passes give the
// median, four more the MAD's two ranks of |x - med| (invalid +3.4e38),
// and the clip pass sums the kept samples in frame order: the block stages
// SEL_CHUNK frame rows at a time in shared memory (two buffers, every warp
// loading) and lane p of warp 0 sums pixel p's, serially, while the next
// chunk's loads are in flight.  Nine passes over the stack, every one
// coalesced, whatever the data; the first also counts the valid samples.
constexpr int SEL_PIX = 32, SEL_WARPS = 8, SEL_BINS = 256, SEL_CHUNK = 64;
constexpr int SEL_UNROLL = 8;  // frame rows a thread has in flight
constexpr unsigned SEL_NO_KEY = 0xffffffffu;

// per-pixel state of one rank pair's select (in shared memory)
struct SelState {
  unsigned pa[SEL_PIX];    // lo's digits so far (the whole key at the end)
  unsigned ra[SEL_PIX];    // lo's rank among the keys with that prefix
  int off[SEL_PIX];        // hi - lo (0 or 1)
  unsigned pb[SEL_PIX];    // hi's prefix once it left (its key when done)
  int bmode[SEL_PIX];      // 0 shares lo's walk, 1 takes a min, 2 done
  unsigned hmin[SEL_PIX];  // the min of the keys with hi's prefix
};

struct SelShared {
  union {
    unsigned hist[SEL_BINS * SEL_PIX];    // the digit counts, [bin][pixel]
    float chunk[2][SEL_CHUNK * SEL_PIX];  // the clip pass's frame rows
  };
  SelState st;
  int count[SEL_PIX];
  float med[SEL_PIX], lo_b[SEL_PIX], hi_b[SEL_PIX];
};

// One counting pass at digit `level` (0..3) over the pixel's samples:
// their keys are float_key(valid ? value : BIG), or of the deviations
// |value - med| (DEV); each thread takes frames wp, wp + SEL_WARPS, ...
// of pixel `lane`.  The first pass also counts the valid samples.
template <bool DEV>
__device__ __forceinline__ void sel_pass(SelShared& S, const float* stack,
                                         const uint8_t* mask, size_t plane,
                                         size_t pix, bool in, int n, int level,
                                         int lane, int wp) {
  const unsigned pa = S.st.pa[lane];
  const bool tmin = level > 0 && S.st.bmode[lane] == 1;
  const unsigned pb = S.st.pb[lane];
  const float med = DEV ? S.med[lane] : 0.0f;
  const int up = 32 - 8 * level, dn = 24 - 8 * level;
  int valid_n = 0;
  if (in) {
    for (int f0 = wp; f0 < n; f0 += SEL_WARPS * SEL_UNROLL) {
      float v[SEL_UNROLL];
      bool ok[SEL_UNROLL];
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        const int f = f0 + u * SEL_WARPS;
        ok[u] = false;
        v[u] = BIG;
        if (f < n) {
          ok[u] = mask == nullptr || mask[f * plane + pix] != 0;
          v[u] = stack[f * plane + pix];
        }
      }
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        if (f0 + u * SEL_WARPS >= n) break;
        valid_n += ok[u];
        const float x = !ok[u] ? BIG : DEV ? fabsf(sub(v[u], med)) : v[u];
        const unsigned key = float_key(x);
        // level 0: every key matches (a shift by 32 is undefined)
        if (level == 0 || (key >> up) == pa)
          atomicAdd(&S.hist[((key >> dn) & 0xffu) * SEL_PIX + lane], 1u);
        if (tmin && (key >> up) == pb) atomicMin(&S.st.hmin[lane], key);
      }
    }
  }
  if (!DEV && level == 0) atomicAdd(&S.count[lane], valid_n);
}

// After the pass at digit `level`: warp wp walks the histograms of pixels
// wp, wp + SEL_WARPS, ... (those inside the image) to the buckets of the
// ranks, and zeroes them for the next pass.  At level 0 the ranks are the
// median's, lo = max((count - 1) / 2, 0) and hi = count / 2 (the MAD's are
// the same two).
__device__ __forceinline__ void sel_walk(SelShared& S, int level, int x0,
                                         int w, int lane, int wp) {
  for (int q = wp; q < SEL_PIX; q += SEL_WARPS) {
    if (x0 + q >= w) continue;  // warp-uniform
    unsigned c[8];
    unsigned sum = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      c[b] = S.hist[(lane * 8 + b) * SEL_PIX + q];
      S.hist[(lane * 8 + b) * SEL_PIX + q] = 0u;
      sum += c[b];
    }
    unsigned incl = sum;  // inclusive scan over the lanes' groups of 8 bins
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned t = __shfl_up_sync(WARP_ALL, incl, d);
      if (lane >= d) incl += t;
    }
    const unsigned excl = incl - sum;
    // the bucket of rank r (r below the histogram's total): its digit and
    // r's rank among its keys
    auto find = [&](unsigned r, unsigned& digit, unsigned& inner) {
      const unsigned owner = __ballot_sync(WARP_ALL, excl <= r && r < incl);
      const int src = __ffs(owner) - 1;
      unsigned d = 0, k = 0, acc = excl;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (acc <= r && r < acc + c[b]) {
          d = lane * 8 + b;
          k = r - acc;
        }
        acc += c[b];
      }
      digit = __shfl_sync(WARP_ALL, d, src);
      inner = __shfl_sync(WARP_ALL, k, src);
    };
    // the pair's state: at level 0 the ranks, from the count
    unsigned pa = 0u, ra;
    int off, mode = 0;
    if (level == 0) {
      const int cnt = S.count[q];
      ra = max((cnt - 1) / 2, 0);
      off = max(cnt / 2, 0) - (int)ra;
    } else {
      pa = S.st.pa[q];
      ra = S.st.ra[q];
      off = S.st.off[q];
      mode = S.st.bmode[q];
    }
    const bool shared_b = mode == 0 && off == 1;
    unsigned da, ia, db, ib;
    find(ra, da, ia);
    find(shared_b ? ra + 1 : ra, db, ib);
    if (lane == 0) {
      const unsigned prefix = pa << 8;
      if (mode == 1) {  // this pass took hi's least key
        S.st.pb[q] = S.st.hmin[q];
        mode = 2;
      } else if (shared_b && db != da) {
        // hi is the first key of the next non-empty bucket (ib == 0)
        S.st.pb[q] = prefix | db;
        S.st.hmin[q] = SEL_NO_KEY;
        mode = level < 3 ? 1 : 2;
      }
      S.st.pa[q] = prefix | da;
      S.st.ra[q] = ia;
      S.st.off[q] = off;
      S.st.bmode[q] = mode;
    }
    __syncwarp();
  }
}

// the pair's two keys, as floats, after the four digits
__device__ __forceinline__ float sel_pair(const SelShared& S, int q) {
  const float a = float_of_key(S.st.pa[q]);
  const float b = S.st.bmode[q] == 2 ? float_of_key(S.st.pb[q]) : a;
  return mul(0.5f, add(a, b));
}

__global__ void __launch_bounds__(SEL_PIX * SEL_WARPS)
clip_select_kernel(const float* __restrict__ stack,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int n, int h, int w, float sigma_lo, float sigma_hi) {
  __shared__ SelShared S;
  const float QNAN = __int_as_float(0x7fc00000);
  const int lane = threadIdx.x, wp = threadIdx.y;
  const int tid = wp * SEL_PIX + lane;
  const int x0 = blockIdx.x * SEL_PIX, x = x0 + lane;
  const bool in = x < w;
  const size_t plane = (size_t)h * w;
  for (int i = tid; i < SEL_BINS * SEL_PIX; i += SEL_PIX * SEL_WARPS)
    S.hist[i] = 0u;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t pix = (size_t)y * w + x;
    if (wp == 0) S.count[lane] = 0;
    __syncthreads();  // the histograms are zero, the last row's sums done
    // the median: four digits of the pair lo, hi
    for (int level = 0; level < 4; ++level) {
      sel_pass<false>(S, stack, mask, plane, pix, in, n, level, lane, wp);
      __syncthreads();
      sel_walk(S, level, x0, w, lane, wp);
      __syncthreads();
    }
    if (wp == 0) S.med[lane] = sel_pair(S, lane);
    __syncthreads();
    // the MAD: the same ranks of the deviations
    for (int level = 0; level < 4; ++level) {
      sel_pass<true>(S, stack, mask, plane, pix, in, n, level, lane, wp);
      __syncthreads();
      sel_walk(S, level, x0, w, lane, wp);
      __syncthreads();
    }
    if (wp == 0) {
      const Clip clip(S.med[lane], sel_pair(S, lane), sigma_lo, sigma_hi);
      S.lo_b[lane] = clip.lo;
      S.hi_b[lane] = clip.hi;
    }
    __syncthreads();  // the histograms are free: the clip pass's buffers
    // the clip pass: chunks of SEL_CHUNK frame rows, thread (lane, wp)
    // staging rows wp, wp + SEL_WARPS, ... of each (NaN where invalid)
    Clip clip(0.0f, 0.0f, 0.0f, 0.0f);
    clip.lo = S.lo_b[lane];
    clip.hi = S.hi_b[lane];
    constexpr int PER = SEL_CHUNK / SEL_WARPS;
    float v[PER];
    auto fetch = [&](int f0) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int f = f0 + wp + u * SEL_WARPS;
        v[u] = QNAN;
        if (in && f < n) {
          const bool ok = mask == nullptr || mask[f * plane + pix] != 0;
          const float s = stack[f * plane + pix];
          v[u] = ok ? s : QNAN;
        }
      }
    };
    auto put = [&](int b) {
#pragma unroll
      for (int u = 0; u < PER; ++u)
        S.chunk[b][(wp + u * SEL_WARPS) * SEL_PIX + lane] = v[u];
    };
    float acc = 0.0f;
    int kept = 0;
    const int chunks = (n + SEL_CHUNK - 1) / SEL_CHUNK;
    fetch(0);
    put(0);
    __syncthreads();
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) fetch((k + 1) * SEL_CHUNK);
      if (wp == 0) {
        const float* rows = S.chunk[k & 1];
        const int m = min(SEL_CHUNK, n - k * SEL_CHUNK);
#pragma unroll 8
        for (int f = 0; f < m; ++f) clip.take(rows[f * SEL_PIX + lane], acc, kept);
      }
      if (k + 1 < chunks) put((k + 1) & 1);
      __syncthreads();
    }
    if (wp == 0 && in) out[pix] = Clip::result(acc, kept);
    __syncthreads();  // the buffers are the histograms again: zero them
    for (int i = tid; i < SEL_BINS * SEL_PIX; i += SEL_PIX * SEL_WARPS)
      S.hist[i] = 0u;
  }
}

// the routes clip_combine_launch takes (kernels._CLIP_ROUTE_CODES)
enum { ROUTE_REGS = 0, ROUTE_SMEM = 1, ROUTE_COLS = 2, ROUTE_SELECT = 3 };

}  // namespace

// route: ROUTE_REGS (n <= 32: the register network for 8, 16, 24 or 32
// frames), ROUTE_SMEM (param: threads per block, 128, with 2 * n * 128 *
// 4 bytes within a block's limit), ROUTE_COLS
// (param: warps per block, 1, 2, 4 or 8, with cols_smem_bytes within the
// limit) or ROUTE_SELECT.
extern "C" int clip_combine_launch(const float* stack, const uint8_t* mask,
                                   float* out, int n, int h, int w,
                                   float sigma_lo, float sigma_hi, int route,
                                   int param, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = h < 65535 ? h : 65535;
  if (route == ROUTE_REGS) {
    if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((w + NT - 1) / NT, rows);
    if (n <= 8)
      clip_regs_kernel<8><<<grid, NT, 0, s>>>(stack, mask, out, n, h, w,
                                              sigma_lo, sigma_hi);
    else if (n <= 16)
      clip_regs_kernel<16><<<grid, NT, 0, s>>>(stack, mask, out, n, h, w,
                                               sigma_lo, sigma_hi);
    else if (n <= 24)
      clip_regs_kernel<24><<<grid, NT, 0, s>>>(stack, mask, out, n, h, w,
                                               sigma_lo, sigma_hi);
    else
      clip_regs_kernel<32><<<grid, NT, 0, s>>>(stack, mask, out, n, h, w,
                                               sigma_lo, sigma_hi);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == ROUTE_SELECT) {
    dim3 grid((w + SEL_PIX - 1) / SEL_PIX, rows);
    clip_select_kernel<<<grid, dim3(SEL_PIX, SEL_WARPS), 0, s>>>(
        stack, mask, out, n, h, w, sigma_lo, sigma_hi);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == ROUTE_COLS) {
    const int W = param;
    if (W != 1 && W != 2 && W != 4 && W != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cols_smem_bytes(n, W);
    cudaError_t err = cudaFuncSetAttribute(
        clip_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((w + W - 1) / W, rows);
    clip_warp_kernel<<<grid, dim3(32, W), smem, s>>>(stack, mask, out, n, h, w,
                                                     sigma_lo, sigma_hi);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != ROUTE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = param;
  if (nt != NT) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = sizeof(float) * 2 * (size_t)n * nt;
  cudaError_t err = cudaFuncSetAttribute(
      clip_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + nt - 1) / nt, rows);
  clip_smem_kernel<<<grid, nt, smem, s>>>(stack, mask, out, n, h, w, sigma_lo,
                                          sigma_hi);
  return static_cast<int>(cudaGetLastError());
}
