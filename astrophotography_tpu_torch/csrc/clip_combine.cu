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
// Three routes, chosen by N in clip_combine_launch (kernels._clip_route
// mirrors the choice):
//  * N <= 8, 16, 24 (the unfused path's N) and 32: the copy to sort lives
//    in M = 8, 16, 24 or 32 registers, N padded to M with +inf; the
//    frame-order copy is the thread's column of shared memory (12 KB a
//    block at M = 24), which keeps the registers near 55 and the SM at
//    8-9 blocks of 128 threads to hide the loads with.  The network is
//    that of the next power of two, fully unrolled, without the
//    comparators whose upper partner would be padding past M (every
//    comparator puts its minimum at the lower index, so that padding
//    never moves): 168 comparators at M = 24 against 240 at 32, two
//    instructions each (min, max).  The deviations of the sorted
//    registers form one bitonic sequence, which a single bitonic merge
//    (log2 P stages, 52 comparators at M = 24) sorts; the ranks are
//    picked with a select tree, so no register array is indexed at run
//    time.
//  * 32 < N <= 908: both copies are columns of shared memory (2 x N x 4 B
//    per thread); the sort is sort_column of sort_network.cuh, as in K2,
//    and the two runs are merged by walking two indices from the median
//    outwards, at most c/2 + 1 steps.  The block has 128 threads up to
//    N = 227, 64 up to 454 and 32 up to 908 (kernels._clip_block_threads),
//    so that the two columns fit the 227 KB a block may use.
//  * N > 908 ('global'): the same code with both columns in a scratch of
//    device memory that the wrapper allocates, one slot of 2 x N x 128
//    floats per block of 128 threads.  The grid holds only as many
//    blocks as the card keeps resident (clip_combine_global_blocks), and
//    they walk the rows, so the scratch does not grow with the image
//    (2 x N x 4 B x 128 threads x the resident blocks).  The same sort and
//    merge, so the
//    route is bit-identical to the twin too; its column traffic goes to
//    device memory, so it is slower per sample than the shared route.
// What is left over the bound at N = 24 is the load phase of a
// thread-per-pixel layout (tools/k1_variants.py: without either network
// the kernel is only a fifth faster); at N = 100 it is the shared-memory
// sort, at two blocks per SM.
//
// Every value operation rounds op by op (__fmul_rn / __fadd_rn /
// __fsub_rn, IEEE division), in the plain twin's order, so kernel and twin
// agree bit for bit: a contraction would move a clip bound by an ulp and
// flip samples that sit on it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_network.cuh"

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

// any N: both copies [n][nt] each, nt = blockDim.x, in shared memory or
// (GLOBAL) in this block's slot of the scratch
template <bool GLOBAL>
__global__ void __launch_bounds__(NT)
clip_cols_kernel(const float* __restrict__ stack,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int n, int h, int w, float sigma_lo, float sigma_hi,
                 float* __restrict__ scratch) {
  extern __shared__ float smem_cols[];
  const float QNAN = __int_as_float(0x7fc00000);
  const int nt = blockDim.x;
  const int x = blockIdx.x * nt + threadIdx.x;
  if (x >= w) return;  // no block-wide sync below
  float* cols = smem_cols;
  if (GLOBAL)
    cols = scratch +
           (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 2 * (size_t)n * nt;
  float* ord = cols + threadIdx.x;
  float* srt = cols + (size_t)n * nt + threadIdx.x;
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

constexpr int SMEM_FRAMES = 908;  // the shared route's limit (32 threads)

}  // namespace

// Blocks of the 'global' route the card keeps resident at once: the grid
// and the scratch slots of that route (kernels.clip_combine_cuda).
extern "C" int clip_combine_global_blocks(void) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, clip_cols_kernel<true>, NT, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// nt: threads per block of the shared-memory route (a multiple of 32, at
// most 128, with 2 * n * nt * 4 bytes within the block's limit); the
// register routes (n <= 32) and the global one (n > 908) always run 128.
// scratch: 2 * n * 128 floats for each of the global route's blocks,
// which are (w + 127) / 128 by grid_rows; null on the other routes.
extern "C" int clip_combine_launch(const float* stack, const uint8_t* mask,
                                   float* out, int n, int h, int w,
                                   float sigma_lo, float sigma_hi, int nt,
                                   float* scratch, int grid_rows,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = h < 65535 ? h : 65535;
  if (n <= 32) {
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
  if (n > SMEM_FRAMES) {
    if (scratch == nullptr || grid_rows < 1 || grid_rows > rows)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((w + NT - 1) / NT, grid_rows);
    clip_cols_kernel<true><<<grid, NT, 0, s>>>(stack, mask, out, n, h, w,
                                               sigma_lo, sigma_hi, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  if (nt < 32 || nt > NT || nt % 32) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = sizeof(float) * 2 * (size_t)n * nt;
  cudaError_t err = cudaFuncSetAttribute(
      clip_cols_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + nt - 1) / nt, rows);
  clip_cols_kernel<false><<<grid, nt, smem, s>>>(stack, mask, out, n, h, w,
                                                 sigma_lo, sigma_hi, nullptr);
  return static_cast<int>(cudaGetLastError());
}
