// K3: masked sigma-clipped mean over the frame axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel astrophotography_tpu/ops/pallas_combine.py
// (pallas_sigma_clip_combine, body _combine_kernel).  Per output pixel of
// an (N, H, W) float32 stack with a uint8 validity mask: sort the samples
// (invalid ones are +3.4e38 and sort last), median = 0.5 * (lo + hi) at
// ranks max((c-1)/2, 0) and c/2 of the c valid samples; sort the
// deviations |x - med| (invalid ones +3.4e38) and take the MAD at the same
// ranks; std = 1.4826 * MAD; keep valid samples inside
// [med - sigma_lo * std, med + sigma_hi * std]; the result is
// acc / max(cnt, 1) with acc += (keep ? x : 0) summed in frame order, or
// NaN where nothing is kept.  (The reference writes x * keep; XLA compiles
// a product with a converted predicate to that select, so a masked inf or
// NaN sample adds 0.)
//
// What bounds it on the H100: device memory.  The stack is read three
// times (samples, deviations, the clip and sum) and the mask twice, all
// coalesced, ~3 GB at 24 x 2048 x 4096 (~1 ms at 3.35 TB/s); the two
// per-pixel insertion sorts cost ~N^2/4 shared-memory moves each, small
// at N = 24.
//
// Design: one thread per output pixel, 128 threads along x per block, so
// each frame's row read is one coalesced 512-byte transaction per warp.
// Each thread keeps its N samples in its own column of shared memory
// (N x 128 x 4 B, bank-conflict free).  The sorted column has lost frame
// order, so the deviation pass and the final sum re-read the samples from
// global memory (L2) in frame order.  Every value operation rounds op by
// op (__fmul_rn / __fadd_rn / __fsub_rn, IEEE division), in the plain
// twin's order, so kernel and twin agree bit for bit: a contraction would
// move a clip bound by an ulp and flip samples that sit on it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr float BIG = 3.4e38f;
constexpr float MAD_TO_STD = 1.482602218505602f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// insertion sort of one thread's column (stride NT)
__device__ __forceinline__ void sort_column(float* col, int n) {
  for (int k = 1; k < n; ++k) {
    float key = col[k * NT];
    int m = k - 1;
    while (m >= 0 && col[m * NT] > key) {
      col[(m + 1) * NT] = col[m * NT];
      --m;
    }
    col[(m + 1) * NT] = key;
  }
}

__global__ void __launch_bounds__(NT)
clip_combine_kernel(const float* __restrict__ stack,
                    const uint8_t* __restrict__ mask, float* __restrict__ out,
                    int n, int h, int w, float sigma_lo, float sigma_hi) {
  extern __shared__ float cols[];  // [n][NT]
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= w) return;  // no block-wide sync below
  float* col = cols + threadIdx.x;
  const size_t plane = (size_t)h * w;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t pix = (size_t)y * w + x;
    int count = 0;
    for (int f = 0; f < n; ++f) {
      const bool v = mask == nullptr || mask[f * plane + pix] != 0;
      col[f * NT] = v ? stack[f * plane + pix] : BIG;
      count += v;
    }
    sort_column(col, n);
    const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
    const float med = mul(0.5f, add(col[lo * NT], col[hi * NT]));
    for (int f = 0; f < n; ++f) {
      const bool v = mask == nullptr || mask[f * plane + pix] != 0;
      col[f * NT] = v ? fabsf(sub(stack[f * plane + pix], med)) : BIG;
    }
    sort_column(col, n);
    const float mad = mul(0.5f, add(col[lo * NT], col[hi * NT]));
    const float sdev = mul(MAD_TO_STD, mad);
    const float lo_b = sub(med, mul(sigma_lo, sdev));
    const float hi_b = add(med, mul(sigma_hi, sdev));
    float acc = 0.0f, cnt = 0.0f;
    for (int f = 0; f < n; ++f) {
      const bool v = mask == nullptr || mask[f * plane + pix] != 0;
      const float s = stack[f * plane + pix];
      const bool keep = v && s >= lo_b && s <= hi_b;
      acc = add(acc, keep ? s : 0.0f);
      cnt = add(cnt, keep ? 1.0f : 0.0f);
    }
    out[pix] = cnt > 0.0f ? __fdiv_rn(acc, fmaxf(cnt, 1.0f))
                          : __int_as_float(0x7fc00000);
  }
}

}  // namespace

extern "C" int clip_combine_launch(const float* stack, const uint8_t* mask,
                                   float* out, int n, int h, int w,
                                   float sigma_lo, float sigma_hi,
                                   void* stream) {
  size_t smem = sizeof(float) * (size_t)n * NT;
  cudaError_t err = cudaFuncSetAttribute(
      clip_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + NT - 1) / NT, h < 65535 ? h : 65535);
  clip_combine_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      stack, mask, out, n, h, w, sigma_lo, sigma_hi);
  return static_cast<int>(cudaGetLastError());
}
