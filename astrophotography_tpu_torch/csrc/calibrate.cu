// Bias / dark / flat calibration of a stack (ops/calibrate.calibrate_batch)
// for Hopper (sm_90a): one streaming pass that reads the raw stack and the
// masters once and writes the float32 stack once.
//
// It replaces no Pallas kernel: the JAX function
// (astrophotography_tpu/ops/calibrate.py, calibrate_batch) is XLA code.
// The port wrote it as a chain of whole-tensor PyTorch operations
// (ops/calibrate.calibrate_batch_plain, the twin this kernel is held to):
// three passes to turn uint16 into float32, then - bias, ratio * dark (a
// stack-sized temporary), -, flat != 0, / flat and a select, each a pass
// over the stack.  That moved ~30 GB and took 11.8 ms of a 34.5 ms request
// at 24 x 4096^2, and its three live float32 stacks set the unfused
// path's memory peak.
//
// What it computes, per pixel of frame n, as the twin does, in its order:
//   x = float(raw)                       (uint16 exactly; float32 as it is)
//   x = x - bias                         where a bias is given
//   d = dark - bias                      where dark_still_biased and a bias
//                                        is given, else d = dark
//   x = x - (ratio[n] * d)               where a dark is given (ratio 1
//                                        without exp_ratios)
//   x = flat != 0 ? x / flat : x         where a flat is given (a NaN flat
//                                        compares != 0, as in the twin)
// Every operation rounds on its own (__fsub_rn / __fmul_rn / __fdiv_rn):
// nvcc's -fmad would otherwise contract x - r * d into an FMA, which
// rounds once where the twin rounds twice.  The flat divides; it is never
// a multiply by its reciprocal.  A missing master is a flag, not a plane
// of zeros or ones, so the twin's bits hold for any input, signed zeros
// and NaN payloads included.  So the output is the twin's bit for bit.
//
// What bounds it on the H100.  The bytes: at 24 x 4096^2 uint16 the stack
// read once (805 MB), the three float32 masters read once (201 MB) and the
// float32 stack written once (1.61 GB), 2.62 GB or 0.78 ms at 3.35 TB/s,
// against ~5 operations a pixel.
//
// Design.  A thread owns 8 consecutive pixels of the (H, W) plane.  It
// loads its bias, dark and flat (two float4 each) once, forms d in
// registers, then walks the frames: 16 B of uint16 (or 32 B of float32) in
// by a streaming load, two float4 out by a streaming store, loads issued
// for UNROLL frames (8 of uint16, 2 of float32) before any of their
// arithmetic, so each thread keeps several in flight.  Measured at the
// unfused cell's call (24 x 4096^2 uint16, H100): 0.933 ms with 8, 0.953
// with 4, 0.956 with 2; 256 threads a block (128: 0.978, 512: 0.934).  The loop over frames is what keeps the masters at
// one read: a grid over frames x pixels would read each 67 MB master once
// a frame, and the three do not fit the 50 MB L2.  The frames are split
// over gridDim.y only when the plane alone gives fewer than BLOCKS_PER_SM
// blocks an SM.  Where H * W is not a multiple of 8 or a base is not
// 16-byte aligned, a scalar kernel (a pixel a thread, the same arithmetic
// and frame loop) takes the whole call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIX = 8;            // consecutive pixels a vector thread owns
constexpr int NT = 256;           // threads of every block
constexpr int BLOCKS_PER_SM = 4;  // below this the frames are split
constexpr int HAS_BIAS = 1;
constexpr int HAS_DARK = 2;
constexpr int HAS_FLAT = 4;
constexpr int DARK_MINUS_BIAS = 8;

// One pixel: b, d and f are the bias, the dark as it is subtracted, and
// the flat, each read only where its flag is set.
__device__ __forceinline__ float calib(float x, float b, float d, float f,
                                      float r, int flags) {
  if (flags & HAS_BIAS) x = __fsub_rn(x, b);
  if (flags & HAS_DARK) x = __fsub_rn(x, __fmul_rn(r, d));
  if ((flags & HAS_FLAT) && f != 0.0f) x = __fdiv_rn(x, f);
  return x;
}

__device__ __forceinline__ float ratio(const float* __restrict__ ratios,
                                       int n) {
  return ratios == nullptr ? 1.0f : __ldg(ratios + n);
}

// 8 pixels of input as loaded: uint16 in one 16-byte word, float32 in two
struct U16x8 {
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* p) {
    v = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int k) const {
    const uint32_t w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return static_cast<float>((k & 1) ? (w >> 16) : (w & 0xffffu));
  }
};

struct F32x8 {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int k) const {
    const float4& q = k < 4 ? a : b;
    const int j = k & 3;
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  }
};

__device__ __forceinline__ void load_plane8(const float* __restrict__ p,
                                            long long i, float (&v)[PIX]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + i) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename In>
__device__ __forceinline__ void calib_store8(const In& raw,
                                             const float (&b)[PIX],
                                             const float (&d)[PIX],
                                             const float (&f)[PIX], float r,
                                             int flags, float* p) {
  float o[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k)
    o[k] = calib(raw.at(k), b[k], d[k], f[k], r, flags);
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(o[0], o[1], o[2], o[3]));
  __stcs(q + 1, make_float4(o[4], o[5], o[6], o[7]));
}

// The vector kernel: a thread owns pixels i .. i + 7 of every frame in
// [blockIdx.y * frames_per_y, +frames_per_y).
template <typename T, typename In, int UNROLL>
__global__ void __launch_bounds__(NT) calibrate_vec_kernel(
    const T* __restrict__ raw, const float* __restrict__ bias,
    const float* __restrict__ dark, const float* __restrict__ flat,
    const float* __restrict__ ratios, int flags, int n, long long plane,
    int frames_per_y, float* __restrict__ out) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * NT + threadIdx.x) * PIX;
  if (i >= plane) return;
  float b[PIX], d[PIX], f[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) b[k] = d[k] = f[k] = 0.0f;
  if (flags & HAS_BIAS) load_plane8(bias, i, b);
  if (flags & HAS_DARK) {
    load_plane8(dark, i, d);
    if (flags & DARK_MINUS_BIAS) {
#pragma unroll
      for (int k = 0; k < PIX; ++k) d[k] = __fsub_rn(d[k], b[k]);
    }
  }
  if (flags & HAS_FLAT) load_plane8(flat, i, f);
  const int f0 = blockIdx.y * frames_per_y;
  const int f1 = min(n, f0 + frames_per_y);
  int fr = f0;
  for (; fr + UNROLL <= f1; fr += UNROLL) {
    In v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u].load(raw + (fr + u) * plane + i);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      calib_store8(v[u], b, d, f, ratio(ratios, fr + u), flags,
                   out + (fr + u) * plane + i);
  }
  for (; fr < f1; ++fr) {
    In v;
    v.load(raw + fr * plane + i);
    calib_store8(v, b, d, f, ratio(ratios, fr), flags, out + fr * plane + i);
  }
}

__device__ __forceinline__ float to_float(uint16_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// The scalar kernel: a thread owns pixel i of every frame of its range.
template <typename T>
__global__ void __launch_bounds__(NT) calibrate_scalar_kernel(
    const T* __restrict__ raw, const float* __restrict__ bias,
    const float* __restrict__ dark, const float* __restrict__ flat,
    const float* __restrict__ ratios, int flags, int n, long long plane,
    int frames_per_y, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= plane) return;
  const float b = (flags & HAS_BIAS) ? __ldg(bias + i) : 0.0f;
  float d = (flags & HAS_DARK) ? __ldg(dark + i) : 0.0f;
  if (flags & DARK_MINUS_BIAS) d = __fsub_rn(d, b);
  const float f = (flags & HAS_FLAT) ? __ldg(flat + i) : 0.0f;
  const int f0 = blockIdx.y * frames_per_y;
  const int f1 = min(n, f0 + frames_per_y);
  for (int fr = f0; fr < f1; ++fr)
    __stcs(out + fr * plane + i,
           calib(to_float(__ldcs(raw + fr * plane + i)), b, d, f,
                 ratio(ratios, fr), flags));
}

template <typename T, typename In, int UNROLL>
cudaError_t launch(const T* raw, const float* bias, const float* dark,
                   const float* flat, const float* ratios, int flags, int n,
                   long long plane, bool vec, float* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long threads = vec ? plane / PIX : plane;
  const long long bx = (threads + NT - 1) / NT;
  if (bx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long fill = static_cast<long long>(BLOCKS_PER_SM) * sms;
  long long gy = 1;
  if (bx < fill) gy = (fill + bx - 1) / bx;
  if (gy > n) gy = n;
  const int per = static_cast<int>((n + gy - 1) / gy);
  const dim3 grid(static_cast<unsigned>(bx), (n + per - 1) / per);
  if (vec)
    calibrate_vec_kernel<T, In, UNROLL><<<grid, NT, 0, s>>>(
        raw, bias, dark, flat, ratios, flags, n, plane, per, out);
  else
    calibrate_scalar_kernel<T><<<grid, NT, 0, s>>>(
        raw, bias, dark, flat, ratios, flags, n, plane, per, out);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// raw: (n, plane) uint16 (is_u16) or float32; bias, dark, flat: (plane,)
// float32 or null (absent); ratios: (n,) float32 or null (1 a frame);
// dark_still_biased: subtract the bias from the dark where both are given;
// out: (n, plane) float32.
extern "C" int calibrate_launch(const void* raw, int is_u16, const float* bias,
                                const float* dark, const float* flat,
                                const float* ratios, int dark_still_biased,
                                int n, long long plane, float* out,
                                void* stream) {
  if (n < 1 || plane < 1 || raw == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int flags = (bias ? HAS_BIAS : 0) | (dark ? HAS_DARK : 0) |
                    (flat ? HAS_FLAT : 0) |
                    (dark_still_biased && bias && dark ? DARK_MINUS_BIAS : 0);
  const bool vec = plane % PIX == 0 && aligned16(raw) && aligned16(out) &&
                   (!bias || aligned16(bias)) && (!dark || aligned16(dark)) &&
                   (!flat || aligned16(flat));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_u16 ? launch<uint16_t, U16x8, 8>(static_cast<const uint16_t*>(raw),
                                          bias, dark, flat, ratios, flags, n,
                                          plane, vec, out, s)
             : launch<float, F32x8, 2>(static_cast<const float*>(raw), bias,
                                       dark, flat, ratios, flags, n, plane,
                                       vec, out, s);
  return static_cast<int>(err);
}
