// K2: fused calibrate + Lanczos3 warp + sigma-clip combine, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel astrophotography_tpu/ops/pallas_warp_combine.py
// (pallas_warp_combine, body _make_kernel).  Per output pixel and frame:
// calibrate the raw taps on the fly, cal = ((raw*A - B) - r*C) * fscale
// (raw * fscale without masters), resample with the separable two-pass
// Lanczos3 (weights from the degree-10 polynomial in t^2) using one of
// three tap bodies — snapped translation (scalar weights, taps [1, 7)),
// 'exact' (per-pixel weights normalised by their sum) or 'lowrank'
// (per-row / per-column weights) — with the TPU kernel's coverage rules;
// then over the N samples of the pixel: sort, median, MAD of all N
// sorted deviations (uncovered samples are +3.4e38 and sort last), clip
// at med -/+ sigma * 1.4826 * MAD, and write 'average', 'median', 'sum'
// or the unclipped 'mean'.  Pixels nobody covers get 0.
//
// What bounds it on the H100: latency of the tap reads, then the
// instruction rate of the per-tap arithmetic.  At N = 100 every output pixel reads
// ~36 taps per frame (2 B raw + 12 B of masters each), almost all from
// L1/L2 because neighbouring threads read neighbouring source pixels;
// device memory sees the raw stack about once.  There is no matrix
// product; the per-pixel sort is ~N^2/4 shared-memory moves.
//
// Design: one thread per output pixel, 64 threads (2 rows x 32 columns)
// per block, looping over frames.  The geometry the TPU kernel derives
// from its shared per-tile source windows — tap bases, the window
// containment test base_ok, the span and lowrank gates, the translation
// snap — arrives precomputed in a per-frame table (16 floats) and a
// per-(frame, tile) table (vbase, ubase, base_ok), so the kernel needs no
// window: it evaluates sum_s wv(s) * mid(s) / sum wv directly, skipping
// taps whose weight is exactly zero (they add nothing to either sum).
// Each thread keeps its N samples in its own column of shared memory
// (N x 64 x 4 B, 25.6 KB at N = 100, bank-conflict free), insertion-sorts
// them, and finds the MAD ranks by merging the two monotone runs of
// deviations around the median instead of sorting them again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 2;
constexpr int NT = BX * BY;
constexpr float BIG = 3.4e38f;
constexpr float MAD_HALF = 0.741301109252801f;  // 1.482602218505602 * 0.5

__constant__ float L3C[11] = {
    9.999994525888e-01f,  -1.827688926461e+00f, 1.122335944632e+00f,
    -3.557261514981e-01f, 6.945395735140e-02f,  -9.185528553885e-03f,
    8.680491817837e-04f,  -5.970731138175e-05f, 2.910034981863e-06f,
    -9.078439824764e-08f, 1.359070044584e-09f};

// Every value operation below rounds op by op (__fmul_rn / __fadd_rn,
// no fused multiply-add), in the plain twin's order, so kernel and twin
// agree bit for bit; a contraction would move sums by an ulp and flip
// samples that sit on a sigma-clip bound.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float l3(float t) {
  float u = mul(t, t);
  if (!(u < 9.0f)) return 0.0f;
  float acc = L3C[10];
#pragma unroll
  for (int k = 9; k >= 0; --k) acc = add(mul(acc, u), L3C[k]);
  return acc;
}

template <typename T>
struct Source {
  const T* raw;          // this frame's (H, W)
  const float* masters;  // (3, H, W) or null
  size_t plane;
  int h, w;
  float er, fs;
  __device__ __forceinline__ float operator()(int y, int x) const {
    if (y < 0 || y >= h || x < 0 || x >= w) return 0.0f;
    size_t o = (size_t)y * w + x;
    float v = static_cast<float>(raw[o]);
    if (masters != nullptr)
      v = sub(sub(mul(v, masters[o]), masters[plane + o]),
              mul(er, masters[2 * plane + o]));
    return mul(v, fs);
  }
};

// a*x + b*y + c (tap coordinates; an ulp there is a visible value
// difference on a steep edge)
__device__ __forceinline__ float affine_rn(float a, float x, float b, float y,
                                           float c) {
  return add(add(mul(a, x), mul(b, y)), c);
}

// first tap s >= lo whose argument base - s can be inside (-3, 3)
__device__ __forceinline__ int tap_lo(float base, int lo) {
  return max(lo, (int)floorf(base) - 3);
}
__device__ __forceinline__ int tap_hi(float base, int hi) {
  return min(hi, (int)floorf(base) + 4);
}

template <typename T>
__device__ float warp_translation(const Source<T>& src, const float* tb,
                                  int vbase, int ubase, float ti, float tj,
                                  int rr, int c, int span) {
  const int t_lo = span >= 7 ? 1 : 0;
  const int t_hi = span >= 7 ? min(span, 7) : span;
  float a_u = (tj + tb[13]) - (float)ubase;   // tj + g0 - ubase
  float a_v = (ti + tb[5]) - (float)vbase;    // ti + m12 - vbase
  float wu[8], wv[8];
  float su = 0.0f, sv = 0.0f;
  for (int s = t_lo; s < t_hi; ++s) {
    wu[s] = l3(a_u - (float)s);
    wv[s] = l3(a_v - (float)s);
    su = s == t_lo ? wu[s] : add(su, wu[s]);
    sv = s == t_lo ? wv[s] : add(sv, wv[s]);
  }
  float inv = fabsf(su) > 1e-3f ? 1.0f / su : 0.0f;
  float inv2 = fabsf(sv) > 1e-3f ? 1.0f / sv : 0.0f;
  float out = 0.0f;
  for (int s = t_lo; s < t_hi; ++s) {
    if (wv[s] == 0.0f) continue;
    int row = vbase + rr + s;
    float mid = 0.0f;
    for (int s2 = t_lo; s2 < t_hi; ++s2) {
      if (wu[s2] == 0.0f) continue;
      mid = add(mid, mul(mul(wu[s2], inv), src(row, ubase + c + s2)));
    }
    out = add(out, mul(mul(wv[s], inv2), mid));
  }
  return out;
}

template <typename T>
__device__ float warp_exact(const Source<T>& src, const float* tb, int vbase,
                            int ubase, float x_out, float v, int rr, int c,
                            int span) {
  const float gx = tb[11], gy = tb[12], g0 = tb[13];
  float v_loc = v - (float)vbase;
  float vb_f = (float)vbase, ub_f = (float)ubase;
  float acc2 = 0.0f, wsum2 = 0.0f;
  float vrel = v_loc - (float)rr;
  for (int s = tap_lo(vrel, 0); s <= tap_hi(vrel, span - 1); ++s) {
    float wvt = l3(v_loc - (float)(rr + s));
    if (wvt == 0.0f) continue;
    int row = vbase + rr + s;
    float u_loc = affine_rn(gx, x_out, gy, vb_f + (float)(rr + s), g0) - ub_f;
    float acc = 0.0f, wsum = 0.0f;
    float urel = u_loc - (float)c;
    for (int s2 = tap_lo(urel, 0); s2 <= tap_hi(urel, span - 1); ++s2) {
      float wt = l3(u_loc - (float)(c + s2));
      if (wt == 0.0f) continue;
      acc = add(acc, mul(wt, src(row, ubase + c + s2)));
      wsum = add(wsum, wt);
    }
    float mid = fabsf(wsum) > 1e-3f ? acc / wsum : 0.0f;
    acc2 = add(acc2, mul(wvt, mid));
    wsum2 = add(wsum2, wvt);
  }
  return fabsf(wsum2) > 1e-3f ? acc2 / wsum2 : 0.0f;
}

template <typename T>
__device__ float warp_lowrank(const Source<T>& src, const float* tb,
                              int vbase, int ubase, float x_out, float ti,
                              float tj, int rr, int c, int span, int th,
                              int tw) {
  const float gx = tb[11], gy = tb[12], g0 = tb[13];
  const float m11 = tb[4];
  const int t1hi = min(span, 9);
  float vb_f = (float)vbase, ub_f = (float)ubase;
  float bv = add(affine_rn(tb[3], x_out, m11, ti, tb[5]) - vb_f,
                 mul(m11 - 1.0f, (float)(th - 1) * 0.5f));
  float acc2 = 0.0f, v0s = 0.0f;
  for (int s = tap_lo(bv, 1); s <= tap_hi(bv, span - 1); ++s) {
    float wvt = l3(bv - (float)s);
    if (wvt == 0.0f) continue;
    int row = vbase + rr + s;
    float bu = add(affine_rn(gx, tj, gy, vb_f + (float)(rr + s), g0) - ub_f,
                   mul(gx - 1.0f, (float)(tw - 1) * 0.5f));
    float acc0 = 0.0f, w0s = 0.0f;
    for (int s2 = tap_lo(bu, 1); s2 <= tap_hi(bu, t1hi - 1); ++s2) {
      float wt = l3(bu - (float)s2);
      if (wt == 0.0f) continue;
      acc0 = add(acc0, mul(wt, src(row, ubase + c + s2)));
      w0s = add(w0s, wt);
    }
    float inv0 = fabsf(w0s) > 1e-3f ? 1.0f / w0s : 0.0f;
    acc2 = add(acc2, mul(wvt, mul(acc0, inv0)));
    v0s = add(v0s, wvt);
  }
  float inv2 = fabsf(v0s) > 1e-3f ? 1.0f / v0s : 0.0f;
  return mul(acc2, inv2);
}

// combine: 0 average, 1 median, 2 sum, 3 mean
template <typename T>
__global__ void __launch_bounds__(NT)
warp_combine_kernel(const T* __restrict__ frames,
                    const float* __restrict__ masters,
                    const float* __restrict__ ftab,
                    const int* __restrict__ ttab, float* __restrict__ out,
                    int n, int h0, int w0, int th, int tw, int n_tj,
                    int n_tiles, int span, int lowrank, int combine,
                    float sigma_lo, float sigma_hi) {
  extern __shared__ float vals[];  // [n][NT]
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w0 || y >= h0) return;  // no block-wide sync below
  const int i = y / th, j = x / tw;
  const int rr = y - i * th, c = x - j * tw;
  const int tile = i * n_tj + j;
  const float x_out = (float)x, y_out = (float)y;
  const float ti = (float)(i * th), tj = (float)(j * tw);
  const size_t plane = (size_t)h0 * w0;

  int count = 0;
  float macc = 0.0f;
  for (int f = 0; f < n; ++f) {
    const float* tb = ftab + 16 * f;
    const int* tt = ttab + 3 * ((size_t)f * n_tiles + tile);
    const int vbase = tt[0], ubase = tt[1];
    const bool trans = tb[8] > 0.5f;
    // coverage: source inside [2, W-4] x [vlo, vhi], window contained,
    // and (general bodies) the frame's span / lowrank gate
    float v = affine_rn(tb[3], x_out, tb[4], y_out, tb[5]);
    float sx = affine_rn(tb[0], x_out, tb[1], y_out, tb[2]);
    bool cover = sx >= 2.0f && sx <= (float)w0 - 4.0f && v >= tb[9] &&
                 v <= tb[10] && tt[2] != 0 && (trans || tb[14] > 0.5f);
    float val = BIG;
    if (cover) {
      Source<T> src{frames + (size_t)f * plane, masters, plane, h0, w0,
                    tb[6], tb[7]};
      if (trans)
        val = warp_translation(src, tb, vbase, ubase, ti, tj, rr, c, span);
      else if (lowrank)
        val = warp_lowrank(src, tb, vbase, ubase, x_out, ti, tj, rr, c, span,
                           th, tw);
      else
        val = warp_exact(src, tb, vbase, ubase, x_out, v, rr, c, span);
      ++count;
      macc = add(macc, val);
    }
    vals[f * NT + tid] = val;
  }
  float* o = out + (size_t)y * w0 + x;
  if (count == 0) {
    *o = 0.0f;
    return;
  }
  if (combine == 3) {  // coverage-weighted mean, no clipping
    *o = macc / (float)count;
    return;
  }
  // insertion sort of this thread's column (uncovered BIG sort last)
  for (int k = 1; k < n; ++k) {
    float key = vals[k * NT + tid];
    int m = k - 1;
    while (m >= 0 && vals[m * NT + tid] > key) {
      vals[(m + 1) * NT + tid] = vals[m * NT + tid];
      --m;
    }
    vals[(m + 1) * NT + tid] = key;
  }
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(vals[lo * NT + tid], vals[hi * NT + tid]));
  // deviations of the sorted samples fall to the median, then rise: merge
  // the run left of p (walking down) with the run from p (walking up)
  const float INF = __int_as_float(0x7f800000);
  int p = 0;
  while (p < n && vals[p * NT + tid] < med) ++p;
  int a = p - 1, b = p;
  float d_lo = 0.0f, d_hi = 0.0f;
  for (int k = 0; k <= hi; ++k) {
    float da = a >= 0 ? fabsf(vals[a * NT + tid] - med) : INF;
    float db = b < n ? fabsf(vals[b * NT + tid] - med) : INF;
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
  const float sdev = mul(MAD_HALF, add(d_lo, d_hi));
  const float lo_b = sub(med, mul(sigma_lo, sdev));
  const float hi_b = add(med, mul(sigma_hi, sdev));
  float acc = 0.0f;
  int cnt = 0, below = 0;
  for (int k = 0; k < count; ++k) {
    float s = vals[k * NT + tid];
    if (s < lo_b) {
      ++below;
    } else if (s <= hi_b) {
      acc = add(acc, s);
      ++cnt;
    }
  }
  float res = 0.0f;
  if (cnt > 0) {
    if (combine == 1) {
      int klo = below + max((cnt - 1) / 2, 0);
      int khi = below + max(cnt / 2, 0);
      res = mul(0.5f, add(vals[klo * NT + tid], vals[khi * NT + tid]));
    } else if (combine == 2) {
      res = acc;
    } else {
      res = acc / (float)cnt;
    }
  }
  *o = res;
}

template <typename T>
cudaError_t launch(const void* frames, const float* masters, const float* ftab,
                   const int* ttab, float* out, int n, int h0, int w0, int th,
                   int tw, int n_ti, int n_tj, int span, int lowrank,
                   int combine, float sigma_lo, float sigma_hi,
                   cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)n * NT;
  cudaError_t err = cudaFuncSetAttribute(
      warp_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 block(BX, BY);
  dim3 grid((w0 + BX - 1) / BX, (h0 + BY - 1) / BY);
  warp_combine_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(frames), masters, ftab, ttab, out, n, h0, w0, th,
      tw, n_tj, n_ti * n_tj, span, lowrank, combine, sigma_lo, sigma_hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int warp_combine_launch(const void* frames, int is_u16,
                                   const float* masters, const float* ftab,
                                   const int* ttab, float* out, int n, int h0,
                                   int w0, int th, int tw, int n_ti, int n_tj,
                                   int span, int lowrank, int combine,
                                   float sigma_lo, float sigma_hi,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_u16 ? launch<uint16_t>(frames, masters, ftab, ttab, out, n, h0, w0,
                                th, tw, n_ti, n_tj, span, lowrank, combine,
                                sigma_lo, sigma_hi, s)
             : launch<float>(frames, masters, ftab, ttab, out, n, h0, w0, th,
                             tw, n_ti, n_tj, span, lowrank, combine, sigma_lo,
                             sigma_hi, s);
  return static_cast<int>(err);
}
