// K1: raw frames -> per-tile star candidates, for Hopper (sm_90a).
//
// Replaces the TPU kernel astrophotography_tpu/ops/pallas_detect.py
// (pallas_detect_tiles, body _make_kernel).  Computes, per frame and per
// (32 binned rows x 256 columns) tile:
//   binned  = 0.5 * (raw[2b] * A[2b] + raw[2b+1] * A[2b+1])
//   density = (G - mean_w * Box) * inv_den - (MF(B) + r * MF(C))
//             with G / Box the separable gr x gc / box filters,
//   peak    = 3x3 local max (strict > against raster-earlier neighbours,
//             >= against later ones), > threshold, inside the border,
//   and the tile's max, its lowest-index argmax, and the calibrated
//   parabola offsets of the winner (odd quintic, clipped to +-0.5).
//
// What bounds it on the H100: memory.  Per raw pixel it reads 2 B of
// raw, 4 B of A and (per binned pixel) 8 B of the two master densities,
// and does ~30 flops; there is no matrix product (the TPU's banded
// bf16 matmul was a matrix-unit device and is not carried over: this
// kernel computes in float32 throughout).
//
// Design: one block per (frame, tile), 256 threads, one per column.
// The block stages its binned rows (tile + r + 2 halo rows, tile +
// r + 1 halo columns each side) in shared memory, so every raw and A
// element is read from device memory about once (1.2x with the halo);
// the column pass, the row pass and the peak test then run out of
// shared memory.  blockIdx.x is the frame, so consecutive blocks work on
// the same tile of different frames and find that tile's A and master
// densities in L2.  Rows and columns outside the frame read as zero; the
// border mask keeps every value they touch out of the result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TTY = 32;    // binned rows per tile
constexpr int TTX = 256;   // columns per tile
constexpr int NTHREADS = 256;
constexpr float NEG = -3.0e38f;

template <typename T>
__device__ __forceinline__ float to_f(T v) { return static_cast<float>(v); }

__device__ __forceinline__ float paroff(float a, float b, float c,
                                        float c1, float c3, float c5) {
  // b is the tile max: the -3e38 sentinel marks an empty tile
  bool valid = b > -1e37f;
  if (!valid) return 0.0f;
  float den = a - 2.0f * b + c;
  float off = fabsf(den) > 1e-12f ? 0.5f * (a - c) / den : 0.0f;
  float e = fminf(fmaxf(off, -0.5f), 0.5f);
  float e2 = e * e;
  float v = e * (c1 + e2 * (c3 + e2 * c5));
  return fminf(fmaxf(v, -0.5f), 0.5f);
}

// params: gr[2r+1], gc[2r+1], mean_w, inv_den, cy1, cy3, cy5, cx1, cx3, cx5
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
detect_tiles_kernel(const T* __restrict__ frames,
                    const float* __restrict__ a_plane,
                    const float* __restrict__ mf,
                    const float* __restrict__ thresholds,
                    const float* __restrict__ exp_ratios,
                    const float* __restrict__ params,
                    float* __restrict__ out_max, int* __restrict__ out_idx,
                    float* __restrict__ out_yoff, float* __restrict__ out_xoff,
                    int h, int w, int r) {
  extern __shared__ float smem[];
  const int f = blockIdx.x;
  const int tile = blockIdx.y;
  const int h2 = h / 2;
  const int txn = w / TTX;
  const int ty = tile / txn, tx = tile % txn;
  const int y0 = ty * TTY;     // first binned row of the tile
  const int x0 = tx * TTX;     // first column of the tile
  const int ntap = 2 * r + 1;
  const int DR = TTY + 2;          // density rows: tile + 1 peak halo each side
  const int DC = TTX + 2;          // density columns
  const int BR = DR + 2 * r;       // binned rows
  const int BC = DC + 2 * r;       // binned / column-pass columns
  float* s_par = smem;                       // 2 * ntap + 8
  float* s_bin = s_par + 2 * ntap + 8;       // BR x BC, later DR x DC density
  float* s_g = s_bin + BR * BC;              // DR x BC
  float* s_b = s_g + DR * BC;                // DR x BC
  const int tid = threadIdx.x;

  for (int i = tid; i < 2 * ntap + 8; i += NTHREADS) s_par[i] = params[i];

  // 1. binned rows [y0 - 1 - r, y0 + TTY + 1 + r), columns
  //    [x0 - 1 - r, x0 + TTX + 1 + r); outside the frame -> 0
  const T* fr = frames + (size_t)f * h * w;
  for (int i = tid; i < BR * BC; i += NTHREADS) {
    int br = i / BC, bc = i - br * BC;
    int gy = y0 - 1 - r + br, gx = x0 - 1 - r + bc;
    float v = 0.0f;
    if (gy >= 0 && gy < h2 && gx >= 0 && gx < w) {
      size_t o0 = (size_t)(2 * gy) * w + gx;
      float v0 = to_f(fr[o0]);
      float v1 = to_f(fr[o0 + w]);
      if (a_plane != nullptr) {
        v0 = v0 * a_plane[o0];
        v1 = v1 * a_plane[o0 + w];
      }
      v = 0.5f * (v0 + v1);
    }
    s_bin[i] = v;
  }
  __syncthreads();
  const float* gr = s_par;
  const float* gc = s_par + ntap;
  const float mean_w = s_par[2 * ntap];
  const float inv_den = s_par[2 * ntap + 1];

  // 2. column (binned-row) pass: Gaussian and box sums over 2r+1 rows
  for (int i = tid; i < DR * BC; i += NTHREADS) {
    int dr = i / BC, bc = i - dr * BC;
    float g = 0.0f, b = 0.0f;
    for (int k = 0; k < ntap; ++k) {
      float v = s_bin[(dr + k) * BC + bc];
      g += v * gr[k];
      b += v;
    }
    s_g[i] = g;
    s_b[i] = b;
  }
  __syncthreads();

  // 3. row (column) pass + master-density subtraction -> density,
  //    stored over the binned rows (no longer needed)
  float* s_d = s_bin;
  const float er = exp_ratios[f];
  for (int i = tid; i < DR * DC; i += NTHREADS) {
    int dr = i / DC, dc = i - dr * DC;
    float g = 0.0f, b = 0.0f;
    for (int s = 0; s < ntap; ++s) {
      g += s_g[dr * BC + dc + s] * gc[s];
      b += s_b[dr * BC + dc + s];
    }
    float d = (g - mean_w * b) * inv_den;
    int gy = y0 - 1 + dr, gx = x0 - 1 + dc;
    if (mf != nullptr && gy >= 0 && gy < h2 && gx >= 0 && gx < w) {
      size_t o = (size_t)gy * w + gx;
      d = d - (mf[o] + er * mf[(size_t)h2 * w + o]);
    }
    s_d[i] = d;
  }
  __syncthreads();

  // 4. peak test down this thread's column; keep the column's best
  //    (first row on ties, so the block winner is the lowest index)
  const float thr = thresholds[f];
  const int lx = tid;
  const int gx = x0 + lx;
  const bool col_ok = gx >= 2 + r && gx < w - 2 - r;
  float best = NEG;
  int best_i = lx;
  for (int ly = 0; ly < TTY; ++ly) {
    int gy = y0 + ly;
    const float* up = s_d + ly * DC + lx;       // density row gy - 1
    const float* mid = up + DC;
    const float* dn = mid + DC;
    float core = mid[1];
    float earlier = fmaxf(fmaxf(up[0], up[1]), fmaxf(up[2], mid[0]));
    float later = fmaxf(fmaxf(mid[2], dn[0]), fmaxf(dn[1], dn[2]));
    bool peak = col_ok && gy >= r + 1 && gy < h2 - r - 1 && core > earlier &&
                core >= later && core > thr;
    float score = peak ? core : NEG;
    if (score > best) {
      best = score;
      best_i = ly * TTX + lx;
    }
  }
  // block arg-max: larger value wins, equal values -> lower index
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, best, off);
    int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  __shared__ float w_best[NTHREADS / 32];
  __shared__ int w_idx[NTHREADS / 32];
  if ((tid & 31) == 0) {
    w_best[tid >> 5] = best;
    w_idx[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    float m = w_best[0];
    int loc = w_idx[0];
    for (int k = 1; k < NTHREADS / 32; ++k) {
      if (w_best[k] > m || (w_best[k] == m && w_idx[k] < loc)) {
        m = w_best[k];
        loc = w_idx[k];
      }
    }
    int ly = loc / TTX, lxw = loc % TTX;
    const float* c = s_d + (ly + 1) * DC + lxw + 1;
    float du = c[-DC], dd = c[DC], dl = c[-1], dr = c[1];
    const float* cal = s_par + 2 * ntap + 2;
    size_t o = ((size_t)f * (h2 / TTY) + ty) * txn + tx;
    out_max[o] = m;
    out_idx[o] = loc;
    out_yoff[o] = paroff(du, m, dd, cal[0], cal[1], cal[2]);
    out_xoff[o] = paroff(dl, m, dr, cal[3], cal[4], cal[5]);
  }
}

template <typename T>
cudaError_t launch(const void* frames, const float* a_plane, const float* mf,
                   const float* thr, const float* er, const float* params,
                   float* out_max, int* out_idx, float* out_yoff,
                   float* out_xoff, int n, int h, int w, int r,
                   cudaStream_t stream) {
  const int ntap = 2 * r + 1;
  const int DR = TTY + 2, DC = TTX + 2;
  const int BR = DR + 2 * r, BC = DC + 2 * r;
  size_t smem = sizeof(float) * (size_t)(2 * ntap + 8 + BR * BC + 2 * DR * BC);
  cudaError_t err = cudaFuncSetAttribute(
      detect_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (h / 2 / TTY) * (w / TTX));
  detect_tiles_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(frames), a_plane, mf, thr, er, params, out_max,
      out_idx, out_yoff, out_xoff, h, w, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" int detect_tiles_launch(const void* frames, int is_u16,
                                   const float* a_plane, const float* mf,
                                   const float* thresholds,
                                   const float* exp_ratios,
                                   const float* params, float* out_max,
                                   int* out_idx, float* out_yoff,
                                   float* out_xoff, int n, int h, int w,
                                   int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_u16 ? launch<uint16_t>(frames, a_plane, mf, thresholds, exp_ratios,
                                params, out_max, out_idx, out_yoff, out_xoff,
                                n, h, w, r, s)
             : launch<float>(frames, a_plane, mf, thresholds, exp_ratios,
                             params, out_max, out_idx, out_yoff, out_xoff, n,
                             h, w, r, s);
  return static_cast<int>(err);
}
