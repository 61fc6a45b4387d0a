// The plain separable warp (ops/warp.warp_affine_separable) for Hopper
// (sm_90a): Heckbert's two-pass Lanczos3 affine warp, a horizontal
// resample along source rows and then a vertical one, onto an output grid
// cut into bands of `band` rows.
//
// It replaces no Pallas kernel: the JAX function
// (astrophotography_tpu/ops/warp.py, warp_affine_separable) is XLA code.
// The port wrote it as a composition of whole-tensor PyTorch operations
// (warp_affine_separable_plain, the twin this kernel is held to), which
// streamed every Horner step of every tap weight through device memory:
// ~700 launches and ~280 GB of traffic a chunk of 5 frames of
// 2048 x 4096, 962 ms of a 1.2 s stack of 24 x 4096^2.
//
// What it computes, per frame f and output band b (rows b*band ..
// b*band + band - 1, the last one running past H_out), as the twin does:
//   * the matrix [A | t] maps output (x, y) to source (sx, sy);
//     v(x, y) = m10*x + m11*y + m12 is the source row, and
//     u(x, y') = gx*x + gy*y' + g0 (gx = m00 - m01*m10/m11, gy = m01/m11,
//     g0 = m02 - m01*m12/m11) the source column of output column x on
//     source row y', so out[y, x] = mid[v(x, y), x] with
//     mid[y', x] = src[y', u(x, y')] exactly;
//   * the band's vertical window starts at base2 = floor(min v) - 3 over
//     the band's rows and the whole output width (clipped; start2 is
//     dynamic_slice's clamp of it), and spans `span` rows past the band;
//     each source row y' (in its source band k = y' / band) has its
//     horizontal window at base1 = floor(min u) - 3 over band k's rows
//     and the output width (start1 likewise);
//   * mid[y', x] = sum_s w(s) src[y', start1 + x + s] / sum_s w(s) over
//     s = 0 .. span-1, w(s) = lanczos3(u - base1 - (x + s)), 0 where the
//     weight sum is not above 1e-3; rows and columns outside the source
//     read 0; out[y, x] likewise from mid[start2 + r + s, x], r = y - b*band;
//   * coverage: analytic (1 where the 6-tap footprint of (sx, sy) lies in
//     the source and, under a translation budget, the shift is within
//     budget - span - 4; the value multiplied by it), or the warped ones
//     channel (2 channels; value / coverage where it exceeds 1e-6,
//     coverage clamped to [0, 1]).
//
// Rounding.  Every value operation rounds op by op (__fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, no contraction into FMAs) in the
// twin's order: the Horner steps of lanczos3_poly with its constants
// rounded to float32, u < 9 before the select, coord - (idx + s),
// acc + w * value from s = 0 (acc starts at -0, which adds to any x as
// x), |wsum| > 1e-3 and the divide, out * cover.  A window base is the
// least of the band's four corner values: each rounded operation of
// a*x + b*y + c is monotone in x and in y, so the float32 grid is
// monotone along each axis and its minimum over a rectangle lies at a
// corner.  So the bases need no reduction and no host read (the twin reads
// its chunk's row range back to the host), and the kernel is bit for bit
// the twin's, the non-finite values a NaN or inf in the source gives
// included.  Every shift is summed, weight 0 or not (0 * inf is NaN in the
// twin too); a weight whose u is not below 9 skips the polynomial.
//
// What bounds it on the H100.  The bytes (the source read once, the band
// and its coverage written once) take 0.72 ms a band of 24 x 2048 x 4096
// at 3.35 TB/s.  The arithmetic is larger: each output pixel and each of
// the ~1.19 mid rows a band computes per output row (band + span over
// band) takes span shifts of ~9 unfused instructions (the argument, its
// square, the test, the products and sums) and the polynomial's 20 on the
// ~6 shifts inside the kernel's support: ~500 instructions a pixel and
// frame at span 12, ~3 ms of issue a band on 132 SMs x 128 lanes at 1.98
// GHz.  Measured (tools/warp_separable.py, H100): 6.5 ms a band, 9x the
// bound of its bytes, against 483 ms for the twin.
//
// Design.  Routes, chosen in kernels._warp_separable_route:
//  * 'smem': one launch, one block of 256 threads per (frame, output band,
//    column tile of TW = 128, 64, 32 or 16 columns).  The block computes
//    its band's base2, then for each of the band + span mid rows its
//    window reads the source row's base1 / start1 (a table in shared
//    memory), then the mid tile (band + span rows x TW x channels) into
//    shared memory, each thread a mid pixel, its taps read from the
//    source through the L1 cache (neighbouring threads on neighbouring
//    columns: coalesced); then each thread an output pixel, its taps from
//    the mid tile, coverage inline, both outputs stored coalesced.  The
//    source is read ~1.2 times, the outputs written once, nothing else
//    touches device memory.  TW is the widest whose tile keeps 4 blocks
//    an SM in shared memory, else the widest that fits at all.
//  * 'scratch' (windows whose mid rows outgrow a block, and wide windows
//    where recomputing the band + span mid rows in every band costs more
//    than a round trip through device memory): two launches.  The first
//    writes each mid row that some band reads, once, to a scratch tensor
//    the wrapper allocates (frames in chunks of at most 1 GiB); the
//    second runs the vertical pass from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads of every block
constexpr int ROUTE_SMEM = 0;
constexpr int ROUTE_SCRATCH = 1;
constexpr int MID_ROWS = 8;    // 'scratch' mid kernel: rows x 128 columns
constexpr int MID_COLS = 128;
constexpr int VERT_COLS = 32;  // 'scratch' vertical kernel: band x 32

__constant__ float L3C[11] = {
    9.999994525888e-01f,  -1.827688926461e+00f, 1.122335944632e+00f,
    -3.557261514981e-01f, 6.945395735140e-02f,  -9.185528553885e-03f,
    8.680491817837e-04f,  -5.970731138175e-05f, 2.910034981863e-06f,
    -9.078439824764e-08f, 1.359070044584e-09f};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// lanczos3_poly: the degree-10 polynomial in u = t^2, 0 where u is not
// below 9 (a NaN argument included)
__device__ __forceinline__ float l3(float t) {
  const float u = mul(t, t);
  if (!(u < 9.0f)) return 0.0f;
  float acc = L3C[10];
#pragma unroll
  for (int k = 9; k >= 0; --k) acc = add(mul(acc, u), L3C[k]);
  return acc;
}

// a*x + b*y + c in the twin's order
__device__ __forceinline__ float affine_rn(float a, float x, float b, float y,
                                           float c) {
  return add(add(mul(a, x), mul(b, y)), c);
}

__device__ __forceinline__ float min4(float a, float b, float c, float d) {
  const float ab = b < a ? b : a;
  const float cd = d < c ? d : c;
  return cd < ab ? cd : ab;
}

struct Geom {
  int h_in, w_in, h_out, w_out, band, span, pad, pad_t;
  int budget;  // translation budget, or -1 for none
};

struct Frame {
  float m00, m01, m02, m10, m11, m12, gx, gy, g0;
};

__device__ __forceinline__ Frame load_frame(const float* __restrict__ mats,
                                            int f) {
  const float* m = mats + 6 * (size_t)f;
  Frame fr;
  fr.m00 = m[0]; fr.m01 = m[1]; fr.m02 = m[2];
  fr.m10 = m[3]; fr.m11 = m[4]; fr.m12 = m[5];
  // 1.0 / m11 is the reciprocal times 1.0 in the twin: one rounding
  const float inv = dvd(1.0f, fr.m11);
  fr.gx = sub(fr.m00, mul(mul(fr.m01, fr.m10), inv));
  fr.gy = mul(fr.m01, inv);
  fr.g0 = sub(fr.m02, mul(mul(fr.m01, fr.m12), inv));
  return fr;
}

// _clipped_base: floor of the minimum, clamped in float to [lo - 8,
// hi + 8], to an integer, minus 3, clamped to [lo, hi]
__device__ __forceinline__ int clipped_base(float mn, int lo, int hi) {
  float m = floorf(mn);
  m = fminf(fmaxf(m, (float)lo - 8.0f), (float)hi + 8.0f);
  long long b = (long long)m - 3;
  b = b < lo ? lo : b;
  return (int)(b > hi ? hi : b);
}

// _slice_start: dynamic_slice's clamp of a window of `length` at `base`
// in an axis padded by `pad` below to `padded` values
__device__ __forceinline__ int slice_start(int base, int pad,
                                           long long padded, int length) {
  long long s = (long long)base + pad;
  s = s < 0 ? 0 : s;
  const long long hi = padded - length;
  s = s > hi ? hi : s;
  return (int)(s - pad);
}

// band b's vertical window: base2 and start2 from the four corners of v
__device__ __forceinline__ void band_window(const Frame& fr, const Geom& g,
                                            int b, int* base2, int* start2) {
  const float y0 = (float)(b * g.band);
  const float y1 = (float)(b * g.band + g.band - 1);
  const float x1 = (float)(g.w_out - 1);
  const float mn = min4(affine_rn(fr.m10, 0.0f, fr.m11, y0, fr.m12),
                        affine_rn(fr.m10, x1, fr.m11, y0, fr.m12),
                        affine_rn(fr.m10, 0.0f, fr.m11, y1, fr.m12),
                        affine_rn(fr.m10, x1, fr.m11, y1, fr.m12));
  *base2 = clipped_base(mn, -g.pad_t, g.h_in + 3);
  *start2 = slice_start(*base2, g.pad_t,
                        (long long)g.pad_t + g.h_in + g.band + g.span + 4,
                        g.band + g.span);
}

// source row y's horizontal window: base1 and start1 of its source band
// from the four corners of u over that band's rows
__device__ __forceinline__ void row_window(const Frame& fr, const Geom& g,
                                           int y, int* start1, float* base1f) {
  const int k = y / g.band;
  const float y0 = (float)(k * g.band);
  const float y1 = (float)(k * g.band + g.band - 1);
  const float x1 = (float)(g.w_out - 1);
  const float mn = min4(affine_rn(fr.gx, 0.0f, fr.gy, y0, fr.g0),
                        affine_rn(fr.gx, x1, fr.gy, y0, fr.g0),
                        affine_rn(fr.gx, 0.0f, fr.gy, y1, fr.g0),
                        affine_rn(fr.gx, x1, fr.gy, y1, fr.g0));
  const int base1 = clipped_base(mn, -g.pad, g.w_in + 3);
  *start1 = slice_start(base1, g.pad, (long long)g.w_in + 2LL * g.pad,
                        g.w_out + g.span);
  *base1f = (float)base1;
}

// _resample_terms' result: acc / wsum where |wsum| > 1e-3, else 0
__device__ __forceinline__ float resolved(float acc, float wsum) {
  return fabsf(wsum) > 1e-3f ? dvd(acc, wsum) : 0.0f;
}

// mid[y, x] (C channels: the value, and the warped ones) of source row
// `row` (y in the source) with its window at start1 / base1f
template <int C>
__device__ __forceinline__ void mid_pixel(const float* __restrict__ row,
                                          const Frame& fr, const Geom& g,
                                          int y, int x, int start1,
                                          float base1f, float* m) {
  const float coord = sub(affine_rn(fr.gx, (float)x, fr.gy, (float)y, fr.g0),
                          base1f);
  float acc0 = -0.0f, acc1 = -0.0f, wsum = -0.0f;
  const int c0 = start1 + x;
#pragma unroll 4
  for (int s = 0; s < g.span; ++s) {
    const float w = l3(sub(coord, (float)(x + s)));
    const int c = c0 + s;
    const bool in = (unsigned)c < (unsigned)g.w_in;
    acc0 = add(acc0, mul(w, in ? __ldg(row + c) : 0.0f));
    if constexpr (C == 2) acc1 = add(acc1, mul(w, in ? 1.0f : 0.0f));
    wsum = add(wsum, w);
  }
  m[0] = resolved(acc0, wsum);
  if constexpr (C == 2) m[1] = resolved(acc1, wsum);
}

// The output pixel (y, x), r = y - b * band, from its band's mid rows:
// `midv(i, c)` is channel c of mid row start2 + i at column x.  Stores the
// value and its coverage.
template <int C, typename MidAt>
__device__ __forceinline__ void out_pixel(const Frame& fr, const Geom& g,
                                          int y, int r, int x, float base2f,
                                          MidAt midv, float* out_px,
                                          float* cov_px) {
  const float xf = (float)x, yf = (float)y;
  const float v = affine_rn(fr.m10, xf, fr.m11, yf, fr.m12);
  const float coord = sub(v, base2f);
  float acc0 = -0.0f, acc1 = -0.0f, wsum = -0.0f;
#pragma unroll 4
  for (int s = 0; s < g.span; ++s) {
    const float w = l3(sub(coord, (float)(r + s)));
    acc0 = add(acc0, mul(w, midv(r + s, 0)));
    if constexpr (C == 2) acc1 = add(acc1, mul(w, midv(r + s, 1)));
    wsum = add(wsum, w);
  }
  const float data = resolved(acc0, wsum);
  if constexpr (C == 1) {
    // covered iff the full 6-tap footprint stays inside the source (v is
    // the grid's sy: the same operations in the same order)
    const float sx = affine_rn(fr.m00, xf, fr.m01, yf, fr.m02);
    bool cov = sx >= 2.0f && sx <= (float)(g.w_in - 4) && v >= 2.0f &&
               v <= (float)(g.h_in - 4);
    if (g.budget >= 0) {
      const float b_eff = (float)(g.budget - g.span - 4);
      cov = cov && fabsf(sub(sx, xf)) <= b_eff && fabsf(sub(v, yf)) <= b_eff;
    }
    const float cover = cov ? 1.0f : 0.0f;
    *out_px = mul(data, cover);
    *cov_px = cover;
  } else {
    const float cover = resolved(acc1, wsum);
    *out_px = cover > 1e-6f ? dvd(data, cover) : 0.0f;
    // torch.clamp: NaN through, else min(max(v, 0), 1)
    *cov_px = isnan(cover) ? cover : fminf(fmaxf(cover, 0.0f), 1.0f);
  }
}

// Shared memory of a 'smem' block, in 4-byte words (kernels.py mirrors it
// in _warp_separable_smem_bytes): the mid tile, then start1 and base1 of
// each mid row.
__host__ __device__ __forceinline__ size_t smem_words(int rows, int tw,
                                                      int chans) {
  return (size_t)chans * rows * tw + 2 * (size_t)rows;
}

template <int C>
__global__ void __launch_bounds__(NT)
    sep_smem_kernel(const float* __restrict__ src,
                    const float* __restrict__ mats, float* __restrict__ out,
                    float* __restrict__ cov, Geom g, int tw_shift,
                    int n_bands, int n_tiles) {
  extern __shared__ float smem[];
  const int tw = 1 << tw_shift;
  const int rows = g.band + g.span;
  float* mid = smem;                               // [C][rows][tw]
  int* start1 = reinterpret_cast<int*>(mid + (size_t)C * rows * tw);
  float* base1f = reinterpret_cast<float*>(start1 + rows);

  long long bid = blockIdx.x;
  const int tile = (int)(bid % n_tiles);
  bid /= n_tiles;
  const int b = (int)(bid % n_bands);
  const int f = (int)(bid / n_bands);
  const Frame fr = load_frame(mats, f);
  int base2, start2;
  band_window(fr, g, b, &base2, &start2);
  for (int i = threadIdx.x; i < rows; i += NT) {
    const int y = start2 + i;
    if (y >= 0 && y < g.h_in) row_window(fr, g, y, &start1[i], &base1f[i]);
  }
  __syncthreads();

  const int x0 = tile << tw_shift;
  const float* plane = src + (size_t)f * g.h_in * g.w_in;
  const int mid_px = rows << tw_shift;
  for (int p = threadIdx.x; p < mid_px; p += NT) {
    const int i = p >> tw_shift, j = p & (tw - 1);
    const int y = start2 + i, x = x0 + j;
    float m[2] = {0.0f, 0.0f};
    if (y >= 0 && y < g.h_in && x < g.w_out)
      mid_pixel<C>(plane + (size_t)y * g.w_in, fr, g, y, x, start1[i],
                   base1f[i], m);
    mid[p] = m[0];
    if constexpr (C == 2) mid[(size_t)rows * tw + p] = m[1];
  }
  __syncthreads();

  const float base2f = (float)base2;
  const int out_px = g.band << tw_shift;
  for (int p = threadIdx.x; p < out_px; p += NT) {
    const int r = p >> tw_shift, j = p & (tw - 1);
    const int y = b * g.band + r, x = x0 + j;
    if (y >= g.h_out || x >= g.w_out) continue;
    const size_t o = ((size_t)f * g.h_out + y) * g.w_out + x;
    out_pixel<C>(fr, g, y, r, x, base2f,
                 [&](int i, int c) {
                   return mid[(size_t)c * rows * tw + ((size_t)i << tw_shift)
                              + j];
                 },
                 out + o, cov + o);
  }
}

// The rows [lo, hi) of frame f's mid image that some band reads: the
// union of the bands' windows, within the source.
__device__ void needed_rows(const Frame& fr, const Geom& g, int n_bands,
                            int* lo, int* hi) {
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = 0x7fffffff;
    s_hi = -0x7fffffff;
  }
  __syncthreads();
  int my_lo = 0x7fffffff, my_hi = -0x7fffffff;
  for (int b = threadIdx.x; b < n_bands; b += NT) {
    int base2, start2;
    band_window(fr, g, b, &base2, &start2);
    my_lo = min(my_lo, start2);
    my_hi = max(my_hi, start2 + g.band + g.span);
  }
  atomicMin(&s_lo, my_lo);
  atomicMax(&s_hi, my_hi);
  __syncthreads();
  *lo = max(s_lo, 0);
  *hi = min(s_hi, g.h_in);
}

// 'scratch', launch 1: the mid image's needed rows, MID_ROWS x MID_COLS a
// block, into scratch [frames][C][h_in][w_out]
template <int C>
__global__ void __launch_bounds__(NT)
    sep_mid_kernel(const float* __restrict__ src,
                   const float* __restrict__ mats, float* __restrict__ mid,
                   Geom g, int n_bands, int n_row_tiles, int n_tiles) {
  __shared__ int start1[MID_ROWS];
  __shared__ float base1f[MID_ROWS];
  long long bid = blockIdx.x;
  const int tile = (int)(bid % n_tiles);
  bid /= n_tiles;
  const int rt = (int)(bid % n_row_tiles);
  const int f = (int)(bid / n_row_tiles);
  const Frame fr = load_frame(mats, f);
  int lo, hi;
  needed_rows(fr, g, n_bands, &lo, &hi);
  const int y0 = rt * MID_ROWS;
  if (y0 + MID_ROWS <= lo || y0 >= hi) return;
  if (threadIdx.x < MID_ROWS) {
    const int y = y0 + threadIdx.x;
    if (y >= lo && y < hi)
      row_window(fr, g, y, &start1[threadIdx.x], &base1f[threadIdx.x]);
  }
  __syncthreads();
  const float* plane = src + (size_t)f * g.h_in * g.w_in;
  const size_t chan = (size_t)g.h_in * g.w_out;
  for (int p = threadIdx.x; p < MID_ROWS * MID_COLS; p += NT) {
    const int i = p / MID_COLS, x = tile * MID_COLS + p % MID_COLS;
    const int y = y0 + i;
    if (y < lo || y >= hi || x >= g.w_out) continue;
    float m[2];
    mid_pixel<C>(plane + (size_t)y * g.w_in, fr, g, y, x, start1[i],
                 base1f[i], m);
    float* at = mid + (size_t)f * C * chan + (size_t)y * g.w_out + x;
    at[0] = m[0];
    if constexpr (C == 2) at[chan] = m[1];
  }
}

// 'scratch', launch 2: the vertical pass of band b, VERT_COLS columns a
// block, its taps from the scratch (rows outside the source read 0)
template <int C>
__global__ void __launch_bounds__(NT)
    sep_vert_kernel(const float* __restrict__ mats,
                    const float* __restrict__ mid, float* __restrict__ out,
                    float* __restrict__ cov, Geom g, int n_bands,
                    int n_tiles) {
  long long bid = blockIdx.x;
  const int tile = (int)(bid % n_tiles);
  bid /= n_tiles;
  const int b = (int)(bid % n_bands);
  const int f = (int)(bid / n_bands);
  const Frame fr = load_frame(mats, f);
  int base2, start2;
  band_window(fr, g, b, &base2, &start2);
  const float base2f = (float)base2;
  const size_t chan = (size_t)g.h_in * g.w_out;
  const float* plane = mid + (size_t)f * C * chan;
  for (int p = threadIdx.x; p < g.band * VERT_COLS; p += NT) {
    const int r = p / VERT_COLS, x = tile * VERT_COLS + p % VERT_COLS;
    const int y = b * g.band + r;
    if (y >= g.h_out || x >= g.w_out) continue;
    const size_t o = ((size_t)f * g.h_out + y) * g.w_out + x;
    out_pixel<C>(fr, g, y, r, x, base2f,
                 [&](int i, int c) {
                   const int row = start2 + i;
                   return (row >= 0 && row < g.h_in)
                              ? __ldg(plane + c * chan + (size_t)row * g.w_out
                                      + x)
                              : 0.0f;
                 },
                 out + o, cov + o);
  }
}

template <int C>
cudaError_t launch(const float* src, const float* mats, float* out,
                   float* cov, float* scratch, int n, const Geom& g,
                   int route, int tw, cudaStream_t s) {
  const int n_bands = (g.h_out + g.band - 1) / g.band;
  if (route == ROUTE_SMEM) {
    int shift = 0;
    while ((1 << shift) < tw) ++shift;
    if ((1 << shift) != tw || tw < 16 || tw > 128)
      return cudaErrorInvalidValue;
    const size_t bytes = 4 * smem_words(g.band + g.span, tw, C);
    cudaError_t err = cudaFuncSetAttribute(
        sep_smem_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    const int n_tiles = (g.w_out + tw - 1) / tw;
    const long long blocks = (long long)n * n_bands * n_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    sep_smem_kernel<C><<<(unsigned)blocks, NT, bytes, s>>>(
        src, mats, out, cov, g, shift, n_bands, n_tiles);
    return cudaGetLastError();
  }
  if (route != ROUTE_SCRATCH || scratch == nullptr)
    return cudaErrorInvalidValue;
  const int n_row_tiles = (g.h_in + MID_ROWS - 1) / MID_ROWS;
  const int n_mid_tiles = (g.w_out + MID_COLS - 1) / MID_COLS;
  const long long mid_blocks = (long long)n * n_row_tiles * n_mid_tiles;
  const int n_tiles = (g.w_out + VERT_COLS - 1) / VERT_COLS;
  const long long blocks = (long long)n * n_bands * n_tiles;
  if (mid_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  sep_mid_kernel<C><<<(unsigned)mid_blocks, NT, 0, s>>>(
      src, mats, scratch, g, n_bands, n_row_tiles, n_mid_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sep_vert_kernel<C><<<(unsigned)blocks, NT, 0, s>>>(mats, scratch, out, cov,
                                                     g, n_bands, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// src (n, h_in, w_in) float32, mats (n, 2, 3) float32; out and cov (n,
// h_out, w_out) float32; scratch (n, channels, h_in, w_out) on 'scratch'
// (else null).  budget < 0: no translation budget.  route 0 'smem' (tw
// its tile's columns), 1 'scratch' (two launches).
extern "C" int warp_separable_launch(const float* src, const float* mats,
                                     float* out, float* cov, float* scratch,
                                     int n, int h_in, int w_in, int h_out,
                                     int w_out, int band, int span, int pad,
                                     int pad_t, int budget, int analytic,
                                     int route, int tw, void* stream) {
  if (n < 1 || band < 1 || span < 1 || h_out < 1 || w_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{h_in, w_in, h_out, w_out, band, span, pad, pad_t, budget};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      analytic ? launch<1>(src, mats, out, cov, scratch, n, g, route, tw, s)
               : launch<2>(src, mats, out, cov, scratch, n, g, route, tw, s);
  return static_cast<int>(err);
}
