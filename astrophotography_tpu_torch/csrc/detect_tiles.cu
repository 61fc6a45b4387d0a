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
// What bounds it on the H100: memory.  The least time is 1.04 ms at
// 100 x 4096^2 uint16: the 3.36 GB of raw, the A plane and the two
// master densities once at 3.35 TB/s; its 3 * (2r + 1) + 9.5 = 24.5
// operations per raw pixel at r = 2 take 0.6 ms at the f32 rate.  There
// is no matrix product (the TPU's banded bf16 matmul was a matrix-unit
// device and is not carried over: this kernel computes in float32
// throughout).  The first design staged a whole tile plus halo in 111 KB
// of shared memory, two blocks per SM, four phases between barriers:
// 16.7 ms, of which the scalar staging loads took ~8 ms and the three
// passes out of shared memory ~7.5 ms, one after the other
// (tools/k1_variants.py).
//
// Design: a rolling row window.  A block owns a strip of up to two tile
// columns (512 columns) and walks down the binned rows of `strip_tiles`
// tiles.  A thread owns 4 neighbouring columns, so a raw row is one
// 8-byte (uint16) or 16-byte (float32) load and A and the densities are
// 16-byte loads, all aligned; raw rows are loaded PF steps before they
// are used, A and the densities one step.  Per step (one binned row):
//  1. the thread bins its 4 columns and pushes them into a register ring
//     of the last 2r + 1 binned rows; the vertical pass is a sum over
//     that ring (taps from the kernel's parameter block: no loads);
//  2. it writes its 4 column sums (G and Box) to one of two shared rows
//     and its 4 densities of the previous row to a ring of four shared
//     density rows; after the step's only barrier it reads the r
//     neighbours each side for the horizontal pass (two loads for each
//     of G and Box);
//  3. a density above the threshold inside the border sets a bit; two
//     steps later, when the rows above and below stand in the density
//     ring, the threads with a bit set (few: a star is a few pixels) run
//     the 3x3 peak test out of shared memory and keep their tile's best
//     peak with its four cross neighbours.  The other threads test one
//     word;
//  4. every 32 rows the 64 threads of a tile column reduce their bests
//     (shuffles, then two warps through shared memory) and write the
//     tile's four outputs.
// The strip's halo of r + 1 columns each side (at most 4) is the work of
// two extra threads; rows and columns outside the frame read as zero and
// the border mask keeps every value they touch out of the result.  Shared
// memory is 8 rows of the strip (17 KB), so registers set the occupancy
// (three blocks of five warps per SM), and the 2r + 2 halo rows are paid
// once per strip segment (2 % at 8 tiles) instead of once per tile
// (19 %).  blockIdx.x is the frame, so neighbouring blocks walk the same
// strip of different frames and find its A and master densities in L2:
// per launch L2 serves 4 B of A and 4 B of densities per raw pixel and
// frame (13.4 GB at 100 x 4096^2) beside the 3.4 GB of raw from device
// memory.  A block that held F frames of a strip would divide those
// 13.4 GB by F at F times the registers; tools/k1_variants.py shows the
// A and density loads cost a tenth of the time, so the block holds one
// frame.  What sets the time now is the instruction count, ~280 per
// thread and step.
//
// Which radius takes which route (kernels._detect_route mirrors it): the
// ring and the neighbour loads need r at compile time, so the rolling
// kernel is instantiated for r = 2 and r = 3 (fwhm below 4.67, the
// default 3.0 included; the halo of r + 1 columns must fit one thread's
// 4).  Radii 1 and 4 to 16 take the generic route, the first design's
// staged tile, kept below with r a run-time argument.  Radii 17 to 128
// (fwhm up to ~171, the reach of the TPU kernel's 128-column lane filter
// and its 128-row band) take the separable route: the staged tile with
// its 2r halo no longer fits a block's shared memory past r = 36, so the
// column pass goes through device memory.  A first kernel bins the raw
// rows and runs the column pass of a strip of 64 binned rows x 128
// columns (its binned rows staged in shared memory, one column a thread)
// into G and Box planes; the staged kernel then reads the tile's G and
// Box rows from those planes instead of computing them, and runs the row
// pass and the peak test as before.  The planes take 8 B per binned pixel
// of a chunk of frames that the wrapper sizes (about 1 GiB).  All routes
// keep the tap order k = 0 .. 2r and the expression forms; the separable
// route also rounds each product and sum on its own (mac<true>), as the
// twin does, so its densities are the twin's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TTY = 32;    // binned rows per tile
constexpr int TTX = 256;   // columns per tile
constexpr int CPT = 4;     // columns per thread of the rolling kernel
constexpr int TPT = TTX / CPT;       // threads per tile column
constexpr int MAX_TILE_COLS = 2;     // tile columns per block
constexpr int MAX_THREADS = 160;     // 2 * 64 + 2 halo threads, in warps
constexpr int PF = 2;                // steps a raw row is loaded ahead
constexpr int RMAX = 16;             // largest radius of the generic route
constexpr int RBIG = 128;            // largest radius of the separable route
constexpr int NTHREADS = 256;        // block of the generic route
constexpr int VSEG = 64;             // binned rows per separable column block
constexpr int VCOLS = 128;           // columns (threads) per column block
constexpr float NEG = -3.0e38f;

// gr[2r+1], gc[2r+1], mean_w, inv_den, cy1, cy3, cy5, cx1, cx3, cx5; passed
// by value, so the taps are operands from the constant bank
template <int RM>
struct ParamsT {
  float v[2 * (2 * RM + 1) + 8];
};
typedef ParamsT<RMAX> Params;
typedef ParamsT<RBIG> ParamsBig;  // 2,088 B: within the 4 KB of arguments

// acc + x * w: one fused multiply-add on the rolling and staged routes;
// rounded op by op on the separable route (RN), in the twin's tap order,
// so its densities are the twin's bits: at large radii the density's
// curvature is small, and the parabola offsets magnify any difference
template <bool RN>
__device__ __forceinline__ float mac(float acc, float x, float w) {
  return RN ? __fadd_rn(acc, __fmul_rn(x, w)) : acc + x * w;
}

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

// ---- the rolling kernel (r = 2, 3) ---------------------------------------

// 4 neighbouring raw pixels of one row
template <typename T>
struct Raw;
template <>
struct Raw<uint16_t> {
  typedef uint2 V;
  static __device__ __forceinline__ V zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void unpack(V r, float (&o)[CPT]) {
    o[0] = (float)(r.x & 0xffffu);
    o[1] = (float)(r.x >> 16);
    o[2] = (float)(r.y & 0xffffu);
    o[3] = (float)(r.y >> 16);
  }
};
template <>
struct Raw<float> {
  typedef float4 V;
  static __device__ __forceinline__ V zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void unpack(V r, float (&o)[CPT]) {
    o[0] = r.x;
    o[1] = r.y;
    o[2] = r.z;
    o[3] = r.w;
  }
};

__device__ __forceinline__ void unpack4(float4 r, float (&o)[CPT]) {
  o[0] = r.x;
  o[1] = r.y;
  o[2] = r.z;
  o[3] = r.w;
}

// what one step needs beside its raw rows: the A rows of raw rows 2b and
// 2b + 1, and the master densities of the row whose density the step
// computes
struct Loads {
  float4 a0, a1, m0, m1;
  bool mf_in;
};

struct Best {
  float v, du, dd, dl, dr;
  int i;
  __device__ __forceinline__ void take(const Best& o) {
    if (o.v > v || (o.v == v && o.i < i)) *this = o;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(MAX_THREADS, 3)
detect_rolling_kernel(const T* __restrict__ frames,
                      const float* __restrict__ a_plane,
                      const float* __restrict__ mf,
                      const float* __restrict__ thresholds,
                      const float* __restrict__ exp_ratios, const Params P,
                      float* __restrict__ out_max, int* __restrict__ out_idx,
                      float* __restrict__ out_yoff,
                      float* __restrict__ out_xoff, int h, int w,
                      int tile_cols, int strip_tiles) {
  static_assert(R + 1 <= CPT, "the halo must fit one thread's columns");
  constexpr int NTAP = 2 * R + 1;
  typedef typename Raw<T>::V V;
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_red[MAX_THREADS / 32];
  const int f = blockIdx.x, strip = blockIdx.y, seg = blockIdx.z;
  const int h2 = h / 2, tyn = h2 / TTY, txn = w / TTX;
  const int ncore = TPT * tile_cols;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // threads [0, ncore) own the strip's columns, ncore the 4 columns left
  // of it, ncore + 1 the 4 right of it; the rest of the last warp idles
  const bool core = t < ncore, writer = t < ncore + 2;
  const int cg = core ? t + 1 : (t == ncore ? 0 : ncore + 1);  // column group
  const int gx0 = strip * tile_cols * TTX + CPT * (cg - 1);
  const bool col_in = writer && gx0 >= 0 && gx0 < w;
  // shared rows: two buffers of G and Box, then a ring of four density
  // rows; 4 floats of padding each side so the edge threads' neighbour
  // loads stay inside
  const int rowlen = CPT * (ncore + 2) + 8;
  const int so = 4 + CPT * cg;
  float* const sdr = smem + 4 * rowlen;
  const float mean_w = P.v[2 * NTAP], inv_den = P.v[2 * NTAP + 1];
  const float thr = thresholds[f], er = exp_ratios[f];
  const int y_first = seg * strip_tiles * TTY;
  const int y_end = min(y_first + strip_tiles * TTY, h2);
  const T* fr = frames + (size_t)f * h * w + gx0;
  const size_t mplane = (size_t)h2 * w;
  const int yb_first = y_first - 1 - R, yb_last = y_end + 1 + R;

  // raw rows 2 yb and 2 yb + 1; rows and columns outside the frame read 0
  auto raw_in = [&](int yb) {
    return col_in && yb >= 0 && yb < h2 && yb <= y_end + R;
  };
  auto load_raw = [&](int yb, V& r0, V& r1) {
    r0 = r1 = Raw<T>::zero();
    if (raw_in(yb)) {
      const T* src = fr + (size_t)(2 * yb) * w;
      r0 = __ldg(reinterpret_cast<const V*>(src));
      r1 = __ldg(reinterpret_cast<const V*>(src + w));
    }
  };
  // the A rows of binned row yb and the densities of row yb - R (both
  // come from L2)
  auto load = [&](int yb) {
    Loads L;
    L.a0 = L.a1 = L.m0 = L.m1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a_plane != nullptr && raw_in(yb)) {
      const size_t o = (size_t)(2 * yb) * w + gx0;
      L.a0 = __ldg(reinterpret_cast<const float4*>(a_plane + o));
      L.a1 = __ldg(reinterpret_cast<const float4*>(a_plane + o + w));
    }
    const int yg = yb - R;
    L.mf_in = mf != nullptr && col_in && yg >= 0 && yg < h2 &&
              yg >= y_first - 1 && yg <= y_end;
    if (L.mf_in) {
      const size_t o = (size_t)yg * w + gx0;
      L.m0 = __ldg(reinterpret_cast<const float4*>(mf + o));
      L.m1 = __ldg(reinterpret_cast<const float4*>(mf + mplane + o));
    }
    return L;
  };

  float win[NTAP][CPT];        // the last 2R + 1 binned rows
  float dprev[CPT];            // own densities of the previous row
#pragma unroll
  for (int k = 0; k < NTAP; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c) win[k][c] = 0.0f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) dprev[c] = 0.0f;
  // column of this thread inside its tile; which of its columns may peak
  const int lx0 = (t % TPT) * CPT;
  unsigned col_ok = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (core && gx0 + c >= 2 + R && gx0 + c < w - 2 - R) col_ok |= 1u << c;
  const Best none{NEG, 0.0f, 0.0f, 0.0f, 0.0f, core ? lx0 : 0x7fffffff};
  Best best = none;
  // columns of this thread whose density passed the threshold inside the
  // border, for the row computed one step (cand1) and two steps (cand2) ago
  unsigned cand1 = 0, cand2 = 0;

  // step yb: binned row yb enters the ring, the vertical pass gives row
  // yg = yb - R, the horizontal pass its density, the peak test runs on
  // row p = yg - 2.  Raw rows are loaded PF steps ahead, A and the
  // densities one step ahead.
  V q0[PF], q1[PF];
#pragma unroll
  for (int d = 0; d < PF; ++d) load_raw(yb_first + d, q0[d], q1[d]);
  Loads nxt = load(yb_first);
  for (int yb = yb_first; yb <= yb_last; ++yb) {
    const Loads cur = nxt;
    const V r0 = q0[0], r1 = q1[0];
#pragma unroll
    for (int d = 0; d + 1 < PF; ++d) {
      q0[d] = q0[d + 1];
      q1[d] = q1[d + 1];
    }
    load_raw(yb + PF, q0[PF - 1], q1[PF - 1]);
    if (yb < yb_last) nxt = load(yb + 1);
    const int yg = yb - R;
    float* sg = smem + ((yb - yb_first) & 1) * 2 * rowlen;
    float* sb = sg + rowlen;

    // 1. bin, push, vertical pass
    float v0[CPT], v1[CPT];
    Raw<T>::unpack(r0, v0);
    Raw<T>::unpack(r1, v1);
    if (a_plane != nullptr) {
      float a0[CPT], a1[CPT];
      unpack4(cur.a0, a0);
      unpack4(cur.a1, a1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        v0[c] = v0[c] * a0[c];
        v1[c] = v1[c] * a1[c];
      }
    }
#pragma unroll
    for (int k = 0; k < NTAP - 1; ++k)
#pragma unroll
      for (int c = 0; c < CPT; ++c) win[k][c] = win[k + 1][c];
    float g[CPT], b[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      win[NTAP - 1][c] = 0.5f * (v0[c] + v1[c]);
      float gs = 0.0f, bs = 0.0f;
#pragma unroll
      for (int k = 0; k < NTAP; ++k) {
        gs += win[k][c] * P.v[k];
        bs += win[k][c];
      }
      g[c] = gs;
      b[c] = bs;
    }

    // 2. exchange through shared memory, horizontal pass.  The density
    //    row yg - 1 goes to slot (yg - 1) & 3 of its ring; the rows the
    //    peak test reads below are in the other three slots.
    if (writer) {
      *reinterpret_cast<float4*>(sg + so) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(sb + so) = make_float4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<float4*>(sdr + ((yg - 1) & 3) * rowlen + so) =
          make_float4(dprev[0], dprev[1], dprev[2], dprev[3]);
    }
    __syncthreads();
    float G[CPT + 2 * R], B[CPT + 2 * R];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      G[R + c] = g[c];
      B[R + c] = b[c];
    }
    if constexpr (R == 2) {
      const float2 gl = *reinterpret_cast<const float2*>(sg + so - 2);
      const float2 gh = *reinterpret_cast<const float2*>(sg + so + CPT);
      const float2 bl = *reinterpret_cast<const float2*>(sb + so - 2);
      const float2 bh = *reinterpret_cast<const float2*>(sb + so + CPT);
      G[0] = gl.x, G[1] = gl.y, G[R + CPT] = gh.x, G[R + CPT + 1] = gh.y;
      B[0] = bl.x, B[1] = bl.y, B[R + CPT] = bh.x, B[R + CPT + 1] = bh.y;
    } else {
      const float4 gl = *reinterpret_cast<const float4*>(sg + so - 4);
      const float4 gh = *reinterpret_cast<const float4*>(sg + so + CPT);
      const float4 bl = *reinterpret_cast<const float4*>(sb + so - 4);
      const float4 bh = *reinterpret_cast<const float4*>(sb + so + CPT);
      G[0] = gl.y, G[1] = gl.z, G[R - 1] = gl.w;
      G[R + CPT] = gh.x, G[R + CPT + 1] = gh.y, G[R + CPT + R - 1] = gh.z;
      B[0] = bl.y, B[1] = bl.z, B[R - 1] = bl.w;
      B[R + CPT] = bh.x, B[R + CPT + 1] = bh.y, B[R + CPT + R - 1] = bh.z;
    }
    float m0[CPT], m1[CPT];
    unpack4(cur.m0, m0);
    unpack4(cur.m1, m1);
    unsigned cand0 = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float gs = 0.0f, bs = 0.0f;
#pragma unroll
      for (int s = 0; s < NTAP; ++s) {
        gs += G[c + s] * P.v[NTAP + s];
        bs += B[c + s];
      }
      float d = (gs - mean_w * bs) * inv_den;
      if (cur.mf_in) d = d - (m0[c] + er * m1[c]);
      dprev[c] = d;
      if (d > thr) cand0 |= 1u << c;
    }
    if (!(yg >= y_first && yg < y_end && yg >= R + 1 && yg < h2 - R - 1))
      cand0 = 0;
    cand0 &= col_ok;

    // 3. peak test on row p = yg - 2, only where a density passed the
    //    threshold (rare): rows p - 1, p, p + 1 from the ring
    const int p = yg - 2;
    if (cand2 != 0) {
      const float* up = sdr + ((p - 1) & 3) * rowlen + so;
      const float* mid = sdr + (p & 3) * rowlen + so;
      const float* dn = sdr + ((p + 1) & 3) * rowlen + so;
      const int ly = p & (TTY - 1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if ((cand2 >> c) & 1u) {
          const float centre = mid[c];
          const float earlier =
              fmaxf(fmaxf(up[c - 1], up[c]), fmaxf(up[c + 1], mid[c - 1]));
          const float later =
              fmaxf(fmaxf(mid[c + 1], dn[c - 1]), fmaxf(dn[c], dn[c + 1]));
          // rows and columns ascend, so the first of equal peaks stays
          if (centre > earlier && centre >= later && centre > best.v)
            best = Best{centre, up[c], dn[c], mid[c - 1], mid[c + 1],
                        ly * TTX + lx0 + c};
        }
      }
    }
    cand2 = cand1;
    cand1 = cand0;
    // 4. end of a tile: larger value wins, equal values -> lower index
    if (p >= y_first && p < y_end && (p & (TTY - 1)) == TTY - 1) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Best o;
        o.v = __shfl_down_sync(0xffffffffu, best.v, off);
        o.i = __shfl_down_sync(0xffffffffu, best.i, off);
        o.du = __shfl_down_sync(0xffffffffu, best.du, off);
        o.dd = __shfl_down_sync(0xffffffffu, best.dd, off);
        o.dl = __shfl_down_sync(0xffffffffu, best.dl, off);
        o.dr = __shfl_down_sync(0xffffffffu, best.dr, off);
        best.take(o);
      }
      if (lane == 0) s_red[warp] = best;
      __syncthreads();
      if (core && (t % TPT) == 0) {
        Best m = s_red[warp];
        m.take(s_red[warp + 1]);
        const float* cal = P.v + 2 * NTAP + 2;
        const int ty = p / TTY, tx = strip * tile_cols + t / TPT;
        const size_t o = ((size_t)f * tyn + ty) * txn + tx;
        out_max[o] = m.v;
        out_idx[o] = m.i;
        out_yoff[o] = paroff(m.du, m.v, m.dd, cal[0], cal[1], cal[2]);
        out_xoff[o] = paroff(m.dl, m.v, m.dr, cal[3], cal[4], cal[5]);
      }
      best = none;
    }
  }
}

template <typename T, int R>
cudaError_t launch_rolling(const void* frames, const float* a_plane,
                           const float* mf, const float* thr, const float* er,
                           const Params& P, float* out_max, int* out_idx,
                           float* out_yoff, float* out_xoff, int n, int h,
                           int w, int tile_cols, int strip_tiles,
                           cudaStream_t stream) {
  if (tile_cols < 1 || tile_cols > MAX_TILE_COLS || strip_tiles < 1 ||
      (w / TTX) % tile_cols)
    return cudaErrorInvalidValue;
  const int threads = (TPT * tile_cols + 2 + 31) / 32 * 32;
  // two buffers of the G and Box rows, then the ring of 4 density rows
  const size_t smem =
      sizeof(float) * 8 * (size_t)(CPT * (TPT * tile_cols + 2) + 8);
  const int tyn = h / 2 / TTY;
  dim3 grid(n, w / TTX / tile_cols, (tyn + strip_tiles - 1) / strip_tiles);
  detect_rolling_kernel<T, R><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(frames), a_plane, mf, thr, er, P, out_max, out_idx,
      out_yoff, out_xoff, h, w, tile_cols, strip_tiles);
  return cudaGetLastError();
}

// ---- the generic route (any r up to RMAX): a staged tile -----------------
//
// One block per (frame, tile), 256 threads, one per column.  The block
// stages its binned rows (tile + r + 2 halo rows, tile + r + 1 halo
// columns each side) in shared memory; the column pass, the row pass and
// the peak test then run out of shared memory, a barrier between them.
// With GB (the separable route) the column pass's G and Box rows are read
// from the planes `gbuf` / `bbuf` (zero outside the frame's columns; rows
// outside the frame only feed densities the border excludes).

template <typename T>
__device__ __forceinline__ float to_f(T v) { return static_cast<float>(v); }

template <typename T, typename PT, bool GB>
__global__ void __launch_bounds__(NTHREADS)
detect_staged_kernel(const T* __restrict__ frames,
                     const float* __restrict__ a_plane,
                     const float* __restrict__ mf,
                     const float* __restrict__ thresholds,
                     const float* __restrict__ exp_ratios, const PT P,
                     const float* __restrict__ gbuf,
                     const float* __restrict__ bbuf,
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
  float* s_g = GB ? s_bin : s_bin + BR * BC; // DR x BC
  float* s_b = s_g + DR * BC;                // DR x BC
  const int tid = threadIdx.x;

  for (int i = tid; i < 2 * ntap + 8; i += NTHREADS) s_par[i] = P.v[i];
  const float* gr = s_par;
  const float* gc = s_par + ntap;
  if (GB) {
    // 1-2. the column pass's rows [y0 - 1, y0 + TTY + 1), columns
    //      [x0 - 1 - r, x0 + TTX + 1 + r), from the planes
    const size_t plane = (size_t)f * h2 * w;
    for (int i = tid; i < DR * BC; i += NTHREADS) {
      int dr = i / BC, bc = i - dr * BC;
      int gy = y0 - 1 + dr, gx = x0 - 1 - r + bc;
      bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w;
      size_t o = plane + (size_t)gy * w + gx;
      s_g[i] = in ? gbuf[o] : 0.0f;
      s_b[i] = in ? bbuf[o] : 0.0f;
    }
    __syncthreads();
  } else {
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
  }
  const float mean_w = s_par[2 * ntap];
  const float inv_den = s_par[2 * ntap + 1];

  // 3. row (column) pass + master-density subtraction -> density,
  //    stored over the binned rows (no longer needed), or after the G
  //    and Box rows on the separable route
  float* s_d = GB ? s_b + DR * BC : s_bin;
  const float er = exp_ratios[f];
  for (int i = tid; i < DR * DC; i += NTHREADS) {
    int dr = i / DC, dc = i - dr * DC;
    float g = 0.0f, b = 0.0f;
    for (int s = 0; s < ntap; ++s) {
      g = mac<GB>(g, s_g[dr * BC + dc + s], gc[s]);
      b += s_b[dr * BC + dc + s];
    }
    float d = GB ? __fmul_rn(__fsub_rn(g, __fmul_rn(mean_w, b)), inv_den)
                 : (g - mean_w * b) * inv_den;
    int gy = y0 - 1 + dr, gx = x0 - 1 + dc;
    if (mf != nullptr && gy >= 0 && gy < h2 && gx >= 0 && gx < w) {
      size_t o = (size_t)gy * w + gx;
      const float m0 = mf[o], m1 = mf[(size_t)h2 * w + o];
      d = GB ? __fsub_rn(d, __fadd_rn(m0, __fmul_rn(er, m1)))
             : d - (m0 + er * m1);
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
cudaError_t launch_staged(const void* frames, const float* a_plane,
                          const float* mf, const float* thr, const float* er,
                          const Params& P, float* out_max, int* out_idx,
                          float* out_yoff, float* out_xoff, int n, int h,
                          int w, int r, cudaStream_t stream) {
  const int ntap = 2 * r + 1;
  const int DR = TTY + 2, DC = TTX + 2;
  const int BR = DR + 2 * r, BC = DC + 2 * r;
  size_t smem = sizeof(float) * (size_t)(2 * ntap + 8 + BR * BC + 2 * DR * BC);
  cudaError_t err = cudaFuncSetAttribute(
      detect_staged_kernel<T, Params, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n, (h / 2 / TTY) * (w / TTX));
  detect_staged_kernel<T, Params, false><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(frames), a_plane, mf, thr, er, P, nullptr,
      nullptr, out_max, out_idx, out_yoff, out_xoff, h, w, r);
  return cudaGetLastError();
}

// ---- the separable route (RMAX < r <= RBIG) -------------------------------
//
// The column pass of binned rows [64 by, 64 by + 64) and columns
// [128 bx, 128 bx + 128) of frame z: each thread stages the binned rows
// of its own column, with the r halo rows each side (zero outside the
// frame), in shared memory ([rows][VCOLS], so no barrier beyond the
// taps' and no bank conflict), then sums its G and Box in tap order.
template <typename T>
__global__ void __launch_bounds__(VCOLS)
detect_vpass_kernel(const T* __restrict__ frames,
                    const float* __restrict__ a_plane, const ParamsBig P,
                    float* __restrict__ gbuf, float* __restrict__ bbuf,
                    int h, int w, int r) {
  extern __shared__ float smem[];
  const int ntap = 2 * r + 1;
  const int h2 = h / 2;
  const int f = blockIdx.z, y0 = blockIdx.y * VSEG;
  const int x = blockIdx.x * VCOLS + threadIdx.x;
  const int rows = min(VSEG, h2 - y0);
  float* gr = smem;                  // ntap column taps
  float* col = smem + ntap + threadIdx.x;
  for (int k = threadIdx.x; k < ntap; k += VCOLS) gr[k] = P.v[k];
  const T* fr = frames + (size_t)f * h * w;
  for (int k = 0; k < rows + 2 * r; ++k) {
    const int gy = y0 - r + k;
    float v = 0.0f;
    if (gy >= 0 && gy < h2) {
      const size_t o0 = (size_t)(2 * gy) * w + x;
      float v0 = to_f(fr[o0]);
      float v1 = to_f(fr[o0 + w]);
      if (a_plane != nullptr) {  // no product folded into the add
        v0 = __fmul_rn(v0, a_plane[o0]);
        v1 = __fmul_rn(v1, a_plane[o0 + w]);
      }
      v = 0.5f * __fadd_rn(v0, v1);
    }
    col[k * VCOLS] = v;
  }
  __syncthreads();
  const size_t plane = (size_t)f * h2 * w;
  for (int y = 0; y < rows; ++y) {
    float g = 0.0f, b = 0.0f;
    for (int k = 0; k < ntap; ++k) {
      const float v = col[(y + k) * VCOLS];
      g = mac<true>(g, v, gr[k]);
      b += v;
    }
    const size_t o = plane + (size_t)(y0 + y) * w + x;
    gbuf[o] = g;
    bbuf[o] = b;
  }
}

// scratch: 2 * chunk * (h / 2) * w floats, the G then the Box planes of
// `chunk` frames; the frames go through both kernels chunk by chunk
template <typename T>
cudaError_t launch_separable(const void* frames, const float* a_plane,
                             const float* mf, const float* thr,
                             const float* er, const ParamsBig& P,
                             float* out_max, int* out_idx, float* out_yoff,
                             float* out_xoff, int n, int h, int w, int r,
                             float* scratch, int chunk, cudaStream_t stream) {
  if (scratch == nullptr || chunk < 1 || w % VCOLS)
    return cudaErrorInvalidValue;
  const int ntap = 2 * r + 1, h2 = h / 2;
  const int DR = TTY + 2, DC = TTX + 2, BC = DC + 2 * r;
  const size_t vsmem = sizeof(float) * ((size_t)(VSEG + 2 * r) * VCOLS + ntap);
  const size_t hsmem =
      sizeof(float) * (size_t)(2 * ntap + 8 + 2 * DR * BC + DR * DC);
  cudaError_t err = cudaFuncSetAttribute(
      detect_vpass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)vsmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(detect_staged_kernel<T, ParamsBig, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hsmem);
  if (err != cudaSuccess) return err;
  const size_t fplane = (size_t)h * w;
  const int tiles = (h2 / TTY) * (w / TTX);
  float* gbuf = scratch;
  float* bbuf = scratch + (size_t)chunk * h2 * w;
  for (int f0 = 0; f0 < n; f0 += chunk) {
    const int c = min(chunk, n - f0);
    const T* fr = static_cast<const T*>(frames) + (size_t)f0 * fplane;
    detect_vpass_kernel<T>
        <<<dim3(w / VCOLS, (h2 + VSEG - 1) / VSEG, c), VCOLS, vsmem, stream>>>(
            fr, a_plane, P, gbuf, bbuf, h, w, r);
    const size_t t0 = (size_t)f0 * tiles;
    detect_staged_kernel<T, ParamsBig, true>
        <<<dim3(c, tiles), NTHREADS, hsmem, stream>>>(
            fr, a_plane, mf, thr + f0, er + f0, P, gbuf, bbuf, out_max + t0,
            out_idx + t0, out_yoff + t0, out_xoff + t0, h, w, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* frames, const float* a_plane, const float* mf,
                   const float* thr, const float* er, const float* params,
                   float* out_max, int* out_idx, float* out_yoff,
                   float* out_xoff, int n, int h, int w, int r, int tile_cols,
                   int strip_tiles, float* scratch, int chunk,
                   cudaStream_t stream) {
  const int np = 2 * (2 * r + 1) + 8;
  if (r > RMAX) {
    ParamsBig P;
    for (int i = 0; i < np; ++i) P.v[i] = params[i];
    return launch_separable<T>(frames, a_plane, mf, thr, er, P, out_max,
                               out_idx, out_yoff, out_xoff, n, h, w, r,
                               scratch, chunk, stream);
  }
  Params P;
  for (int i = 0; i < np; ++i) P.v[i] = params[i];
  if (r == 2)
    return launch_rolling<T, 2>(frames, a_plane, mf, thr, er, P, out_max,
                                out_idx, out_yoff, out_xoff, n, h, w,
                                tile_cols, strip_tiles, stream);
  if (r == 3)
    return launch_rolling<T, 3>(frames, a_plane, mf, thr, er, P, out_max,
                                out_idx, out_yoff, out_xoff, n, h, w,
                                tile_cols, strip_tiles, stream);
  return launch_staged<T>(frames, a_plane, mf, thr, er, P, out_max, out_idx,
                          out_yoff, out_xoff, n, h, w, r, stream);
}

}  // namespace

// params: 2 * (2r + 1) + 8 floats in host memory (see Params); tile_cols
// and strip_tiles: the rolling kernel's block, from kernels._detect_layout;
// scratch and chunk: the separable route's planes (kernels._detect_chunk),
// null and 0 on the others
extern "C" int detect_tiles_launch(const void* frames, int is_u16,
                                   const float* a_plane, const float* mf,
                                   const float* thresholds,
                                   const float* exp_ratios,
                                   const float* params, float* out_max,
                                   int* out_idx, float* out_yoff,
                                   float* out_xoff, int n, int h, int w,
                                   int r, int tile_cols, int strip_tiles,
                                   float* scratch, int chunk, void* stream) {
  if (r < 1 || r > RBIG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_u16 ? launch<uint16_t>(frames, a_plane, mf, thresholds, exp_ratios,
                                params, out_max, out_idx, out_yoff, out_xoff,
                                n, h, w, r, tile_cols, strip_tiles, scratch,
                                chunk, s)
             : launch<float>(frames, a_plane, mf, thresholds, exp_ratios,
                             params, out_max, out_idx, out_yoff, out_xoff, n,
                             h, w, r, tile_cols, strip_tiles, scratch, chunk,
                             s);
  return static_cast<int>(err);
}
