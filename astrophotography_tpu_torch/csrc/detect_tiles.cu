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
// What bounds it on the H100: memory up to r = 5, operations from r = 6.
// At 100 x 4096^2 uint16 the 3.36 GB of raw, the A plane and the two
// master densities take 1.04 ms once at 3.35 TB/s; its 3 * (2r + 1) + 9.5
// operations per raw pixel take 0.6 ms at r = 2 at the f32 rate (67
// TFLOP/s), 1.21 ms at r = 6 and 2.72 ms at r = 16.  There is no matrix
// product (the TPU's banded bf16 matmul was a matrix-unit device and is
// not carried over: this kernel computes in float32 throughout).  The
// first design staged a whole tile plus halo in shared memory, one block
// per (frame, tile), four phases between barriers: 16.7 ms at r = 2 (the
// scalar staging loads ~8 ms, the three passes ~7.5 ms, one after the
// other; tools/k1_variants.py), 35-57 ms at r = 4-16, where a block of
// 117-155 KB left one per SM (tools/k1_routes.py).
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
// Which radius takes which route (kernels._detect_route mirrors it):
//  * r = 2 and 3 (fwhm below 4.67, the default 3.0 included): the rolling
//    kernel above, its ring of 2r + 1 binned rows in registers, FMAs
//    contracted (its sharp peaks keep it within chip_smoke._k1_agrees'
//    rule of the twin).
//  * r = 1 and 4 to 16 (fwhm 4.67 to 22.0: an oversampled rig, e.g. 2.5"
//    seeing at 0.29"/px is ~8.5 px): the ring kernel, the same strip walk
//    with the ring of the last 2r binned rows in shared memory (each thread
//    reads and writes only its own columns there, so the vertical pass
//    needs no barrier), ceil((r + 1) / 4) halo threads each side, and the
//    horizontal pass sliding a 12-float window over the G and Box rows
//    (one 16-byte load per row and 4 taps).  One instance per radius: the
//    taps are constant-bank operands and every shared offset is known.
//    The first 2r steps of a strip segment only fill the ring.
//  * r = 17 to 128 (fwhm up to ~171, the reach of the TPU kernel's
//    128-column lane filter and its 128-row band): the separable route.
//    A ring of 2r rows x a strip no longer fits shared memory, so the
//    column pass goes through device memory: a column-pass kernel (one
//    column a thread, a shared ring of 2r + 8 binned rows, 8 output rows a
//    step from one read of each ring row) writes G and Box planes; the
//    planes kernel then walks the strip as the ring kernel does, reading
//    the G and Box rows of each step from the planes with 16-byte loads.
//    The planes take 8 B per binned pixel of a chunk of frames that the
//    wrapper sizes (about 1 GiB).
// All routes keep the tap order k = 0 .. 2r and the expression forms.  The
// ring and separable routes round each product and sum on its own (mac),
// as the twin does, so their tile maxima are the twin's bits; no FMA can
// be used there, so their operations take at least twice the bound's f32
// time.  What sets their time is instruction issue: 24 f32 operations per
// tap, binned row and 4 columns, beside the ring's and the window's
// shared-memory loads; the separable route also writes and rereads its
// planes (8 B per binned pixel each way).

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
constexpr int RMAX = 16;             // largest radius of the ring route
constexpr int RBIG = 128;            // largest radius of the separable route
constexpr int VCOLS = 128;           // columns (threads) per column block
constexpr int VM = 8;                // rows a column-pass thread sums a step
constexpr float NEG = -3.0e38f;

// gr[2r+1], gc[2r+1], mean_w, inv_den, cy1, cy3, cy5, cx1, cx3, cx5; passed
// by value, so the taps are operands from the constant bank
template <int RM>
struct ParamsT {
  float v[2 * (2 * RM + 1) + 8];
};
typedef ParamsT<RMAX> Params;
typedef ParamsT<RBIG> ParamsBig;  // 2,088 B: within the 4 KB of arguments

// acc + x * w rounded op by op (no fused multiply-add), as the twin
// computes it: the ring and separable routes sum every tap so, in the
// twin's tap order, so their densities are the twin's bits.  The parabola
// offsets of a wide footprint's flat peak magnify any difference: with
// FMAs the ring kernel's offsets left the 1e-4 bin of chip_smoke's rule at
// radius 8 on 8 px stars
__device__ __forceinline__ float mac(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
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

// ---- what the ring and planes kernels share --------------------------------

// floats of padding each side of a shared row of the ring and planes
// kernels: the horizontal pass's window may read up to 15 floats past a
// thread's last needed column
constexpr int HPAD = 16;

// The horizontal pass of one thread's CPT columns x_c:
//   gs[c] = sum_s G[x_c - r + s] * gc[s],  bs[c] = sum_s B[x_c - r + s]
// in tap order s = 0 .. ntap - 1, for the columns set in `need`.  gp / bp
// point at the thread's first column minus RL = 4 ceil(r / 4) (16-byte
// aligned); D = RL - r.  A window of 12 floats of each row slides over it
// 4 taps at a time, one 16-byte load per row and step.

// 4 floats of shared memory into dst[0 .. 3]
__device__ __forceinline__ void take4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// taps k0 .. k0 + 3 (those below ntap where GUARD) with weights wk, then
// the window slides by 4
template <int D, bool GUARD>
__device__ __forceinline__ void hblock(const float* gp, const float* bp,
                                       float (&wg)[12], float (&wb)[12],
                                       const float (&wk)[4], int k0, int ntap,
                                       unsigned need, float (&gs)[CPT],
                                       float (&bs)[CPT]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!GUARD || k0 + j < ntap) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if ((need >> c) & 1u) {
          gs[c] = mac(gs[c], wg[D + c + j], wk[j]);
          bs[c] = __fadd_rn(bs[c], wb[D + c + j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    wg[i] = wg[i + 4];
    wb[i] = wb[i + 4];
  }
  take4(gp + k0 + 12, wg + 8);
  take4(bp + k0 + 12, wb + 8);
}

template <int D>
__device__ __forceinline__ void hwindow(const float* gp, const float* bp,
                                        float (&wg)[12], float (&wb)[12],
                                        float (&gs)[CPT], float (&bs)[CPT]) {
#pragma unroll
  for (int i = 0; i < 12; i += 4) {
    take4(gp + i, wg + i);
    take4(bp + i, wb + i);
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) gs[c] = bs[c] = 0.0f;
}

// the ring kernel's pass: NTAP a compile-time value, the taps wt(k)
// constant-bank operands, every offset known
template <int D, int NTAP, typename Wt>
__device__ __forceinline__ void hpass_ct(const float* __restrict__ gp,
                                         const float* __restrict__ bp,
                                         unsigned need, Wt wt,
                                         float (&gs)[CPT], float (&bs)[CPT]) {
  float wg[12], wb[12];
  hwindow<D>(gp, bp, wg, wb, gs, bs);
#pragma unroll
  for (int k0 = 0; k0 < NTAP; k0 += 4) {
    float wk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wk[j] = k0 + j < NTAP ? wt(k0 + j) : 0.0f;
    hblock<D, true>(gp, bp, wg, wb, wk, k0, NTAP, need, gs, bs);
  }
}

// the planes kernel's pass: a run-time tap count, the taps `w` in shared
// memory (16-byte loads, zero-padded to a multiple of 4); whole blocks of
// 4 taps run three to an iteration with no guard (so the window's slides
// are register renames), the rest one block at a time, each tap guarded
template <int D>
__device__ __forceinline__ void hpass_rt(const float* __restrict__ gp,
                                         const float* __restrict__ bp,
                                         const float* __restrict__ w, int ntap,
                                         unsigned need, float (&gs)[CPT],
                                         float (&bs)[CPT]) {
  float wg[12], wb[12], wk[4];
  hwindow<D>(gp, bp, wg, wb, gs, bs);
  const int full = ntap / 12 * 12;
  int k0 = 0;
#pragma unroll 1
  for (; k0 < full; k0 += 12) {
#pragma unroll
    for (int b = 0; b < 12; b += 4) {
      take4(w + k0 + b, wk);
      hblock<D, false>(gp, bp, wg, wb, wk, k0 + b, ntap, need, gs, bs);
    }
  }
#pragma unroll 1
  for (; k0 < ntap; k0 += 4) {
    take4(w + k0, wk);
    hblock<D, true>(gp, bp, wg, wb, wk, k0, ntap, need, gs, bs);
  }
}

// the 3x3 peak test of density row p (the thread's columns of rows p - 1,
// p, p + 1 at up, mid, dn in shared memory), for the columns set in `cand`
// (few: a star is a few pixels); keeps the thread's best peak with its
// cross neighbours
__device__ __forceinline__ void peak_test(const float* up, const float* mid,
                                          const float* dn, int p, int lx0,
                                          unsigned cand, Best& best) {
  const int ly = p & (TTY - 1);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if ((cand >> c) & 1u) {
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

// the end of a tile (row p): the 64 threads of each tile column reduce
// their bests (shuffles, then two warps through shared memory), larger
// value first and equal values to the lower index, and write the tile's
// four outputs.  Every thread of the block calls it.
__device__ __forceinline__ void tile_end(Best& best, const Best& none,
                                         Best* s_red, bool core, int t,
                                         int p, int f, int tyn, int txn,
                                         int tx0, const float* cal,
                                         float* out_max, int* out_idx,
                                         float* out_yoff, float* out_xoff) {
  const int lane = t & 31, warp = t >> 5;
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
    const size_t o = ((size_t)f * tyn + p / TTY) * txn + tx0 + t / TPT;
    out_max[o] = m.v;
    out_idx[o] = m.i;
    out_yoff[o] = paroff(m.du, m.v, m.dd, cal[0], cal[1], cal[2]);
    out_xoff[o] = paroff(m.dl, m.v, m.dr, cal[3], cal[4], cal[5]);
  }
  best = none;
}

// ---- the ring kernel (r = 1 and 4 .. 16) -----------------------------------

// a ring block's threads: `HALO` column groups of 4 each side of the strip
// hold its r + 1 halo columns; the horizontal pass reads RL columns each
// side of a thread's own 4, D of them beyond the radius
template <int R>
struct RingShape {
  static constexpr int NTAP = 2 * R + 1;
  static constexpr int HALO = (R + 1 + CPT - 1) / CPT;
  static constexpr int RL = CPT * ((R + CPT - 1) / CPT);
  static constexpr int D = RL - R;
  static constexpr int DEPTH = 2 * R;  // binned rows the ring keeps
  // a shared row, as long for one tile column as for two (so every offset
  // is a compile-time value)
  static constexpr int ROWLEN = CPT * (TPT * MAX_TILE_COLS + 2 * HALO) +
                                2 * HPAD;
  static constexpr int SMEM = 4 * (DEPTH + 8) * ROWLEN;
  // three blocks an SM where their shared memory fits (to r = 13), else two
  static constexpr int MIN_BLOCKS = 3 * (SMEM + 1024 + 256) <= 233472 ? 3 : 2;
};

// The rolling kernel's strip walk, for radii whose 2r + 1 binned rows do
// not fit a thread's registers.  Per step (one binned row yb):
//  1. each thread bins its 4 columns; the vertical pass sums the 2r rows
//     before it out of a shared ring (each thread reads and writes only
//     its own columns there, so no barrier) and the new row from
//     registers, then the new row replaces the oldest in the ring;
//  2. G and Box rows go to shared memory, the densities of the previous
//     row to the density ring; after the step's only barrier the
//     horizontal pass slides a window over the neighbours (hpass);
//  3. peak test two rows back and the tile's reduction, as the rolling
//     kernel does.
// The first 2r steps of a strip segment only fill the ring.  Halo threads
// compute the strip's halo columns; only the innermost one each side
// computes a density (the column the peak test reads next to the strip).
template <typename T, int R>
__global__ void __launch_bounds__(MAX_THREADS, RingShape<R>::MIN_BLOCKS)
detect_ring_kernel(const T* __restrict__ frames,
                   const float* __restrict__ a_plane,
                   const float* __restrict__ mf,
                   const float* __restrict__ thresholds,
                   const float* __restrict__ exp_ratios, const Params P,
                   float* __restrict__ out_max, int* __restrict__ out_idx,
                   float* __restrict__ out_yoff, float* __restrict__ out_xoff,
                   int h, int w, int tile_cols, int strip_tiles) {
  typedef RingShape<R> S;
  constexpr int NTAP = S::NTAP, HALO = S::HALO, DEPTH = S::DEPTH;
  typedef typename Raw<T>::V V;
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_red[MAX_THREADS / 32];
  const int f = blockIdx.x, strip = blockIdx.y, seg = blockIdx.z;
  const int h2 = h / 2, tyn = h2 / TTY, txn = w / TTX;
  const int ncore = TPT * tile_cols;
  const int t = threadIdx.x;
  // threads [0, ncore) own the strip's columns, the next HALO the groups
  // left of it (outermost first), the next HALO those right of it
  const bool core = t < ncore, writer = t < ncore + 2 * HALO;
  const int cg = core ? HALO + t : (t < ncore + HALO ? t - ncore : t);
  const unsigned need = core ? 0xfu
                        : cg == HALO - 1 ? 0x8u
                        : cg == HALO + ncore ? 0x1u : 0u;
  const int gx0 = strip * tile_cols * TTX + CPT * (cg - HALO);
  const bool col_in = writer && gx0 >= 0 && gx0 < w;
  // shared rows: the ring of DEPTH binned rows, two buffers of G and Box,
  // the ring of four density rows
  constexpr int rowlen = S::ROWLEN;
  const int so = HPAD + CPT * cg;
  float* const ring = smem;
  float* const sdr = smem + (DEPTH + 4) * rowlen;
  const float mean_w = P.v[2 * NTAP], inv_den = P.v[2 * NTAP + 1];
  const float thr = thresholds[f], er = exp_ratios[f];
  const int y_first = seg * strip_tiles * TTY;
  const int y_end = min(y_first + strip_tiles * TTY, h2);
  const T* fr = frames + (size_t)f * h * w + gx0;
  const size_t mplane = (size_t)h2 * w;
  const int yb_first = y_first - 1 - R, yb_last = y_end + 1 + R;

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
  auto load = [&](int yb) {
    Loads L;
    L.a0 = L.a1 = L.m0 = L.m1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a_plane != nullptr && raw_in(yb)) {
      const size_t o = (size_t)(2 * yb) * w + gx0;
      L.a0 = __ldg(reinterpret_cast<const float4*>(a_plane + o));
      L.a1 = __ldg(reinterpret_cast<const float4*>(a_plane + o + w));
    }
    const int yg = yb - R;
    L.mf_in = mf != nullptr && need != 0u && col_in && yg >= 0 && yg < h2 &&
              yg >= y_first - 1 && yg <= y_end;
    if (L.mf_in) {
      const size_t o = (size_t)yg * w + gx0;
      L.m0 = __ldg(reinterpret_cast<const float4*>(mf + o));
      L.m1 = __ldg(reinterpret_cast<const float4*>(mf + mplane + o));
    }
    return L;
  };

  float dprev[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dprev[c] = 0.0f;
  const int lx0 = (t % TPT) * CPT;
  unsigned col_ok = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (core && gx0 + c >= 2 + R && gx0 + c < w - 2 - R) col_ok |= 1u << c;
  const Best none{NEG, 0.0f, 0.0f, 0.0f, 0.0f, core ? lx0 : 0x7fffffff};
  Best best = none;
  unsigned cand1 = 0, cand2 = 0;
  int slot = 0;  // the ring slot of binned row yb (and of row yb - 2R)

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
    const int step = yb - yb_first;
    float* const rs = ring + slot * rowlen + so;
    const int oldest = slot;
    slot = slot + 1 == DEPTH ? 0 : slot + 1;

    // 1. bin; fill the ring, or sum the vertical pass and push
    float v0[CPT], v1[CPT], nb[CPT];
    Raw<T>::unpack(r0, v0);
    Raw<T>::unpack(r1, v1);
    if (a_plane != nullptr) {
      float a0[CPT], a1[CPT];
      unpack4(cur.a0, a0);
      unpack4(cur.a1, a1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        v0[c] = __fmul_rn(v0[c], a0[c]);  // no product folded into the add
        v1[c] = __fmul_rn(v1[c], a1[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      nb[c] = 0.5f * __fadd_rn(v0[c], v1[c]);
    if (step < DEPTH) {
      if (writer)
        *reinterpret_cast<float4*>(rs) = make_float4(nb[0], nb[1], nb[2], nb[3]);
      continue;
    }
    const int yg = yb - R;
    float g[CPT], b[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) g[c] = b[c] = 0.0f;
    if (writer) {
      // tap k reads slot oldest + k, wrapped: from p_lo before the ring's
      // end, from p_hi (DEPTH rows back) past it
      const float* const p_lo = ring + oldest * rowlen + so;
      const float* const p_hi = p_lo - DEPTH * rowlen;
      const int split = DEPTH - oldest;
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        float x[CPT];
        take4((k < split ? p_lo : p_hi) + k * rowlen, x);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          g[c] = mac(g[c], x[c], P.v[k]);
          b[c] = __fadd_rn(b[c], x[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        g[c] = mac(g[c], nb[c], P.v[DEPTH]);
        b[c] = __fadd_rn(b[c], nb[c]);
      }
      *reinterpret_cast<float4*>(rs) = make_float4(nb[0], nb[1], nb[2], nb[3]);
    }

    // 2. exchange through shared memory, horizontal pass
    float* const sg = smem + (DEPTH + 2 * (step & 1)) * rowlen;
    float* const sb = sg + rowlen;
    if (writer) {
      *reinterpret_cast<float4*>(sg + so) = make_float4(g[0], g[1], g[2], g[3]);
      *reinterpret_cast<float4*>(sb + so) = make_float4(b[0], b[1], b[2], b[3]);
    }
    if (need != 0u)
      *reinterpret_cast<float4*>(sdr + ((yg - 1) & 3) * rowlen + so) =
          make_float4(dprev[0], dprev[1], dprev[2], dprev[3]);
    __syncthreads();
    unsigned cand0 = 0;
    if (need != 0u) {
      float gs[CPT], bs[CPT], m0[CPT], m1[CPT];
      hpass_ct<S::D, NTAP>(sg + so - S::RL, sb + so - S::RL, need,
                           [&](int k) { return P.v[NTAP + k]; }, gs, bs);
      unpack4(cur.m0, m0);
      unpack4(cur.m1, m1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float d = __fmul_rn(__fsub_rn(gs[c], __fmul_rn(mean_w, bs[c])),
                            inv_den);
        if (cur.mf_in)
          d = __fsub_rn(d, __fadd_rn(m0[c], __fmul_rn(er, m1[c])));
        dprev[c] = d;
        if (d > thr) cand0 |= 1u << c;
      }
    }
    if (!(yg >= y_first && yg < y_end && yg >= R + 1 && yg < h2 - R - 1))
      cand0 = 0;
    cand0 &= col_ok;

    // 3. peak test on row p = yg - 2; 4. end of a tile
    const int p = yg - 2;
    if (cand2 != 0)
      peak_test(sdr + ((p - 1) & 3) * rowlen + so, sdr + (p & 3) * rowlen + so,
                sdr + ((p + 1) & 3) * rowlen + so, p, lx0, cand2, best);
    cand2 = cand1;
    cand1 = cand0;
    if (p >= y_first && p < y_end && (p & (TTY - 1)) == TTY - 1)
      tile_end(best, none, s_red, core, t, p, f, tyn, txn, strip * tile_cols,
               P.v + 2 * NTAP + 2, out_max, out_idx, out_yoff, out_xoff);
  }
}

template <typename T, int R>
cudaError_t launch_ring(const void* frames, const float* a_plane,
                        const float* mf, const float* thr, const float* er,
                        const Params& P, float* out_max, int* out_idx,
                        float* out_yoff, float* out_xoff, int n, int h, int w,
                        int tile_cols, int strip_tiles, cudaStream_t stream) {
  if (tile_cols < 1 || tile_cols > MAX_TILE_COLS || strip_tiles < 1 ||
      (w / TTX) % tile_cols)
    return cudaErrorInvalidValue;
  const int threads =
      (TPT * tile_cols + 2 * RingShape<R>::HALO + 31) / 32 * 32;
  const size_t smem = RingShape<R>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      detect_ring_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int tyn = h / 2 / TTY;
  dim3 grid(n, w / TTX / tile_cols, (tyn + strip_tiles - 1) / strip_tiles);
  detect_ring_kernel<T, R><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(frames), a_plane, mf, thr, er, P, out_max, out_idx,
      out_yoff, out_xoff, h, w, tile_cols, strip_tiles);
  return cudaGetLastError();
}

// ---- the separable route (RMAX < r <= RBIG) -------------------------------

template <typename T>
__device__ __forceinline__ float to_f(T v) { return static_cast<float>(v); }
//
// The column pass: a block of VCOLS threads, one column each, walks down
// `seg_rows` binned rows of its columns.  It keeps the last 2r + VM binned
// rows of each column in a shared ring ([rows][VCOLS]: each thread reads
// and writes only its own column, so no barrier), and per step bins VM new
// rows (loaded a step ahead) and sums the G and Box values of VM output
// rows: a window of VM ring values slides down the taps, so each ring
// value is read once per step and feeds VM outputs.  The 2r halo rows of
// a segment are loaded once, without arithmetic.  Every product and sum is
// rounded on its own, in tap order, as in the twin.
template <typename T>
__global__ void __launch_bounds__(VCOLS)
detect_vpass_kernel(const T* __restrict__ frames,
                    const float* __restrict__ a_plane, const ParamsBig P,
                    float* __restrict__ gbuf, float* __restrict__ bbuf,
                    int h, int w, int r, int seg_rows) {
  extern __shared__ float smem[];
  const int ntap = 2 * r + 1, h2 = h / 2, q = 2 * r + VM;
  // blockIdx.x is the frame, so neighbouring blocks read the same A rows
  // (from L2)
  const int f = blockIdx.x;
  const int y_first = blockIdx.z * seg_rows;
  const int y_end = min(y_first + seg_rows, h2);
  const int x = blockIdx.y * VCOLS + threadIdx.x;
  const int nw = (ntap + VM - 1) / VM * VM;
  float* const s_w = smem;                    // column taps, zero-padded
  float* const col = smem + nw + threadIdx.x;  // the ring, [q][VCOLS]
  for (int k = threadIdx.x; k < nw; k += VCOLS)
    s_w[k] = k < ntap ? P.v[k] : 0.0f;
  __syncthreads();
  const T* fr = frames + (size_t)f * h * w + x;
  const float* ap = a_plane != nullptr ? a_plane + x : nullptr;
  // binned row yb of this column; rows outside the frame read 0
  auto binned = [&](int yb) {
    float v = 0.0f;
    if (yb >= 0 && yb < h2) {
      const size_t o = (size_t)(2 * yb) * w;
      float v0 = to_f(fr[o]);
      float v1 = to_f(fr[o + w]);
      if (ap != nullptr) {  // no product folded into the add
        v0 = __fmul_rn(v0, ap[o]);
        v1 = __fmul_rn(v1, ap[o + w]);
      }
      v = 0.5f * __fadd_rn(v0, v1);
    }
    return v;
  };
  // the ring: binned row y_first - r + i sits in slot i mod q
  for (int i0 = 0; i0 < 2 * r; i0 += VM) {
    float v[VM];
#pragma unroll
    for (int j = 0; j < VM; ++j) v[j] = binned(y_first - r + i0 + j);
#pragma unroll
    for (int j = 0; j < VM; ++j)
      if (i0 + j < 2 * r) col[(i0 + j) * VCOLS] = v[j];
  }
  float nx[VM];
#pragma unroll
  for (int j = 0; j < VM; ++j) nx[j] = binned(y_first + r + j);
  const size_t plane = (size_t)f * h2 * w + x;
  int base = 0;  // the slot of binned row y0 - r
  for (int y0 = y_first; y0 < y_end; y0 += VM) {
    // rows y0 + r .. y0 + r + VM - 1 take slots base + 2r .. (mod q)
#pragma unroll
    for (int j = 0; j < VM; ++j) {
      int s = base + 2 * r + j;
      s = s >= q ? s - q : s;
      col[s * VCOLS] = nx[j];
    }
    if (y0 + VM < y_end) {
#pragma unroll
      for (int j = 0; j < VM; ++j) nx[j] = binned(y0 + VM + r + j);
    }
    // output row y0 + m takes row y0 - r + m + k at tap k, from the
    // window slot (k + m) % VM
    float g[VM], bx[VM], win[VM];
#pragma unroll
    for (int m = 0; m < VM; ++m) {
      g[m] = bx[m] = 0.0f;
      int s = base + m;
      s = s >= q ? s - q : s;
      if (m + 1 < VM) win[m] = col[s * VCOLS];
    }
    // at block k0 the window takes rows from slot sb = base + k0 + VM - 1
    // on, wrapped: from lo before the ring's end, from hi (q rows back);
    // whole blocks of VM taps run with no guard
    int sb = base + VM - 1;
    sb = sb >= q ? sb - q : sb;
    auto block = [&](int k0, bool guard) {
      const float* const lo = col + sb * VCOLS;
      const float* const hi = lo - q * VCOLS;
      const int split = q - sb;
      sb += VM;
      sb = sb >= q ? sb - q : sb;
      float wk[VM];
#pragma unroll
      for (int j = 0; j < VM; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(s_w + k0 + j);
        wk[j] = v.x;
        wk[j + 1] = v.y;
        wk[j + 2] = v.z;
        wk[j + 3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < VM; ++kk) {
        if (!guard || k0 + kk < ntap) {
          win[(kk + VM - 1) % VM] = (kk < split ? lo : hi)[kk * VCOLS];
#pragma unroll
          for (int m = 0; m < VM; ++m) {
            const float v = win[(kk + m) % VM];
            g[m] = mac(g[m], v, wk[kk]);
            bx[m] = __fadd_rn(bx[m], v);
          }
        }
      }
    };
    const int full = ntap / VM * VM;
#pragma unroll 1
    for (int k0 = 0; k0 < full; k0 += VM) block(k0, false);
    if (full < ntap) block(full, true);
#pragma unroll
    for (int m = 0; m < VM; ++m) {
      if (y0 + m < y_end) {
        const size_t o = plane + (size_t)(y0 + m) * w;
        gbuf[o] = g[m];
        bbuf[o] = bx[m];
      }
    }
    base += VM;
    base = base >= q ? base - q : base;
  }
}

// binned rows a column-pass block walks: at least 256 and 16 r (so the 2r
// halo rows add at most an eighth), a multiple of VM
int vpass_seg_rows(int r, int h2) {
  const int want = max(256, 16 * r);
  return (min(want, h2) + VM - 1) / VM * VM;
}

// The tile pass on the planes: the ring kernel's strip walk with the G and
// Box rows of each step read from the planes (16-byte loads, the strip's
// r + 1 halo columns each side loaded by all of its threads together) in
// place of the ring; the horizontal pass (hpass, run-time tap count) and
// the densities round op by op as the twin does.  Two edge threads
// compute the density of the column next to the strip on each side.
template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
detect_planes_kernel(const float* __restrict__ gbuf,
                     const float* __restrict__ bbuf,
                     const float* __restrict__ mf,
                     const float* __restrict__ thresholds,
                     const float* __restrict__ exp_ratios, const ParamsBig P,
                     float* __restrict__ out_max, int* __restrict__ out_idx,
                     float* __restrict__ out_yoff,
                     float* __restrict__ out_xoff, int h, int w, int r,
                     int tile_cols, int strip_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_red[MAX_THREADS / 32];
  const int f = blockIdx.x, strip = blockIdx.y, seg = blockIdx.z;
  const int h2 = h / 2, tyn = h2 / TTY, txn = w / TTX;
  const int ncore = TPT * tile_cols;
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int ntap = 2 * r + 1, rl = CPT * ((r + CPT - 1) / CPT);
  // a row: hv groups of 4 left of the strip (the edge thread's and the
  // hpass window's), the strip, hv + 3 right of it (the window's overrun)
  const int hv = rl / CPT + 1, nv = ncore + 2 * hv + 3, rowlen = CPT * nv;
  const bool core = t < ncore;
  const int vi = core ? hv + t : (t == ncore ? hv - 1 : hv + ncore);
  const unsigned need = core ? 0xfu
                        : t == ncore ? 0x8u
                        : t == ncore + 1 ? 0x1u : 0u;
  const int so = CPT * vi;
  const int x0 = strip * tile_cols * TTX;
  const int gx0 = x0 + CPT * (vi - hv);
  const int nw = (ntap + 3) & ~3;
  float* const s_w = smem;                        // row taps, zero-padded
  float* const rows = smem + nw;                  // G, B, G, B, 4 densities
  float* const sdr = rows + 4 * rowlen;
  for (int k = t; k < nw; k += nthreads)
    s_w[k] = k < ntap ? P.v[ntap + k] : 0.0f;
  const float mean_w = P.v[2 * ntap], inv_den = P.v[2 * ntap + 1];
  const float thr = thresholds[f], er = exp_ratios[f];
  const int y_first = seg * strip_tiles * TTY;
  const int y_end = min(y_first + strip_tiles * TTY, h2);
  const size_t plane = (size_t)f * h2 * w;
  const size_t mplane = (size_t)h2 * w;
  const bool col_in = need != 0u && gx0 >= 0 && gx0 < w;

  // row yg's 4-column groups i = t, t + nthreads of G and Box (0 outside
  // the frame), and this thread's master densities of row yg
  auto load_row = [&](int yg, float4 (&gv)[2], float4 (&bv)[2]) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = t + it * nthreads;
      const int gx = x0 + CPT * (i - hv);
      gv[it] = bv[it] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < nv && yg >= 0 && yg < h2 && gx >= 0 && gx < w) {
        const size_t o = plane + (size_t)yg * w + gx;
        gv[it] = __ldg(reinterpret_cast<const float4*>(gbuf + o));
        bv[it] = __ldg(reinterpret_cast<const float4*>(bbuf + o));
      }
    }
  };
  auto load_mf = [&](int yg, Loads& L) {
    L.mf_in = mf != nullptr && col_in && yg >= 0 && yg < h2 && yg <= y_end;
    L.m0 = L.m1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (L.mf_in) {
      const size_t o = (size_t)yg * w + gx0;
      L.m0 = __ldg(reinterpret_cast<const float4*>(mf + o));
      L.m1 = __ldg(reinterpret_cast<const float4*>(mf + mplane + o));
    }
  };

  float dprev[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dprev[c] = 0.0f;
  const int lx0 = (t % TPT) * CPT;
  unsigned col_ok = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (core && gx0 + c >= 2 + r && gx0 + c < w - 2 - r) col_ok |= 1u << c;
  const Best none{NEG, 0.0f, 0.0f, 0.0f, 0.0f, core ? lx0 : 0x7fffffff};
  Best best = none;
  unsigned cand1 = 0, cand2 = 0;

  // step yg: the G and Box rows of yg, its densities; the peak test runs
  // on row p = yg - 2
  float4 ng[2], nbv[2];
  Loads nl;
  load_row(y_first - 1, ng, nbv);
  load_mf(y_first - 1, nl);
  for (int yg = y_first - 1; yg <= y_end + 1; ++yg) {
    const float4 cg0 = ng[0], cg1 = ng[1], cb0 = nbv[0], cb1 = nbv[1];
    const Loads cur = nl;
    if (yg <= y_end) {
      load_row(yg + 1, ng, nbv);
      load_mf(yg + 1, nl);
    }
    const int step = yg - (y_first - 1);
    float* const sg = rows + 2 * (step & 1) * rowlen;
    float* const sb = sg + rowlen;
    if (t < nv) {
      *reinterpret_cast<float4*>(sg + CPT * t) = cg0;
      *reinterpret_cast<float4*>(sb + CPT * t) = cb0;
    }
    if (t + nthreads < nv) {
      *reinterpret_cast<float4*>(sg + CPT * (t + nthreads)) = cg1;
      *reinterpret_cast<float4*>(sb + CPT * (t + nthreads)) = cb1;
    }
    if (need != 0u)
      *reinterpret_cast<float4*>(sdr + ((yg - 1) & 3) * rowlen + so) =
          make_float4(dprev[0], dprev[1], dprev[2], dprev[3]);
    __syncthreads();
    unsigned cand0 = 0;
    if (need != 0u) {
      float gs[CPT], bs[CPT], m0[CPT], m1[CPT];
      hpass_rt<D>(sg + so - rl, sb + so - rl, s_w, ntap, need, gs, bs);
      unpack4(cur.m0, m0);
      unpack4(cur.m1, m1);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float d = __fmul_rn(__fsub_rn(gs[c], __fmul_rn(mean_w, bs[c])), inv_den);
        if (cur.mf_in) d = __fsub_rn(d, __fadd_rn(m0[c], __fmul_rn(er, m1[c])));
        dprev[c] = d;
        if (d > thr) cand0 |= 1u << c;
      }
    }
    if (!(yg >= y_first && yg < y_end && yg >= r + 1 && yg < h2 - r - 1))
      cand0 = 0;
    cand0 &= col_ok;
    const int p = yg - 2;
    if (cand2 != 0)
      peak_test(sdr + ((p - 1) & 3) * rowlen + so, sdr + (p & 3) * rowlen + so,
                sdr + ((p + 1) & 3) * rowlen + so, p, lx0, cand2, best);
    cand2 = cand1;
    cand1 = cand0;
    if (p >= y_first && p < y_end && (p & (TTY - 1)) == TTY - 1)
      tile_end(best, none, s_red, core, t, p, f, tyn, txn, strip * tile_cols,
               P.v + 2 * ntap + 2, out_max, out_idx, out_yoff, out_xoff);
  }
}

// scratch: 2 * chunk * (h / 2) * w floats, the G then the Box planes of
// `chunk` frames; the frames go through both kernels chunk by chunk, the
// tile pass with the block of kernels._detect_layout
template <typename T>
cudaError_t launch_separable(const void* frames, const float* a_plane,
                             const float* mf, const float* thr,
                             const float* er, const ParamsBig& P,
                             float* out_max, int* out_idx, float* out_yoff,
                             float* out_xoff, int n, int h, int w, int r,
                             int tile_cols, int strip_tiles, float* scratch,
                             int chunk, cudaStream_t stream) {
  if (scratch == nullptr || chunk < 1 || w % VCOLS || tile_cols < 1 ||
      tile_cols > MAX_TILE_COLS || strip_tiles < 1 || (w / TTX) % tile_cols)
    return cudaErrorInvalidValue;
  const int ntap = 2 * r + 1, h2 = h / 2, nw = (ntap + 3) & ~3;
  const int seg_rows = vpass_seg_rows(r, h2);
  const size_t vsmem = sizeof(float) *
      ((size_t)(2 * r + VM) * VCOLS + (ntap + VM - 1) / VM * VM);
  const int ncore = TPT * tile_cols, rl = CPT * ((r + CPT - 1) / CPT);
  const int nv = ncore + 2 * (rl / CPT + 1) + 3;
  const size_t psmem = sizeof(float) * ((size_t)8 * CPT * nv + nw);
  const int threads = (ncore + 2 + 31) / 32 * 32;
  void (*planes)(const float*, const float*, const float*, const float*,
                 const float*, const ParamsBig, float*, int*, float*, float*,
                 int, int, int, int, int);
  switch (rl - r) {
    case 0: planes = detect_planes_kernel<0>; break;
    case 1: planes = detect_planes_kernel<1>; break;
    case 2: planes = detect_planes_kernel<2>; break;
    default: planes = detect_planes_kernel<3>; break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      detect_vpass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)vsmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(planes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)psmem);
  if (err != cudaSuccess) return err;
  const size_t fplane = (size_t)h * w;
  const int tyn = h2 / TTY, tiles = tyn * (w / TTX);
  float* gbuf = scratch;
  float* bbuf = scratch + (size_t)chunk * h2 * w;
  for (int f0 = 0; f0 < n; f0 += chunk) {
    const int c = min(chunk, n - f0);
    const T* fr = static_cast<const T*>(frames) + f0 * fplane;
    detect_vpass_kernel<T>
        <<<dim3(c, w / VCOLS, (h2 + seg_rows - 1) / seg_rows), VCOLS, vsmem,
           stream>>>(fr, a_plane, P, gbuf, bbuf, h, w, r, seg_rows);
    const size_t t0 = (size_t)f0 * tiles;
    planes<<<dim3(c, w / TTX / tile_cols, (tyn + strip_tiles - 1) / strip_tiles),
             threads, psmem, stream>>>(
        gbuf, bbuf, mf, thr + f0, er + f0, P, out_max + t0, out_idx + t0,
        out_yoff + t0, out_xoff + t0, h, w, r, tile_cols, strip_tiles);
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
                               tile_cols, strip_tiles, scratch, chunk, stream);
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
#define RING_CASE(R)                                                        \
  case R:                                                                   \
    return launch_ring<T, R>(frames, a_plane, mf, thr, er, P, out_max,      \
                             out_idx, out_yoff, out_xoff, n, h, w,          \
                             tile_cols, strip_tiles, stream);
  switch (r) {
    RING_CASE(1) RING_CASE(4) RING_CASE(5) RING_CASE(6) RING_CASE(7)
    RING_CASE(8) RING_CASE(9) RING_CASE(10) RING_CASE(11) RING_CASE(12)
    RING_CASE(13) RING_CASE(14) RING_CASE(15) RING_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef RING_CASE
}

}  // namespace

// params: 2 * (2r + 1) + 8 floats in host memory (see Params); tile_cols
// and strip_tiles: the block of the rolling, ring and planes kernels, from
// kernels._detect_layout; scratch and chunk: the separable route's planes
// (kernels._detect_chunk), null and 0 on the others
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
