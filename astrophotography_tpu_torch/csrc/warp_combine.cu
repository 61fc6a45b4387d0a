// K2: fused calibrate + Lanczos3 warp + sigma-clip combine, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel astrophotography_tpu/ops/pallas_warp_combine.py
// (pallas_warp_combine, body _make_kernel).  Per output pixel and frame:
// calibrate the raw taps, cal = ((raw*A - B) - r*C) * fscale (raw *
// fscale without masters), resample with the separable two-pass Lanczos3
// (weights from the degree-10 polynomial in t^2) using one of three tap
// bodies — snapped translation (scalar weights, taps [1, 7)), 'exact'
// (per-pixel weights normalised by their sum) or 'lowrank' (per-row /
// per-column weights) — with the TPU kernel's coverage rules; then over
// the N samples of the pixel: sort, median, MAD of all N sorted
// deviations (uncovered samples are +3.4e38 and sort last), clip at
// med -/+ sigma * 1.4826 * MAD, and write 'average', 'median', 'sum' or
// the unclipped 'mean'.  Pixels nobody covers get 0.
//
// What bounds it on the H100.  The least time is 1.08 ms at 100 x 4096^2:
// the 3.36 GB raw stack, 0.20 GB of masters and the 0.07 GB image at
// 3.35 TB/s; its ~37 operations per (frame, pixel) (calibration, 6 + 6
// taps, the sort's compares) take ~0.9 ms at the f32 rate.  There is no
// matrix product, and the tensor cores are out of scope: every value
// operation is f32 rounded op by op (below), and a bf16 hi/lo product
// would not give the twin's bits.  The first design evaluated 12 Lanczos
// polynomials and calibrated ~36 taps per thread and frame; its warp
// phase was ~90 % of 419 ms (chip_smoke.py's average-vs-mean split).
// This one does the per-frame work once per block, and is bound by
// latency: the N-sample columns (N x 4 B per pixel) and ~128 registers a
// thread leave 16 warps per SM, each a chain of shared-memory round
// trips, so the SM issues a fraction of its peak: tools/k2_variants.py
// measures ~4,800 cycles per warp and frame on the snap body and ~7,000
// on lowrank, and without any window loads the warp phase is only
// 8-10 % faster: the chains, not the memory, set its time.
//
// Design.  A block covers 8 output rows x 32 columns inside one TPU
// tile (fewer rows when N leaves no room; the last block of a tile is
// clipped, and its idle threads still join the barriers), so all its
// pixels share each frame's tap bases (vbase, ubase) and window test
// base_ok from the per-(frame, tile) table, which reaches the block
// through a shared-memory ring three frames ahead.  Per frame:
//  1. The calibrated source window, rows vbase + r0 + [0, rows + span)
//     by columns ubase + c0 + [0, 32 + span), goes into shared memory,
//     each source pixel calibrated once in the twin's order.  Each warp
//     stages the window rows it owns; their raw pixels and masters were
//     loaded into registers during the previous frame.  Outside the
//     image the window reads 0.
//  2. The tap weights are computed once per (frame, block): the snap
//     body's 12 weights and two reciprocals by one warp, a frame ahead;
//     the lowrank body's horizontal weights once per window row and its
//     vertical weights once per column.
//  3. Each warp runs the horizontal pass over its own rows, one mid value
//     per (window row, column); after the frame's only block barrier the
//     vertical pass reads them from the other of two mid buffers while
//     the next frame's rows are filtered.  The 'exact' body keeps its
//     per-pixel tap loop on the window, behind two more barriers.
// A frame whose base_ok or gate is false for the tile is skipped by the
// whole block.  Each thread keeps its N samples in its own column of
// shared memory; the combine sorts that column with a bitonic network
// (stages of partner distance < 16 run in registers on 16-sample blocks,
// the others in shared memory, +inf padding never stored) instead of an
// insertion sort whose trip counts diverged within a warp, then finds
// the MAD ranks by merging the two monotone runs of deviations around
// the median.  No per-thread array is indexed at run time (no local
// memory).
//
// Three routes (kernels._warp_route picks one by frames and span):
//  * 'smem', the few-frame route: the columns are shared memory, as
//    above, and each thread sorts its own, in blocks of 8 rows
//    (kernels._WARP_SMEM_ROWS; past the frames where they fit, 'cols'
//    wins: chip_smoke.py's route sweep).
//  * 'cols', the many-frame route (warp_combine_cols_kernel): the grid
//    holds the blocks the card keeps resident, each walks the output
//    blocks (8 rows but for very wide windows), and the warp phase writes
//    each sample once to the block's slot of a scratch in device memory
//    ([n][nt], a coalesced row per frame).  Then the combine reads it back
//    once, W = `by` pixels at a time (W x 4 B per frame row), into one
//    column per warp of shared memory, and each warp sorts its pixel's
//    column with all 32 lanes (warp_sort.cuh), finds the median at its
//    ranks, the MAD by bisecting the two runs of deviations around it and
//    the kept run by binary search, and sums the run from its sorted
//    registers, serially, in ascending order.  So a sample crosses device
//    memory once each way (9.6 KB a pixel at 1200 frames), where a thread
//    that sorted its own column there walked it ~36 times.  At 1200 x
//    512^2 the warp phase and the writes take ~2/3 of the time and the
//    combine the rest, in which the sorts overlap the tile reads and
//    barriers (tools/cols_variants.py).  A column longer than `run` (what
//    a warp's share of shared memory holds, kernels._warp_cols_run: 7232
//    frames at 8 rows) is sorted in runs of `run`, each written back to
//    the slot in place, and combined by bisecting ranks over the sorted
//    runs (monotone float keys, binary searches in each run) and summing
//    the kept samples in ascending chunks of fewer than `run`, each
//    gathered from the runs into the warp's column and sorted there
//    (combine_runs).
//    Only the card's memory limits N.
//  * 'wide', windows past one row of a shared block (span > 192 at 32
//    columns; warp_combine_wide_kernel): a block's window, (rows + span) x
//    (32 + span) floats, no longer fits 227 KB.  What bounds the route
//    on this card is the mid rows, not the window: a block of up to 32
//    output rows (8 warps, 4 rows a thread) keeps its (rows + span) x 32
//    mid rows in shared memory and stages the window one calibrated row
//    per warp, only the columns that row's taps reach; spans up to 1436
//    (kernels._WARP_WIDE_MAX_SPAN, 8 rows a block there), where the
//    wrapper raises.  Per frame the block filters only the mid rows its
//    pixels read, each once (~rows + 15 at 5-15 degree rotations), the
//    frame's parameters, snap weights and mid-row range prepared a frame
//    ahead, two barriers a frame; the 'exact' passes evaluate their 8
//    tap weights side by side.  Each thread combines its own pixels from
//    the block's slot of the 'cols' scratch: in registers to 32 frames,
//    in its column of its warp's shared words to 112, through the 'cols'
//    combine past that (any N; the grid stops where the scratch would
//    pass 1 GiB).  3 blocks an SM where their shared memory fits, else 2.
//    H100, 'exact', span 256: 5.0-5.2 ms at 24 x 2048^2 u16 (the first
//    design 15.2), 4.7-4.8 ms on the wide pipeline's calibrated f32 stack;
//    107-112 ms at 100 x 4096^2 (160.5); 99-102 ms at 360 x 2048^2, span
//    288 (120.9); 11-15x the bound, which counts the exact taps' weights
//    at the f32 FMA rate while every tap here rounds op by op (~25
//    instructions, no FMA).  The warp phase is ~87 % of the time at 100
//    frames, its horizontal pass ~2/3 of it and the vertical ~1/3
//    (tools/wide_variants.py).  Forced below span 193 it beats 'cols'
//    from 100 to 600 frames (0.68-0.97x) and loses from 908 on
//    (chip_smoke.py's route sweep); 'cols' keeps its own warp phase.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_network.cuh"  // sort_column: the 'smem' route's network
#include "warp_sort.cuh"     // sort_col and the ranks: the 'cols' route

namespace {

constexpr int BX = 32;      // output columns per block: one warp per row
constexpr int MAX_BY = 8;   // output rows per block
constexpr int HT = 8;       // lowrank horizontal taps s2 in [1, min(span, 9))
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

// Shared memory of a block, in 4-byte words.  kernels.py mirrors the
// total (_warp_smem_bytes) to pick the block's rows.
constexpr int RP = 3;      // window rows per warp loaded a frame ahead
constexpr int PSLOT = 20;  // per-frame slot: table row, vbase, ubase, use
constexpr int PRING = 5;   // slots: frames f-1 .. f+3
enum { OFF = 0, SNAP = 1, LOW = 2, EXACT = 3 };  // how the block uses a frame

struct Layout {
  int nt, wr, wc;
  int vals, win, mid, hw, hinv, vw, vr, sw, ring, total;
};

__host__ __device__ inline Layout layout(int n, int by, int span) {
  Layout L;
  L.nt = BX * by;
  L.wr = by + span;                  // window rows
  L.wc = BX + span;                  // window columns
  L.vals = 0;                        // [n][nt] samples
  L.win = L.vals + n * L.nt;         // [wr][wc] calibrated window
  L.mid = L.win + L.wr * L.wc;       // [2][wr][BX] horizontal pass
  L.hw = L.mid + 2 * L.wr * BX;      // [wr][HT] lowrank row weights
  L.hinv = L.hw + L.wr * HT;         // [wr] lowrank 1 / row weight sum
  L.vw = L.hinv + L.wr;              // [2][HT][BX] lowrank column weights
  L.vr = L.vw + 2 * HT * BX;         // [2][BX][2] lowrank column taps
  L.sw = L.vr + 4 * BX;              // [3][16] snap weights and masks
  L.ring = L.sw + 3 * 16;            // [PRING][PSLOT] frame parameters
  L.total = L.ring + PRING * PSLOT;
  return L;
}

// One frame of the source: raw pixels, calibrated on the way in.
template <typename T>
struct Src {
  const T* frames;
  const float* masters;  // (3, H, W) or null
  size_t plane;
  int h0, w0;

  __device__ __forceinline__ float cal(float v, float av, float bv, float cv,
                                       float er, float fs) const {
    if (masters != nullptr) v = sub(sub(mul(v, av), bv), mul(er, cv));
    return mul(v, fs);
  }
  // calibrated pixel (gy, gx) of frame f; 0 outside the image
  __device__ __forceinline__ float load_cal(int f, int gy, int gx, float er,
                                            float fs) const {
    if (gy < 0 || gy >= h0 || gx < 0 || gx >= w0) return 0.0f;
    size_t o = (size_t)gy * w0 + gx;
    float v = static_cast<float>(frames[(size_t)f * plane + o]);
    return masters != nullptr
               ? cal(v, masters[o], masters[plane + o], masters[2 * plane + o],
                     er, fs)
               : cal(v, 0.0f, 0.0f, 0.0f, er, fs);
  }
};

// The window rows a warp owns (r_lo + ty + m * by), columns lane and
// lane + 32: loaded into registers a frame ahead (raw in its own type, so
// nothing waits on the load before the row is staged), calibrated into
// the shared window when staged.  Rows past RP and columns past 64 are
// loaded when staged.
template <typename T>
struct Rows {
  T raw[RP][2];
  float a[RP][2], b[RP][2], c[RP][2];
  unsigned in;  // bit 2m+e: element (m, e) lies inside the image

  __device__ __forceinline__ void fetch(const Src<T>& S, int f, int y0, int x0,
                                        int r_lo, int r_hi, int ty, int by,
                                        int lane, int wc) {
    const T* fr = S.frames + (size_t)f * S.plane;
    in = 0;
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      const int r = r_lo + ty + m * by, gy = y0 + r;
      if (r < r_hi && gy >= 0 && gy < S.h0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = lane + 32 * e, gx = x0 + col;
          if (col < wc && gx >= 0 && gx < S.w0) {
            const size_t o = (size_t)gy * S.w0 + gx;
            raw[m][e] = fr[o];
            if (S.masters != nullptr) {
              a[m][e] = S.masters[o];
              b[m][e] = S.masters[S.plane + o];
              c[m][e] = S.masters[2 * S.plane + o];
            }
            in |= 1u << (2 * m + e);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void stage(const Src<T>& S, float* win, int f,
                                        int y0, int x0, int r_lo, int r_hi,
                                        int ty, int by, int lane, int wc,
                                        float er, float fs) const {
#pragma unroll
    for (int m = 0; m < RP; ++m) {
      const int r = r_lo + ty + m * by;
      if (r < r_hi) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = lane + 32 * e;
          if (col < wc)
            win[r * wc + col] =
                (in >> (2 * m + e)) & 1u
                    ? S.cal(static_cast<float>(raw[m][e]), a[m][e], b[m][e],
                            c[m][e], er, fs)
                    : 0.0f;
        }
        for (int col = lane + 64; col < wc; col += 32)
          win[r * wc + col] = S.load_cal(f, y0 + r, x0 + col, er, fs);
      }
    }
    for (int r = r_lo + ty + RP * by; r < r_hi; r += by)
      for (int col = lane; col < wc; col += 32)
        win[r * wc + col] = S.load_cal(f, y0 + r, x0 + col, er, fs);
  }
};

// One output block, (bid_x, bid_y) in the grid of the shared route.
// The N-sample columns are in shared memory, or (COLS) in `gvals`, the
// block's slot of a scratch in device memory ([n + 2][nt] words); on
// COLS the block then leaves each pixel's count of covered samples (0
// where nothing is left to combine) and output offset in the slot's rows
// n and n + 1 for cols_combine.
// combine: 0 average, 1 median, 2 sum, 3 mean
template <typename T, bool COLS>
__device__ __forceinline__ void warp_block(
    const T* __restrict__ frames, const float* __restrict__ masters,
    const float* __restrict__ ftab, const int* __restrict__ ttab,
    float* __restrict__ out, int n, int h0, int w0, int th, int tw, int n_tj,
    int n_tiles, int span, int lowrank, int combine, float sigma_lo,
    float sigma_hi, int by, int sbx, int sby, int bid_x, int bid_y,
    float* __restrict__ gvals) {
  extern __shared__ float smem[];
  const Layout L = layout(COLS ? 0 : n, by, span);
  float* vals = COLS ? gvals : smem + L.vals;
  float* win = smem + L.win;
  float* midb = smem + L.mid;
  float* hw = smem + L.hw;
  float* hinv = smem + L.hinv;
  float* vwb = smem + L.vw;
  int* vrb = reinterpret_cast<int*>(smem + L.vr);
  float* swb = smem + L.sw;
  float* ring = smem + L.ring;
  const unsigned FULL = 0xffffffffu;
  const int nt = L.nt, wc = L.wc, wrn = L.wr;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + lane;
  // block -> (tile, sub-block): rows r0 + [0, by), columns c0 + [0, BX)
  const int j = bid_x / sbx, c0 = (bid_x - j * sbx) * BX;
  const int i = bid_y / sby, r0 = (bid_y - i * sby) * by;
  const int tile = i * n_tj + j;
  const int c = c0 + lane, rr = r0 + ty;
  const int x = j * tw + c, y = i * th + rr;
  const bool live = c < tw && rr < th && x < w0 && y < h0;
  const float x_out = (float)x, y_out = (float)y;
  const float ti = (float)(i * th), tj = (float)(j * tw);
  // snap taps [t_lo, t_hi) (at most 6); lowrank horizontal taps [1, t1hi)
  const int t_lo = span >= 7 ? 1 : 0;
  const int t_hi = span >= 7 ? min(span, 7) : span;
  const int nk = t_hi - t_lo;
  const int t1hi = min(span, 9);
  const Src<T> S{frames, masters, (size_t)h0 * w0, h0, w0};
  Rows<T> rows;

  // Frame parameters go through a ring of shared-memory slots, three
  // frames ahead: warp 0 loads frame g's table row and tile entry (one
  // word per lane) and stores them later in the same frame, so no thread
  // waits on the table.  A slot holds the 16 floats of the row, then
  // vbase, ubase, and whether the block uses the frame (window contained
  // and, for the general bodies, the span / lowrank gate).
  auto slot = [&](int g) { return ring + (g % PRING) * PSLOT; };
  auto param_load = [&](int g) -> int {
    if (lane < 16) return __float_as_int(ftab[16 * g + lane]);
    if (lane < 19) return ttab[3 * ((size_t)g * n_tiles + tile) + lane - 16];
    return 0;
  };
  auto param_store = [&](int g, int pv) {  // every lane of warp 0
    const int b8 = __shfl_sync(FULL, pv, 8), b14 = __shfl_sync(FULL, pv, 14);
    int* sl = reinterpret_cast<int*>(slot(g));
    if (lane < 18)
      sl[lane] = pv;
    else if (lane == 18)
      sl[18] = pv != 0 && (__int_as_float(b8) > 0.5f ||
                           __int_as_float(b14) > 0.5f);
  };
  auto kind_of = [&](const float* P) {
    return reinterpret_cast<const int*>(P)[18] == 0
               ? OFF
               : (P[8] > 0.5f ? SNAP : (lowrank ? LOW : EXACT));
  };
  // the window rows each body reads
  auto rows_lo = [&](int k) { return k == EXACT ? 0 : (k == SNAP ? t_lo : 1); };
  auto rows_hi = [&](int k) { return k == SNAP ? by + t_hi - 1 : by + span - 1; };
  auto fetch = [&](int g) {
    const float* P = slot(g);
    const int* Pi = reinterpret_cast<const int*>(P);
    const int k = kind_of(P);
    if (k != OFF)
      rows.fetch(S, g, Pi[16] + r0, Pi[17] + c0, rows_lo(k), rows_hi(k), ty,
                 by, lane, wc);
  };

  // snap body weights of frame g, one warp: the 12 tap weights and two
  // reciprocals (lanes 0-7 horizontal wu, 8-15 vertical wv), scaled, and
  // the masks of the non-zero taps
  auto snap_weights = [&](int g) {
    const float* P = slot(g);
    const int* Pi = reinterpret_cast<const int*>(P);
    const int k = lane & 7;
    const float a = lane < 8 ? (tj + P[13]) - (float)Pi[17]  // tj + g0 - ubase
                             : (ti + P[5]) - (float)Pi[16];  // ti + m12 - vbase
    const float w = k < nk ? l3(a - (float)(t_lo + k)) : 0.0f;
    float ws[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) ws[q] = __shfl_sync(FULL, w, (lane & 8) + q);
    float sum = ws[0];
#pragma unroll
    for (int q = 1; q < 6; ++q)
      if (q < nk) sum = add(sum, ws[q]);
    const float inv = fabsf(sum) > 1e-3f ? 1.0f / sum : 0.0f;
    const unsigned nz = __ballot_sync(FULL, k < nk && w != 0.0f);
    float* o = swb + (g % 3) * 16;  // [0, 6) hu, [8, 14) hv, masks at 6, 14
    if (k < nk && lane < 16) o[lane] = mul(w, inv);
    if (lane == 0) {
      reinterpret_cast<int*>(o)[6] = nz & 0xffu;
      reinterpret_cast<int*>(o)[14] = (nz >> 8) & 0xffu;
    }
  };

  // coverage of this pixel in frame g: source inside [2, W-4] x [vlo, vhi]
  // (the window and gate tests hold for the whole block)
  auto covered = [&](const float* P) {
    const float v = affine_rn(P[3], x_out, P[4], y_out, P[5]);
    const float sx = affine_rn(P[0], x_out, P[1], y_out, P[2]);
    return sx >= 2.0f && sx <= (float)w0 - 4.0f && v >= P[9] && v <= P[10];
  };

  // sample g of this pixel, [n][nt] in shared memory or in the slot
  auto at = [&](int g) { return (size_t)g * nt + tid; };
  int count = 0;
  float macc = 0.0f;
  auto take = [&](int g, float val) {  // a covered sample, in frame order
    ++count;
    macc = add(macc, val);
    vals[at(g)] = val;
  };

  // vertical pass of frame g (snap or lowrank) from its mid rows
  auto vertical = [&](int g, int kg) {
    if (!live) return;
    const float* P = slot(g);
    if (!covered(P)) {
      vals[at(g)] = BIG;
      return;
    }
    const float* mid = midb + (g & 1) * wrn * BX;
    if (kg == SNAP) {
      const float* o = swb + (g % 3) * 16;
      const int vmask = reinterpret_cast<const int*>(o)[14];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float m = mid[(ty + t_lo + q) * BX + lane], wv = o[8 + q];
        if (q < nk && ((vmask >> q) & 1)) acc = add(acc, mul(wv, m));
      }
      take(g, acc);
    } else {
      const float* vw = vwb + (g & 1) * HT * BX;
      const int* vr = vrb + (g & 1) * 2 * BX;
      const int lo = vr[2 * lane], hi = vr[2 * lane + 1];
      float acc2 = 0.0f, v0s = 0.0f;
#pragma unroll
      for (int q = 0; q < HT; ++q) {  // at most 8 taps in [lo, hi]
        const int s = max(min(lo + q, hi), 0);
        const float wvt = vw[q * BX + lane], m = mid[(ty + s) * BX + lane];
        if (lo + q <= hi && wvt != 0.0f) {
          acc2 = add(acc2, mul(wvt, m));
          v0s = add(v0s, wvt);
        }
      }
      float inv2 = fabsf(v0s) > 1e-3f ? 1.0f / v0s : 0.0f;
      take(g, mul(acc2, inv2));
    }
  };

  // 'exact' body of frame f: per-pixel weights on the staged window
  auto exact = [&](int f) {
    if (!live) return;
    const float* P = slot(f);
    if (!covered(P)) {
      vals[at(f)] = BIG;
      return;
    }
    const int* Pi = reinterpret_cast<const int*>(P);
    const float gx = P[11], gy = P[12], g0 = P[13];
    const float vb_f = (float)Pi[16], ub_f = (float)Pi[17];
    float v_loc = affine_rn(P[3], x_out, P[4], y_out, P[5]) - vb_f;
    float acc2 = 0.0f, wsum2 = 0.0f;
    float vrel = v_loc - (float)rr;
    for (int s = tap_lo(vrel, 0); s <= tap_hi(vrel, span - 1); ++s) {
      float wvt = l3(v_loc - (float)(rr + s));
      if (wvt == 0.0f) continue;
      const float* src = win + (ty + s) * wc + lane;
      float u_loc = affine_rn(gx, x_out, gy, vb_f + (float)(rr + s), g0) - ub_f;
      float acc = 0.0f, wsum = 0.0f;
      float urel = u_loc - (float)c;
      for (int s2 = tap_lo(urel, 0); s2 <= tap_hi(urel, span - 1); ++s2) {
        float wt = l3(u_loc - (float)(c + s2));
        if (wt == 0.0f) continue;
        acc = add(acc, mul(wt, src[s2]));
        wsum = add(wsum, wt);
      }
      float m = fabsf(wsum) > 1e-3f ? acc / wsum : 0.0f;
      acc2 = add(acc2, mul(wvt, m));
      wsum2 = add(wsum2, wvt);
    }
    take(f, fabsf(wsum2) > 1e-3f ? acc2 / wsum2 : 0.0f);
  };

  if (tid < 32)
    for (int g = 0; g < min(n, PRING - 2); ++g) param_store(g, param_load(g));
  __syncthreads();
  if (ty == 0 && kind_of(slot(0)) == SNAP) snap_weights(0);
  fetch(0);
  __syncthreads();

  // One block barrier per frame: each warp stages and filters the window
  // rows it owns (warp-synchronous), while the vertical pass of the
  // previous frame reads the other mid buffer.
  int kp = OFF;  // how the block used frame f-1
  for (int f = 0; f < n; ++f) {
    const float* P = slot(f);
    const int* Pi = reinterpret_cast<const int*>(P);
    const int k = kind_of(P);
    const bool ahead = tid < 32 && f + PRING - 2 < n;
    const int pv = ahead ? param_load(f + PRING - 2) : 0;
    const float vb_f = (float)Pi[16], ub_f = (float)Pi[17];
    float* mid = midb + (f & 1) * wrn * BX;
    if (k != OFF) {
      rows.stage(S, win, f, Pi[16] + r0, Pi[17] + c0, rows_lo(k), rows_hi(k),
                 ty, by, lane, wc, P[6], P[7]);
      __syncwarp();
    }
    if (k == SNAP) {
      // horizontal pass: one mid value per (owned window row, column)
      const float* o = swb + (f % 3) * 16;
      const int hmask = reinterpret_cast<const int*>(o)[6];
      float hu[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) hu[q] = o[q];
      for (int r = t_lo + ty; r < by + t_hi - 1; r += by) {
        const float* src = win + r * wc + lane + t_lo;
        float m = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float xq = src[q];
          if (q < nk && ((hmask >> q) & 1)) m = add(m, mul(hu[q], xq));
        }
        mid[r * BX + lane] = m;
      }
    } else if (k == LOW) {
      const float gx = P[11], gy = P[12], g0 = P[13];
      const int r_hi = by + span - 1;
      // row weights of the owned rows (source row vbase + r0 + r), 8 lanes
      // per row, the row's sum in tap order by shuffles
      for (int m0 = 0; 1 + ty + m0 * by < r_hi; m0 += 4) {
        const int r = 1 + ty + (m0 + (lane >> 3)) * by, s2 = 1 + (lane & 7);
        float w = 0.0f;
        if (r < r_hi) {
          float bu = add(affine_rn(gx, tj, gy, vb_f + (float)(r0 + r), g0) - ub_f,
                         mul(gx - 1.0f, (float)(tw - 1) * 0.5f));
          if (s2 >= tap_lo(bu, 1) && s2 <= tap_hi(bu, t1hi - 1))
            w = l3(bu - (float)s2);
        }
        float ws[HT];
#pragma unroll
        for (int q = 0; q < HT; ++q)
          ws[q] = __shfl_sync(FULL, w, (lane & ~(HT - 1)) + q);
        float w0s = 0.0f;
#pragma unroll
        for (int q = 0; q < HT; ++q)
          if (ws[q] != 0.0f) w0s = add(w0s, ws[q]);
        if (r < r_hi) {
          hw[r * HT + s2 - 1] = w;
          if (s2 == 1) hinv[r] = fabsf(w0s) > 1e-3f ? 1.0f / w0s : 0.0f;
        }
      }
      __syncwarp();
      for (int r = 1 + ty; r < r_hi; r += by) {
        const float* src = win + r * wc + lane + 1;
        const float* w = hw + r * HT;
        float acc0 = 0.0f;
#pragma unroll
        for (int q = 0; q < HT; ++q) {
          const float xq = src[q], wq = w[q];
          if (q < t1hi - 1 && wq != 0.0f) acc0 = add(acc0, mul(wq, xq));
        }
        mid[r * BX + lane] = mul(acc0, hinv[r]);
      }
      // column weights of the block: tap lo + q of column cx
      const float m11 = P[4];
      float* vw = vwb + (f & 1) * HT * BX;
      int* vr = vrb + (f & 1) * 2 * BX;
      for (int t = tid; t < HT * BX; t += nt) {
        const int q = t / BX, cx = t - q * BX;
        const float xo = (float)(j * tw + c0 + cx);
        float bv = add(affine_rn(P[3], xo, m11, ti, P[5]) - vb_f,
                       mul(m11 - 1.0f, (float)(th - 1) * 0.5f));
        const int lo = tap_lo(bv, 1), hi = tap_hi(bv, span - 1);
        vw[t] = lo + q <= hi ? l3(bv - (float)(lo + q)) : 0.0f;
        if (q == 0) {
          vr[2 * cx] = lo;
          vr[2 * cx + 1] = hi;
        }
      }
    }
    if (f + 1 < n) {
      fetch(f + 1);
      if (ty == f % by && kind_of(slot(f + 1)) == SNAP) snap_weights(f + 1);
    }
    if (kp == SNAP || kp == LOW) vertical(f - 1, kp);
    if (ahead) param_store(f + PRING - 2, pv);
    __syncthreads();
    if (k == EXACT) {
      exact(f);
      __syncthreads();  // the next frame restages the window
    } else if (k == OFF && live) {
      vals[at(f)] = BIG;
    }
    kp = k;
  }
  if (kp == SNAP || kp == LOW) vertical(n - 1, kp);
  if (COLS) {
    int* pc = reinterpret_cast<int*>(vals + (size_t)n * nt);
    int left = 0;
    if (live) {
      float* o = out + (size_t)y * w0 + x;
      if (count == 0)
        *o = 0.0f;
      else if (combine == 3)
        *o = macc / (float)count;
      else
        left = count;
    }
    pc[tid] = left;
    pc[nt + tid] = live ? y * w0 + x : 0;
    return;
  }
  if (!live) return;  // no block-wide sync below (in this block)

  float* o = out + (size_t)y * w0 + x;
  if (count == 0) {
    *o = 0.0f;
    return;
  }
  if (combine == 3) {  // coverage-weighted mean, no clipping
    *o = macc / (float)count;
    return;
  }
  float* col = vals + tid;
  sort_column(col, n, nt);  // uncovered BIG sort last
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(col[lo * nt], col[hi * nt]));
  // deviations of the sorted samples fall to the median, then rise: merge
  // the run left of p (walking down) with the run from p (walking up)
  const float INF = __int_as_float(0x7f800000);
  int p = 0;
  while (p < n && col[p * nt] < med) ++p;
  int a = p - 1, b = p;
  float d_lo = 0.0f, d_hi = 0.0f;
  for (int k = 0; k <= hi; ++k) {
    float da = a >= 0 ? fabsf(col[a * nt] - med) : INF;
    float db = b < n ? fabsf(col[b * nt] - med) : INF;
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
    float s = col[k * nt];
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
      res = mul(0.5f, add(col[klo * nt], col[khi * nt]));
    } else if (combine == 2) {
      res = acc;
    } else {
      res = acc / (float)cnt;
    }
  }
  *o = res;
}

template <typename T>
__global__ void __launch_bounds__(BX * MAX_BY, 2)
warp_combine_kernel(const T* __restrict__ frames,
                    const float* __restrict__ masters,
                    const float* __restrict__ ftab,
                    const int* __restrict__ ttab, float* __restrict__ out,
                    int n, int h0, int w0, int th, int tw, int n_tj,
                    int n_tiles, int span, int lowrank, int combine,
                    float sigma_lo, float sigma_hi, int by, int sbx, int sby) {
  warp_block<T, false>(frames, masters, ftab, ttab, out, n, h0, w0, th, tw,
                       n_tj, n_tiles, span, lowrank, combine, sigma_lo,
                       sigma_hi, by, sbx, sby, blockIdx.x, blockIdx.y,
                       nullptr);
}

// 'cols': words of one warp's column of the combine tile (L rounded up
// to 32, plus a pad that spreads the W columns of a tile load over the
// banks), and the block's shared memory in words: the warp phase's
// layout (no columns) and the tile over the same words.
// kernels._warp_cols_smem_bytes mirrors it.
__host__ __device__ inline int cols_stride(int L, int W) {
  const int pad = W >= 8 ? 4 : W >= 4 ? 8 : W >= 2 ? 16 : 0;
  return ((L + 31) & ~31) + pad;
}
__host__ __device__ inline int cols_words(int L, int by, int span) {
  const int warp = layout(0, by, span).total, tile = by * cols_stride(L, by);
  return warp > tile ? warp : tile;
}

// The clip of a sorted column of n samples whose first `count` are the
// covered ones (the rest +3.4e38), in the twin's arithmetic: the kept
// samples are the sorted run [below, below + cnt).
struct Kept {
  int below, cnt;
};
__device__ __forceinline__ Kept clip_sorted(const Sorted& c, int n, int count,
                                            float sigma_lo, float sigma_hi) {
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(c[lo], c[hi]));
  // MAD over all n sorted deviations (an uncovered one is |3.4e38 - med|)
  const int p = lower_bound(c, n, med);
  const float sdev =
      mul(MAD_HALF, add(kth_dev(c, p, n, med, lo), kth_dev(c, p, n, med, hi)));
  const float lo_b = sub(med, mul(sigma_lo, sdev));
  const float hi_b = add(med, mul(sigma_hi, sdev));
  const int below = lower_bound(c, count, lo_b);
  return {below, max(upper_bound(c, count, hi_b) - below, 0)};
}

__device__ __forceinline__ float kept_median(const Sorted& c, Kept k) {
  return mul(0.5f, add(c[k.below + max((k.cnt - 1) / 2, 0)],
                       c[k.below + k.cnt / 2]));
}

// The combine of a column of n <= 32 R samples, sorted by the warp in
// registers: the ranks from the stored column, the kept run summed from
// the registers (run_sum).
template <int R>
__device__ __forceinline__ float combine_run(float* col, int n, int count,
                                             int combine, float sigma_lo,
                                             float sigma_hi, int lane) {
  float v[R];
  sort_run<R>(col, n, lane, v);
  const Sorted c{col, col_shift(n)};
  const Kept k = clip_sorted(c, n, count, sigma_lo, sigma_hi);
  if (k.cnt == 0) return 0.0f;
  if (combine == 1) return kept_median(c, k);
  const float acc = run_sum<R>(v, k.below, k.below + k.cnt, lane);
  return combine == 2 ? acc : acc / (float)k.cnt;
}

// The combine of a column of n samples in shared memory, any n.
__device__ __noinline__ float combine_col(float* col, int n, int count,
                                          int combine, float sigma_lo,
                                          float sigma_hi, int lane) {
  switch (col_regs(n)) {
    case 2: return combine_run<2>(col, n, count, combine, sigma_lo, sigma_hi, lane);
    case 4: return combine_run<4>(col, n, count, combine, sigma_lo, sigma_hi, lane);
    case 8: return combine_run<8>(col, n, count, combine, sigma_lo, sigma_hi, lane);
    case 16: return combine_run<16>(col, n, count, combine, sigma_lo, sigma_hi, lane);
    default: break;
  }
  if (n <= SORT_RUN)
    return combine_run<32>(col, n, count, combine, sigma_lo, sigma_hi, lane);
  sort_col(col, n, lane);  // runs of 1024 merged on chip
  const Sorted c{col, col_shift(n)};
  const Kept k = clip_sorted(c, n, count, sigma_lo, sigma_hi);
  if (k.cnt == 0) return 0.0f;
  if (combine == 1) return kept_median(c, k);
  float acc = 0.0f;  // in ascending order, one add after another
#pragma unroll 8
  for (int e = k.below; e < k.below + k.cnt; ++e) acc = add(acc, c[e]);
  return combine == 2 ? acc : acc / (float)k.cnt;
}

// A pixel's column in the slot as K sorted runs of `run` samples (the
// last shorter): sample i of run r at base[(r * run + i) * stride].
struct Runs {
  const float* base;
  int stride, n, run, K;
  __device__ __forceinline__ int len(int r) const {
    return min(run, n - r * run);
  }
  __device__ __forceinline__ float at(int r, int i) const {
    return base[(size_t)(r * run + i) * stride];
  }
  // first index in [0, m) of run r where pred(value) turns true (pred is
  // false, then true, along the run)
  template <typename P>
  __device__ __forceinline__ int find(int r, int m, P pred) const {
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pred(at(r, mid))) hi = mid; else lo = mid + 1;
    }
    return lo;
  }
  // samples whose key is at most t
  __device__ __forceinline__ int keys_le(unsigned t) const {
    int c = 0;
    for (int r = 0; r < K; ++r)
      c += find(r, len(r), [&](float v) { return float_key(v) > t; });
    return c;
  }
  // the key of the sorted column's sample k: the smallest key with more
  // than k samples at or below it
  __device__ __forceinline__ unsigned rank_key(int k) const {
    unsigned lo = 0u, hi = 0xffffffffu;
    while (lo < hi) {
      const unsigned mid = lo + ((hi - lo) >> 1);
      if (keys_le(mid) > k) hi = mid; else lo = mid + 1;
    }
    return lo;
  }
  // the k-th smallest deviation |v - med| over all n samples: in each run
  // they fall left of the median and rise from it, so each count is two
  // binary searches; bisected over the bits of a non-negative float
  __device__ __forceinline__ float rank_dev(float med, int k) const {
    unsigned lo = 0u, hi = 0x7f800000u;
    while (lo < hi) {
      const unsigned mid = lo + ((hi - lo) >> 1);
      const float d = __uint_as_float(mid);
      int c = 0;
      for (int r = 0; r < K; ++r) {
        const int m = len(r);
        const int p = find(r, m, [&](float v) { return !(v < med); });
        c += p - find(r, p, [&](float v) { return fabsf(v - med) <= d; });
        const int q = find(r, m, [&](float v) {
          return !(v < med) && fabsf(v - med) > d; });
        c += q - p;
      }
      if (c > k) hi = mid; else lo = mid + 1;
    }
    return __uint_as_float(lo);
  }
};

// combine_col over the K sorted runs of a column past `run` samples:
// the same ranks (bisected), the same kept set, and its sum in ascending
// order: chunks of fewer than `run` samples below a key t bisected at
// the chunk's last rank, gathered from the runs into `col` and sorted
// there, then the samples that equal t.  Every lane computes the same.
__device__ float combine_runs(const Runs& R, int count, int combine,
                              float sigma_lo, float sigma_hi, float* col,
                              int lane) {
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(float_of_key(R.rank_key(lo)),
                                  float_of_key(R.rank_key(hi))));
  const float sdev =
      mul(MAD_HALF, add(R.rank_dev(med, lo), R.rank_dev(med, hi)));
  const float lo_b = sub(med, mul(sigma_lo, sdev));
  const float hi_b = add(med, mul(sigma_hi, sdev));
  // per run: the covered samples [0, c_r), the kept ones [a_r, e_r)
  auto covered = [&](int r) {
    return R.find(r, R.len(r), [&](float v) { return !(v < BIG); });
  };
  auto kept_end = [&](int r) {
    return R.find(r, covered(r), [&](float v) { return hi_b < v; });
  };
  auto kept_start = [&](int r) {
    return R.find(r, covered(r), [&](float v) { return !(v < lo_b); });
  };
  int below = 0, cnt = 0;
  for (int r = 0; r < R.K; ++r) {
    const int a = kept_start(r);
    below += a;
    cnt += max(kept_end(r) - a, 0);
  }
  if (cnt == 0) return 0.0f;
  if (combine == 1)
    return mul(0.5f, add(float_of_key(R.rank_key(below + max((cnt - 1) / 2, 0))),
                         float_of_key(R.rank_key(below + cnt / 2))));
  float acc = 0.0f;
  unsigned tprev = 0u;
  bool first = true;
  for (;;) {
    // the first kept sample not yet summed, per run
    auto start = [&](int r) {
      return first ? kept_start(r)
                   : R.find(r, R.len(r),
                            [&](float v) { return float_key(v) > tprev; });
    };
    int rem = 0, rank0 = 0;
    for (int r = 0; r < R.K; ++r) {
      const int a = start(r);
      rem += max(kept_end(r) - a, 0);
      rank0 += a;
    }
    if (rem <= 0) break;
    const bool last = rem <= R.run;
    const unsigned t = last ? 0u : R.rank_key(rank0 + R.run - 1);
    // gather [start, end) of each run: all that is left, or the keys below t
    auto end = [&](int r) {
      return last ? kept_end(r)
                  : R.find(r, R.len(r),
                           [&](float v) { return float_key(v) >= t; });
    };
    int total = 0;
    for (int r = 0; r < R.K; ++r) total += max(end(r) - start(r), 0);
    const int s = col_shift(total);
    for (int r = 0, pos = 0; r < R.K; ++r) {
      const int a = start(r), m = max(end(r) - a, 0);
      for (int i = lane; i < m; i += 32) col[swz(pos + i, s)] = R.at(r, a + i);
      pos += m;
    }
    __syncwarp();
    sort_col(col, total, lane);
    for (int e = 0; e < total; ++e) acc = add(acc, col[swz(e, s)]);
    __syncwarp();
    if (last) break;
    int ties = 0;
    for (int r = 0; r < R.K; ++r)
      ties += R.find(r, R.len(r), [&](float v) { return float_key(v) > t; }) -
              R.find(r, R.len(r), [&](float v) { return float_key(v) >= t; });
    const float vt = float_of_key(t);
    for (int m = 0; m < ties; ++m) acc = add(acc, vt);
    tprev = t;
    first = false;
  }
  return combine == 2 ? acc : acc / (float)cnt;
}

// The combine of one output block of nt pixels on 'cols' or 'wide', after
// the warp phase: W (the block's warps) pixels at a time (tid order:
// neighbours in a row), warp w on pixel g + w.  With n <= run the block
// reads the group's n x W samples from the slot (W words a frame row) into
// one column per warp once and each warp sorts and combines its own; past
// `run` the runs are read, sorted and written back one after another, then
// combine_runs reads them.
__device__ __forceinline__ void cols_combine(float* __restrict__ slot,
                                             float* __restrict__ out, int n,
                                             int W, int nt, int run,
                                             int combine, float sigma_lo,
                                             float sigma_hi) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, wp = threadIdx.y, nth = BX * W;
  const int tid = wp * BX + lane;
  const int* pc = reinterpret_cast<const int*>(slot + (size_t)n * nt);
  const int CS = cols_stride(min(n, run), W);
  float* col = smem + wp * CS;
  const int K = (n + run - 1) / run;
  for (int g = 0; g < nt; g += W) {
    bool any = false;
    for (int q = 0; q < W; ++q) any |= pc[g + q] > 0;
    if (!any) continue;  // the same for every thread
    const int q = g + wp, count = pc[q];
    float* tile = slot + g;  // the group's samples, W words a frame row
    float res = 0.0f;
    for (int r = 0; r < K; ++r) {
      const int f0 = r * run, len = min(run, n - f0), s = col_shift(len);
      __syncthreads();  // the tile's readers are done
#pragma unroll 8
      for (int i = tid; i < len * W; i += nth) {
        const int f = i / W, p = i - f * W;
        smem[p * CS + swz(f, s)] = tile[(size_t)(f0 + f) * nt + p];
      }
      __syncthreads();
      if (K == 1) {
        if (count > 0)
          res = combine_col(col, n, count, combine, sigma_lo, sigma_hi, lane);
      } else {
        if (count > 0) sort_col(col, len, lane);
        __syncthreads();
#pragma unroll 8
        for (int i = tid; i < len * W; i += nth) {
          const int f = i / W, p = i - f * W;
          tile[(size_t)(f0 + f) * nt + p] = smem[p * CS + swz(f, s)];
        }
      }
    }
    if (K > 1) {
      __syncthreads();  // the sorted runs are in the slot; the tile is free
      if (count > 0)
        res = combine_runs(Runs{tile + wp, nt, n, run, K}, count, combine,
                           sigma_lo, sigma_hi, col, lane);
    }
    if (count > 0 && lane == 0) out[pc[nt + q]] = res;
  }
}

// The 'cols' route: the grid holds only the blocks the card keeps
// resident (warp_combine_cols_blocks); each walks the output blocks (nbx
// per row of blocks, nblocks in all) with a stride of the grid and keeps
// its samples in its own slot of `scratch` ((n + 2) x nt words, nt = 32
// x by: the samples, then each pixel's count and output offset).
template <typename T>
__global__ void __launch_bounds__(BX * MAX_BY, 2)
warp_combine_cols_kernel(const T* __restrict__ frames,
                         const float* __restrict__ masters,
                         const float* __restrict__ ftab,
                         const int* __restrict__ ttab,
                         float* __restrict__ out, int n, int h0, int w0,
                         int th, int tw, int n_tj, int n_tiles, int span,
                         int lowrank, int combine, float sigma_lo,
                         float sigma_hi, int by, int sbx, int sby, int nbx,
                         int nblocks, int run, float* __restrict__ scratch) {
  float* slot = scratch + (size_t)blockIdx.x * (n + 2) * (BX * by);
  for (int b = blockIdx.x; b < nblocks; b += gridDim.x) {
    // the previous output block's threads are done with shared memory
    if (b != (int)blockIdx.x) __syncthreads();
    warp_block<T, true>(frames, masters, ftab, ttab, out, n, h0, w0, th, tw,
                        n_tj, n_tiles, span, lowrank, combine, sigma_lo,
                        sigma_hi, by, sbx, sby, b % nbx, b / nbx, slot);
    if (combine != 3) {
      __syncthreads();
      cols_combine(slot, out, n, by, BX * by, run, combine, sigma_lo,
                   sigma_hi);
    }
  }
}

// ---------------------------------------------------------------------
// The 'wide' route: windows that leave no room for even one output row of
// a shared block (span past 192 at 32 columns).  A block of WIDE_WARPS
// warps covers up to WIDE_WARPS x WIDE_PIX output rows by BX columns of
// one tile (`rows`, kernels._warp_wide_rows); per frame it computes the
// mid rows its pixels read (mid row k is the horizontal pass of source
// row vbase + r0 + k, and output row kr reads mid rows kr + s), each once:
// each warp stages one calibrated window row at a time, only the columns
// that row's taps reach, into its own row of shared memory and filters it
// into the mid rows ((rows + span) x BX floats), in the twin's order;
// after a block barrier the vertical pass reads them.
//
// The frame pipeline.  A frame's parameters reach the block through a
// ring of WIDE_RING shared slots, loaded by warp 0 two frames ahead; the
// frame's body weights (the snap taps) and the range of mid rows its
// pixels read are prepared during the frame before (`prep`), into slots
// of their own, so two barriers a frame remain: after the horizontal
// pass, and after the vertical pass and the next frame's preparation.
// (Two mid buffers, the vertical pass of one frame beside the horizontal
// pass of the next behind one barrier, with two staged rows a warp, were
// 17-24 % slower, their 128 registers spilling more: 676 B of spill
// loads against 236; so were the next row's pixels loaded into registers
// a row ahead; tools/wide_variants.py.)  The 'exact' body evaluates a pass's 8
// tap weights side by side (exact_taps).  The lowrank body's column
// weights are each lane's own (every warp's pixels share the lane's
// column), so each thread computes them in the vertical pass.
//
// The combine.  Each thread combines its own pixels' samples, which it
// wrote itself into the block's slot of the scratch (in L2): up to
// WIDE_REG_MAX (32) frames with a register network, no barrier and no
// shared memory; up to WIDE_COL_MAX (112) sorted in its column of its
// warp's [n][BX] words of shared memory (the smem route's network and
// arithmetic), after one barrier, where two blocks still fit an SM;
// past that the block combines through the 'cols' combine (cols_combine).
// Any frame count works.
constexpr int WIDE_WARPS = 8;  // warps of a block: BX x 8 threads
constexpr int WIDE_PIX = 4;    // output rows per thread: blocks of <= 32 rows
constexpr int WIDE_RING = 4;   // parameter slots: frames f .. f + 2 in use
constexpr int WIDE_SLOTS = 2;  // weights and ranges: frames f, f + 1
constexpr int WIDE_REG_MAX = 32;
constexpr int WIDE_COL_MAX = 112;  // a warp's [n][BX] columns: 2 blocks an SM
constexpr int NO_ROW = 0x7fffffff;

struct WideLayout {
  int wc, mid, stage, sw, ring, rng, total;
};

// Shared memory of a 'wide' block's warp phase, in words
// (kernels._warp_wide_smem_bytes mirrors the total).
__host__ __device__ inline WideLayout wide_layout(int rows, int span) {
  WideLayout L;
  L.wc = BX + span;                      // window columns
  L.mid = 0;                             // [rows + span][BX] mid rows
  L.stage = L.mid + (rows + span) * BX;  // [WIDE_WARPS][wc] a row per warp
  L.sw = L.stage + WIDE_WARPS * L.wc;    // [WIDE_SLOTS][16] snap weights
  L.ring = L.sw + WIDE_SLOTS * 16;       // [WIDE_RING][PSLOT] parameters
  L.rng = L.ring + WIDE_RING * PSLOT;    // [WIDE_SLOTS][2] mid rows read
  L.total = L.rng + WIDE_SLOTS * 2;
  return L;
}

// The block's words: the warp phase and, past WIDE_REG_MAX frames, the
// 'cols' combine's tile over the same words (kernels._warp_wide_smem_total
// mirrors it).
__host__ __device__ inline int wide_words(int n, int L, int rows, int span) {
  const int warp = wide_layout(rows, span).total;
  const int tile = n <= WIDE_REG_MAX   ? 0
                   : n <= WIDE_COL_MAX ? WIDE_WARPS * n * BX
                                       : WIDE_WARPS * cols_stride(L, WIDE_WARPS);
  return warp > tile ? warp : tile;
}

// compare-exchange of the register networks: min and max order -0 below
// +0, so they only permute their operands
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

// bitonic merge of M registers that fall and then rise (the padding
// [M, P) standing for a maximum), in log2 P stages
template <int M>
__device__ __forceinline__ void merge_regs(float (&v)[M]) {
  constexpr int P = pow2_at_least(M);
#pragma unroll
  for (int j = P >> 1; j > 0; j >>= 1)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (!(i & j) && (i ^ j) < M) cswap_mm(v[i], v[i ^ j]);
}

// v[k], k < M, by a select tree over the bits of k (no register array is
// indexed at run time)
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

// The combine of one pixel's n <= M samples (col[f * stride], uncovered
// ones +3.4e38), count of them covered, in registers, in the 'smem'
// route's arithmetic: the sorted samples' median at ranks lo, hi; the MAD
// at the same ranks of all n sorted deviations (they fall to the median
// and rise after it, padding +inf: one bitonic merge sorts them); the
// clip; the kept run's median, sum or mean, summed in ascending order.
template <int M>
__device__ __forceinline__ float combine_regs(const float* col, int stride,
                                              int n, int count, int combine,
                                              float sigma_lo, float sigma_hi) {
  const float INF = __int_as_float(0x7f800000);
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = i < n ? col[(size_t)i * stride] : INF;
  sort_regs<M>(v);
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(pick<M>(v, lo), pick<M>(v, hi)));
  float d[M];
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = i < n ? fabsf(v[i] - med) : INF;
  merge_regs<M>(d);
  const float sdev = mul(MAD_HALF, add(pick<M>(d, lo), pick<M>(d, hi)));
  const float lo_b = sub(med, mul(sigma_lo, sdev));
  const float hi_b = add(med, mul(sigma_hi, sdev));
  float acc = 0.0f;
  int cnt = 0, below = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < count) {
      const float s = v[i];
      if (s < lo_b) {
        ++below;
      } else if (s <= hi_b) {
        acc = add(acc, s);
        ++cnt;
      }
    }
  }
  if (cnt == 0) return 0.0f;
  if (combine == 1)
    return mul(0.5f, add(pick<M>(v, below + max((cnt - 1) / 2, 0)),
                         pick<M>(v, below + cnt / 2)));
  return combine == 2 ? acc : acc / (float)cnt;
}

__device__ __noinline__ float combine_small(const float* col, int stride,
                                            int n, int count, int combine,
                                            float sigma_lo, float sigma_hi) {
  if (n <= 8)
    return combine_regs<8>(col, stride, n, count, combine, sigma_lo, sigma_hi);
  if (n <= 16)
    return combine_regs<16>(col, stride, n, count, combine, sigma_lo, sigma_hi);
  if (n <= 24)
    return combine_regs<24>(col, stride, n, count, combine, sigma_lo, sigma_hi);
  return combine_regs<32>(col, stride, n, count, combine, sigma_lo, sigma_hi);
}

// One 'exact' pass at coordinate t of a pixel at b: the taps s in
// [tap_lo(t - b, 0), tap_hi(t - b, span - 1)] (at most 8) with weights
// l3(t - (b + s)), normalised by their sum, in the twin's order; the eight
// weights are evaluated side by side (eight polynomial chains in flight)
// and summed in tap order, a zero weight skipped.  at(s) reads tap s.
template <typename F>
__device__ __forceinline__ float exact_taps(float t, int b, int span, F at) {
  const float rel = t - (float)b;
  const int lo = tap_lo(rel, 0), hi = tap_hi(rel, span - 1);
  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    w[q] = lo + q <= hi ? l3(t - (float)(b + lo + q)) : 0.0f;
  float acc = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (lo + q <= hi && w[q] != 0.0f) {
      acc = add(acc, mul(w[q], at(lo + q)));
      wsum = add(wsum, w[q]);
    }
  return fabsf(wsum) > 1e-3f ? acc / wsum : 0.0f;
}

// a body as a type, for the loops written once per body
template <int K>
struct Kind {
  static constexpr int value = K;
};

// The combine of one pixel's sorted column col[0, n) (stride st, the
// uncovered samples +3.4e38 last), count of them covered, in the 'smem'
// route's arithmetic (warp_block): the median at ranks lo, hi; the MAD by
// merging the two monotone runs of deviations around it, over all n; the
// clip; the kept run's median, sum or mean in ascending order.
__device__ __noinline__ float combine_sorted(const float* col, int st, int n,
                                             int count, int combine,
                                             float sigma_lo, float sigma_hi) {
  const float INF = __int_as_float(0x7f800000);
  const int lo = max((count - 1) / 2, 0), hi = max(count / 2, 0);
  const float med = mul(0.5f, add(col[lo * st], col[hi * st]));
  int p = 0;
  while (p < n && col[p * st] < med) ++p;
  int a = p - 1, b = p;
  float d_lo = 0.0f, d_hi = 0.0f;
  for (int k = 0; k <= hi; ++k) {
    const float da = a >= 0 ? fabsf(col[a * st] - med) : INF;
    const float db = b < n ? fabsf(col[b * st] - med) : INF;
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
    const float s = col[k * st];
    if (s < lo_b) {
      ++below;
    } else if (s <= hi_b) {
      acc = add(acc, s);
      ++cnt;
    }
  }
  if (cnt == 0) return 0.0f;
  if (combine == 1)
    return mul(0.5f, add(col[(below + max((cnt - 1) / 2, 0)) * st],
                         col[(below + max(cnt / 2, 0)) * st]));
  return combine == 2 ? acc : acc / (float)cnt;
}

// One output block of the 'wide' route, (bid_x, bid_y) in its grid: the
// warp phase into `vals`, the block's slot ([n + 2][nt] words, nt = BX x
// rows); then, up to WIDE_REG_MAX frames, each thread's combine of its own
// pixels; past it each pixel's count of covered samples and output offset
// in the slot's rows n and n + 1, as warp_block leaves them on 'cols'.
template <typename T>
__device__ __forceinline__ void wide_block(
    const T* __restrict__ frames, const float* __restrict__ masters,
    const float* __restrict__ ftab, const int* __restrict__ ttab,
    float* __restrict__ out, int n, int h0, int w0, int th, int tw, int n_tj,
    int n_tiles, int span, int lowrank, int combine, float sigma_lo,
    float sigma_hi, int rows, int sbx, int sby, int bid_x, int bid_y,
    float* __restrict__ vals) {
  extern __shared__ float smem[];
  constexpr int NSLOT = WIDE_SLOTS;
  const WideLayout L = wide_layout(rows, span);
  float* midb = smem + L.mid;
  float* stage = smem + L.stage + threadIdx.y * L.wc;
  float* swb = smem + L.sw;
  float* ring = smem + L.ring;
  int* rngb = reinterpret_cast<int*>(smem + L.rng);
  const unsigned FULL = 0xffffffffu;
  const int nt = BX * rows, last_mid = rows + span - 1;
  const int lane = threadIdx.x, wp = threadIdx.y;
  const int tid = wp * BX + lane;
  // block -> (tile, sub-block): rows r0 + [0, rows), columns c0 + [0, BX)
  const int j = bid_x / sbx, c0 = (bid_x - j * sbx) * BX;
  const int i = bid_y / sby, r0 = (bid_y - i * sby) * rows;
  const int tile = i * n_tj + j;
  const int c = c0 + lane, x = j * tw + c;
  const bool col_live = c < tw && x < w0;
  const int rows_here = min(rows, th - r0);  // the tile clips its last block
  const float x_out = (float)x;
  const float ti = (float)(i * th), tj = (float)(j * tw);
  const int t_lo = span >= 7 ? 1 : 0;
  const int t_hi = span >= 7 ? min(span, 7) : span;
  const int nk = t_hi - t_lo;
  const int t1hi = min(span, 9);
  const Src<T> S{frames, masters, (size_t)h0 * w0, h0, w0};

  auto slot = [&](int g) { return ring + (g % WIDE_RING) * PSLOT; };
  auto param_load = [&](int g) -> int {  // warp 0, one word a lane
    if (lane < 16) return __float_as_int(ftab[16 * (size_t)g + lane]);
    if (lane < 19) return ttab[3 * ((size_t)g * n_tiles + tile) + lane - 16];
    return 0;
  };
  auto param_store = [&](int g, int pv) {
    if (lane < 19) reinterpret_cast<int*>(slot(g))[lane] = pv;
  };
  // how the block uses frame g: the window contained and, for the general
  // bodies, the span / lowrank gate (the same for the whole block)
  auto kind_of = [&](const float* P) {
    const bool use = reinterpret_cast<const int*>(P)[18] != 0 &&
                     (P[8] > 0.5f || P[14] > 0.5f);
    return !use ? OFF : (P[8] > 0.5f ? SNAP : (lowrank ? LOW : EXACT));
  };
  // this thread's output rows k = wp + m * WIDE_WARPS (block-relative)
  auto live = [&](int k) {
    return col_live && k < rows_here && i * th + r0 + k < h0;
  };
  auto covered = [&](const float* P, int k) {
    const float y_out = (float)(i * th + r0 + k);
    const float v = affine_rn(P[3], x_out, P[4], y_out, P[5]);
    const float sx = affine_rn(P[0], x_out, P[1], y_out, P[2]);
    return sx >= 2.0f && sx <= (float)w0 - 4.0f && v >= P[9] && v <= P[10];
  };
  // the 'exact' body's vertical coordinate of output row k
  auto v_local = [&](const float* P, int k) {
    const float y_out = (float)(i * th + r0 + k);
    return affine_rn(P[3], x_out, P[4], y_out, P[5]) -
           (float)reinterpret_cast<const int*>(P)[16];
  };
  // the lowrank body's vertical taps of this lane's column: [lo, hi] and
  // the weights of taps lo + q
  auto low_taps = [&](const float* P, int& lo, int& hi) {
    const float m11 = P[4];
    const float bv = add(affine_rn(P[3], x_out, m11, ti, P[5]) -
                             (float)reinterpret_cast<const int*>(P)[16],
                         mul(m11 - 1.0f, (float)(th - 1) * 0.5f));
    lo = tap_lo(bv, 1);
    hi = tap_hi(bv, span - 1);
    return bv;
  };

  // Prepare frame g (its parameters are in the ring): the snap weights
  // (one warp: the 12 tap weights and two reciprocals, lanes 0-7
  // horizontal, 8-15 vertical, scaled, and the masks of the non-zero
  // taps) and the range of mid rows the block's pixels read, into slot
  // g % NSLOT (its range was reset to empty before).
  auto prep = [&](int g) {
    const float* P = slot(g);
    const int kind = kind_of(P);
    int* rng = rngb + (g % NSLOT) * 2;
    if (kind == OFF) return;
    if (kind == SNAP) {
      if (wp == g % WIDE_WARPS) {
        const int* Pi = reinterpret_cast<const int*>(P);
        const int q0 = lane & 7;
        const float a = lane < 8 ? (tj + P[13]) - (float)Pi[17]
                                 : (ti + P[5]) - (float)Pi[16];
        const float w = q0 < nk ? l3(a - (float)(t_lo + q0)) : 0.0f;
        float ws[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) ws[q] = __shfl_sync(FULL, w, (lane & 8) + q);
        float sum = ws[0];
#pragma unroll
        for (int q = 1; q < 6; ++q)
          if (q < nk) sum = add(sum, ws[q]);
        const float inv = fabsf(sum) > 1e-3f ? 1.0f / sum : 0.0f;
        const unsigned nz = __ballot_sync(FULL, q0 < nk && w != 0.0f);
        float* sw = swb + (g % NSLOT) * 16;
        if (q0 < nk && lane < 16) sw[lane] = mul(w, inv);
        if (lane == 0) {
          reinterpret_cast<int*>(sw)[6] = nz & 0xffu;
          reinterpret_cast<int*>(sw)[14] = (nz >> 8) & 0xffu;
          rng[0] = t_lo;
          rng[1] = rows_here - 1 + t_hi - 1;
        }
      }
      return;
    }
    int klo = NO_ROW, khi = -1;
    if (kind == LOW) {
      if (wp != 0) return;
      int lo, hi;
      low_taps(P, lo, hi);
      if (lo <= hi) {  // every column of the block
        klo = lo;
        khi = hi + rows_here - 1;
      }
    } else {
#pragma unroll
      for (int m = 0; m < WIDE_PIX; ++m) {
        const int k = wp + m * WIDE_WARPS;
        if (live(k) && covered(P, k)) {
          const float vrel = v_local(P, k) - (float)(r0 + k);
          const int lo = tap_lo(vrel, 0), hi = tap_hi(vrel, span - 1);
          if (lo <= hi) {
            klo = min(klo, k + lo);
            khi = max(khi, k + hi);
          }
        }
      }
    }
    klo = __reduce_min_sync(FULL, klo);
    khi = __reduce_max_sync(FULL, khi);
    if (lane == 0 && klo <= khi) {
      atomicMin(rng, klo);
      atomicMax(rng + 1, khi);
    }
  };

  // The horizontal pass of frame f into the mid rows: warp wp stages
  // and filters mid rows qlo + wp, qlo + wp + WIDE_WARPS, ...  One loop
  // per body (K), so each keeps only its own state live.
  auto horizontal = [&](int f) {
    const float* P = slot(f);
    const int kind = kind_of(P);
    if (kind == OFF) return;
    const int* Pi = reinterpret_cast<const int*>(P);
    const int* rng = rngb + (f % NSLOT) * 2;
    const int qlo = rng[0], qhi = min(rng[1], last_mid);
    // no pixel of the block is covered (qlo is NO_ROW), or no row of
    // this warp's is read
    if (qlo > qhi || qhi - qlo < wp) return;
    float* mid = midb;
    auto run = [&](auto K) {
      constexpr int kind = decltype(K)::value;
      const float vb_f = (float)Pi[16], ub_f = (float)Pi[17];
      const float gx = P[11], gy = P[12], g0 = P[13];
      const int gy0 = Pi[16] + r0, gx0 = Pi[17] + c0;
      // the window columns [clo, chi] that row k's taps reach, and the
      // 'exact' body's horizontal coordinate
      auto reach = [&](int k, int& clo, int& chi, float& u_loc) {
        if constexpr (kind == SNAP) {
          clo = t_lo;
          chi = BX - 1 + t_hi - 1;
        } else if constexpr (kind == LOW) {
          clo = 1;
          chi = BX - 1 + t1hi - 1;
        } else {
          u_loc = affine_rn(gx, x_out, gy, vb_f + (float)(r0 + k), g0) - ub_f;
          const float urel = u_loc - (float)c;
          const int lo = tap_lo(urel, 0), hi = tap_hi(urel, span - 1);
          const bool any = col_live && lo <= hi;
          clo = __reduce_min_sync(FULL, any ? lane + lo : NO_ROW);
          chi = __reduce_max_sync(FULL, any ? lane + hi : -1);
        }
      };
      // this lane's mid value of row k, staged at st
      auto filter = [&](const float* st, int k, float u_loc) {
        float mv = 0.0f;
        if constexpr (kind == SNAP) {
          const float* sw = swb + (f % NSLOT) * 16;
          const int hmask = reinterpret_cast<const int*>(sw)[6];
#pragma unroll
          for (int q = 0; q < 6; ++q)
            if (q < nk && ((hmask >> q) & 1))
              mv = add(mv, mul(sw[q], st[lane + t_lo + q]));
        } else if constexpr (kind == LOW) {
          // the row's weights, 8 lanes, the sum in tap order by shuffles
          const float bu =
              add(affine_rn(gx, tj, gy, vb_f + (float)(r0 + k), g0) - ub_f,
                  mul(gx - 1.0f, (float)(tw - 1) * 0.5f));
          const int s2 = 1 + (lane & 7);
          const float w = s2 >= tap_lo(bu, 1) && s2 <= tap_hi(bu, t1hi - 1)
                              ? l3(bu - (float)s2)
                              : 0.0f;
          float ws[HT];
#pragma unroll
          for (int q = 0; q < HT; ++q) ws[q] = __shfl_sync(FULL, w, q);
          float w0s = 0.0f;
#pragma unroll
          for (int q = 0; q < HT; ++q)
            if (ws[q] != 0.0f) w0s = add(w0s, ws[q]);
          const float hinv = fabsf(w0s) > 1e-3f ? 1.0f / w0s : 0.0f;
          float acc0 = 0.0f;
#pragma unroll
          for (int q = 0; q < HT; ++q)
            if (q < t1hi - 1 && ws[q] != 0.0f)
              acc0 = add(acc0, mul(ws[q], st[lane + 1 + q]));
          mv = mul(acc0, hinv);
        } else {
          if (col_live)
            mv = exact_taps(u_loc, c, span,
                            [&](int s2) { return st[lane + s2]; });
        }
        return mv;
      };
      for (int k = qlo + wp; k <= qhi; k += WIDE_WARPS) {
        int clo, chi;
        float u_loc = 0.0f;
        reach(k, clo, chi, u_loc);
        // (clo > chi: no lane of an 'exact' row reaches a tap)
        for (int col = clo + lane; col <= chi; col += 32)
          stage[col] = S.load_cal(f, gy0 + k, gx0 + col, P[6], P[7]);
        __syncwarp();
        mid[k * BX + lane] = filter(stage, k, u_loc);
        __syncwarp();  // the stage's readers are done
      }
    };
    if (kind == SNAP)
      run(Kind<SNAP>{});
    else if (kind == LOW)
      run(Kind<LOW>{});
    else
      run(Kind<EXACT>{});
  };

  int count[WIDE_PIX];
  float macc[WIDE_PIX];
#pragma unroll
  for (int m = 0; m < WIDE_PIX; ++m) {
    count[m] = 0;
    macc[m] = 0.0f;
  }

  // The vertical pass of frame f from the mid rows: this thread's
  // samples (+3.4e38 where not covered), in frame order; one loop per body.
  auto vertical = [&](int f) {
    const float* P = slot(f);
    const int kind = kind_of(P);
    const float* mid = midb;
    auto run = [&](auto K) {
      constexpr int kind = decltype(K)::value;
      float vw[HT];
      int vlo = 0, vhi = -1;
      if constexpr (kind == LOW) {
        const float bv = low_taps(P, vlo, vhi);
#pragma unroll
        for (int q = 0; q < HT; ++q)
          vw[q] = vlo + q <= vhi ? l3(bv - (float)(vlo + q)) : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < WIDE_PIX; ++m) {
        const int k = wp + m * WIDE_WARPS;
        if (!live(k)) continue;
        float* o = vals + (size_t)f * nt + k * BX + lane;
        if (kind == OFF || !covered(P, k)) {
          *o = BIG;
          continue;
        }
        float val = 0.0f;
        if constexpr (kind == SNAP) {
          const float* sw = swb + (f % NSLOT) * 16;
          const int vmask = reinterpret_cast<const int*>(sw)[14];
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const float mq = mid[min(k + t_lo + q, last_mid) * BX + lane];
            if (q < nk && ((vmask >> q) & 1)) acc = add(acc, mul(sw[8 + q], mq));
          }
          val = acc;
        } else if constexpr (kind == LOW) {
          float acc2 = 0.0f, v0s = 0.0f;
#pragma unroll
          for (int q = 0; q < HT; ++q) {  // at most 8 taps in [lo, hi]
            const int s = max(min(vlo + q, vhi), 0);
            const float mq = mid[min(k + s, last_mid) * BX + lane];
            if (vlo + q <= vhi && vw[q] != 0.0f) {
              acc2 = add(acc2, mul(vw[q], mq));
              v0s = add(v0s, vw[q]);
            }
          }
          val = mul(acc2, fabsf(v0s) > 1e-3f ? 1.0f / v0s : 0.0f);
        } else if constexpr (kind == EXACT) {
          val = exact_taps(v_local(P, k), r0 + k, span,
                           [&](int s) { return mid[(k + s) * BX + lane]; });
        }
        ++count[m];  // a covered sample, in frame order
        macc[m] = add(macc[m], val);
        *o = val;
      }
    };
    if (kind == SNAP)
      run(Kind<SNAP>{});
    else if (kind == LOW)
      run(Kind<LOW>{});
    else if (kind == EXACT)
      run(Kind<EXACT>{});
    else
      run(Kind<OFF>{});
  };

  // the pipeline's prologue: frames 0 and 1's parameters, every range
  // empty, frame 0 prepared
  if (wp == 0) {
    for (int g = 0; g < min(n, 2); ++g) param_store(g, param_load(g));
    if (lane < 2 * NSLOT) rngb[lane] = lane & 1 ? -1 : NO_ROW;
  }
  __syncthreads();
  prep(0);
  __syncthreads();
  for (int f = 0; f < n; ++f) {
    // warp 0 loads frame f + 2's parameters now and stores them last;
    // the range slot of frame f + 1 is emptied before it is prepared
    const bool ahead = wp == 0 && f + 2 < n;
    const int pv = ahead ? param_load(f + 2) : 0;
    if (tid == 0 && f + 1 < n) {
      int* rng = rngb + ((f + 1) % NSLOT) * 2;
      rng[0] = NO_ROW;
      rng[1] = -1;
    }
    horizontal(f);
    __syncthreads();  // the mid rows are complete
    vertical(f);
    if (f + 1 < n) prep(f + 1);
    if (ahead) param_store(f + 2, pv);
    __syncthreads();  // the mid rows are read; frame f + 1 is prepared
  }

  if (n <= WIDE_COL_MAX) {
    // each thread's own pixels, from the samples it wrote: in registers,
    // or past WIDE_REG_MAX frames sorted in the thread's column of its
    // warp's [n][BX] words of shared memory, once every warp is done
    // with the mid rows
    float* col = smem + (size_t)wp * n * BX + lane;
    if (n > WIDE_REG_MAX) __syncthreads();
    // a rolled loop (one copy of the combines); count and macc are read
    // by a select, so they stay in registers
#pragma unroll 1
    for (int m = 0; m < WIDE_PIX; ++m) {
      const int k = wp + m * WIDE_WARPS;
      if (!live(k)) continue;
      int cm = count[0];
      float am = macc[0];
#pragma unroll
      for (int q = 1; q < WIDE_PIX; ++q)
        if (q == m) {
          cm = count[q];
          am = macc[q];
        }
      const int off = (i * th + r0 + k) * w0 + x;
      const float* own = vals + k * BX + lane;
      if (cm == 0) {
        out[off] = 0.0f;
      } else if (combine == 3) {
        out[off] = am / (float)cm;
      } else if (n <= WIDE_REG_MAX) {
        out[off] = combine_small(own, nt, n, cm, combine, sigma_lo, sigma_hi);
      } else {
#pragma unroll 8
        for (int f = 0; f < n; ++f) col[f * BX] = own[(size_t)f * nt];
        sort_column(col, n, BX);  // uncovered +3.4e38 sort last
        out[off] = combine_sorted(col, BX, n, cm, combine, sigma_lo, sigma_hi);
      }
    }
    return;
  }
  int* pc = reinterpret_cast<int*>(vals + (size_t)n * nt);
#pragma unroll
  for (int m = 0; m < WIDE_PIX; ++m) {
    const int k = wp + m * WIDE_WARPS;
    if (k >= rows) continue;
    const int p = k * BX + lane, off = (i * th + r0 + k) * w0 + x;
    int left = 0;
    if (live(k)) {
      if (count[m] == 0)
        out[off] = 0.0f;
      else if (combine == 3)
        out[off] = macc[m] / (float)count[m];
      else
        left = count[m];
    }
    pc[p] = left;
    pc[nt + p] = live(k) ? off : 0;
  }
}

// The 'wide' route's kernel: like warp_combine_cols_kernel, a grid of the
// blocks the card keeps resident (no more than a 1 GiB scratch holds),
// each walking the output blocks with the grid's stride, its samples in
// its own slot of `scratch` ((n + 2) x nt words, nt = BX x rows).
template <typename T, int MINB>
__global__ void __launch_bounds__(BX * WIDE_WARPS, MINB)
warp_combine_wide_kernel(const T* __restrict__ frames,
                         const float* __restrict__ masters,
                         const float* __restrict__ ftab,
                         const int* __restrict__ ttab,
                         float* __restrict__ out, int n, int h0, int w0,
                         int th, int tw, int n_tj, int n_tiles, int span,
                         int lowrank, int combine, float sigma_lo,
                         float sigma_hi, int rows, int sbx, int sby, int nbx,
                         int nblocks, int run, float* __restrict__ scratch) {
  const int nt = BX * rows;
  float* slot = scratch + (size_t)blockIdx.x * (n + 2) * nt;
  for (int b = blockIdx.x; b < nblocks; b += gridDim.x) {
    if (b != (int)blockIdx.x) __syncthreads();
    wide_block<T>(frames, masters, ftab, ttab, out, n, h0, w0, th, tw,
                        n_tj, n_tiles, span, lowrank, combine, sigma_lo,
                        sigma_hi, rows, sbx, sby, b % nbx, b / nbx, slot);
    if (n > WIDE_COL_MAX && combine != 3) {
      __syncthreads();
      cols_combine(slot, out, n, WIDE_WARPS, nt, run, combine, sigma_lo,
                   sigma_hi);
    }
  }
}

template <typename T>
cudaError_t launch(const void* frames, const float* masters, const float* ftab,
                   const int* ttab, float* out, int n, int h0, int w0, int th,
                   int tw, int n_ti, int n_tj, int span, int lowrank,
                   int combine, float sigma_lo, float sigma_hi, int by,
                   cudaStream_t stream) {
  if (by < 1 || by > MAX_BY) return cudaErrorInvalidValue;
  size_t smem = sizeof(float) * (size_t)layout(n, by, span).total;
  cudaError_t err = cudaFuncSetAttribute(
      warp_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int sbx = (tw + BX - 1) / BX, sby = (th + by - 1) / by;
  dim3 block(BX, by);
  dim3 grid(n_tj * sbx, n_ti * sby);
  warp_combine_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(frames), masters, ftab, ttab, out, n, h0, w0, th,
      tw, n_tj, n_ti * n_tj, span, lowrank, combine, sigma_lo, sigma_hi, by,
      sbx, sby);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols(const void* frames, const float* masters,
                        const float* ftab, const int* ttab, float* out, int n,
                        int h0, int w0, int th, int tw, int n_ti, int n_tj,
                        int span, int lowrank, int combine, float sigma_lo,
                        float sigma_hi, int by, int run, float* scratch,
                        int grid_blocks, cudaStream_t stream) {
  if (by < 1 || by > MAX_BY || scratch == nullptr || grid_blocks < 1 ||
      run < 32)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)cols_words(min(n, run), by, span);
  cudaError_t err = cudaFuncSetAttribute(
      warp_combine_cols_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int sbx = (tw + BX - 1) / BX, sby = (th + by - 1) / by;
  const int nbx = n_tj * sbx, nblocks = nbx * n_ti * sby;
  dim3 block(BX, by);
  warp_combine_cols_kernel<T>
      <<<min(grid_blocks, nblocks), block, smem, stream>>>(
          static_cast<const T*>(frames), masters, ftab, ttab, out, n, h0, w0,
          th, tw, n_tj, n_ti * n_tj, span, lowrank, combine, sigma_lo,
          sigma_hi, by, sbx, sby, nbx, nblocks, run, scratch);
  return cudaGetLastError();
}

template <typename T>
int cols_blocks(int n, int span, int by, int run) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = sizeof(float) * (size_t)cols_words(min(n, run), by, span);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(warp_combine_cols_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, warp_combine_cols_kernel<T>, BX * by, smem) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

// The blocks an SM must keep of the 'wide' kernel: 3 where three blocks'
// shared memory fits an SM's 228 KB (1 KB of each reserved; 85 registers
// a thread, some spilled), else 2 (128 registers).  Three were 13-14 %
// faster where they fit, 24 % slower where shared memory held the SM to
// two anyway (tools/wide_variants.py).  kernels._warp_wide_min_blocks
// mirrors it.
__host__ __device__ inline int wide_min_blocks(int n, int L, int rows,
                                               int span) {
  return 3 * (4 * wide_words(n, L, rows, span) + 1024) <= 233472 ? 3 : 2;
}

template <typename T, int MINB>
cudaError_t launch_wide_b(const void* frames, const float* masters,
                          const float* ftab, const int* ttab, float* out,
                          int n, int h0, int w0, int th, int tw, int n_ti,
                          int n_tj, int span, int lowrank, int combine,
                          float sigma_lo, float sigma_hi, int rows, int run,
                          float* scratch, int grid_blocks,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)wide_words(n, min(n, run), rows, span);
  cudaError_t err = cudaFuncSetAttribute(
      warp_combine_wide_kernel<T, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int sbx = (tw + BX - 1) / BX, sby = (th + rows - 1) / rows;
  const int nbx = n_tj * sbx, nblocks = nbx * n_ti * sby;
  dim3 block(BX, WIDE_WARPS);
  warp_combine_wide_kernel<T, MINB>
      <<<min(grid_blocks, nblocks), block, smem, stream>>>(
          static_cast<const T*>(frames), masters, ftab, ttab, out, n, h0, w0,
          th, tw, n_tj, n_ti * n_tj, span, lowrank, combine, sigma_lo,
          sigma_hi, rows, sbx, sby, nbx, nblocks, run, scratch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* frames, const float* masters,
                        const float* ftab, const int* ttab, float* out, int n,
                        int h0, int w0, int th, int tw, int n_ti, int n_tj,
                        int span, int lowrank, int combine, float sigma_lo,
                        float sigma_hi, int rows, int run, float* scratch,
                        int grid_blocks, cudaStream_t stream) {
  if (rows < 1 || rows > WIDE_WARPS * WIDE_PIX || scratch == nullptr ||
      grid_blocks < 1 || run < 32)
    return cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(frames, masters, ftab, ttab, out, n, h0, w0, th, tw, n_ti,
                  n_tj, span, lowrank, combine, sigma_lo, sigma_hi, rows, run,
                  scratch, grid_blocks, stream);
  };
  return wide_min_blocks(n, min(n, run), rows, span) == 3
             ? go(launch_wide_b<T, 3>)
             : go(launch_wide_b<T, 2>);
}

template <typename T, int MINB>
int wide_blocks_b(int n, int span, int rows, int run) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = sizeof(float) * (size_t)wide_words(n, min(n, run), rows, span);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(warp_combine_wide_kernel<T, MINB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, warp_combine_wide_kernel<T, MINB>, BX * WIDE_WARPS,
          smem) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

template <typename T>
int wide_blocks(int n, int span, int rows, int run) {
  return wide_min_blocks(n, min(n, run), rows, span) == 3
             ? wide_blocks_b<T, 3>(n, span, rows, run)
             : wide_blocks_b<T, 2>(n, span, rows, run);
}

}  // namespace

// Blocks of the 'cols' route the card keeps resident at once for n
// frames, this window (span), block (by rows) and run: its grid and its
// scratch slots.
extern "C" int warp_combine_cols_blocks(int is_u16, int n, int span, int by,
                                        int run) {
  return is_u16 ? cols_blocks<uint16_t>(n, span, by, run)
                : cols_blocks<float>(n, span, by, run);
}

// scratch: null for the 'smem' route; for 'cols' (n + 2) x 32 x
// block_rows words for each of its grid_blocks blocks, and run the most samples of
// a column the combine sorts at once (kernels._warp_cols_run)
extern "C" int warp_combine_launch(const void* frames, int is_u16,
                                   const float* masters, const float* ftab,
                                   const int* ttab, float* out, int n, int h0,
                                   int w0, int th, int tw, int n_ti, int n_tj,
                                   int span, int lowrank, int combine,
                                   float sigma_lo, float sigma_hi,
                                   int block_rows, float* scratch,
                                   int grid_blocks, int run, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (scratch != nullptr)
    err = is_u16 ? launch_cols<uint16_t>(
                       frames, masters, ftab, ttab, out, n, h0, w0, th, tw,
                       n_ti, n_tj, span, lowrank, combine, sigma_lo, sigma_hi,
                       block_rows, run, scratch, grid_blocks, s)
                 : launch_cols<float>(
                       frames, masters, ftab, ttab, out, n, h0, w0, th, tw,
                       n_ti, n_tj, span, lowrank, combine, sigma_lo, sigma_hi,
                       block_rows, run, scratch, grid_blocks, s);
  else
    err = is_u16 ? launch<uint16_t>(frames, masters, ftab, ttab, out, n, h0,
                                    w0, th, tw, n_ti, n_tj, span, lowrank,
                                    combine, sigma_lo, sigma_hi, block_rows, s)
                 : launch<float>(frames, masters, ftab, ttab, out, n, h0, w0,
                                 th, tw, n_ti, n_tj, span, lowrank, combine,
                                 sigma_lo, sigma_hi, block_rows, s);
  return static_cast<int>(err);
}

// Blocks of the 'wide' route the card keeps resident at once for n frames,
// this window (span), block (rows) and run.
extern "C" int warp_combine_wide_blocks(int is_u16, int n, int span, int rows,
                                        int run) {
  return is_u16 ? wide_blocks<uint16_t>(n, span, rows, run)
                : wide_blocks<float>(n, span, rows, run);
}

// The 'wide' route: the arguments of warp_combine_launch, with block_rows
// the output rows of a block (kernels._warp_wide_rows) and the scratch
// (n + 2) x 32 x block_rows words for each of its grid_blocks blocks.
extern "C" int warp_combine_wide_launch(const void* frames, int is_u16,
                                        const float* masters,
                                        const float* ftab, const int* ttab,
                                        float* out, int n, int h0, int w0,
                                        int th, int tw, int n_ti, int n_tj,
                                        int span, int lowrank, int combine,
                                        float sigma_lo, float sigma_hi,
                                        int block_rows, float* scratch,
                                        int grid_blocks, int run,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_u16 ? launch_wide<uint16_t>(frames, masters, ftab, ttab, out, n, h0,
                                     w0, th, tw, n_ti, n_tj, span, lowrank,
                                     combine, sigma_lo, sigma_hi, block_rows,
                                     run, scratch, grid_blocks, s)
             : launch_wide<float>(frames, masters, ftab, ttab, out, n, h0, w0,
                                  th, tw, n_ti, n_tj, span, lowrank, combine,
                                  sigma_lo, sigma_hi, block_rows, run, scratch,
                                  grid_blocks, s);
  return static_cast<int>(err);
}
