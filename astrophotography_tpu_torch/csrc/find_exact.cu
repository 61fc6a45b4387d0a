// Exact star detection (ops/detect.find_stars, mode 'exact') for Hopper
// (sm_90a): DAOFIND's circular matched filter (the "density"), the 3x3
// peak test and the top-k candidates of each frame, in two launches and no
// host read.
//
// It replaces no Pallas kernel: the JAX function
// (astrophotography_tpu/ops/detect.py, find_stars) is XLA code.  The port
// wrote it as a composition of whole-tensor PyTorch operations
// (ops/detect.find_stars_plain, the twin this kernel is held to): 21 taps
// of a multiply and an add over the whole (N, H, W) stack, 8 maxima of the
// peak test, a pairwise row max, a cumsum over every pair-maximum and a
// nonzero whose count the host reads.  That took 111.6 ms of a 220 ms
// request at 24 x 4096^2 (about five stack-sized temporaries live at once).
//
// What it computes, per frame f, as the twin does:
//   * dens[y, x] = sum of k[dy][dx] * data[y + dy - r, x + dx - r] over the
//     nonzero taps of daofind_kernel(fwhm) in dy-major order, zero outside
//     the frame, from acc = 0, each step acc = acc + (k * p) rounded op by
//     op (__fmul_rn, then __fadd_rn: no contraction into an FMA); masked
//     pixels are -inf;
//   * a peak: dens > each of its 4 raster-earlier neighbours, >= each of
//     its 4 later ones (outside the frame -inf), > the frame's threshold,
//     and border + r inside every edge.  A comparison with a NaN is false,
//     which is what the twin's NaN-propagating maxima give;
//   * the max_stars best peaks in _top_k's order: value descending, ties by
//     ascending index of the array the twin ranks (the pairwise row max for
//     even heights, so (y / 2) * W + x; the raster index for odd ones);
//     -0 ranks equal to +0.  Slots past the last peak hold -inf at (0, 0).
// No two peaks are 8-adjacent (each would have to beat the other), so a
// 2 x 2 cell holds at most one, and the pair index of a peak is unique: a
// 64-bit key (the value's order bits, then the complement of the index)
// orders the peaks totally.
//
// What bounds it on the H100.  The float32 stack read once, 24 x 4096^2 x
// 4 B = 1.61 GB, takes 0.48 ms at 3.35 TB/s; the 21 taps at 2 operations
// and the peak test ~0.31 ms at 67 TFLOP/s.  Rounded op by op, a tap is two
// instructions, so the instruction count sits close to the bytes.
//
// Design.
//  * find_tiles_kernel: one block of 256 threads per (frame, tile of 32 x
//    126 pixels).  It stages the tile and a halo of r + 1 into shared
//    memory (16-byte loads where the width allows, zeros outside the
//    frame), then computes the densities of the tile and a ring of one:
//    34 x 128 positions, a thread one column and a run of 17 rows, so each
//    staged value read from shared memory serves every output row of the
//    run that uses it (taps from the kernel's parameters: operands from the
//    constant bank).  The densities go over the staged input (and, where
//    the caller asks for the statistics, to the density plane), the core's
//    3x3 test appends its peaks to a shared list, and the block writes the
//    list, or its max_stars best by rank where it holds more, to the
//    frame's candidate buffer (one atomic add a block reserves the slots).
//  * find_merge_kernel: one block per frame: a radix select (8 passes of 8
//    bits) over the frame's candidates finds the max_stars-th key, the
//    keys at or above it are ranked by counting and written in order.
//    Every cell frame has a few hundred candidates, cached in shared
//    memory; past 2048 the passes read them from device memory.
// Radii 2 to 8 (fwhm below 11.33) each have their instance; the twin takes
// the rest (kernels._find_exact_route).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;             // core rows of a tile
constexpr int TW = 126;            // core columns of a tile
constexpr int DR = TH + 2;         // density rows (a ring of one)
constexpr int DC = TW + 2;         // density columns: one thread each
constexpr int NT = 2 * DC;         // threads of a tile block
constexpr int RUN = DR / 2;        // density rows a thread computes
constexpr int CAP = (TH / 2) * (TW / 2);   // the most peaks a tile holds
constexpr int RMIN = 2;
constexpr int RMAX = 8;
constexpr int MT = 512;            // threads of a merge block
constexpr int CACHE = 2048;        // candidate keys a merge block caches
constexpr int KMAX = 2048;         // the most stars a frame keeps
constexpr int MAX_Z = 65535;       // frames a launch's grid holds

static_assert(DC == 128, "a thread's column is tid & 127");

// the taps of daofind_kernel(fwhm) at radius R, dy-major, by value
template <int R>
struct Taps {
  float k[(2 * R + 1) * (2 * R + 1)];
};

// daofind_kernel's circular footprint: its zero taps are skipped
template <int R>
__host__ __device__ constexpr bool in_foot(int dy, int dx) {
  return (dy - R) * (dy - R) + (dx - R) * (dx - R) <= R * R + R;
}

template <int R>
struct Tile {
  static constexpr int IR = DR + 2 * R;                   // staged rows
  // staged columns: the DC + 2R a density run reads, from a 16-byte
  // aligned start up to 3 columns left of them
  static constexpr int SW = (DC + 2 * R + 3 + 3) / 4 * 4;
  static constexpr int WORDS = IR * SW > DR * DC ? IR * SW : DR * DC;
};

// the rank order of _top_k: value descending (-0 as +0), then ascending
// index ``idx`` of the array it ranks
__device__ __forceinline__ unsigned long long order_key(float v,
                                                        unsigned idx) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xFFFFFFFFu - idx);
}

template <int R>
__global__ void __launch_bounds__(NT)
    find_tiles_kernel(const float* __restrict__ data,
                      const unsigned char* __restrict__ mask,
                      long long mask_stride, const float* __restrict__ thr,
                      const Taps<R> P, int h, int w, int edge, int k,
                      int even, int vec, float* __restrict__ dens,
                      float* __restrict__ cand_val,
                      int* __restrict__ cand_pos,
                      int* __restrict__ cand_count, long long cap) {
  using T = Tile<R>;
  __shared__ __align__(16) float s_buf[T::WORDS];
  __shared__ unsigned long long s_key[CAP];
  __shared__ float s_val[CAP];
  __shared__ int s_pos[CAP];
  __shared__ int s_n, s_base;

  const int tid = threadIdx.x;
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float* frame = data + static_cast<size_t>(f) * h * w;

  // 1. stage rows y0 - 1 - R .. y0 + TH + R from a column ga aligned to 4
  const int gx0 = x0 - 1 - R;
  const int ga = gx0 & ~3;          // floor to a multiple of 4
  const int off = gx0 - ga;
  const int gy0 = y0 - 1 - R;
  constexpr int Q = T::SW / 4;
  for (int i = tid; i < T::IR * Q; i += NT) {
    const int row = i / Q, q = i - row * Q;
    const int gy = gy0 + row, gx = ga + 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < h) {
      const float* src = frame + static_cast<size_t>(gy) * w;
      if (vec) {
        // w % 4 == 0: a group of 4 lies wholly inside or wholly outside
        if (gx >= 0 && gx < w)
          v = __ldg(reinterpret_cast<const float4*>(src + gx));
      } else {
        if (gx >= 0 && gx < w) v.x = __ldg(src + gx);
        if (gx + 1 >= 0 && gx + 1 < w) v.y = __ldg(src + gx + 1);
        if (gx + 2 >= 0 && gx + 2 < w) v.z = __ldg(src + gx + 2);
        if (gx + 3 >= 0 && gx + 3 < w) v.w = __ldg(src + gx + 3);
      }
    }
    *reinterpret_cast<float4*>(s_buf + row * T::SW + 4 * q) = v;
  }
  __syncthreads();

  // 2. the densities of DR x DC positions: column c, rows j0 .. j0 + RUN - 1
  const int c = tid & (DC - 1);
  const int j0 = (tid >> 7) * RUN;
  float acc[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0.0f;
  const float* col = s_buf + off + c;
#pragma unroll
  for (int ii = 0; ii < RUN + 2 * R; ++ii) {
    float v[2 * R + 1];
#pragma unroll
    for (int dx = 0; dx <= 2 * R; ++dx) v[dx] = col[(j0 + ii) * T::SW + dx];
    // staged row j0 + ii is tap row dy = ii - j of density row j0 + j:
    // rows in ascending order keep each sum's taps dy-major
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int dy = ii - j;
      if (dy < 0 || dy > 2 * R) continue;
#pragma unroll
      for (int dx = 0; dx <= 2 * R; ++dx) {
        if (!in_foot<R>(dy, dx)) continue;
        acc[j] = __fadd_rn(acc[j],
                           __fmul_rn(P.k[dy * (2 * R + 1) + dx], v[dx]));
      }
    }
  }
  __syncthreads();                  // the staged input is read

  float* s_dens = s_buf;            // [DR][DC] over the staged input
  const int x = x0 - 1 + c;
  const bool xin = x >= 0 && x < w;
  const bool core_col = c >= 1 && c <= TW;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int jj = j0 + j;
    const int y = y0 - 1 + jj;
    float d = acc[j];
    if (!xin || y < 0 || y >= h) {
      d = -CUDART_INF_F;
    } else if (mask != nullptr &&
               mask[f * mask_stride + static_cast<long long>(y) * w + x]) {
      d = -CUDART_INF_F;
    }
    s_dens[jj * DC + c] = d;
    if (dens != nullptr && core_col && jj >= 1 && jj <= TH && xin &&
        y < h)
      dens[(static_cast<size_t>(f) * h + y) * w + x] = d;
  }
  if (tid == 0) s_n = 0;
  __syncthreads();

  // 3. the 3x3 test of the core: column c, rows jb .. jb + TH / 2 - 1
  const float t = thr[f];
  if (core_col && xin && x >= edge && x < w - edge) {
    const int jb = 1 + (tid >> 7) * (TH / 2);
    const float* dc = s_dens + c;
    float a0 = dc[(jb - 1) * DC - 1], a1 = dc[(jb - 1) * DC],
          a2 = dc[(jb - 1) * DC + 1];
    float b0 = dc[jb * DC - 1], b1 = dc[jb * DC], b2 = dc[jb * DC + 1];
    for (int j = jb; j < jb + TH / 2; ++j) {
      const float e0 = dc[(j + 1) * DC - 1], e1 = dc[(j + 1) * DC],
                  e2 = dc[(j + 1) * DC + 1];
      const int y = y0 - 1 + j;
      const float d = b1;
      if (y < h && y >= edge && y < h - edge && d > a0 && d > a1 &&
          d > a2 && d > b0 && d >= b2 && d >= e0 && d >= e1 && d >= e2 &&
          d > t) {
        const int s = atomicAdd(&s_n, 1);
        if (s < CAP) {
          const unsigned idx =
              even ? static_cast<unsigned>((y >> 1) * w + x)
                   : static_cast<unsigned>(y * w + x);
          s_key[s] = order_key(d, idx);
          s_val[s] = d;
          s_pos[s] = y * w + x;
        }
      }
      a0 = b0; a1 = b1; a2 = b2;
      b0 = e0; b1 = e1; b2 = e2;
    }
  }
  __syncthreads();

  // 4. the tile's peaks, or its k best by rank, to the frame's buffer
  const int cnt = min(s_n, CAP);
  if (cnt == 0) return;
  const int keep = min(cnt, k);
  if (tid == 0) s_base = atomicAdd(cand_count + f, keep);
  __syncthreads();
  const long long base = f * cap + s_base;
  for (int i = tid; i < cnt; i += NT) {
    int slot = i;
    if (cnt > k) {
      const unsigned long long key = s_key[i];
      int rank = 0;
      for (int j = 0; j < cnt; ++j) rank += s_key[j] > key;
      if (rank >= k) continue;
      slot = rank;
    }
    cand_val[base + slot] = s_val[i];
    cand_pos[base + slot] = s_pos[i];
  }
}

__device__ __forceinline__ unsigned long long cand_key(float v, int pos,
                                                       int w, int even) {
  if (!even) return order_key(v, static_cast<unsigned>(pos));
  const int y = pos / w;
  return order_key(v, static_cast<unsigned>((y >> 1) * w + (pos - y * w)));
}

__global__ void __launch_bounds__(MT)
    find_merge_kernel(const float* __restrict__ cand_val,
                      const int* __restrict__ cand_pos,
                      const int* __restrict__ cand_count, long long cap,
                      int k, int w, int even, float* __restrict__ out_val,
                      long long* __restrict__ out_y,
                      long long* __restrict__ out_x) {
  __shared__ unsigned long long s_keys[CACHE];
  __shared__ unsigned long long s_sel[KMAX];
  __shared__ int s_idx[KMAX];
  __shared__ int s_hist[256];
  __shared__ unsigned long long s_prefix;
  __shared__ int s_need, s_nsel;

  const int tid = threadIdx.x;
  const int f = blockIdx.x;
  const int m = cand_count[f];
  const float* val = cand_val + f * cap;
  const int* pos = cand_pos + f * cap;
  const bool cached = m <= CACHE;
  if (cached)
    for (int i = tid; i < m; i += MT)
      s_keys[i] = cand_key(val[i], pos[i], w, even);
  if (tid == 0) {
    s_prefix = 0ull;
    s_need = k;
    s_nsel = 0;
  }
  __syncthreads();
  auto key_at = [&](int i) {
    return cached ? s_keys[i] : cand_key(val[i], pos[i], w, even);
  };

  // the k-th largest key, 8 bits a pass from the top
  unsigned long long least = 0ull;
  if (m > k) {
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += MT) s_hist[i] = 0;
      __syncthreads();
      const unsigned long long prefix = s_prefix;
      const unsigned long long high =
          shift == 56 ? 0ull : (~0ull << (shift + 8));
      for (int i = tid; i < m; i += MT) {
        const unsigned long long key = key_at(i);
        if ((key & high) == prefix)
          atomicAdd(s_hist + ((key >> shift) & 255u), 1);
      }
      __syncthreads();
      if (tid < 32) {
        // every lane reads the count still needed before the shuffles,
        // and so before the lane that finds the digit updates it
        const int need = s_need;
        // lane l holds bins 255 - 8l .. 248 - 8l, the highest in lane 0
        int bins[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bins[j] = s_hist[255 - 8 * tid - j];
          sum += bins[j];
        }
        int inc = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, inc, o);
          if (tid >= o) inc += up;
        }
        int run = inc - sum;
        if (run < need && need <= inc) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (run + bins[j] >= need) {
              s_need = need - run;
              s_prefix = prefix | (static_cast<unsigned long long>(
                                       255 - 8 * tid - j)
                                   << shift);
              break;
            }
            run += bins[j];
          }
        }
      }
      __syncthreads();
    }
    least = s_prefix;
  }

  // the min(m, k) keys at or above it, ranked by counting
  for (int i = tid; i < m; i += MT) {
    const unsigned long long key = key_at(i);
    if (key >= least) {
      const int s = atomicAdd(&s_nsel, 1);
      if (s < KMAX) {
        s_sel[s] = key;
        s_idx[s] = i;
      }
    }
  }
  __syncthreads();
  const int ns = min(s_nsel, k);
  const long long o = static_cast<long long>(f) * k;
  for (int i = tid; i < ns; i += MT) {
    const unsigned long long key = s_sel[i];
    int rank = 0;
    for (int j = 0; j < ns; ++j) rank += s_sel[j] > key;
    const int ci = s_idx[i];
    const int p = pos[ci];
    out_val[o + rank] = val[ci];
    out_y[o + rank] = p / w;
    out_x[o + rank] = p % w;
  }
  for (int i = ns + tid; i < k; i += MT) {
    out_val[o + i] = -CUDART_INF_F;
    out_y[o + i] = 0;
    out_x[o + i] = 0;
  }
}

template <int R>
cudaError_t launch_tiles(const float* data, const unsigned char* mask,
                         long long mask_stride, const float* thr,
                         const float* taps, int n, int h, int w, int edge,
                         int k, int even, int vec, float* dens,
                         float* cand_val, int* cand_pos, int* cand_count,
                         long long cap, cudaStream_t s) {
  Taps<R> P;
  for (int i = 0; i < (2 * R + 1) * (2 * R + 1); ++i) P.k[i] = taps[i];
  const dim3 block(NT);
  for (int f0 = 0; f0 < n; f0 += MAX_Z) {
    const int m = n - f0 < MAX_Z ? n - f0 : MAX_Z;
    const size_t px = static_cast<size_t>(f0) * h * w;
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, m);
    find_tiles_kernel<R><<<grid, block, 0, s>>>(
        data + px, mask == nullptr ? nullptr : mask + f0 * mask_stride,
        mask_stride, thr + f0, P, h, w, edge, k, even, vec,
        dens == nullptr ? nullptr : dens + px, cand_val + f0 * cap,
        cand_pos + f0 * cap, cand_count + f0, cap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// data (n, h, w) float32; mask null or uint8 (h, w) (mask_stride 0) or (n,
// h, w) (mask_stride h * w), nonzero = excluded; thr (n,) float32 on the
// card; taps (2r + 1)^2 float32 in host memory, daofind_kernel's dy-major;
// dens null or (n, h, w) float32, the masked density plane; the candidate
// buffers (n, cap) and counts (n,), cap at least the tiles of a frame
// times min(k, 1008); out_val (n, k) float32, out_y / out_x (n, k) int64.
extern "C" int find_exact_launch(const float* data, const unsigned char* mask,
                                 long long mask_stride, const float* thr,
                                 const float* taps, int r, int n, int h,
                                 int w, int border, int k, float* dens,
                                 float* cand_val, int* cand_pos,
                                 int* cand_count, long long cap,
                                 float* out_val, long long* out_y,
                                 long long* out_x, void* stream) {
  const long long tiles = static_cast<long long>((w + TW - 1) / TW) *
                          ((h + TH - 1) / TH);
  if (n < 1 || h < 1 || w < 1 || k < 1 || k > KMAX || r < RMIN ||
      r > RMAX || static_cast<long long>(h) * w > 0x7fffffffLL ||
      (h + TH - 1) / TH > 65535 || cap < tiles * (k < CAP ? k : CAP))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cand_count, 0, sizeof(int) * n, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int edge = border + r;
  const int even = h % 2 == 0;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
#define TILES_CASE(R)                                                       \
  case R:                                                                   \
    err = launch_tiles<R>(data, mask, mask_stride, thr, taps, n, h, w,     \
                          edge, k, even, vec, dens, cand_val, cand_pos,     \
                          cand_count, cap, s);                              \
    break;
  switch (r) {
    TILES_CASE(2) TILES_CASE(3) TILES_CASE(4) TILES_CASE(5) TILES_CASE(6)
    TILES_CASE(7) TILES_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILES_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  find_merge_kernel<<<n, MT, 0, s>>>(cand_val, cand_pos, cand_count, cap, k,
                                     w, even, out_val, out_y, out_x);
  return static_cast<int>(cudaGetLastError());
}
