// Kernel A: fused FAST-9/16 corner score + 3x3 non-max suppression over
// every pyramid level in one launch.
//
// Replaces the Pallas TPU kernel orbslam_in_practice_tpu/ops/pallas_fast.py
// (fast_score_nms). Exact counterpart of the plain PyTorch version
// nms3x3(fast_score(img)) in orbslam_in_practice_tpu_torch/ops/fast.py: every
// operation is a float32 subtraction, min or max, so the output is bit-exact,
// with the 3 px border zero.
//
// Launch: one 1-D grid over the 32x32 output tiles of all levels. The levels
// travel by value in `Levels`; a block finds its level in the tile prefix
// sums. Block: 256 threads. Loops walk their 2-D arrays by adding, not
// dividing: integer division costs more than the float work here.
//   1. Load the 40x40 raw tile (the output tile plus a 4 px halo: 3 for the
//      FAST circle, 1 for NMS) into shared memory, row-contiguous and
//      coalesced, reading 0 outside the image as the Pallas padding does.
//      Each pixel is read about (40*40)/(32*32) = 1.6 times. A thread issues
//      all 7 of its loads before its first store.
//   2. Compass test over the 34x34 score region (the tile plus a 1 px ring,
//      1.13 times the tile), per polarity: any 9 contiguous circle pixels
//      hold two neighbouring compass pixels (0 and 4, 4 and 8, 8 and 12, or
//      12 and 0), so without such a pair both brighter than the centre the
//      brighter arc scores <= 0, and likewise for the darker. Every score
//      starts at +0, and pixels outside the image's 3 px interior keep it.
//      Each warp lists the arcs of its own positions that pass in its own
//      slice of shared memory (ballot + popc), so no block barrier or
//      shared counter stands between the test and the scoring.
//   3. The warp scores its list, one arc an entry, so every lane scores a
//      candidate and a pixel that can only be brighter (or darker) pays for
//      one arc, not two. The darker arc is the brighter arc of the negated
//      margins (negation is exact); an arc is 48 min/max (see arc_score).
//      The two entries of one pixel meet in a shared atomicMax on the
//      float's bits, which orders non-negative floats as integers. min and
//      max return one of their inputs, so their order does not change a bit.
//   4. NMS: each thread owns 4 consecutive rows of one column of the output
//      tile, reads the 6x3 scores around them once, and keeps a score if it
//      is >= its 3x3 max, else writes 0.
//
// Loads: plain coalesced loads, not TMA. A TMA tensor map needs row strides
// that are multiples of 16 bytes: 640 and 444 px rows are, 533 and 370 (and
// TUM1's 309, 257, 214 and 179) are not, so TMA would first need a padded
// copy of every level. Its zero fill outside the image would match the
// padding, but the copy would cost a pass over the pyramid.
//
// Bound: ALU issue, just above bytes. A pixel costs 12 float instructions
// for the compass test, 65 for each arc it passes (16 FMAs, 48 min/max, a
// max with 0: arc_score) and 6 for NMS. On the 4 bench levels (771,112 px)
// about one arc a pixel passes, so that is ~63 M instructions, 1.9 us at
// 132 SMs x 128 lanes x 1.98 GHz (3.3 us if every pixel ran both arcs),
// against 6.17 MB, 1.84 us at 3.35 TB/s. bench_kernels.py::fast_work counts
// what a given image needs.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int MAX_LEVELS = 8;             // ops/cuda_fast.py::MAX_LEVELS
constexpr int TILE = 32;                  // output tile edge
constexpr int THREADS = 256;
constexpr int HALO = 4;
constexpr int RAW = TILE + 2 * HALO;      // 40
constexpr int SC = TILE + 2;              // 34: score region edge
constexpr int N_SC = SC * SC;             // 1156
constexpr int LOADS = (RAW * RAW + THREADS - 1) / THREADS;  // 7 a thread
constexpr int ROUNDS = (N_SC + THREADS - 1) / THREADS;      // 5 score positions a thread
constexpr int WARPS = THREADS / 32;

// (r, c) of flat index i + THREADS in a row-major array COLS wide, from
// (r, c) of i, without dividing
template <int COLS>
__device__ __forceinline__ void advance(int& r, int& c) {
  r += THREADS / COLS;
  c += THREADS % COLS;
  if (c >= COLS) {
    c -= COLS;
    ++r;
  }
}

struct Levels {
  const float* img[MAX_LEVELS];
  float* out[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int tile_start[MAX_LEVELS + 1];  // level l holds tiles [tile_start[l], tile_start[l + 1])
  int n;
};

// Which arcs of the pixel at raw-tile position (r, c) can score above 0:
// bit 0 the brighter, bit 1 the darker. An arc needs two neighbouring
// compass pixels (circle indices 0, 4, 8, 12) beyond the centre its way.
__device__ __forceinline__ int compass_test(const float (*raw)[RAW], int r, int c) {
  const float centre = raw[r][c];
  const float m0 = raw[r + 3][c] - centre;   // index 0: (0, 3)
  const float m4 = raw[r][c + 3] - centre;   // index 4: (3, 0)
  const float m8 = raw[r - 3][c] - centre;   // index 8: (0, -3)
  const float m12 = raw[r][c - 3] - centre;  // index 12: (-3, 0)
  const bool b0 = m0 > 0.0f, b4 = m4 > 0.0f, b8 = m8 > 0.0f, b12 = m12 > 0.0f;
  const bool d0 = m0 < 0.0f, d4 = m4 < 0.0f, d8 = m8 < 0.0f, d12 = m12 < 0.0f;
  const bool bright = (b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0);
  const bool dark = (d0 && d4) || (d4 && d8) || (d8 && d12) || (d12 && d0);
  return (int)bright | ((int)dark << 1);
}

// Score of one arc polarity of the pixel at raw-tile position (r, c): the
// highest threshold at which 9 contiguous circle pixels are all beyond the
// centre that way (sign 1: brighter; -1: darker, on the negated margins),
// max over the 16 windows k..k+8 of their min. Windows k and k+1 (k even)
// share the 8 pixels k+1..k+8, whose min comes from a doubling tree over odd
// starts, and max(min(m[k], C), min(C, m[k+9])) = min(C, max(m[k], m[k+9])):
// 48 min/max an arc instead of 80.
__device__ __forceinline__ float arc_score(const float (*raw)[RAW], int r, int c, float sign) {
  // OpenCV FAST-16 circle (x, y), circular order, radius 3
  const int cx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int cy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  // the margins sign * (v - centre), each rounded once as v - centre is:
  // sign * v and sign * centre are exact, and rounding is odd-symmetric
  const float neg_centre = -sign * raw[r][c];
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = fmaf(sign, raw[r + cy[k]][c + cx[k]], neg_centre);

  // mnJ[q]: min of the J pixels from 2q + 1 on
  float mn2[8], mn4[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) mn2[q] = fminf(m[2 * q + 1], m[(2 * q + 2) & 15]);
#pragma unroll
  for (int q = 0; q < 8; ++q) mn4[q] = fminf(mn2[q], mn2[(q + 1) & 7]);
  float best = -INFINITY;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float core = fminf(mn4[q], mn4[(q + 2) & 7]);  // pixels 2q+1 .. 2q+8
    best = fmaxf(best, fminf(core, fmaxf(m[2 * q], m[(2 * q + 9) & 15])));
  }
  return best;
}

__global__ void __launch_bounds__(THREADS) fast_score_nms_kernel(const Levels lv) {
  __shared__ float raw[RAW][RAW];
  __shared__ float score[SC][SC];
  __shared__ short cand[WARPS][2 * ROUNDS * 32];  // (r << 7) | (c << 1) | polarity

  int l = 0;
  while (l + 1 < lv.n && (int)blockIdx.x >= lv.tile_start[l + 1]) ++l;
  const float* __restrict__ img = lv.img[l];
  float* __restrict__ out = lv.out[l];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int t = blockIdx.x - lv.tile_start[l];
  const int y0 = (t / lv.tiles_x[l]) * TILE;
  const int x0 = (t % lv.tiles_x[l]) * TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;

  float v[LOADS];
  {
    int r = tid / RAW, c = tid % RAW;
#pragma unroll
    for (int j = 0; j < LOADS; ++j, advance<RAW>(r, c)) {
      const int gy = y0 - HALO + r;
      const int gx = x0 - HALO + c;
      v[j] = (r < RAW && gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[(size_t)gy * w + gx] : 0.0f;
    }
    r = tid / RAW;
    c = tid % RAW;
#pragma unroll
    for (int j = 0; j < LOADS; ++j, advance<RAW>(r, c)) {
      if (r < RAW) raw[r][c] = v[j];
    }
  }
  __syncthreads();

  // score-region (r, c) is image pixel (y0 - 1 + r, x0 - 1 + c) and raw-tile
  // (r + 3, c + 3). A warp tests its own positions, lists the arcs that pass
  // in its own slice of `cand` (every lane runs every round, so the ballots
  // are whole), then scores that slice.
  short* list = cand[warp];
  int n = 0;
  for (int base = 0, r = tid / SC, c = tid % SC; base < N_SC; base += THREADS, advance<SC>(r, c)) {
    int arcs = 0;
    if (r < SC) {
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + c;
      if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) arcs = compass_test(raw, r + 3, c + 3);
      score[r][c] = 0.0f;
    }
    const unsigned bright = __ballot_sync(0xffffffffu, arcs & 1);
    const unsigned dark = __ballot_sync(0xffffffffu, arcs & 2);
    const int key = (r << 7) | (c << 1);
    if (arcs & 1) list[n + __popc(bright & below)] = (short)key;
    if (arcs & 2) list[n + __popc(bright) + __popc(dark & below)] = (short)(key | 1);
    n += __popc(bright) + __popc(dark);
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const int key = list[j];
    const int r = key >> 7;
    const int c = (key >> 1) & 63;
    const float s = fmaxf(arc_score(raw, r + 3, c + 3, (key & 1) ? -1.0f : 1.0f), 0.0f);
    atomicMax(reinterpret_cast<int*>(&score[r][c]), __float_as_int(s));
  }
  __syncthreads();

  // NMS: warp g owns output rows 4g .. 4g+3, lane tx column tx; the 3
  // score columns around it are read once for all 4 rows
  constexpr int NMS_ROWS = TILE * TILE / THREADS;  // 4
  const int tx = lane;
  const int row0 = warp * NMS_ROWS;
  float colmax[NMS_ROWS + 2];
#pragma unroll
  for (int j = 0; j < NMS_ROWS + 2; ++j)
    colmax[j] = fmaxf(fmaxf(score[row0 + j][tx], score[row0 + j][tx + 1]), score[row0 + j][tx + 2]);
  const int gx = x0 + tx;
#pragma unroll
  for (int q = 0; q < NMS_ROWS; ++q) {
    const int gy = y0 + row0 + q;
    const float pooled = fmaxf(fmaxf(colmax[q], colmax[q + 1]), colmax[q + 2]);
    const float s = score[row0 + q + 1][tx + 1];
    if (gy < h && gx < w) out[(size_t)gy * w + gx] = s >= pooled ? s : 0.0f;
  }
}

}  // namespace

// Every level in one launch. imgs, outs: n_levels device pointers to (h, w)
// float32 contiguous images and outputs, in host memory; hw: n_levels (h, w)
// pairs in host memory. Returns the cudaError_t of the launch (0 on success).
extern "C" int fast_score_nms_levels(const void* const* imgs, void* const* outs, const int* hw,
                                     int n_levels, cudaStream_t stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  lv.n = n_levels;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = hw[2 * l];
    const int w = hw[2 * l + 1];
    if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
    lv.img[l] = static_cast<const float*>(imgs[l]);
    lv.out[l] = static_cast<float*>(outs[l]);
    lv.h[l] = h;
    lv.w[l] = w;
    lv.tiles_x[l] = (w + TILE - 1) / TILE;
    lv.tile_start[l] = tiles;
    tiles += lv.tiles_x[l] * ((h + TILE - 1) / TILE);
  }
  lv.tile_start[n_levels] = tiles;
  fast_score_nms_kernel<<<tiles, THREADS, 0, stream>>>(lv);
  return (int)cudaGetLastError();
}
