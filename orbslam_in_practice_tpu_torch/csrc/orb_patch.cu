// Kernel B: per-keypoint ORB features over every pyramid level in one
// launch: intensity-centroid angle, in-patch 7x7 Gaussian blur and rotated
// BRIEF, written as packed descriptor words and as +-1 int8 rows.
//
// Replaces the Pallas TPU kernel orbslam_in_practice_tpu/ops/pallas_patch.py
// (orb_patch_features). Plain PyTorch version: ic_angle + gaussian_blur7 +
// brief_descriptors (+ unpack_to_pm1), orbslam_in_practice_tpu_torch/ops/.
//
// Launch: one block of THREADS threads per keypoint, over the keypoints of
// all levels. The levels travel by value in `Levels`; a keypoint finds its
// level in the keypoint prefix sums. Loops walk their 2-D arrays by adding,
// not dividing: integer division cost more than the float work here.
//   1. Load the 45x45 raw window around the keypoint into shared memory,
//      clamping indices to the image (the edge replication of the
//      reference's padded image). Padding keypoints at (0, 0) are safe
//      through the same clamp. A thread issues all its loads, and its
//      pattern pairs', before its first store, so the block waits for one
//      round trip to L2, not one a load.
//   2. m10 and m01 over the radius-15 disc: per-thread partial sums, a warp
//      shuffle reduction, one shared-memory step, and every thread sums the
//      warps' partials in the same order. (cos, sin) = (m10, m01) / r, with
//      (1, 0) when the moment is 0.
//   3. Rotated BRIEF: lane j of a warp owns pattern pair 32 w + j of word w.
//      It rotates both points, rounds half to even, clips to +-19 and
//      compares I(a) < I(b), where I is the blurred image. __ballot_sync
//      packs the warp's 32 bits into descriptor word w (bit j = bit 32 w + j,
//      the order of pack_bits), and the lane writes byte 32 w + j of the +-1
//      row.
// The blur runs over the whole 39x39 window, rows then columns, in shared
// memory, each thread computing a strip of 3 outputs from 9 loaded values,
// summing in the plain version's order without fused multiply-adds, so the
// blurred values match it exactly. 128 threads a keypoint and the window
// blur measured fastest against 32, 64 and 256 threads and against blurring
// at the 512 sample points alone (1.7-1.8x slower) at 512, 800, 1000 and
// 1600 keypoints (PERF.md, kernel B's design table). The TPU kernel's
// one-hot column-select matmul and 56x256 tile alignment exist only because
// the TPU has no gather; here the samples are read straight from shared
// memory.
//
// Bound: ALU issue. A keypoint takes ~48k float ops (a separable blur of the
// 39x39 window, 42.6k; the moments over 709 disc pixels; 512 rotated
// samples), 38 M ops for 800 keypoints: 1.15 us at 132 SMs x 128 lanes x
// 1.98 GHz. Its bytes are at most the pyramid, 3.1 MB (0.92 us at 3.35 TB/s).
// With a few hundred to 1600 keypoints the grid is about one wave of 6 to
// 12 blocks an SM; the separable passes' index arithmetic and shared-memory
// traffic, not the float work, fill the issue slots (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 8;           // ops/cuda_patch.py::MAX_LEVELS
constexpr int THREADS = 128;            // a keypoint's block: PERF.md's design table
constexpr int WARPS = THREADS / 32;
constexpr int PATCH_R = 15;             // IC-angle disc radius
constexpr int DISC = 2 * PATCH_R + 1;   // 31
constexpr int DESC_R = 19;              // rotated-pattern reach
constexpr int HALF = DESC_R + 3;        // 22: reach plus blur support
constexpr int WIN = 2 * HALF + 1;       // 45: raw window
constexpr int BWIN = 2 * DESC_R + 1;    // 39: blurred window
constexpr int WORDS = 8;                // 256 bits
constexpr int LOADS = (WIN * WIN + THREADS - 1) / THREADS;  // window loads a thread
constexpr int MY_WORDS = WORDS / WARPS;  // descriptor words a warp owns
constexpr int STRIP = 3;                 // blurred outputs a thread computes at once
static_assert(BWIN % STRIP == 0, "the blurred window splits into strips");
static_assert(WORDS % WARPS == 0, "every warp owns as many descriptor words");

// 7-tap Gaussian, sigma 2, in float32: ops/image.py::_gauss_kernel7(2.0)
// (tests/test_torch_levels.py holds the two equal)
constexpr float G0 = 0x1.1f5f62p-4f;
constexpr float G1 = 0x1.0c70fcp-3f;
constexpr float G2 = 0x1.869472p-3f;
constexpr float G3 = 0x1.ba95c0p-3f;

__device__ __forceinline__ float gauss(int t) {
  return t == 0 || t == 6 ? G0 : t == 1 || t == 5 ? G1 : t == 2 || t == 4 ? G2 : G3;
}

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

// STRIP outputs of a 7-tap blur in gaussian_blur7's order (no fused
// multiply-adds): out[q] = sum_t G[t] x[q + t]
__device__ __forceinline__ void blur_strip(const float (&x)[STRIP + 6], float (&out)[STRIP]) {
#pragma unroll
  for (int q = 0; q < STRIP; ++q) {
    float acc = __fmul_rn(gauss(0), x[q]);
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(gauss(t), x[q + t]));
    out[q] = acc;
  }
}

struct Levels {
  const float* img[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS + 1];  // level l holds keypoints [start[l], start[l + 1])
  int n;
};

__global__ void __launch_bounds__(THREADS)
orb_patch_kernel(const Levels lv, const int* __restrict__ yx, const float4* __restrict__ pattern,
                 float* __restrict__ angle, int* __restrict__ desc, signed char* __restrict__ pm1) {
  __shared__ float raw[WIN][WIN];
  __shared__ float red[2][WARPS];
  __shared__ float rows[BWIN][WIN];
  __shared__ float blur[BWIN][BWIN];

  const int n = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.n && n >= lv.start[l + 1]) ++l;
  const float* __restrict__ img = lv.img[l];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int y = yx[2 * n];
  const int x = yx[2 * n + 1];

  // warp `warp` owns words warp, warp + WARPS, ...; lane j of word w owns
  // pattern pair k = 32 w + j = [(ax, ay), (bx, by)]
  float4 pairs[MY_WORDS];
#pragma unroll
  for (int q = 0; q < MY_WORDS; ++q) pairs[q] = pattern[32 * (warp + q * WARPS) + lane];
  float v[LOADS];
  {
    int r = tid / WIN, c = tid % WIN;
#pragma unroll
    for (int j = 0; j < LOADS; ++j, advance<WIN>(r, c)) {
      const int gy = min(max(y - HALF + min(r, WIN - 1), 0), h - 1);
      const int gx = min(max(x - HALF + c, 0), w - 1);
      v[j] = img[(size_t)gy * w + gx];
    }
    r = tid / WIN;
    c = tid % WIN;
#pragma unroll
    for (int j = 0; j < LOADS; ++j, advance<WIN>(r, c)) {
      if (r < WIN) raw[r][c] = v[j];
    }
  }
  __syncthreads();

  // intensity-centroid moments over the disc
  float m10 = 0.0f, m01 = 0.0f;
  for (int r = tid / DISC, c = tid % DISC; r < DISC; advance<DISC>(r, c)) {
    const int dy = r - PATCH_R;
    const int dx = c - PATCH_R;
    if (dx * dx + dy * dy <= PATCH_R * PATCH_R) {
      const float v = raw[HALF + dy][HALF + dx];
      m10 += dx * v;
      m01 += dy * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }

  // vertical pass: rows[r][c] = blur of raw column c at raw row r + 3, a
  // strip of STRIP rows of one column a thread at a time
  for (int i = tid; i < (BWIN / STRIP) * WIN; i += THREADS) {
    const int r = (i / WIN) * STRIP;
    const int c = i % WIN;
    float x[STRIP + 6], out[STRIP];
#pragma unroll
    for (int j = 0; j < STRIP + 6; ++j) x[j] = raw[r + j][c];
    blur_strip(x, out);
#pragma unroll
    for (int q = 0; q < STRIP; ++q) rows[r + q][c] = out[q];
  }
  __syncthreads();

  float s10 = red[0][0];
  float s01 = red[1][0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) {
    s10 += red[0][k];
    s01 += red[1][k];
  }
  const float r = sqrtf(s10 * s10 + s01 * s01);
  const bool safe = r > 0.0f;
  const float ca = safe ? s10 / r : 1.0f;
  const float sa = safe ? s01 / r : 0.0f;
  if (tid == 0) angle[n] = atan2f(sa, ca);

  // horizontal pass: blur[r][c] = blurred image at offset (r - 19, c - 19),
  // a strip of STRIP columns of one row a thread at a time
  for (int i = tid; i < BWIN * (BWIN / STRIP); i += THREADS) {
    const int r = i / (BWIN / STRIP);
    const int c = (i % (BWIN / STRIP)) * STRIP;
    float x[STRIP + 6], out[STRIP];
#pragma unroll
    for (int j = 0; j < STRIP + 6; ++j) x[j] = rows[r][c + j];
    blur_strip(x, out);
#pragma unroll
    for (int q = 0; q < STRIP; ++q) blur[r][c + q] = out[q];
  }
  __syncthreads();

  // rotated BRIEF
#pragma unroll
  for (int q = 0; q < MY_WORDS; ++q) {
    const int word = warp + q * WARPS;
    const int k = 32 * word + lane;
    const float pt[4] = {pairs[q].x, pairs[q].y, pairs[q].z, pairs[q].w};
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float px = pt[2 * j];
      const float py = pt[2 * j + 1];
      const float fx = rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
      const float fy = rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
      const int rx = min(max((int)fx, -DESC_R), DESC_R);
      const int ry = min(max((int)fy, -DESC_R), DESC_R);
      v[j] = blur[ry + DESC_R][rx + DESC_R];
    }
    const bool bit = v[0] < v[1];
    const unsigned bits = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) desc[WORDS * n + word] = (int)bits;
    pm1[(size_t)256 * n + k] = bit ? 1 : -1;
  }
}

}  // namespace

// Every level in one launch. imgs: n_levels device pointers to (h, w)
// float32 contiguous level images, in host memory; hw: n_levels (h, w) pairs
// and start: n_levels + 1 keypoint prefix sums, both in host memory. yx:
// (start[n_levels], 2) int32 (row, col) on the device, the keypoints of
// level l in rows [start[l], start[l + 1]); pattern: (256, 2, 2) float32.
// Writes angle (n,) float32, desc (n, 8) int32 and pm1 (n, 256) int8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int orb_patch_features_levels(const void* const* imgs, const int* hw, const int* start,
                                         int n_levels, const int* yx, const float* pattern,
                                         float* angle, int* desc, signed char* pm1,
                                         cudaStream_t stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS || start[0] != 0) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    if (hw[2 * l] <= 0 || hw[2 * l + 1] <= 0 || start[l + 1] < start[l]) {
      return (int)cudaErrorInvalidValue;
    }
    lv.img[l] = static_cast<const float*>(imgs[l]);
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start[l];
  }
  const int n = start[n_levels];
  lv.start[n_levels] = n;
  if (n == 0) return 0;
  orb_patch_kernel<<<n, THREADS, 0, stream>>>(lv, yx, reinterpret_cast<const float4*>(pattern),
                                              angle, desc, pm1);
  return (int)cudaGetLastError();
}
