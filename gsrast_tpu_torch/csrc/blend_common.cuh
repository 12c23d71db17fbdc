// What the two tile-blend kernels (blend_forward.cu, blend_backward.cu) share: the
// map from a thread to its pixels, the staging of a batch of feature rows into
// shared memory, and the box outside which a splat blends no pixel.
//
// One block of W warps owns one tile of P = tile_h * tile_w pixels, K pixels a
// thread, W = P / 32K. Warp w owns the 8 x 4K patch at (w / wx, w % wx) of the grid
// of patches that tiles the tile (wx = tile_w / 4K), so a warp's pixels are a 2-D
// patch and a small splat touches few warps. The patch is cut into K sub-patches
// of 4 x 8 pixels, row-major (K / 2 across); the thread's pixel i is lane
// (l / 8, l % 8) of sub-patch i. A sub-patch whose 32 pixels are all done skips its
// arithmetic as a unit. The kernels take tiles of 256 to 2048 pixels whose height is
// a multiple of 8 and width a multiple of 4K (`render/blend.py::kernel_footprint`).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace gsrast {

constexpr int kRows = 9;     // mx, my, conic A, B, C, opacity, r, g, b
constexpr int kStride = 12;  // floats per staged position: 3 aligned float4 loads
constexpr unsigned kFull = 0xffffffffu;

// Row-major index in the tile of this thread's pixel i, for K pixels a thread and
// wx patches across the tile.
template <int K>
__device__ __forceinline__ int footprint_pixel(int i, int wx, int tile_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = (warp / wx) * 8 + (i / (K / 2)) * 4 + (lane >> 3);
  const int x = (warp % wx) * (4 * K) + (i % (K / 2)) * 8 + (lane & 7);
  return y * tile_w + x;
}

// Pixel origin (x, y) of local tile `tile`: its column is tile % grid_w and its
// global tile row row0 + (tile / grid_w) * tile_row_step. The tile-sharded path
// blends only the rows a device owns (the reference's tile_map,
// pallas_blend.py:201-206); the whole grid is row0 = 0, tile_row_step = 1.
__device__ __forceinline__ int2 tile_origin(int tile, int grid_w, int row0,
                                           int tile_row_step, int tile_h, int tile_w) {
  return make_int2((tile % grid_w) * tile_w,
                   (row0 + (tile / grid_w) * tile_row_step) * tile_h);
}

// Copies positions [base, base + n) of the 9 feature rows into dst[0, n), one
// position's 9 floats per kStride-float row, with cp.async, and commits them as
// one group; the caller waits (__pipeline_wait_prior) and then passes a barrier
// before reading. Copies are 4 bytes: a segment starts at any column, so its rows
// are not 16-byte aligned.
template <int kThreads, int kBatch>
__device__ __forceinline__ void stage_batch(float (*dst)[kStride],
                                            const float* __restrict__ feat,
                                            long long row_stride, int base, int n) {
  for (int s = threadIdx.x; s < kRows * kBatch; s += kThreads) {
    const int r = s / kBatch, j = s % kBatch;
    if (j < n) __pipeline_memcpy_async(&dst[j][r], feat + r * row_stride + base + j, 4);
  }
  __pipeline_commit();
}

// The 9 staged features of one position, as three broadcast 16-byte loads.
struct Features {
  float mx, my, ca, cb, cc, op, r, g, b;
};

__device__ __forceinline__ Features load_features(const float (*stage)[kStride], int j) {
  const float4* p = reinterpret_cast<const float4*>(stage[j]);
  const float4 a = p[0], c = p[1], d = p[2];
  return {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w, d.x};
}

// Whether all 9 features of a staged position are finite. Where one is not, the
// kernels' arithmetic may carry a NaN even from a skipped position, so nothing is
// skipped early.
__device__ __forceinline__ bool features_finite(const float (&f)[kStride]) {
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) finite = finite && isfinite(f[r]);
  return finite;
}

// The box (x0, x1, y0, y1) outside which the splat of one staged position is
// skipped at every pixel: alpha = opacity exp(power) >= alpha_min needs
// power >= -t, t = ln(opacity / alpha_min), which bounds the pixel to the
// ellipse 1/2 d^T M d <= t (M = [[A, B], [B, C]]), whose box has half-sides
// sqrt(2 t C / det) and sqrt(2 t A / det). t is widened by far more than the
// rounding of power at that distance (a few ulps of its largest term), and the box
// by half a pixel, so every pixel outside it is skipped by the kernels' own
// arithmetic too, and testing a pixel against the box first changes no output.
// An opacity below alpha_min skips everywhere (an empty box); a conic that is not
// positive definite skips nowhere.
__device__ __forceinline__ float4 splat_box(const float (&f)[kStride], float alpha_min) {
  const float inf = __int_as_float(0x7f800000);
  const float a = f[2], b = f[3], c = f[4], op = f[5];
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det > 0.0f)) return make_float4(-inf, inf, -inf, inf);
  if (op < alpha_min) return make_float4(inf, -inf, inf, -inf);
  const float sxx = c / det, syy = a / det;
  float t = fmaxf(logf(op / alpha_min), 0.0f);
  float rx = sqrtf(2.0f * t * sxx), ry = sqrtf(2.0f * t * syy);
  const float terms = 0.5f * (a * rx * rx + c * ry * ry) + fabsf(b) * rx * ry;
  t = 1.001f * t + 1e-5f * terms + 1e-3f;
  rx = sqrtf(2.0f * t * sxx) + 0.5f;
  ry = sqrtf(2.0f * t * syy) + 0.5f;
  return make_float4(f[0] - rx, f[0] + rx, f[1] - ry, f[1] + ry);
}

// splat_box of staged positions [0, n) into box; a box of NaNs, which skips
// nothing (NaN compares false), where a feature is not finite. By all threads of
// the block; the caller passes a barrier before reading.
template <int kThreads>
__device__ __forceinline__ void stage_boxes(float4* box, const float (*stage)[kStride],
                                            int n, float alpha_min) {
  const float nan = __int_as_float(0x7fc00000);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    box[j] = features_finite(stage[j]) ? splat_box(stage[j], alpha_min)
                                       : make_float4(nan, nan, nan, nan);
  }
}

__device__ __forceinline__ bool outside(float4 box, float px, float py) {
  return px < box.x || px > box.y || py < box.z || py > box.w;
}

}  // namespace gsrast
