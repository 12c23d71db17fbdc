// Tile-blend forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `_forward_kernel` (gsrast_tpu/render/pallas_blend.py:181,
// launched by `blend_forward` at :301). Per tile of P = tile_h * tile_w pixels it
// walks the tile's depth-sorted intersections [tile_starts[t], tile_starts[t+1])
// front to back and evaluates, per pixel, the recurrence
//     power = -1/2 (A dx^2 + C dy^2) - B dx dy        (dx = mean - pixel)
//     alpha = min(alpha_max, opacity * exp(power)); alpha = 0 if power > 0
//             or alpha < alpha_min (the position is skipped)
//     stop before the first position where T (1 - alpha) < t_min
//     rgb += c alpha T;  T *= 1 - alpha;  n_contrib += 1
// and writes rgb (T, 3, P), final_t (T, P) and n_contrib (T, P) int32. n_contrib
// counts every position before saturation, skipped ones included, as the reference
// does (pallas_blend.py:46-52).
//
// What bounds it on this card: one expf plus about 15 flops per (pixel,
// intersection), and every pixel block of a tile re-reads the tile's whole segment
// (9 floats per intersection) from L2. The design answers the re-read by staging
// each batch of 256 intersections in shared memory as 9 SoA rows, loaded once per
// block with coalesced reads and then broadcast to all 256 threads (one pixel per
// thread); it answers the compute by letting the whole block leave the segment as
// soon as every pixel is saturated (__syncthreads_count), which is the TPU kernel's
// per-tile chunk skip and the early exit of the reference CUDA rasterizer.
//
// The TPU kernel's 128-wide chunks, tile-id lane masks and FROWS/OUT_ROWS padding
// are layout workarounds for the TPU and are not carried: segment bounds are exact.
// The grid is (tiles, ceil(P / 256)), so a 32x64 tile (P = 2048) runs as 8 blocks.
//
// Rounding: the products and sums below use the _rn intrinsics, which nvcc never
// contracts into fused multiply-adds, and expf (not __expf); the file is built
// without --use_fast_math. The alpha_min and t_min thresholds therefore see the
// same alpha as the plain PyTorch version. T is multiplied sequentially, where the
// plain version and the TPU kernel take cumulative products; a pixel whose
// transmittance lands within rounding of t_min may stop one blended position
// earlier or later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // pixels per block = intersections per staged batch
constexpr int kRows = 9;       // mx, my, conic A, B, C, opacity, r, g, b

__global__ void __launch_bounds__(kThreads)
blend_forward_kernel(const float* __restrict__ feat, long long row_stride,
                     const int* __restrict__ tile_starts, int grid_w, int tile_h,
                     int tile_w, float alpha_min, float alpha_max, float t_min,
                     float* __restrict__ rgb, float* __restrict__ final_t,
                     int* __restrict__ n_contrib) {
  __shared__ float stage[kRows][kThreads];

  const int tile = blockIdx.x;
  const int num_pix = tile_h * tile_w;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const bool inside = p < num_pix;
  const float px = static_cast<float>((tile % grid_w) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / grid_w) * tile_h + p / tile_w);
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];

  float trans = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int count = 0;
  bool done = !inside;

  for (int base = start; base < end; base += kThreads) {
    // Block-uniform: every thread reaches this barrier once per batch. It also
    // keeps the previous batch's readers ahead of this batch's writes.
    if (__syncthreads_count(done) == kThreads) break;
    const int i = base + threadIdx.x;
    if (i < end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        stage[r][threadIdx.x] = feat[r * row_stride + i];
      }
    }
    __syncthreads();
    const int n = min(kThreads, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = __fsub_rn(stage[0][j], px);
      const float dy = __fsub_rn(stage[1][j], py);
      const float quad = __fadd_rn(__fmul_rn(stage[2][j], __fmul_rn(dx, dx)),
                                   __fmul_rn(stage[4][j], __fmul_rn(dy, dy)));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(stage[3][j], __fmul_rn(dx, dy)));
      const float alpha = fminf(alpha_max, __fmul_rn(stage[5][j], expf(power)));
      const float a = (power <= 0.0f && alpha >= alpha_min) ? alpha : 0.0f;
      const float next = __fmul_rn(trans, __fsub_rn(1.0f, a));
      if (next < t_min) {
        done = true;
        break;
      }
      const float w = __fmul_rn(a, trans);
      acc_r = __fadd_rn(acc_r, __fmul_rn(stage[6][j], w));
      acc_g = __fadd_rn(acc_g, __fmul_rn(stage[7][j], w));
      acc_b = __fadd_rn(acc_b, __fmul_rn(stage[8][j], w));
      trans = next;
      ++count;
    }
  }

  if (inside) {
    const long long out = static_cast<long long>(tile) * num_pix + p;
    const long long out3 = static_cast<long long>(tile) * 3 * num_pix + p;
    rgb[out3] = acc_r;
    rgb[out3 + num_pix] = acc_g;
    rgb[out3 + 2 * num_pix] = acc_b;
    final_t[out] = trans;
    n_contrib[out] = count;
  }
}

}  // namespace

// feat: (>= 9, row_stride) float32 rows in (tile, depth) order; tile_starts:
// (num_tiles + 1,) int32. Outputs are written in full. Runs on `stream` and does
// not synchronise; returns cudaGetLastError() after the launch.
extern "C" int gsrast_blend_forward(const float* feat, long long row_stride,
                                    const int* tile_starts, int num_tiles,
                                    int grid_w, int tile_h, int tile_w,
                                    float alpha_min, float alpha_max, float t_min,
                                    float* rgb, float* final_t, int* n_contrib,
                                    void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(num_tiles, (tile_h * tile_w + kThreads - 1) / kThreads);
  blend_forward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, row_stride, tile_starts, grid_w, tile_h, tile_w, alpha_min, alpha_max,
      t_min, rgb, final_t, n_contrib);
  return static_cast<int>(cudaGetLastError());
}
