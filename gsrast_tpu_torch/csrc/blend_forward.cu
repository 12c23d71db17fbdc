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
// does (pallas_blend.py:46-52). The tiles may be a device's local rows of the grid,
// as the TPU kernel's num_tiles/tile_map place them (tile_origin, blend_common.cuh).
//
// What bounds it on this card: one expf plus about 21 flops per (pixel,
// intersection) that the pixel reaches before it saturates, and on scenes with long
// segments the longest tile's chain of positions. The design (blend_common.cuh for
// the block and the pixel map, shared with the backward):
// - One block owns a tile, so each segment is staged once: batches of 256
//   intersections in shared memory, a position's 9 features read by every thread
//   as three broadcast 16-byte loads. Block b takes tile order[b] (tile_order.cu:
//   longest segment first).
// - The next batch is copied into the other half of a two-slot ring by cp.async
//   while the current one is computed.
// - Warps on 2-D patches, 2 pixels a thread. A pixel outside the splat's box
//   (stage_boxes) counts the position as skipped without evaluating it. A lane
//   leaves a batch as soon as its K pixels are saturated, a 32-pixel sub-patch does
//   no arithmetic once all of its pixels are, and the block leaves the segment once
//   every pixel is (__syncthreads_count): the TPU kernel's per-tile chunk skip and
//   the early exit of the reference CUDA rasterizer.
//
// The TPU kernel's 128-wide chunks, tile-id lane masks and FROWS/OUT_ROWS padding
// are layout workarounds for the TPU and are not carried: segment bounds are exact.
//
// Rounding: the products and sums below use the _rn intrinsics, which nvcc never
// contracts into fused multiply-adds, and expf (not __expf); the file is built
// without --use_fast_math. The alpha_min and t_min thresholds therefore see the
// same alpha as the plain PyTorch version. T is multiplied sequentially, where the
// plain version and the TPU kernel take cumulative products; a pixel whose
// transmittance lands within rounding of t_min may stop one blended position
// earlier or later.

#include "blend_common.cuh"

namespace {

using namespace gsrast;

constexpr int kBatch = 256;  // intersections per staged batch
constexpr int K = 2;         // pixels a thread

template <int W>
__global__ void __launch_bounds__(32 * W)
blend_forward_kernel(const float* __restrict__ feat, long long row_stride,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ order, int grid_w, int row0,
                     int tile_row_step, int tile_h, int tile_w, int wx,
                     float alpha_min, float alpha_max,
                     float t_min, float* __restrict__ rgb, float* __restrict__ final_t,
                     int* __restrict__ n_contrib) {
  constexpr int kThreads = 32 * W;
  __shared__ __align__(16) float stage[2][kBatch][kStride];
  __shared__ float4 box[kBatch];

  const int tile = order[blockIdx.x];
  const int num_pix = tile_h * tile_w;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int2 origin = tile_origin(tile, grid_w, row0, tile_row_step, tile_h, tile_w);
  const int ox = origin.x, oy = origin.y;

  int pix[K], count[K];
  float px[K], py[K], trans[K], acc_r[K], acc_g[K], acc_b[K];
  bool live[K];
  bool any_live = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pix[k] = footprint_pixel<K>(k, wx, tile_w);
    px[k] = static_cast<float>(ox + pix[k] % tile_w);
    py[k] = static_cast<float>(oy + pix[k] / tile_w);
    trans[k] = 1.0f;
    acc_r[k] = acc_g[k] = acc_b[k] = 0.0f;
    count[k] = 0;
    live[k] = true;
  }

  const int nb = (end - start + kBatch - 1) / kBatch;
  if (nb > 0) {
    stage_batch<kThreads, kBatch>(stage[0], feat, row_stride, start,
                                  min(kBatch, end - start));
  }
  for (int b = 0; b < nb; ++b) {
    __pipeline_wait_prior(0);
    // Batch b has landed for every thread, and every reader of the previous
    // batch's slot, (b + 1) % 2, is past it. Leave once every pixel is done.
    if (__syncthreads_count(!any_live) == kThreads) break;
    const int base = start + b * kBatch;
    if (b + 1 < nb) {
      stage_batch<kThreads, kBatch>(stage[(b + 1) & 1], feat, row_stride,
                                    base + kBatch, min(kBatch, end - base - kBatch));
    }
    const float(*s)[kStride] = stage[b & 1];
    const int n = min(kBatch, end - base);
    stage_boxes<kThreads>(box, s, n, alpha_min);
    __syncthreads();
    for (int j = 0; j < n && any_live; ++j) {
      const float4 bx = box[j];
      const Features f = load_features(s, j);
      any_live = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!live[k]) continue;
        if (outside(bx, px[k], py[k])) {  // skipped: T unchanged, counted
          ++count[k];
          any_live = true;
          continue;
        }
        const float dx = __fsub_rn(f.mx, px[k]);
        const float dy = __fsub_rn(f.my, py[k]);
        const float quad = __fadd_rn(__fmul_rn(f.ca, __fmul_rn(dx, dx)),
                                     __fmul_rn(f.cc, __fmul_rn(dy, dy)));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(f.cb, __fmul_rn(dx, dy)));
        const float alpha = fminf(alpha_max, __fmul_rn(f.op, expf(power)));
        const float a = (power <= 0.0f && alpha >= alpha_min) ? alpha : 0.0f;
        const float next = __fmul_rn(trans[k], __fsub_rn(1.0f, a));
        if (next < t_min) {
          live[k] = false;
          continue;
        }
        const float w = __fmul_rn(a, trans[k]);
        acc_r[k] = __fadd_rn(acc_r[k], __fmul_rn(f.r, w));
        acc_g[k] = __fadd_rn(acc_g[k], __fmul_rn(f.g, w));
        acc_b[k] = __fadd_rn(acc_b[k], __fmul_rn(f.b, w));
        trans[k] = next;
        ++count[k];
        any_live = true;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long out = static_cast<long long>(tile) * num_pix + pix[k];
    const long long out3 = static_cast<long long>(tile) * 3 * num_pix + pix[k];
    rgb[out3] = acc_r[k];
    rgb[out3 + num_pix] = acc_g[k];
    rgb[out3 + 2 * num_pix] = acc_b[k];
    final_t[out] = trans[k];
    n_contrib[out] = count[k];
  }
}

}  // namespace

// feat: (>= 9, row_stride) float32 rows in (tile, depth) order; tile_starts:
// (num_tiles + 1,) int32; order: (num_tiles,) int32, the tile of each block
// (tile_order.cu). The num_tiles tiles are local: whole rows of grid_w tiles,
// local tile t covering the pixels of global tile row row0 + (t / grid_w) *
// tile_row_step, column t % grid_w (the tile-sharded path; 0 and 1 for the whole
// grid). Outputs are written in full. Runs on `stream` and does not
// synchronise; returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a tile shape the kernel does not take (blend_common.cuh).
extern "C" int gsrast_blend_forward(const float* feat, long long row_stride,
                                    const int* tile_starts, const int* order,
                                    int num_tiles, int grid_w, int row0,
                                    int tile_row_step, int tile_h, int tile_w,
                                    float alpha_min, float alpha_max, float t_min,
                                    float* rgb, float* final_t, int* n_contrib,
                                    void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  if (tile_h % 8 != 0 || tile_w % (4 * K) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wx = tile_w / (4 * K);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_h * tile_w / (32 * K)) {  // warps a block
#define GSRAST_LAUNCH(W)                                                              \
  case W:                                                                             \
    blend_forward_kernel<W><<<num_tiles, 32 * W, 0, s>>>(                             \
        feat, row_stride, tile_starts, order, grid_w, row0, tile_row_step, tile_h,    \
        tile_w, wx, alpha_min, alpha_max, t_min, rgb, final_t, n_contrib);            \
    break;
    GSRAST_LAUNCH(4) GSRAST_LAUNCH(8) GSRAST_LAUNCH(16) GSRAST_LAUNCH(32)
#undef GSRAST_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
