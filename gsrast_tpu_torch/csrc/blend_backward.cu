// Tile-blend backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `_backward_kernel` (gsrast_tpu/render/pallas_blend.py:350,
// launched by `blend_backward` at :598). Per tile it replays the forward blend back
// to front from the saved per-pixel final_t, over the positions the forward blended
// (index < n_contrib and not skipped), and writes the 9 gradient rows of every
// intersection (on local tiles placed as in the forward, tile_origin in
// blend_common.cuh):
//     T_before = T_after / (1 - alpha)
//     u = d_rgb . c,  w = alpha T_before
//     d alpha = T_before u - (q + final_t d_final_t) / (1 - alpha)
//               (q = sum of u w over the later positions); 0 where
//               opacity exp(power) >= alpha_max (the clamped branch)
//     d power = d alpha * opacity exp(power)
//     d mx = -(A Sx + B Sy), d my = -(C Sy + B Sx), d A = -1/2 S(dp dx^2),
//     d B = -S(dp dx dy), d C = -1/2 S(dp dy^2), d opacity = S(d alpha exp(power)),
//     d rgb = S(w d_rgb), with S the sum over the tile's pixels and Sx = S(dp dx).
//
// What bounds it on this card: per (pixel, position) about 37 flops, one expf and
// one division, and then, per position, the sum of 9 values over the tile's pixels.
// The design (blend_common.cuh for the block and the pixel map):
// - One block owns a tile: W warps on 2-D patches, 4 pixels a thread; block
//   kTailBlocks + b takes tile order[b] (tile_order.cu: longest segment first).
//   Each column's sums meet inside its block and are written
//   with plain stores: no atomics, and every element of d_feat is written exactly
//   once (zeros included), so the caller need not fill it.
// - The block walks the segment newest first, in batches of 64 positions (32 with 16
//   warps), from the block's largest n_contrib (later positions carry no gradient).
//   Each warp starts at its own largest n_contrib. A pixel past its n_contrib, or
//   outside the splat's box (stage_boxes), skips the position, and a 32-pixel
//   sub-patch whose lanes all skip it does no arithmetic there.
// - Per position a lane first adds its K pixels' 9 values, then the warp sums them
//   by a transpose-reduce: each shuffle step halves the set of values a lane
//   carries (9, 5, 3, 2, 1: 12 shuffles where 9 butterflies take 45), skipped when
//   no lane of the warp blended there. The lanes left holding a row's sum store it
//   into the warp's own slot of a per-batch buffer.
// - After the batch one pass adds the warps' slots in warp order and stores the 9
//   rows: the order of every sum is fixed, so two launches give identical bits.
// - The next batch's feature rows are copied into the other half of a two-slot ring
//   by cp.async while the current batch is computed; the first batch processed, the
//   newest, lands in slot (nb - 1) % 2.
// - T is replayed with one reciprocal of 1 - alpha used twice.
//
// Rounding: alpha uses the _rn intrinsics and expf, as blend_forward.cu does, so the
// skip test (power <= 0, alpha >= alpha_min) sees the forward's alpha; which
// positions carry a gradient is decided by the forward's n_contrib, so both backward
// versions share the gate. Only the replayed T and the sums round differently.

#include "blend_common.cuh"

namespace {

using namespace gsrast;

constexpr int kTailBlocks = 64;  // blocks that zero the columns outside every segment
constexpr int K = 4;             // pixels a thread

// v[0, N) -> v[0, H), H = (N + 1) / 2, summed with the lane `offset` away: a lane
// with `upper` keeps the values [H, N) (0 past N), the other lane [0, H).
template <int N>
__device__ __forceinline__ void fold(float (&v)[kRows], int offset, bool upper) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = (i + H < N) ? v[i + H] : 0.0f;
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, offset);
  }
}

template <int W>
__global__ void __launch_bounds__(32 * W)
blend_backward_kernel(const float* __restrict__ feat, long long row_stride,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ order, int num_tiles, int grid_w,
                      int row0, int tile_row_step, int tile_h, int tile_w, int wx,
                      float alpha_min,
                      float alpha_max, const float* __restrict__ d_rgb,
                      const float* __restrict__ d_final_t,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib, float* __restrict__ d_feat) {
  constexpr int kThreads = 32 * W;
  constexpr int kBatch = W <= 8 ? 64 : 32;  // positions per staged batch
  __shared__ __align__(16) float stage[2][kBatch][kStride];
  __shared__ float4 box[kBatch];
  __shared__ float part[W][kRows][kBatch + 1];  // +1: rows on distinct banks
  __shared__ int warp_live[W];

  if (blockIdx.x < kTailBlocks) {
    // Columns outside every segment: [0, tile_starts[0]) and [tile_starts[T], S).
    const int head = tile_starts[0];
    const int tail = tile_starts[num_tiles];
    for (long long c = blockIdx.x * kThreads + threadIdx.x; c < row_stride;
         c += kTailBlocks * kThreads) {
      if (c >= head && c < tail) continue;
#pragma unroll
      for (int r = 0; r <= kRows; ++r) d_feat[r * row_stride + c] = 0.0f;
    }
    return;
  }
  const int tile = order[blockIdx.x - kTailBlocks];
  const int num_pix = tile_h * tile_w;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = tile_starts[tile];
  const int seg = tile_starts[tile + 1] - start;
  const int2 origin = tile_origin(tile, grid_w, row0, tile_row_step, tile_h, tile_w);
  const int ox = origin.x, oy = origin.y;

  float px[K], py[K], trans[K], ft_dft[K], dr[K], dg[K], db[K], q[K];
  int nc[K];
  int my_nc = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = footprint_pixel<K>(k, wx, tile_w);
    px[k] = static_cast<float>(ox + p % tile_w);
    py[k] = static_cast<float>(oy + p / tile_w);
    q[k] = 0.0f;
    const long long out = static_cast<long long>(tile) * num_pix + p;
    const long long out3 = static_cast<long long>(tile) * 3 * num_pix + p;
    nc[k] = min(n_contrib[out], seg);
    trans[k] = final_t[out];
    ft_dft[k] = trans[k] * d_final_t[out];
    dr[k] = d_rgb[out3];
    dg[k] = d_rgb[out3 + num_pix];
    db[k] = d_rgb[out3 + 2 * num_pix];
    my_nc = max(my_nc, nc[k]);
  }
  const int wl = __reduce_max_sync(kFull, my_nc);  // this warp's positions [0, wl)
  if (lane == 0) warp_live[warp] = wl;

  // The gradient row whose warp sum this lane holds after the folds, and whether
  // it stores it (one of the two lanes that hold each row).
  int row = (lane >> 1) & 1;
  bool owner = (lane & 1) == 0;
  row += (lane & 4) ? 2 : 0;
  owner = owner && row < 3;
  row += (lane & 8) ? 3 : 0;
  owner = owner && row < 5;
  row += (lane & 16) ? 5 : 0;
  owner = owner && row < kRows;
  __syncthreads();
  int live = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) live = max(live, warp_live[w]);

  // Positions past the block's largest n_contrib carry no gradient.
  for (int c = live + threadIdx.x; c < seg; c += kThreads) {
#pragma unroll
    for (int r = 0; r <= kRows; ++r) d_feat[r * row_stride + start + c] = 0.0f;
  }

  const int nb = (live + kBatch - 1) / kBatch;
  if (nb > 0) {
    const int base = (nb - 1) * kBatch;
    stage_batch<kThreads, kBatch>(stage[(nb - 1) & 1], feat, row_stride, start + base,
                                  live - base);
  }
  for (int b = nb - 1; b >= 0; --b) {
    __pipeline_wait_prior(0);
    // Batch b has landed for every thread, and the previous batch's pass over
    // `part` and its stage slot, (b + 1) % 2 = (b - 1) % 2, is done.
    __syncthreads();
    if (b > 0) {
      stage_batch<kThreads, kBatch>(stage[(b - 1) & 1], feat, row_stride,
                                    start + (b - 1) * kBatch, kBatch);
    }
    const float(*s)[kStride] = stage[b & 1];
    const int lo = b * kBatch;
    const int hi = min(live, lo + kBatch);
    stage_boxes<kThreads>(box, s, hi - lo, alpha_min);
    __syncthreads();
    for (int i = min(hi, wl) - 1; i >= lo; --i) {
      const int j = i - lo;
      const float4 bx = box[j];
      const Features f = load_features(s, j);
      float v[kRows] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      bool blended = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (i >= nc[k] || outside(bx, px[k], py[k])) continue;
        const float dx = __fsub_rn(f.mx, px[k]);
        const float dy = __fsub_rn(f.my, py[k]);
        const float quad = __fadd_rn(__fmul_rn(f.ca, __fmul_rn(dx, dx)),
                                     __fmul_rn(f.cc, __fmul_rn(dy, dy)));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(f.cb, __fmul_rn(dx, dy)));
        const float gauss = expf(power);
        const float og = __fmul_rn(f.op, gauss);
        const float alpha = fminf(alpha_max, og);
        if (!(power <= 0.0f && alpha >= alpha_min)) continue;
        blended = true;
        const float inv = __frcp_rn(__fsub_rn(1.0f, alpha));
        const float t_before = trans[k] * inv;
        const float w = alpha * t_before;
        const float u = dr[k] * f.r + dg[k] * f.g + db[k] * f.b;
        const float dalpha = t_before * u - (q[k] + ft_dft[k]) * inv;
        q[k] += u * w;
        trans[k] = t_before;
        v[6] += w * dr[k];
        v[7] += w * dg[k];
        v[8] += w * db[k];
        if (og < alpha_max) {
          const float dpx = dalpha * og * dx;
          const float dpy = dalpha * og * dy;
          v[0] += dpx;
          v[1] += dpy;
          v[2] += dpx * dx;
          v[3] += dpx * dy;
          v[4] += dpy * dy;
          v[5] += dalpha * gauss;
        }
      }
      float sum = 0.0f;
      if (__any_sync(kFull, blended)) {
        fold<9>(v, 16, lane & 16);
        fold<5>(v, 8, lane & 8);
        fold<3>(v, 4, lane & 4);
        fold<2>(v, 2, lane & 2);
        sum = v[0] + __shfl_xor_sync(kFull, v[0], 1);
      }
      if (owner) part[warp][row][j] = sum;
    }
    __syncthreads();  // every warp's slots of this batch are written
    // Raw sums S(dp dx), S(dp dy), S(dp dx^2), S(dp dx dy), S(dp dy^2),
    // S(d alpha G), S(w dr), S(w dg), S(w db) -> rows, warps added in warp order.
    const int n = hi - lo;
    for (int it = threadIdx.x; it < (kRows + 1) * kBatch; it += kThreads) {
      const int r = it / kBatch, j = it % kBatch;
      if (j >= n) continue;
      const int i = lo + j;
      float out = 0.0f;  // row 9 (tile id) stays 0
      if (r < kRows) {
        const int other = r < 2 ? 1 - r : r;
        float a = 0.0f, c = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (i < warp_live[w]) {
            a += part[w][r][j];
            c += part[w][other][j];
          }
        }
        const Features f = load_features(s, j);
        if (r == 0) out = -(f.ca * a + f.cb * c);
        else if (r == 1) out = -(f.cc * a + f.cb * c);
        else if (r == 2 || r == 4) out = -0.5f * a;
        else if (r == 3) out = -a;
        else out = a;
      }
      d_feat[r * row_stride + start + i] = out;
    }
  }
}

}  // namespace

// feat: (>= 10, row_stride) float32 rows in (tile, depth) order; tile_starts:
// (num_tiles + 1,) int32; order: (num_tiles,) int32, the tile of each block
// (tile_order.cu); the tiles are local, placed by row0 and tile_row_step as in
// gsrast_blend_forward; d_rgb (num_tiles, 3, P), d_final_t, final_t (num_tiles, P)
// float32; n_contrib (num_tiles, P) int32. d_feat: (>= 10, row_stride) float32, every
// element of rows 0:10 written (0 outside the blended positions). Runs on `stream`
// and does not synchronise; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tile shape the kernel does not take (blend_common.cuh).
extern "C" int gsrast_blend_backward(const float* feat, long long row_stride,
                                     const int* tile_starts, const int* order,
                                     int num_tiles, int grid_w, int row0,
                                     int tile_row_step, int tile_h, int tile_w,
                                     float alpha_min, float alpha_max,
                                     const float* d_rgb, const float* d_final_t,
                                     const float* final_t, const int* n_contrib,
                                     float* d_feat, void* stream) {
  if (tile_h % 8 != 0 || tile_w % (4 * K) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wx = tile_w / (4 * K);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile_h * tile_w / (32 * K)) {  // warps a block
#define GSRAST_LAUNCH(W)                                                             \
  case W:                                                                            \
    blend_backward_kernel<W><<<num_tiles + kTailBlocks, 32 * W, 0, s>>>(             \
        feat, row_stride, tile_starts, order, num_tiles, grid_w, row0, tile_row_step, \
        tile_h, tile_w, wx, alpha_min, alpha_max, d_rgb, d_final_t, final_t,         \
        n_contrib, d_feat);                                                          \
    break;
    GSRAST_LAUNCH(2) GSRAST_LAUNCH(4) GSRAST_LAUNCH(8) GSRAST_LAUNCH(16)
#undef GSRAST_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
