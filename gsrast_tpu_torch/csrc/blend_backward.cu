// Tile-blend backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel `_backward_kernel` (gsrast_tpu/render/pallas_blend.py:350,
// launched by `blend_backward` at :598). Per tile it replays the forward blend back
// to front from the saved per-pixel final_t, over the positions the forward blended
// (index < n_contrib and not skipped), and writes the 9 gradient rows of every
// intersection:
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
// What bounds it on this card: the forward's per-(pixel, position) work (one expf
// and ~15 flops) plus a division and ~25 flops, and then the sum of 9 values over
// the tile's pixels for every position, which is a cross-thread reduction. The
// design: one thread per pixel, grid (tiles, ceil(P / 256)) as in the forward. The
// block walks its tile's segment in batches of 256 positions, newest batch first,
// starting at the block's largest n_contrib (later positions carry no gradient, the
// counterpart of the TPU kernel's dead-chunk zero-fill), with each batch's 9 feature
// rows staged in shared memory as SoA rows. Per position each warp sums its 32
// pixels' 9 raw sums by shuffles, skipped when no pixel of the warp blended there;
// lane 0 adds the warp's row values into a shared per-batch accumulator; after the
// batch one atomicAdd per (block, intersection, row) adds the block's value into the
// zero-filled d_feat. A 2048-pixel tile runs as 8 blocks, so each value has at most
// 8 addends in device memory; their order, and the last bits, may change between
// runs.
//
// Not carried from the TPU kernel: the 128-wide chunks, double-buffered DMA, psplit
// pixel slices, the MXU suffix matmul and the read-modify-write of chunks shared by
// two tiles. Each column here has one owning tile, and only its blocks write it.
// Columns outside every segment, and row 9, are never written.
//
// Rounding: the alpha and transmittance arithmetic uses the _rn intrinsics and
// expf, as blend_forward.cu does, so the skip test (power <= 0, alpha >= alpha_min)
// sees the forward's alpha; which positions carry a gradient is decided by the
// forward's n_contrib, so both backward versions share the gate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // pixels per block = positions per staged batch
constexpr int kRows = 9;       // mx, my, conic A, B, C, opacity, r, g, b
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFull, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const float* __restrict__ feat, long long row_stride,
                      const int* __restrict__ tile_starts, int grid_w, int tile_h,
                      int tile_w, float alpha_min, float alpha_max,
                      const float* __restrict__ d_rgb,
                      const float* __restrict__ d_final_t,
                      const float* __restrict__ final_t,
                      const int* __restrict__ n_contrib, float* __restrict__ d_feat) {
  __shared__ float stage[kRows][kThreads];
  __shared__ float grad[kRows][kThreads];
  __shared__ int block_nc;

  const int tile = blockIdx.x;
  const int num_pix = tile_h * tile_w;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool inside = p < num_pix;
  const float px = static_cast<float>((tile % grid_w) * tile_w + p % tile_w);
  const float py = static_cast<float>((tile / grid_w) * tile_h + p / tile_w);
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];

  int nc = 0;
  float trans = 1.0f, dr = 0.0f, dg = 0.0f, db = 0.0f, ft_dft = 0.0f;
  if (inside) {
    const long long out = static_cast<long long>(tile) * num_pix + p;
    const long long out3 = static_cast<long long>(tile) * 3 * num_pix + p;
    nc = n_contrib[out];
    trans = final_t[out];
    ft_dft = trans * d_final_t[out];
    dr = d_rgb[out3];
    dg = d_rgb[out3 + num_pix];
    db = d_rgb[out3 + 2 * num_pix];
  }
  if (threadIdx.x == 0) block_nc = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) grad[r][threadIdx.x] = 0.0f;
  __syncthreads();
  const int warp_nc = __reduce_max_sync(kFull, nc);
  if (lane == 0) atomicMax(&block_nc, warp_nc);
  __syncthreads();
  const int live_end = start + min(block_nc, end - start);

  float q = 0.0f;  // sum of u w over the positions after the current one
  for (int batch_end = live_end; batch_end > start; batch_end -= kThreads) {
    const int base = max(start, batch_end - kThreads);
    const int n = batch_end - base;
    if (threadIdx.x < n) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        stage[r][threadIdx.x] = feat[r * row_stride + base + threadIdx.x];
      }
    }
    __syncthreads();
    // Block-uniform loop: every lane of every warp reaches the shuffles.
    for (int j = n - 1; j >= 0; --j) {
      float sx = 0.0f, sy = 0.0f, sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
      float sop = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
      bool blended = false;
      if (base + j - start < nc) {
        const float dx = __fsub_rn(stage[0][j], px);
        const float dy = __fsub_rn(stage[1][j], py);
        const float quad = __fadd_rn(__fmul_rn(stage[2][j], __fmul_rn(dx, dx)),
                                     __fmul_rn(stage[4][j], __fmul_rn(dy, dy)));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(stage[3][j], __fmul_rn(dx, dy)));
        const float gauss = expf(power);
        const float og = __fmul_rn(stage[5][j], gauss);
        const float alpha = fminf(alpha_max, og);
        if (power <= 0.0f && alpha >= alpha_min) {
          blended = true;
          const float om = __fsub_rn(1.0f, alpha);
          const float t_before = __fdiv_rn(trans, om);
          const float w = __fmul_rn(alpha, t_before);
          const float u = dr * stage[6][j] + dg * stage[7][j] + db * stage[8][j];
          const float dalpha = t_before * u - (q + ft_dft) / om;
          q += u * w;
          trans = t_before;
          sr = w * dr;
          sg = w * dg;
          sb = w * db;
          if (og < alpha_max) {
            const float dpower = dalpha * og;
            sx = dpower * dx;
            sy = dpower * dy;
            sxx = sx * dx;
            sxy = sx * dy;
            syy = sy * dy;
            sop = dalpha * gauss;
          }
        }
      }
      if (__any_sync(kFull, blended)) {
        sx = warp_sum(sx);
        sy = warp_sum(sy);
        sxx = warp_sum(sxx);
        sxy = warp_sum(sxy);
        syy = warp_sum(syy);
        sop = warp_sum(sop);
        sr = warp_sum(sr);
        sg = warp_sum(sg);
        sb = warp_sum(sb);
        if (lane == 0) {
          const float ca = stage[2][j], cb = stage[3][j], cc = stage[4][j];
          atomicAdd(&grad[0][j], -(ca * sx + cb * sy));
          atomicAdd(&grad[1][j], -(cc * sy + cb * sx));
          atomicAdd(&grad[2][j], -0.5f * sxx);
          atomicAdd(&grad[3][j], -sxy);
          atomicAdd(&grad[4][j], -0.5f * syy);
          atomicAdd(&grad[5][j], sop);
          atomicAdd(&grad[6][j], sr);
          atomicAdd(&grad[7][j], sg);
          atomicAdd(&grad[8][j], sb);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < n) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = grad[r][threadIdx.x];
        if (v != 0.0f) atomicAdd(&d_feat[r * row_stride + base + threadIdx.x], v);
        grad[r][threadIdx.x] = 0.0f;
      }
    }
    // Keeps this batch's readers of stage/grad ahead of the next batch's writes.
    __syncthreads();
  }
}

}  // namespace

// feat: (>= 9, row_stride) float32 rows in (tile, depth) order; tile_starts:
// (num_tiles + 1,) int32; d_rgb (num_tiles, 3, P), d_final_t, final_t (num_tiles, P)
// float32; n_contrib (num_tiles, P) int32. d_feat: (>= 9, row_stride) float32,
// zero-filled by the caller; rows 0:9 of the blended columns are added to. Runs on
// `stream` and does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int gsrast_blend_backward(const float* feat, long long row_stride,
                                     const int* tile_starts, int num_tiles,
                                     int grid_w, int tile_h, int tile_w,
                                     float alpha_min, float alpha_max,
                                     const float* d_rgb, const float* d_final_t,
                                     const float* final_t, const int* n_contrib,
                                     float* d_feat, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(num_tiles, (tile_h * tile_w + kThreads - 1) / kThreads);
  blend_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feat, row_stride, tile_starts, grid_w, tile_h, tile_w, alpha_min, alpha_max,
      d_rgb, d_final_t, final_t, n_contrib, d_feat);
  return static_cast<int>(cudaGetLastError());
}
