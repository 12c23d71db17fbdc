// The training loss, (1 - w) L1 + w (1 - SSIM), forward and backward, for Hopper
// (sm_90a), bound to Python through ctypes.
//
// Replaces no Pallas kernel. It stands for the reference's loss
// (gsrast_tpu/train/loss.py:43-68: `ssim`, `l1`, `rgb_loss`), which XLA fuses into the
// jitted train step, SSIM's 11x11 window filter on the TPU's convolution units. Its
// eager PyTorch form (train/loss.py::rgb_loss_torch, the plain version of both kernels
// here) runs five depthwise cuDNN convolutions forward and three backward, each after a
// copy of the (H, W, C) image into planes, with autograd's elementwise chain between.
//
// Per pixel and channel, with G the window and zero "same" padding: mu0 = G*x,
// mu1 = G*y, e00 = G*(x x), e11 = G*(y y), e01 = G*(x y); sigma = e - mu mu; S = A1 A2 /
// (B1 B2) with A1 = 2 mu0 mu1 + c1, A2 = 2 sigma01 + c2, B1 = mu0 mu0 + mu1 mu1 + c1,
// B2 = sigma00 + sigma11 + c2. The loss is (1 - w) mean|x - y| + w (1 - mean S).
// The backward: G is symmetric and zero-padded, so the filter's adjoint is the filter,
// and with N = H W C and g the incoming gradient,
//   d_x = g ((1 - w)/N sign(x - y) - w/N [G*dS/dmu0 + 2 x G*dS/de00 + y G*dS/de01]),
//   dS/dmu0 = 2 mu1 (A2 - A1)/(B1 B2) + 2 mu0 S (1/B2 - 1/B1), dS/de00 = -S/B2,
//   dS/de01 = 2 A1/(B1 B2).
//
// What bounds it on this card: operations, narrowly. At 1920x1080x3 the forward reads
// x and y once (49.8 MB, 0.015 ms at 3.35 TB/s) and does about 245 float operations a
// value (two 11-tap passes of five quantities, the products, S and |x - y|), 1.5 GFLOP,
// 0.023 ms at 67 TFLOP/s; the backward reads x and y and writes d_x (74.6 MB, 0.022 ms)
// and does about 395 a value (the forward's recomputed, three more filtered maps),
// 2.5 GFLOP, 0.037 ms.
//
// The design:
// - The filter is separable: a horizontal 11-tap pass over a tile and its halo in shared
//   memory, then a vertical one, for the five quantities at once. The taps are the
//   float32 values of the reference window's float64 g
//   (train/loss.py::_gaussian_taps, read from device memory once a block); the
//   reference's 2-D window is float32(g_i g_j), and the two passes weigh a pixel by g_i
//   and g_j in turn, which differs from it by at most 1.2 ulps a tap (1.18 at the
//   largest).
// - One block a tile, 256 threads, over all C channels in turn: a channel's plane of x
//   and y is read into shared memory, zero outside the image (SAME zero padding at
//   every edge), from any strides: the (H, W, C) rows of a crop, or the channel planes
//   the render assembles (render/tiled.py::untile_cf), which it reads coalesced.
//   Consecutive threads take consecutive columns in every pass, so shared-memory reads
//   are conflict-free.
// - The forward: tiles of 32x32 with a 5-pixel halo. Each block writes one partial sum
//   of S and of |x - y|; a second launch of one block sums the partials in a fixed order
//   (float64) and writes (1 - w) l1 + w (1 - ssim), in the reference's order and float32
//   rounding, to a 0-d tensor. No float atomics anywhere: two launches give the same
//   bits, and a CUDA graph's replay gives an eager step's.
// - The backward recomputes: tiles of 16x32 with a 10-pixel halo of x and y, the five
//   filtered maps and then dS/dmu0, dS/de00 and dS/de01 on the tile and a 5-pixel halo
//   (zero outside the image, where the adjoint's padding is), those three filtered the
//   same way, and d_x written once. Nothing is kept between forward and backward.
// - Graph-safe: no allocation and no host synchronisation; w, the shape and C are host
//   values, fixed per capture; the taps and the incoming gradient are read from device
//   memory.
//
// Rounding: S is formed in the reference's forms and order (sigma as E[x x] - mu mu,
// then the two factors of each of the numerator and the denominator), each operation
// rounded as the plain version rounds it (the _rn intrinsics, never contracted into
// fused multiply-adds; the division is IEEE). The filter's sums are taken in another
// order than cuDNN's, and the backward's arithmetic may contract: both kernels are held
// to the plain version within a tolerance anchored on a float64 run of it.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

constexpr float kC1 = 0.0001f;  // 0.01 ** 2, as PyTorch rounds the Python scalar
constexpr float kC2 = 0.0009f;  // 0.03 ** 2

// The forward's tile, and its input with the halo.
constexpr int kFwdH = 32, kFwdW = 32;
constexpr int kFwdInH = kFwdH + 2 * kRadius, kFwdInW = kFwdW + 2 * kRadius;
// The backward's tile; its input with a halo of two radii; the region of the dS maps
// (the tile and one radius).
constexpr int kBwdH = 16, kBwdW = 32;
constexpr int kBwdInH = kBwdH + 4 * kRadius, kBwdInW = kBwdW + 4 * kRadius;
constexpr int kMidH = kBwdH + 2 * kRadius, kMidW = kBwdW + 2 * kRadius;

// One (H, W, C) float32 image, with its strides in elements: the (H, W, C) rows of an
// image a view crops, or the channel planes the render assembles.
template <typename T>
struct Strided {
  T* data;
  long long row, pixel, channel;
};
using Image = Strided<const float>;

struct Shape {
  int height, width, channels;
};

__device__ __forceinline__ bool inside(const Shape s, int row, int col) {
  return row >= 0 && row < s.height && col >= 0 && col < s.width;
}

template <typename T>
__device__ __forceinline__ T& at(const Strided<T> im, int row, int col, int ch) {
  return im.data[row * im.row + col * im.pixel + ch * im.channel];
}

// Channel `ch` of x and y over rows [row0, row0 + rows) and columns [col0, col0 + cols)
// into the planes sx and sy (rows x cols, row-major), zero outside the image.
__device__ void load_planes(const Image x, const Image y, const Shape s, int ch, int row0,
                            int col0, int rows, int cols, float* sx, float* sy) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int row = row0 + i / cols, col = col0 + i % cols;
    const bool in = inside(s, row, col);
    sx[i] = in ? at(x, row, col, ch) : 0.0f;
    sy[i] = in ? at(y, row, col, ch) : 0.0f;
  }
}

// The horizontal pass of x, y, x x, y y and x y over the planes sx and sy (rows x
// cols): five planes of rows x (cols - 2 kRadius) into h, in that order.
__device__ void moments_rows(const float* sx, const float* sy, int rows, int cols,
                             const float* g, float* h) {
  const int out_cols = cols - 2 * kRadius, plane = rows * out_cols;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int r = i / out_cols, c = i % out_cols;
    const float* px = sx + r * cols + c;
    const float* py = sy + r * cols + c;
    float m0 = 0.0f, m1 = 0.0f, m00 = 0.0f, m11 = 0.0f, m01 = 0.0f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const float a = px[t], b = py[t], w = g[t];
      m0 += w * a;
      m1 += w * b;
      m00 += w * __fmul_rn(a, a);  // the product rounded, as the plain version's
      m11 += w * __fmul_rn(b, b);
      m01 += w * __fmul_rn(a, b);
    }
    h[i] = m0;
    h[plane + i] = m1;
    h[2 * plane + i] = m00;
    h[3 * plane + i] = m11;
    h[4 * plane + i] = m01;
  }
}

// The horizontal pass of K planes of rows x cols: K planes of rows x (cols - 2 kRadius)
// into dst.
template <int K>
__device__ void filter_rows(const float* src, int rows, int cols, const float* g,
                           float* dst) {
  const int out_cols = cols - 2 * kRadius, plane = rows * out_cols;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int r = i / out_cols, c = i % out_cols;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const float w = g[t];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += w * src[k * rows * cols + r * cols + c + t];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k * plane + i] = acc[k];
  }
}

// The vertical pass at row r, column c of K planes of rows x cols.
template <int K>
__device__ __forceinline__ void filter_column(const float* src, int rows, int cols, int r,
                                              int c, const float* g, float* out) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.0f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float w = g[t];
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] += w * src[k * rows * cols + (r + t) * cols + c];
  }
}

// S and its factors from the five filtered values (mu0, mu1, e00, e11, e01), in the
// reference's forms and order.
struct Ssim {
  float s, a1, a2, b1, b2;
};

__device__ __forceinline__ Ssim ssim_terms(const float* m) {
  const float mu00 = __fmul_rn(m[0], m[0]), mu11 = __fmul_rn(m[1], m[1]),
              mu01 = __fmul_rn(m[0], m[1]);
  const float s00 = __fsub_rn(m[2], mu00), s11 = __fsub_rn(m[3], mu11),
              s01 = __fsub_rn(m[4], mu01);
  Ssim t;
  t.a1 = __fadd_rn(__fmul_rn(2.0f, mu01), kC1);
  t.a2 = __fadd_rn(__fmul_rn(2.0f, s01), kC2);
  t.b1 = __fadd_rn(__fadd_rn(mu00, mu11), kC1);
  t.b2 = __fadd_rn(__fadd_rn(s00, s11), kC2);
  t.s = __fdiv_rn(__fmul_rn(t.a1, t.a2), __fmul_rn(t.b1, t.b2));
  return t;
}

// Sums a[0..n) and b[0..n) of shared memory into a[0] and b[0], in a fixed order
// (n a power of two, every thread of the block calling).
__device__ void block_sum(double* a, double* b, int n) {
  __syncthreads();
  for (int half = n / 2; half > 0; half /= 2) {
    if (static_cast<int>(threadIdx.x) < half) {
      a[threadIdx.x] += a[threadIdx.x + half];
      b[threadIdx.x] += b[threadIdx.x + half];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_forward_kernel(const Image x, const Image y, const Shape s,
                        const float* __restrict__ taps, double2* __restrict__ partials) {
  __shared__ float g[kTaps];
  __shared__ float sx[kFwdInH * kFwdInW], sy[kFwdInH * kFwdInW];
  __shared__ float h[5 * kFwdInH * kFwdW];
  __shared__ double red_s[kThreads], red_l1[kThreads];
  for (int t = threadIdx.x; t < kTaps; t += blockDim.x) g[t] = taps[t];
  const int row0 = blockIdx.y * kFwdH, col0 = blockIdx.x * kFwdW;
  double sum_s = 0.0, sum_l1 = 0.0;  // float64 from the first value on
  for (int ch = 0; ch < s.channels; ++ch) {
    __syncthreads();  // g written; the last channel's planes read
    load_planes(x, y, s, ch, row0 - kRadius, col0 - kRadius, kFwdInH, kFwdInW, sx, sy);
    __syncthreads();
    moments_rows(sx, sy, kFwdInH, kFwdInW, g, h);
    __syncthreads();
    for (int i = threadIdx.x; i < kFwdH * kFwdW; i += blockDim.x) {
      const int r = i / kFwdW, c = i % kFwdW;
      if (!inside(s, row0 + r, col0 + c)) continue;
      float m[5];
      filter_column<5>(h, kFwdInH, kFwdW, r, c, g, m);
      sum_s += ssim_terms(m).s;
      const int j = (r + kRadius) * kFwdInW + c + kRadius;
      sum_l1 += fabsf(__fsub_rn(sx[j], sy[j]));
    }
  }
  red_s[threadIdx.x] = sum_s;
  red_l1[threadIdx.x] = sum_l1;
  block_sum(red_s, red_l1, blockDim.x);
  if (threadIdx.x == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = make_double2(red_s[0], red_l1[0]);
}

__global__ void __launch_bounds__(kSumThreads)
    loss_sum_kernel(const double2* __restrict__ partials, int count, long long n_values,
                    float weight, float one_minus_weight, float* __restrict__ loss) {
  __shared__ double red_s[kSumThreads], red_l1[kSumThreads];
  double sum_s = 0.0, sum_l1 = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    sum_s += partials[i].x;
    sum_l1 += partials[i].y;
  }
  red_s[threadIdx.x] = sum_s;
  red_l1[threadIdx.x] = sum_l1;
  block_sum(red_s, red_l1, blockDim.x);
  if (threadIdx.x == 0) {
    const float ssim = static_cast<float>(red_s[0] / static_cast<double>(n_values));
    const float l1 = static_cast<float>(red_l1[0] / static_cast<double>(n_values));
    *loss = __fadd_rn(__fmul_rn(one_minus_weight, l1),
                      __fmul_rn(weight, __fsub_rn(1.0f, ssim)));
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_backward_kernel(const Image x, const Image y, const Shape s,
                         const float* __restrict__ taps, float l1_coef, float ssim_coef,
                         const float* __restrict__ grad, const Strided<float> d_x) {
  __shared__ float g[kTaps];
  // The planes of x and y; then the three dS maps on the tile and one radius.
  __shared__ float planes[2 * kBwdInH * kBwdInW];
  // The five maps' horizontal pass; then the dS maps'.
  __shared__ float h[5 * kBwdInH * kMidW];
  static_assert(3 * kMidH * kMidW <= 2 * kBwdInH * kBwdInW, "dS maps overflow");
  float* sx = planes;
  float* sy = planes + kBwdInH * kBwdInW;
  float* ds = planes;
  for (int t = threadIdx.x; t < kTaps; t += blockDim.x) g[t] = taps[t];
  const float scale = *grad;
  const int row0 = blockIdx.y * kBwdH, col0 = blockIdx.x * kBwdW;
  constexpr int kMid = kMidH * kMidW;
  for (int ch = 0; ch < s.channels; ++ch) {
    __syncthreads();  // g written; the last channel's maps read
    load_planes(x, y, s, ch, row0 - 2 * kRadius, col0 - 2 * kRadius, kBwdInH, kBwdInW,
                sx, sy);
    __syncthreads();
    moments_rows(sx, sy, kBwdInH, kBwdInW, g, h);
    __syncthreads();
    for (int i = threadIdx.x; i < kMid; i += blockDim.x) {
      const int r = i / kMidW, c = i % kMidW;
      float d_mu0 = 0.0f, d_e00 = 0.0f, d_e01 = 0.0f;
      if (inside(s, row0 - kRadius + r, col0 - kRadius + c)) {
        float m[5];
        filter_column<5>(h, kBwdInH, kMidW, r, c, g, m);
        const Ssim t = ssim_terms(m);
        const float inv = 1.0f / (t.b1 * t.b2);
        d_mu0 = 2.0f * m[1] * (t.a2 - t.a1) * inv +
                2.0f * m[0] * t.s * (1.0f / t.b2 - 1.0f / t.b1);
        d_e00 = -t.s / t.b2;
        d_e01 = 2.0f * t.a1 * inv;
      }
      ds[i] = d_mu0;
      ds[kMid + i] = d_e00;
      ds[2 * kMid + i] = d_e01;
    }
    __syncthreads();
    filter_rows<3>(ds, kMidH, kMidW, g, h);
    __syncthreads();
    for (int i = threadIdx.x; i < kBwdH * kBwdW; i += blockDim.x) {
      const int r = i / kBwdW, c = i % kBwdW, row = row0 + r, col = col0 + c;
      if (!inside(s, row, col)) continue;
      float v[3];
      filter_column<3>(h, kMidH, kBwdW, r, c, g, v);
      const float a = at(x, row, col, ch);
      const float b = at(y, row, col, ch);
      const float diff = a - b;
      const float sign = static_cast<float>((diff > 0.0f) - (diff < 0.0f));
      at(d_x, row, col, ch) =
          scale * (l1_coef * sign - ssim_coef * (v[0] + 2.0f * a * v[1] + b * v[2]));
    }
  }
}

dim3 forward_grid(int height, int width) {
  return dim3((width + kFwdW - 1) / kFwdW, (height + kFwdH - 1) / kFwdH);
}

}  // namespace

// The number of partial sums (float64 pairs) that gsrast_loss_forward's scratch holds
// for an image of height x width.
extern "C" int gsrast_loss_partials(int height, int width) {
  const dim3 grid = forward_grid(height, width);
  return static_cast<int>(grid.x * grid.y);
}

// pred and target (height, width, channels) float32, each with its three strides in
// elements (any: a crop's rows, the render's channel planes); taps (11,) float32.
// Writes (1 - w) mean|pred - target| + w (1 - mean S) to loss (a float32 scalar),
// through `partials` (gsrast_loss_partials(height, width) float64 pairs of scratch);
// weight and one_minus_weight are w and 1 - w rounded to float32. Runs on `stream`
// without synchronising; returns cudaGetLastError() after the launches.
extern "C" int gsrast_loss_forward(const float* pred, long long pred_s0,
                                   long long pred_s1, long long pred_s2,
                                   const float* target,
                                   long long target_s0, long long target_s1,
                                   long long target_s2, int height, int width,
                                   int channels, const float* taps, float weight,
                                   float one_minus_weight, double* partials, float* loss,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = forward_grid(height, width);
  auto* sums = reinterpret_cast<double2*>(partials);
  loss_forward_kernel<<<grid, kThreads, 0, st>>>(
      Image{pred, pred_s0, pred_s1, pred_s2},
      Image{target, target_s0, target_s1, target_s2}, Shape{height, width, channels},
      taps, sums);
  loss_sum_kernel<<<1, kSumThreads, 0, st>>>(
      sums, static_cast<int>(grid.x * grid.y),
      static_cast<long long>(height) * width * channels, weight, one_minus_weight, loss);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs, l1_coef = (1 - w)/N and ssim_coef = w/N (N = height width
// channels) rounded to float32, and grad, the loss's incoming gradient (a float32
// scalar in device memory). Writes every element of d_pred (height, width, channels),
// with its three strides in elements (not overlapping). Runs on `stream` without
// synchronising; returns cudaGetLastError() after the launch.
extern "C" int gsrast_loss_backward(const float* pred, long long pred_s0,
                                    long long pred_s1, long long pred_s2,
                                    const float* target, long long target_s0,
                                    long long target_s1, long long target_s2, int height,
                                    int width, int channels, const float* taps,
                                    float l1_coef, float ssim_coef, const float* grad,
                                    float* d_pred, long long d_pred_s0,
                                    long long d_pred_s1, long long d_pred_s2,
                                    void* stream) {
  const dim3 grid((width + kBwdW - 1) / kBwdW, (height + kBwdH - 1) / kBwdH);
  loss_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Image{pred, pred_s0, pred_s1, pred_s2},
      Image{target, target_s0, target_s1, target_s2}, Shape{height, width, channels},
      taps, l1_coef, ssim_coef, grad,
      Strided<float>{d_pred, d_pred_s0, d_pred_s1, d_pred_s2});
  return static_cast<int>(cudaGetLastError());
}
