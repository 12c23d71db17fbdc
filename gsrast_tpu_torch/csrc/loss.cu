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
//   dS/de01 = 2 A1/(B1 B2),
// and sign(0) = 1: the reference's jax.grad of |x - y| takes 1 where x equals y.
//
// What bounds it on this card: operations. At 1920x1080x3 the forward reads x and y once
// (49.8 MB, 0.015 ms at 3.35 TB/s) and does about 246 float operations a value (two
// 11-tap passes of five quantities, the products, S and |x - y|), 1.5 GFLOP, 0.023 ms
// at 67 TFLOP/s; the backward reads x and y and writes d_x (74.6 MB, 0.022 ms) and does
// about 402 a value (the forward's recomputed, three more filtered maps), 2.5 GFLOP,
// 0.037 ms. The FMAs are the work; every other instruction (a shared-memory access, an
// address, a copy) takes an issue slot from them.
//
// The design, to spend the issue slots on FMAs:
// - A block owns a strip of columns of one channel and walks down a segment of its
//   rows, kRows (11) at a time. Each step stages the next 11 rows of x and y (the strip
//   and its halo) into dynamic shared memory by 4-byte cp.async, double-buffered, from
//   any strides: the (H, W, C) rows of a crop, or the channel planes the render
//   assembles (render/tiled.py::untile_cf). A warp copies consecutive pixels of a row;
//   outside the image (SAME padding at every edge) the copy's source size is 0 bytes,
//   which fills a zero, from an address clamped into the image: one instruction a value
//   and no branch (a copy or a store behind a branch cost ~35 instructions a value, the
//   zero-fill size through cuda_pipeline.h's switch ~45).
// - The horizontal 11-tap pass: a thread takes 8 consecutive outputs of a row, reads
//   its 18 inputs of x and y with 16-byte loads, forms x x, y y and x y once an input
//   (__fmul_rn, as the plain version rounds them) and filters the five quantities into
//   shared planes.
// - The vertical pass: one thread a column. Each thread keeps the last 11 rows of its
//   column's five horizontal sums in a ring of registers, indexed by the row modulo 11
//   (the 11-row step is unrolled, so every index is a constant), and filters them once
//   a row: each value is read from shared memory once. The rows above a segment are
//   paid once a segment, not once a tile.
// - The forward's strip is 128 columns (one thread each, the horizontal pass reading
//   138). Each block sums S (vertical pass) and |x - y| (horizontal pass, at the
//   centres) in float64, from float sums of at most 11 (a step's rows of S, a span's
//   8 of |x - y|: a float64 conversion and add a value took issue slots the FMAs
//   need), and writes one pair; a second launch of one block sums the
//   pairs in a fixed order and writes (1 - w) l1 + w (1 - ssim), in the reference's
//   order and float32 rounding, to a 0-d tensor. No float atomics: two launches give
//   the same bits, and a CUDA graph's replay gives an eager step's.
// - The backward recomputes. Its strip is 118 output columns: the moments and the three
//   dS maps on 128 columns (the strip and a 5-pixel ring), from 138 staged ones; each
//   11-row step filters the step's dS rows horizontally (three quantities, 8 outputs a
//   thread) and vertically (a second register ring of three), and writes d_x once, in
//   pred's layout. The dS terms take two approximate reciprocals (__fdividef, within 2
//   ulps: B1 >= c1 and B2 near c2 or more keep them in its range) where the plain
//   version divides four times. The outputs' own x and y are read from device memory
//   (their staged rows are overwritten by then), all 11 rows' loads issued before the
//   dS maps' horizontal pass hides their latency. Nothing is kept between forward and
//   backward: saving the dS maps
//   would move 149 MB more a 1080p step, more than the recompute's operations bound.
// - The segment height is the host's choice per shape (plan()): of the heights that
//   make whole 11-row steps, the one whose blocks fill the card's resident slots in
//   the fewest steps (waves x steps a block), so a 512x512 image still fills the card.
// - Graph-safe: no allocation and no host synchronisation; w, the shape and C are host
//   values, fixed per capture; the taps (read once a thread into registers) and the
//   incoming gradient are read from device memory.
//
// Rounding: S is formed in the reference's forms and order (sigma as E[x x] - mu mu,
// then the two factors of each of the numerator and the denominator), each operation
// rounded as the plain version rounds it (the _rn intrinsics, never contracted into
// fused multiply-adds; the division is IEEE). The filter's taps are the float32 values
// of the reference window's float64 g (train/loss.py::_gaussian_taps); the reference's
// 2-D window is float32(g_i g_j), which the two passes' g_i then g_j differ from by at
// most 1.2 ulps a tap. The filter's sums are taken in tap order, in another order than
// cuDNN's, and the backward's arithmetic may contract: both kernels are held to the
// plain version within a tolerance anchored on a float64 run of it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
// Rows a step: the period of the vertical passes' register rings.
constexpr int kRows = kTaps;
// A block: one thread a column of moments, a strip of kCols of them.
constexpr int kThreads = 128;
constexpr int kCols = kThreads;
constexpr int kIn = kCols + 2 * kRadius;       // staged columns a row
constexpr int kInStride = 140;                 // ... padded to whole 16 bytes
constexpr int kSpan = 8;                       // horizontal outputs a thread item
constexpr int kSpanIn = kSpan + 2 * kRadius;   // ... and the inputs they read
constexpr int kFwdCols = kCols;                // output columns a strip
constexpr int kBwdCols = kCols - 2 * kRadius;
constexpr int kBwdSpans = (kBwdCols + kSpan - 1) / kSpan;
constexpr int kDsStride = 132;  // a dS row: kCols, padded for the last span's reads
constexpr int kHdStride = kBwdSpans * kSpan;  // a row of the dS maps' horizontal pass
// Rows a segment's input adds to its outputs: the forward's moments need 5 above and
// below; the backward's dS maps 5 more.
constexpr int kFwdHalo = 2 * kRadius, kBwdHalo = 4 * kRadius;
constexpr int kMaxSteps = 32;  // the longest segment plan() considers, in steps
constexpr int kSumThreads = 1024;

constexpr float kC1 = 0.0001f;  // 0.01 ** 2, as PyTorch rounds the Python scalar
constexpr float kC2 = 0.0009f;  // 0.03 ** 2

// Dynamic shared memory, in floats: two slots of staged rows (x's, then y's); the five
// horizontal planes (reused by the backward for its dS maps' horizontal pass, and by
// the forward for its float64 block sum); the backward's three dS planes.
constexpr int kStageFloats = 2 * kRows * kInStride;
constexpr int kPlaneFloats = 5 * kRows * kCols;
constexpr int kDsFloats = 3 * kRows * kDsStride;
constexpr size_t kFwdShared = sizeof(float) * (2 * kStageFloats + kPlaneFloats);
constexpr size_t kBwdShared = kFwdShared + sizeof(float) * kDsFloats;
static_assert(kInStride % 4 == 0 && kInStride >= kIn, "staged rows");
static_assert(kDsStride % 4 == 0 && kDsStride >= kHdStride + 2 * kRadius, "dS rows");
static_assert(kHdStride % 4 == 0 && 3 * kRows * kHdStride <= kPlaneFloats, "dS sums");
static_assert(2 * kThreads * sizeof(double) <= sizeof(float) * kPlaneFloats, "sums");
static_assert(kCols % kSpan == 0 && kSpanIn % 2 == 0, "spans");

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

template <typename T>
__device__ __forceinline__ T& at(const Strided<T> im, int row, int col, int ch) {
  return im.data[row * im.row + col * im.pixel + ch * im.channel];
}

// One float of device memory at src into shared memory at dst by cp.async, or a zero
// where `in` is false (a source size of 0 bytes): one instruction, no branch. src must
// be a valid address either way.
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src, bool in) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
#else
  *dst = in ? *src : 0.0f;
#endif
}

// Rows [row0, row0 + kRows) and columns [col0, col0 + kIn) of channel ch of x and y
// into dst by cp.async (not waited for): x's rows, then y's, kInStride floats apart;
// zero outside the image, whose addresses are clamped into it. Thread t copies columns
// t, t + kThreads, ...: a warp reads consecutive pixels of a row.
__device__ void stage_rows(const Image x, const Image y, const Shape s, int ch, int row0,
                           int col0, float* dst) {
  for (int c = threadIdx.x; c < kIn; c += blockDim.x) {
    const int col = col0 + c;
    const bool col_in = col >= 0 && col < s.width;
    const int cc = min(max(col, 0), s.width - 1);
    const float* px = x.data + cc * x.pixel + ch * x.channel;
    const float* py = y.data + cc * y.pixel + ch * y.channel;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r, rr = min(max(row, 0), s.height - 1);
      const bool in = col_in && row == rr;
      copy_or_zero(dst + r * kInStride + c, px + rr * x.row, in);
      copy_or_zero(dst + (kRows + r) * kInStride + c, py + rr * y.row, in);
    }
  }
}

// N floats of shared memory from p (16-byte aligned) into v, 16 bytes a load.
template <int N>
__device__ __forceinline__ void load_span(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i + 4 <= N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
  if constexpr (N % 4 == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p + N - 2);
    v[N - 2] = q.x;
    v[N - 1] = q.y;
  }
}

// kSpan floats from v into shared memory at p (16-byte aligned).
__device__ __forceinline__ void store_span(float* p, const float (&v)[kSpan]) {
#pragma unroll
  for (int i = 0; i < kSpan; i += 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// The horizontal pass of one span: out[o] = sum_t g[t] v(o + t), each sum's terms in
// tap order, into shared memory at p; v(t) is formed once an input.
template <typename Value>
__device__ __forceinline__ void filter_span(const float (&g)[kTaps], float* p, Value v) {
  float out[kSpan];
#pragma unroll
  for (int o = 0; o < kSpan; ++o) out[o] = 0.0f;
#pragma unroll
  for (int t = 0; t < kSpanIn; ++t) {
    const float x = v(t);
#pragma unroll
    for (int o = 0; o < kSpan; ++o) {
      if (t - o >= 0 && t - o < kTaps) out[o] += g[t - o] * x;
    }
  }
  store_span(p, out);
}

// The horizontal pass of x, y, x x, y y and x y over one slot of staged rows: five
// planes of kRows x kCols into h, in that order; the products rounded as the plain
// version rounds them. centre(r, j, a, b) sees each span's inputs (row r, outputs from
// column j kSpan; the output o's own pixel at o + kRadius).
template <typename Centre>
__device__ void moments_rows(const float* staged, const float (&g)[kTaps], float* h,
                             Centre centre) {
  constexpr int kSpans = kCols / kSpan, kPlane = kRows * kCols;
  for (int item = threadIdx.x; item < kRows * kSpans; item += blockDim.x) {
    const int r = item / kSpans, j = item % kSpans;
    float a[kSpanIn], b[kSpanIn];
    load_span(staged + r * kInStride + j * kSpan, a);
    load_span(staged + (kRows + r) * kInStride + j * kSpan, b);
    float* out = h + r * kCols + j * kSpan;
    filter_span(g, out, [&](int t) { return a[t]; });
    filter_span(g, out + kPlane, [&](int t) { return b[t]; });
    filter_span(g, out + 2 * kPlane, [&](int t) { return __fmul_rn(a[t], a[t]); });
    filter_span(g, out + 3 * kPlane, [&](int t) { return __fmul_rn(b[t], b[t]); });
    filter_span(g, out + 4 * kPlane, [&](int t) { return __fmul_rn(a[t], b[t]); });
    centre(r, j, a, b);
  }
}

// The vertical pass's sum at the ring's newest row i (mod kRows): the taps over the
// last kRows rows, oldest first (each sum's terms in tap order).
__device__ __forceinline__ float filter_ring(const float (&ring)[kRows], int i,
                                             const float (&g)[kTaps]) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc += g[t] * ring[(i + 1 + t) % kRows];
  return acc;
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

// The rows of a block's segment, [r0, r_end), and its 11-row steps: a segment's input
// is its rows and `halo` more, half above and half below.
struct Segment {
  int r0, r_end, steps;
};

__device__ __forceinline__ Segment segment(const Shape s, int rows, int halo) {
  Segment seg;
  seg.r0 = blockIdx.y * rows;
  seg.r_end = min(seg.r0 + rows, s.height);
  seg.steps = (seg.r_end - seg.r0 + halo + kRows - 1) / kRows;
  return seg;
}

// Stages step n + 1 of a segment whose input starts at row0 (if there is one) and
// waits for step n's rows: every step's copies are one cp.async group.
__device__ __forceinline__ void next_step(const Image x, const Image y, const Shape s,
                                          int ch, int row0, int col0, int n, int steps,
                                          float* stage) {
  if (n + 1 < steps) {
    stage_rows(x, y, s, ch, row0 + (n + 1) * kRows, col0,
               stage + ((n + 1) & 1) * kStageFloats);
    __pipeline_commit();
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  __syncthreads();
}

extern __shared__ float4 loss_shared[];

// Block (strip, segment, channel): the segment's input rows start kRadius above it,
// column c of the moments is the image's column c0 + c.
__global__ void __launch_bounds__(kThreads, 4)
    loss_forward_kernel(const Image x, const Image y, const Shape s, int rows,
                        const float* __restrict__ taps, double2* __restrict__ partials) {
  float* stage = reinterpret_cast<float*>(loss_shared);
  float* h = stage + 2 * kStageFloats;
  float g[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) g[t] = taps[t];
  const int ch = blockIdx.z, c0 = blockIdx.x * kFwdCols;
  const Segment seg = segment(s, rows, kFwdHalo);
  const int row0 = seg.r0 - kRadius;  // the staged rows' first
  const bool col_in = c0 + static_cast<int>(threadIdx.x) < s.width;
  double sum_s = 0.0, sum_l1 = 0.0;  // float64 over float sums of at most 11
  float ring[5][kRows];
  stage_rows(x, y, s, ch, row0, c0 - kRadius, stage);
  __pipeline_commit();
  for (int n = 0; n < seg.steps; ++n) {
    next_step(x, y, s, ch, row0, c0 - kRadius, n, seg.steps, stage);
    moments_rows(stage + (n & 1) * kStageFloats, g, h,
                 [&](int r, int j, const float (&a)[kSpanIn], const float (&b)[kSpanIn]) {
                   const int row = row0 + n * kRows + r;
                   if (row < seg.r0 || row >= seg.r_end) return;
                   float l1 = 0.0f;
#pragma unroll
                   for (int o = 0; o < kSpan; ++o) {
                     if (c0 + j * kSpan + o < s.width) {
                       l1 += fabsf(__fsub_rn(a[o + kRadius], b[o + kRadius]));
                     }
                   }
                   sum_l1 += l1;
                 });
    __syncthreads();
    float step_s = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int q = 0; q < 5; ++q) ring[q][i] = h[(q * kRows + i) * kCols + threadIdx.x];
      // Once the ring holds 11 rows, its centre is the output row row0 + k - kRadius.
      const int k = n * kRows + i;
      if (k >= 2 * kRadius && seg.r0 + k - 2 * kRadius < seg.r_end && col_in) {
        float m[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) m[q] = filter_ring(ring[q], i, g);
        step_s += ssim_terms(m).s;
      }
    }
    sum_s += step_s;
  }
  __syncthreads();  // the planes' last reads done: they take the block's sums
  double* red = reinterpret_cast<double*>(h);
  red[threadIdx.x] = sum_s;
  red[kThreads + threadIdx.x] = sum_l1;
  block_sum(red, red + kThreads, kThreads);
  if (threadIdx.x == 0) {
    partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        make_double2(red[0], red[kThreads]);
  }
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

// The horizontal pass of the three dS planes (kRows x kDsStride) into kRows x
// kHdStride planes at hd.
__device__ void filter_ds_rows(const float* ds, const float (&g)[kTaps], float* hd) {
  for (int item = threadIdx.x; item < kRows * kBwdSpans; item += blockDim.x) {
    const int r = item / kBwdSpans, j = item % kBwdSpans;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float v[kSpanIn];
      load_span(ds + (q * kRows + r) * kDsStride + j * kSpan, v);
      filter_span(g, hd + (q * kRows + r) * kHdStride + j * kSpan,
                  [&](int t) { return v[t]; });
    }
  }
}

// Block (strip, segment, channel): the segment's input rows start 2 kRadius above it;
// column c of the moments and dS maps is the image's column c0 - kRadius + c, output
// column c (c < kBwdCols) the image's c0 + c. Step n's row i is the input's row
// k = n kRows + i; the moments' ring is then centred on dS row d = k - 2 kRadius (the
// image's row r0 - kRadius + d), and the dS maps' ring on output row d - 2 kRadius.
__global__ void __launch_bounds__(kThreads, 3)
    loss_backward_kernel(const Image x, const Image y, const Shape s, int rows,
                         const float* __restrict__ taps, float l1_coef, float ssim_coef,
                         const float* __restrict__ grad, const Strided<float> d_x) {
  float* stage = reinterpret_cast<float*>(loss_shared);
  float* h = stage + 2 * kStageFloats;  // the moments' horizontal planes, then dS's
  float* ds = h + kPlaneFloats;
  float g[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) g[t] = taps[t];
  const float scale = *grad;
  const int ch = blockIdx.z, c0 = blockIdx.x * kBwdCols, c = threadIdx.x;
  const Segment seg = segment(s, rows, kBwdHalo);
  const int row0 = seg.r0 - 2 * kRadius;  // the staged rows' first
  const int mid_col = c0 - kRadius + c, col = c0 + c;
  const bool mid_col_in = mid_col >= 0 && mid_col < s.width;
  const bool out_col = c < kBwdCols && col < s.width;
  float ring[5][kRows], ring_ds[3][kRows];
  stage_rows(x, y, s, ch, row0, c0 - 2 * kRadius, stage);
  __pipeline_commit();
  for (int n = 0; n < seg.steps; ++n) {
    next_step(x, y, s, ch, row0, c0 - 2 * kRadius, n, seg.steps, stage);
    moments_rows(stage + (n & 1) * kStageFloats, g, h,
                 [](int, int, const float (&)[kSpanIn], const float (&)[kSpanIn]) {});
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int q = 0; q < 5; ++q) ring[q][i] = h[(q * kRows + i) * kCols + c];
      const int k = n * kRows + i, mid_row = row0 + k - kRadius;
      float d_mu0 = 0.0f, d_e00 = 0.0f, d_e01 = 0.0f;  // zero outside the image
      if (k >= 2 * kRadius && mid_row >= 0 && mid_row < s.height && mid_col_in) {
        float m[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) m[q] = filter_ring(ring[q], i, g);
        const Ssim t = ssim_terms(m);
        const float r1 = __fdividef(1.0f, t.b1), r2 = __fdividef(1.0f, t.b2);
        const float inv = r1 * r2;
        d_mu0 = 2.0f * m[1] * (t.a2 - t.a1) * inv + 2.0f * m[0] * t.s * (r2 - r1);
        d_e00 = -t.s * r2;
        d_e01 = 2.0f * t.a1 * inv;
      }
      ds[i * kDsStride + c] = d_mu0;
      ds[(kRows + i) * kDsStride + c] = d_e00;
      ds[(2 * kRows + i) * kDsStride + c] = d_e01;
    }
    __syncthreads();
    // The step's output pixels of x and y, loaded (clamped into the image, so that
    // every load is unconditional) ahead of the pass that hides their latency.
    float xo[kRows], yo[kRows];
    const int out_c = min(col, s.width - 1);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = min(max(row0 + n * kRows + i - 2 * kRadius, 0), s.height - 1);
      xo[i] = at(x, row, out_c, ch);
      yo[i] = at(y, row, out_c, ch);
    }
    filter_ds_rows(ds, g, h);
    __syncthreads();
    if (c >= kBwdCols) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) ring_ds[q][i] = h[(q * kRows + i) * kHdStride + c];
      const int k = n * kRows + i, row = row0 + k - 2 * kRadius;
      if (k >= 4 * kRadius && row < seg.r_end && out_col) {
        float v[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) v[q] = filter_ring(ring_ds[q], i, g);
        const float a = xo[i], b = yo[i];
        const float sign = __fsub_rn(a, b) >= 0.0f ? 1.0f : -1.0f;  // jax.grad's |.|'
        at(d_x, row, col, ch) =
            scale * (l1_coef * sign - ssim_coef * (v[0] + 2.0f * a * v[1] + b * v[2]));
      }
    }
  }
}

// A kernel's launch over an (H, W, C) image: the grid of (strips, segments, C) blocks
// and the segment's rows.
struct Plan {
  dim3 grid;
  int rows;
  size_t shared;
};

// The kernel's dynamic shared memory allowed, and the plan of `cols`-column strips
// whose segments take whole 11-row steps (with `halo` input rows beyond their own): of
// up to kMaxSteps steps, the one that makes the fewest steps a block times waves of the
// card's resident blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor times its
// SMs), the shorter on a tie.
template <typename Kernel>
cudaError_t plan(Kernel kernel, size_t shared, int cols, int halo, int height, int width,
                 int channels, Plan* p) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(shared));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared);
  }
  if (e != cudaSuccess) return e;
  if (height < 1 || width < 1 || channels < 1 || per_sm < 1) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int strips = (width + cols - 1) / cols;
  long long best = -1;
  for (int steps = (halo + kRows) / kRows; steps <= kMaxSteps; ++steps) {
    const int rows = steps * kRows - halo;
    const int segments = (height + rows - 1) / rows;
    const long long blocks = static_cast<long long>(strips) * segments * channels;
    const long long cost = (blocks + slots - 1) / slots * steps;
    if (best < 0 || cost < best) {
      best = cost;
      p->grid = dim3(strips, segments, channels);
      p->rows = rows;
    }
    if (segments == 1) break;
  }
  p->shared = shared;
  return cudaSuccess;
}

cudaError_t forward_plan(int height, int width, int channels, Plan* p) {
  return plan(loss_forward_kernel, kFwdShared, kFwdCols, kFwdHalo, height, width,
              channels, p);
}

cudaError_t backward_plan(int height, int width, int channels, Plan* p) {
  return plan(loss_backward_kernel, kBwdShared, kBwdCols, kBwdHalo, height, width,
              channels, p);
}

}  // namespace

// The number of partial sums (float64 pairs) that gsrast_loss_forward's scratch holds
// for an image of height x width x channels; -1 where the plan fails.
extern "C" int gsrast_loss_partials(int height, int width, int channels) {
  Plan p;
  if (forward_plan(height, width, channels, &p) != cudaSuccess) return -1;
  return static_cast<int>(p.grid.x * p.grid.y * p.grid.z);
}

// pred and target (height, width, channels) float32, each with its three strides in
// elements (any: a crop's rows, the render's channel planes); taps (11,) float32.
// Writes (1 - w) mean|pred - target| + w (1 - mean S) to loss (a float32 scalar),
// through `partials` (gsrast_loss_partials(height, width, channels) float64 pairs of
// scratch); weight and one_minus_weight are w and 1 - w rounded to float32. Runs on
// `stream` without synchronising; returns cudaGetLastError() after the launches.
extern "C" int gsrast_loss_forward(const float* pred, long long pred_s0,
                                   long long pred_s1, long long pred_s2,
                                   const float* target,
                                   long long target_s0, long long target_s1,
                                   long long target_s2, int height, int width,
                                   int channels, const float* taps, float weight,
                                   float one_minus_weight, double* partials, float* loss,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  Plan p;
  const cudaError_t e = forward_plan(height, width, channels, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* sums = reinterpret_cast<double2*>(partials);
  loss_forward_kernel<<<p.grid, kThreads, p.shared, st>>>(
      Image{pred, pred_s0, pred_s1, pred_s2},
      Image{target, target_s0, target_s1, target_s2}, Shape{height, width, channels},
      p.rows, taps, sums);
  loss_sum_kernel<<<1, kSumThreads, 0, st>>>(
      sums, static_cast<int>(p.grid.x * p.grid.y * p.grid.z),
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
  Plan p;
  const cudaError_t e = backward_plan(height, width, channels, &p);
  if (e != cudaSuccess) return static_cast<int>(e);
  loss_backward_kernel<<<p.grid, kThreads, p.shared, static_cast<cudaStream_t>(stream)>>>(
      Image{pred, pred_s0, pred_s1, pred_s2},
      Image{target, target_s0, target_s1, target_s2}, Shape{height, width, channels},
      p.rows, taps, l1_coef, ssim_coef, grad,
      Strided<float>{d_pred, d_pred_s0, d_pred_s1, d_pred_s2});
  return static_cast<int>(cudaGetLastError());
}

// The launch of the forward (backward = 0) or the backward (1) over an image of
// height x width x channels: threads and dynamic shared bytes a block, the blocks of
// it that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the grid's blocks and the rows of a
// segment (plan()); and the kernel's registers a thread, local (spilled) bytes a
// thread and static shared bytes a block (cudaFuncGetAttributes).
extern "C" int gsrast_loss_occupancy(int backward, int height, int width, int channels,
                                     int* threads, int* shared_bytes, int* blocks_per_sm,
                                     int* blocks, int* segment_rows, int* registers,
                                     int* local_bytes, int* static_shared_bytes) {
  Plan p;
  cudaFuncAttributes attr;
  cudaError_t e;
  if (backward) {
    e = backward_plan(height, width, channels, &p);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, loss_backward_kernel);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, loss_backward_kernel,
                                                        kThreads, p.shared);
    }
  } else {
    e = forward_plan(height, width, channels, &p);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, loss_forward_kernel);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, loss_forward_kernel,
                                                        kThreads, p.shared);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *shared_bytes = static_cast<int>(p.shared);
  *blocks = static_cast<int>(p.grid.x * p.grid.y * p.grid.z);
  *segment_rows = p.rows;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
