// Per-Gaussian preprocess, forward and backward, for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the reference's preprocess (gsrast_tpu/ops/preprocess.py:38-124), which
// reaches no pallas_call: XLA fuses it into one computation over all N Gaussians,
// its TPU analog of the reference CUDA rasterizer's per-Gaussian preprocess kernel.
// Its eager PyTorch form (ops/preprocess.py::preprocess_torch, the plain version of
// both kernels here) runs about a thousand elementwise kernels forward and backward
// at SH degree 3, each a pass over N.
//
// Per Gaussian the forward projects the mean (to_camera, project), culls it (the
// near plane, the NDC margin, the mask, det > 0), builds the 3-D covariance from the
// unit quaternion and the scales, splats it to 2-D (EWA, the 1.3x tangent clamp, the
// depth guard of culled points), inverts it to the conic, shades the SH colour along
// the view direction, and bounds the opacity-aware per-axis extent by the radius and
// the covered tile rectangle (the saturating int casts). It writes mean2d, depth,
// conic, colour, masked opacity, radius and rect for every Gaussian, culled ones
// included, as the plain version does.
//
// What bounds it on this card: bytes. Forward, a Gaussian reads 237 B at SH degree 3
// (means 12, scales 12, quats 16, opacity 4, mask 1, SH 192) and writes 60 B;
// backward it reads the same inputs and up to 40 B of cotangents and writes 244 B of
// gradients. About 150 float operations a Gaussian forward and 400 backward are far
// below the FP32 rate at 3.35 TB/s.
//
// The design:
// - The camera is a block of kCamFloats floats that torch ops build each call from the
//   Camera's device tensors (camera.py::device_camera), never host scalars, copied into
//   shared memory once a block: a CUDA graph that captured a launch reads the camera
//   copied into its static tensors at each replay.
// - The forward (preprocess_forward_kernel): a warp takes chunks of 32 consecutive
//   Gaussians, a lane a Gaussian, in a grid of one wave (the blocks of 4 warps the
//   card holds at once), each warp walking chunks in strides of the grid's warps.
//   Each chunk's inputs are copied into shared memory by cp.async, consecutive lanes
//   on consecutive words: each array's run (16 bytes a lane where it is 16-byte
//   aligned), and of each SH row, (N, K, 3) with K the scene's stride, only the
//   (D + 1)^2 coefficients degree D reads, at an odd stride so that the lanes read
//   their rows from 32 banks. The copies of a warp's next chunk run while it
//   computes this one (two stages). A thread a Gaussian reading its own rows in
//   place makes each warp-wide load of an SH coefficient touch 32 rows 192 B apart,
//   and moves the 3- and 4-float rows one word a thread; its grid at 116k Gaussians
//   is under one wave, with one Gaussian's loads in flight a thread. The arithmetic
//   is the same helpers' (project_geometry, shade, the extents) on the staged
//   values, so the outputs' bits are those of a thread a Gaussian. The outputs are
//   stored in place: gathering mean2d, conic and colour in shared memory to store
//   them as 16-byte vectors took longer on every cell timed (PERF.md section 6).
// - The backward recomputes the forward's intermediates from the saved inputs and
//   the camera (the reference CUDA rasterizer's recipe): nothing per Gaussian is
//   kept between the two. It writes each Gaussian's gradients once, with no atomics,
//   so two launches on the same inputs give the same bits. The cotangents come with
//   their strides (autograd hands the transposed views of render/pipeline.py's
//   feature rows, or the zero-stride expansions of a sum); a null cotangent is zero.
// - The backward's SH rows go through shared memory (preprocess_backward_kernel).
//   They are 384 of its 509 bytes a Gaussian at K = 16, and a thread reading its own
//   row from device memory makes each warp-wide access touch 32 rows 192 B apart, 144
//   such accesses a Gaussian (the colour, the direction's gradient, the row's
//   gradient). A warp's 32 consecutive rows are one contiguous chunk, copied in and
//   stored back with consecutive lanes on consecutive words.
// - The SH degree is a template parameter (0-3).
//
// Rounding: the forward is written in the plain version's order of operations on R
// (below), whose products, sums and differences are the _rn intrinsics, which nvcc
// never contracts into fused multiply-adds; division is __fdiv_rn, sqrtf and logf are
// the IEEE and CUDA-library functions PyTorch's CUDA kernels call, and the file is
// built without --use_fast_math. Where the plain version divides by a host scalar
// (opacity / (0.98 ALPHA_MIN), a coordinate / tile_w), PyTorch's CUDA kernel
// multiplies by the scalar's reciprocal, and so does this file. A sum over a short
// axis (matmul_f32, the direction's norm) is taken left to right. The backward's own
// arithmetic may contract: it is held to the plain VJP within a tolerance.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

// The camera block (camera.py::device_camera): view (4x4, row-major), full
// projection (4x4), position (3), focal_x, focal_y, tan_fov_x, tan_fov_y.
constexpr int kCamView = 0;
constexpr int kCamProj = 16;
constexpr int kCamPos = 32;
constexpr int kCamFocalX = 35;
constexpr int kCamFocalY = 36;
constexpr int kCamTanX = 37;
constexpr int kCamTanY = 38;
constexpr int kCamFloats = 39;

constexpr float kTangentClamp = 1.3f;  // covariance.py::compute_cov2d

// ops/sh.py's constants, rounded to float32 as PyTorch rounds a Python scalar.
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f, kC2_1 = -1.0925484305920792f,
                kC2_2 = 0.31539156525252005f, kC2_3 = -1.0925484305920792f,
                kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f, kC3_1 = 2.890611442640554f,
                kC3_2 = -0.45704579946446572f, kC3_3 = 0.3731763325901154f,
                kC3_4 = -0.45704579946446572f, kC3_5 = 1.445305721320277f,
                kC3_6 = -0.5900435899266435f;

// A float whose every product, sum, difference and quotient rounds on its own, as
// one PyTorch op does. C++ and Python both associate left to right, so an
// expression written as the plain version writes it rounds as the plain version.
struct R {
  float v;
  R() = default;
  __device__ __forceinline__ R(float x) : v(x) {}
};
__device__ __forceinline__ R operator+(R a, R b) { return __fadd_rn(a.v, b.v); }
__device__ __forceinline__ R operator-(R a, R b) { return __fsub_rn(a.v, b.v); }
__device__ __forceinline__ R operator*(R a, R b) { return __fmul_rn(a.v, b.v); }
__device__ __forceinline__ R operator/(R a, R b) { return __fdiv_rn(a.v, b.v); }
__device__ __forceinline__ R operator-(R a) { return -a.v; }

// torch.clamp and torch.maximum propagate NaN; fminf and fmaxf do not.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

// projection.py::tile_rect's cast: NaN -> 0, +inf -> hi, -inf -> 0, clamped to
// [0, hi], truncated.
__device__ __forceinline__ int saturate_i32(float x, int hi) {
  const float h = static_cast<float>(hi);
  if (isnan(x)) x = 0.0f;
  if (isinf(x)) x = x > 0.0f ? h : 0.0f;
  return static_cast<int>(fminf(fmaxf(x, 0.0f), h));
}

struct Consts {
  int width, height;
  float near_depth, ndc_margin, dilation;
};

// The forward's intermediates that the backward differentiates through.
struct Geometry {
  R mv[3];            // the mean in camera space (mv[2] = depth)
  R hom0, hom1, w;    // clip x, y and 1 / (clip w + 1e-7)
  R px, py;           // pixel position, before mean2d_delta
  bool frustum;       // in the frustum and live: the depth guard's test
  bool valid;         // det > 0
  R rot[9], m[9];     // R and M = R diag(s), row-major
  R cov6[6];          // Sigma: xx, xy, xz, yy, yz, zz
  R tz, ux, uy, cux, cuy, lim_x, lim_y, tx, ty, inv_z, inv_z2;
  R t0[3], t1[3];     // T = J W, rows
  R v0[3], v1[3];     // Sigma t0, Sigma t1
  R a, b, c, inv_det;
  R dvec[3], norm, dir[3];
  R rgb[3];           // the SH sum before + 0.5 and the clamp
};

template <int D>
__device__ __forceinline__ void eval_sh(const float* __restrict__ sh, const R* d, R* rgb) {
  const R x = d[0], y = d[1], z = d[2];
  R xx, yy, zz, xy, yz, xz;
  if constexpr (D >= 2) {
    xx = x * x; yy = y * y; zz = z * z;
    xy = x * y; yz = y * z; xz = x * z;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* s = sh + ch;  // s[3 k]: coefficient k of this channel
    R r = kC0 * R(s[0]);
    if constexpr (D >= 1) {
      r = r - kC1 * y * s[3] + kC1 * z * s[6] - kC1 * x * s[9];
    }
    if constexpr (D >= 2) {
      r = r + kC2_0 * xy * s[12] + kC2_1 * yz * s[15]
          + kC2_2 * (2.0f * zz - xx - yy) * s[18] + kC2_3 * xz * s[21]
          + kC2_4 * (xx - yy) * s[24];
    }
    if constexpr (D >= 3) {
      r = r + kC3_0 * y * (3.0f * xx - yy) * s[27] + kC3_1 * xy * z * s[30]
          + kC3_2 * y * (4.0f * zz - xx - yy) * s[33]
          + kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy) * s[36]
          + kC3_4 * x * (4.0f * zz - xx - yy) * s[39] + kC3_5 * z * (xx - yy) * s[42]
          + kC3_6 * x * (xx - 3.0f * yy) * s[45];
    }
    rgb[ch] = r;
  }
}

// The plain version's forward for Gaussian i up to the conic: everything but the
// colour (shade) and the extents, which carry no gradient.
__device__ __forceinline__ void project_geometry(
    long long i, const float* cam, const float* __restrict__ means,
    const float* __restrict__ scales, const float* __restrict__ quats,
    const unsigned char* __restrict__ mask, const Consts& k, Geometry& g) {
  const float* view = cam + kCamView;
  const float* proj = cam + kCamProj;
  const R p[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};

  // projection.py::to_camera and ::project (matmul_f32: products summed left to right).
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.mv[j] = p[0] * view[4 * j] + p[1] * view[4 * j + 1] + p[2] * view[4 * j + 2]
              + view[4 * j + 3];
  }
  g.hom0 = p[0] * proj[0] + p[1] * proj[1] + p[2] * proj[2] + proj[3];
  g.hom1 = p[0] * proj[4] + p[1] * proj[5] + p[2] * proj[6] + proj[7];
  const R hom3 = p[0] * proj[12] + p[1] * proj[13] + p[2] * proj[14] + proj[15];
  g.w = R(1.0f) / (hom3 + 1e-7f);
  const R ndc0 = g.hom0 * g.w, ndc1 = g.hom1 * g.w;
  g.px = ((ndc0 + 1.0f) * static_cast<float>(k.width) - 1.0f) * 0.5f;
  g.py = ((ndc1 + 1.0f) * static_cast<float>(k.height) - 1.0f) * 0.5f;
  const float m = k.ndc_margin;
  g.frustum = g.mv[2].v > k.near_depth && ndc0.v > -m && ndc0.v < m && ndc1.v > -m &&
              ndc1.v < m && mask[i] != 0;

  // covariance.py::quat_to_rotmat and ::compute_cov3d.
  const R qw = quats[4 * i], qx = quats[4 * i + 1], qy = quats[4 * i + 2],
          qz = quats[4 * i + 3];
  g.rot[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.rot[1] = 2.0f * (qx * qy - qw * qz);
  g.rot[2] = 2.0f * (qx * qz + qw * qy);
  g.rot[3] = 2.0f * (qx * qy + qw * qz);
  g.rot[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.rot[5] = 2.0f * (qy * qz - qw * qx);
  g.rot[6] = 2.0f * (qx * qz - qw * qy);
  g.rot[7] = 2.0f * (qy * qz + qw * qx);
  g.rot[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g.m[3 * r + c] = g.rot[3 * r + c] * scales[3 * i + c];
  }
  const R* mm = g.m;
  g.cov6[0] = mm[0] * mm[0] + mm[1] * mm[1] + mm[2] * mm[2];
  g.cov6[1] = mm[0] * mm[3] + mm[1] * mm[4] + mm[2] * mm[5];
  g.cov6[2] = mm[0] * mm[6] + mm[1] * mm[7] + mm[2] * mm[8];
  g.cov6[3] = mm[3] * mm[3] + mm[4] * mm[4] + mm[5] * mm[5];
  g.cov6[4] = mm[3] * mm[6] + mm[4] * mm[7] + mm[5] * mm[8];
  g.cov6[5] = mm[6] * mm[6] + mm[7] * mm[7] + mm[8] * mm[8];

  // covariance.py::compute_cov2d on preprocess.py's safe_view.
  const float fx = cam[kCamFocalX], fy = cam[kCamFocalY];
  g.tz = g.frustum ? g.mv[2] : R(1.0f);
  g.lim_x = kTangentClamp * R(cam[kCamTanX]);
  g.lim_y = kTangentClamp * R(cam[kCamTanY]);
  g.ux = g.mv[0] / g.tz;
  g.uy = g.mv[1] / g.tz;
  g.cux = clamp_nan(g.ux.v, (-g.lim_x).v, g.lim_x.v);
  g.cuy = clamp_nan(g.uy.v, (-g.lim_y).v, g.lim_y.v);
  g.tx = g.cux * g.tz;
  g.ty = g.cuy * g.tz;
  g.inv_z = R(1.0f) / g.tz;
  g.inv_z2 = g.inv_z * g.inv_z;
  const R jx = fx * g.inv_z, jy = fy * g.inv_z;
  const R jxz = -R(fx) * g.tx * g.inv_z2, jyz = -R(fy) * g.ty * g.inv_z2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.t0[c] = jx * view[c] + jxz * view[8 + c];
    g.t1[c] = jy * view[4 + c] + jyz * view[8 + c];
  }
  const R s00 = g.cov6[0], s01 = g.cov6[1], s02 = g.cov6[2], s11 = g.cov6[3],
          s12 = g.cov6[4], s22 = g.cov6[5];
  const R* t0 = g.t0;
  const R* t1 = g.t1;
  g.v0[0] = s00 * t0[0] + s01 * t0[1] + s02 * t0[2];
  g.v0[1] = s01 * t0[0] + s11 * t0[1] + s12 * t0[2];
  g.v0[2] = s02 * t0[0] + s12 * t0[1] + s22 * t0[2];
  g.v1[0] = s00 * t1[0] + s01 * t1[1] + s02 * t1[2];
  g.v1[1] = s01 * t1[0] + s11 * t1[1] + s12 * t1[2];
  g.v1[2] = s02 * t1[0] + s12 * t1[1] + s22 * t1[2];
  g.a = t0[0] * g.v0[0] + t0[1] * g.v0[1] + t0[2] * g.v0[2] + k.dilation;
  g.b = t1[0] * g.v0[0] + t1[1] * g.v0[1] + t1[2] * g.v0[2];
  g.c = t1[0] * g.v1[0] + t1[1] * g.v1[1] + t1[2] * g.v1[2] + k.dilation;

  // covariance.py::conic.
  const R det = g.a * g.c - g.b * g.b;
  g.valid = det.v > 0.0f;
  g.inv_det = R(1.0f) / (g.valid ? det : R(1.0f));
}

// The view direction of Gaussian i and ops/sh.py::eval_sh of its SH row `sh_row`
// (K rows of 3 channels, in device or shared memory).
template <int D>
__device__ __forceinline__ void shade(long long i, const float* cam,
                                      const float* __restrict__ means,
                                      const float* __restrict__ sh_row,
                                      Geometry& g) {
  const R p[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};
  const float* pos = cam + kCamPos;
#pragma unroll
  for (int j = 0; j < 3; ++j) g.dvec[j] = p[j] - pos[j];
  g.norm = sqrtf((g.dvec[0] * g.dvec[0] + g.dvec[1] * g.dvec[1] + g.dvec[2] * g.dvec[2]).v);
  const R s = g.norm + 1e-12f;
#pragma unroll
  for (int j = 0; j < 3; ++j) g.dir[j] = g.dvec[j] / s;
  eval_sh<D>(sh_row, g.dir, g.rgb);
}

// The forward's warps a block (PERF.md section 6: 1, 2, 4 and 8 timed).
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;

// Floats between two staged SH rows of K coefficients: 3K made odd, so that the 32
// lanes reading coefficient c of their own rows (words t * stride + c) fall in 32
// different banks; 3K = 48 apart they would fall in two. (Rows stored coefficient-
// major would serve those reads as well, but would put the copy's consecutive words
// 32 floats apart, in one bank.)
__host__ __device__ constexpr int staged_stride(int sh_stride) { return (3 * sh_stride) | 1; }

// The floats of an SH row that degree D evaluates: (D + 1)^2 coefficients of 3
// channels; the forward stages only these, staged_stride((D + 1)^2) floats apart.
__host__ __device__ constexpr int sh_used(int degree) { return 3 * (degree + 1) * (degree + 1); }
__host__ __device__ constexpr int fwd_sh_stride(int degree) {
  return staged_stride((degree + 1) * (degree + 1));
}

// One stage of a forward warp's chunk of 32 consecutive Gaussians in shared memory:
// their inputs, each array at a 16-byte boundary, the SH rows' used floats at
// fwd_sh_stride(D) floats a row.
template <int D>
struct alignas(16) FwdStage {
  float means[96];
  float scales[96];
  float quats[128];
  float opacity[32];
  float delta[64];
  float sh[32 * fwd_sh_stride(D)];
  unsigned char mask[32];
};

// A forward warp's shared memory: two stages.
template <int D>
__host__ __device__ constexpr size_t fwd_warp_bytes() {
  return 2 * sizeof(FwdStage<D>);
}

// The forward's blocks of degree D that an SM's shared memory holds (228 KB an SM,
// 1 KB of it reserved a block), at most 32 warps: its register budget. At degree 3
// shared memory holds 3 blocks of 4 warps, which could take 170 registers a thread
// (ptxas takes 64); at degrees 0 and 1 the cap of 32 warps leaves 64.
template <int D>
__host__ __device__ constexpr int fwd_min_blocks() {
  constexpr size_t block = kFwdWarps * fwd_warp_bytes<D>() + sizeof(float) * kCamFloats + 1024;
  constexpr size_t most = 32 / kFwdWarps;
  return static_cast<int>(233472 / block < most ? 233472 / block : most);
}

// cp.async of `floats` consecutive floats of one array from src (device memory) to
// dst (shared, 16-byte aligned), the warp's lanes on consecutive words. A whole
// chunk's run of an array of W floats a Gaussian (floats = 32 W) whose rows start at
// 16-byte boundaries (`vec`; a chunk's first row does where the array's first does)
// is one 16-byte copy for each of the first 8 W lanes; a part-chunk, or an array that
// is not so aligned, goes 4 bytes a lane.
template <int W>
__device__ __forceinline__ void copy_run(float* dst, const float* __restrict__ src,
                                         int floats, bool vec, int lane) {
  if (vec && floats == 32 * W) {
    if (lane < 8 * W) __pipeline_memcpy_async(dst + 4 * lane, src + 4 * lane, 16);
    return;
  }
  for (int w = lane; w < floats; w += 32) __pipeline_memcpy_async(dst + w, src + w, 4);
}

// Bits of FwdArgs::vec: the arrays whose first float lies on a 16-byte boundary.
enum : unsigned { kVecMeans = 1, kVecScales = 2, kVecQuats = 4, kVecOpacity = 8, kVecDelta = 16 };

// The forward's inputs and outputs, as the entry point takes them.
struct FwdArgs {
  const float* cam;
  const float* means;
  const float* scales;
  const float* quats;
  const float* opacities;
  const float* sh;
  const unsigned char* mask;
  const float* mean2d_delta;  // or null
  int n, sh_stride;
  unsigned vec;  // kVec* bits
  Consts k;
  int grid_h, grid_w, tile_h, tile_w;
  float inv_threshold, extent_cap;
  float* mean2d;
  float* depth;
  float* conic;
  float* color;
  float* opacity;
  int* radius;
  int* rect;
};

// Issues the cp.async copies of chunk `chunk`'s inputs into stage `st`: each array's
// run of its `rows` Gaussians (copy_run), and of each SH row only the used floats
// (rows 3 sh_stride floats apart in device memory), 4 bytes a lane on consecutive
// words of the rows' used floats.
// Returns the lane's mask byte, a plain load (cp.async copies 4 bytes at least, from a
// 4-byte boundary, which a byte mask need not keep), used one chunk later.
template <int D>
__device__ __forceinline__ unsigned char issue_chunk(const FwdArgs& a, long long chunk,
                                                     FwdStage<D>& st, int lane) {
  constexpr int u = sh_used(D), su = fwd_sh_stride(D);
  const long long first = 32 * chunk;
  const int rows = static_cast<int>(min(32LL, a.n - first));
  copy_run<3>(st.means, a.means + 3 * first, 3 * rows, a.vec & kVecMeans, lane);
  copy_run<3>(st.scales, a.scales + 3 * first, 3 * rows, a.vec & kVecScales, lane);
  copy_run<4>(st.quats, a.quats + 4 * first, 4 * rows, a.vec & kVecQuats, lane);
  copy_run<1>(st.opacity, a.opacities + first, rows, a.vec & kVecOpacity, lane);
  if (a.mean2d_delta != nullptr) {
    copy_run<2>(st.delta, a.mean2d_delta + 2 * first, 2 * rows, a.vec & kVecDelta, lane);
  }
  const int rf = 3 * a.sh_stride;
  const float* src = a.sh + first * rf;
  constexpr int dr = 32 / u, dc = 32 % u;  // a step of 32 words in rows and columns
  int r = lane / u, c = lane % u;
  for (int w = lane; w < rows * u; w += 32) {
    __pipeline_memcpy_async(st.sh + r * su + c, src + static_cast<long long>(r) * rf + c, 4);
    r += dr;
    c += dc;
    if (c >= u) {
      c -= u;
      ++r;
    }
  }
  return lane < rows ? a.mask[first + lane] : 0;
}

// The forward of chunk `chunk` from its staged inputs: per lane one Gaussian, through
// the same helpers, in the same order of operations, as a thread a Gaussian computes
// it from device memory; its outputs stored in place.
template <int D>
__device__ __forceinline__ void forward_chunk(const FwdArgs& a, const float* cam,
                                              long long chunk, FwdStage<D>& st,
                                              unsigned char mask_byte, int lane) {
  const long long first = 32 * chunk;
  const int rows = static_cast<int>(min(32LL, a.n - first));
  if (lane < rows) {
    const long long i = first + lane;
    st.mask[lane] = mask_byte;
    Geometry g;
    project_geometry(lane, cam, st.means, st.scales, st.quats, st.mask, a.k, g);
    shade<D>(lane, cam, st.means, st.sh + lane * fwd_sh_stride(D), g);
    const bool visible = g.frustum && g.valid;

    R px = g.px, py = g.py;
    if (a.mean2d_delta != nullptr) {
      px = px + st.delta[2 * lane];
      py = py + st.delta[2 * lane + 1];
    }
    a.mean2d[2 * i] = px.v;
    a.mean2d[2 * i + 1] = py.v;
    a.depth[i] = g.mv[2].v;
    a.conic[3 * i] = (g.c * g.inv_det).v;
    a.conic[3 * i + 1] = (-g.b * g.inv_det).v;
    a.conic[3 * i + 2] = (g.a * g.inv_det).v;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float r = (g.rgb[ch] + 0.5f).v;
      a.color[3 * i + ch] = isnan(r) ? r : fmaxf(r, 0.0f);
    }

    // The opacity-aware per-axis extents, the radius and the tile rectangle.
    const float op = st.opacity[lane];
    const float cfac =
        clamp_nan((2.0f * R(logf((R(op) * a.inv_threshold).v))).v, 0.0f, a.extent_cap);
    const float ext_x =
        ceilf(sqrtf((R(cfac) * (isnan(g.a.v) ? g.a.v : fmaxf(g.a.v, 0.0f))).v));
    const float ext_y =
        ceilf(sqrtf((R(cfac) * (isnan(g.c.v) ? g.c.v : fmaxf(g.c.v, 0.0f))).v));
    a.radius[i] = static_cast<int>(visible ? max_nan(ext_x, ext_y) : 0.0f);
    const float rx = visible ? ext_x : 0.0f, ry = visible ? ext_y : 0.0f;
    const R inv_tw = R(1.0f) / static_cast<float>(a.tile_w);
    const R inv_th = R(1.0f) / static_cast<float>(a.tile_h);
    const long long n = a.n;
    a.rect[i] = saturate_i32(((px - rx) * inv_tw).v, a.grid_w);
    a.rect[n + i] = saturate_i32(((py - ry) * inv_th).v, a.grid_h);
    a.rect[2 * n + i] = saturate_i32(ceilf(((px + rx + 1.0f) * inv_tw).v), a.grid_w);
    a.rect[3 * n + i] = saturate_i32(ceilf(((py + ry + 1.0f) * inv_th).v), a.grid_h);
    a.opacity[i] = visible ? op : 0.0f;
  }
  __syncwarp();  // the stage is free again
}

// The forward: a grid of one wave (the blocks the card holds at once), each warp
// walking chunks of 32 consecutive Gaussians in strides of the grid's warps. While a
// warp computes a chunk from one stage, the next chunk's inputs are being copied into
// the other; the first chunk's copies are in flight while the block loads the camera.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, fwd_min_blocks<D>())
preprocess_forward_kernel(const FwdArgs a) {
  extern __shared__ float4 fwd_shared[];  // per warp: two FwdStage<D>
  __shared__ float cam[kCamFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FwdStage<D>* stage = reinterpret_cast<FwdStage<D>*>(fwd_shared) + 2 * warp;
  const long long chunks = (a.n + 31) / 32;
  const long long step = static_cast<long long>(gridDim.x) * kFwdWarps;
  long long chunk = static_cast<long long>(blockIdx.x) * kFwdWarps + warp;
  unsigned char mask_byte = 0;
  if (chunk < chunks) mask_byte = issue_chunk<D>(a, chunk, stage[0], lane);
  __pipeline_commit();
  for (int c = threadIdx.x; c < kCamFloats; c += kFwdThreads) cam[c] = a.cam[c];
  __syncthreads();
  for (int s = 0; chunk < chunks; chunk += step, s ^= 1) {
    const long long next = chunk + step;
    unsigned char next_mask = 0;
    if (next < chunks) next_mask = issue_chunk<D>(a, next, stage[s ^ 1], lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this chunk's copies, not the next one's
    __syncwarp();
    forward_chunk<D>(a, cam, chunk, stage[s], mask_byte, lane);
    mask_byte = next_mask;
  }
}

using ForwardKernel = decltype(&preprocess_forward_kernel<0>);

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

constexpr int kDevices = 64;  // devices whose forward occupancy is kept

// The forward kernel of SH degree `degree`, its dynamic shared bytes a block, the
// blocks of it one SM holds at once and the device's SMs; cudaErrorInvalidValue for a
// degree outside 0-3 or rows shorter than it reads. The kernel's shared-memory limit
// is raised and its occupancy asked once a device and degree (again if the device's
// SM count changes); the SM count is read each call.
cudaError_t prepare_forward(int degree, int sh_stride, ForwardKernel* kernel, size_t* shared,
                            int* per_sm, int* sms) {
  const ForwardKernel kernels[] = {preprocess_forward_kernel<0>, preprocess_forward_kernel<1>,
                                   preprocess_forward_kernel<2>, preprocess_forward_kernel<3>};
  const size_t bytes[] = {fwd_warp_bytes<0>(), fwd_warp_bytes<1>(), fwd_warp_bytes<2>(),
                          fwd_warp_bytes<3>()};
  if (degree < 0 || degree > 3 || sh_stride < (degree + 1) * (degree + 1)) {
    return cudaErrorInvalidValue;
  }
  *kernel = kernels[degree];
  *shared = kFwdWarps * bytes[degree];
  static std::atomic<long long> known[kDevices][4];  // SMs << 32 | blocks an SM; 0: not asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kDevices;
  const long long seen = kept ? known[dev][degree].load(std::memory_order_relaxed) : 0;
  if (seen != 0 && seen >> 32 == *sms) {
    *per_sm = static_cast<int>(seen & 0xffffffff);
    return cudaSuccess;
  }
  if (*shared > 48 * 1024) {
    e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*shared));
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, *kernel, kFwdThreads, *shared);
  if (e != cudaSuccess) return e;
  if (kept) known[dev][degree].store(static_cast<long long>(*sms) << 32 | *per_sm);
  return cudaSuccess;
}

// The forward's grid for n Gaussians: one wave, fewer blocks where n leaves some
// without a chunk.
long long forward_blocks(int n, int per_sm, int sms) {
  const long long chunks = (static_cast<long long>(n) + 31) / 32;
  const long long wanted = (chunks + kFwdWarps - 1) / kFwdWarps;
  return max(min(wanted, static_cast<long long>(per_sm) * sms), 1LL);
}

// A cotangent: rows of `cols` floats at (row stride s0, column stride s1); null is 0.
struct Cot {
  const float* p;
  long long s0, s1;
  __device__ __forceinline__ float at(long long i, int j) const {
    return p == nullptr ? 0.0f : p[i * s0 + j * s1];
  }
};

// ops/sh.py::eval_sh's VJP for one staged SH row `row` (K = sh_stride coefficients
// of 3 channels): the direction's gradient ddir from the row's coefficients, then the
// row's gradient written over the row: basis x dres for the `used` coefficients, 0
// past them.
template <int D>
__device__ __forceinline__ void sh_backward(float* row, const R* dir, const float* dres,
                                            int sh_stride, float* ddir) {
  const float x = dir[0].v, y = dir[1].v, z = dir[2].v;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  ddir[0] = ddir[1] = ddir[2] = 0.0f;
  if constexpr (D >= 1) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* s = row + ch;
      const float gr = dres[ch];
      float dx = -kC1 * s[9], dy = -kC1 * s[3], dz = kC1 * s[6];
      if constexpr (D >= 2) {
        dx += kC2_0 * y * s[12] - kC2_2 * 2.0f * x * s[18] + kC2_3 * z * s[21] +
              kC2_4 * 2.0f * x * s[24];
        dy += kC2_0 * x * s[12] + kC2_1 * z * s[15] - kC2_2 * 2.0f * y * s[18] -
              kC2_4 * 2.0f * y * s[24];
        dz += kC2_1 * y * s[15] + kC2_2 * 4.0f * z * s[18] + kC2_3 * x * s[21];
      }
      if constexpr (D >= 3) {
        dx += kC3_0 * 6.0f * xy * s[27] + kC3_1 * yz * s[30] - kC3_2 * 2.0f * xy * s[33] -
              kC3_3 * 6.0f * xz * s[36] + kC3_4 * (4.0f * zz - 3.0f * xx - yy) * s[39] +
              kC3_5 * 2.0f * xz * s[42] + kC3_6 * 3.0f * (xx - yy) * s[45];
        dy += kC3_0 * 3.0f * (xx - yy) * s[27] + kC3_1 * xz * s[30] +
              kC3_2 * (4.0f * zz - xx - 3.0f * yy) * s[33] - kC3_3 * 6.0f * yz * s[36] -
              kC3_4 * 2.0f * xy * s[39] - kC3_5 * 2.0f * yz * s[42] -
              kC3_6 * 6.0f * xy * s[45];
        dz += kC3_1 * xy * s[30] + kC3_2 * 8.0f * yz * s[33] +
              kC3_3 * 3.0f * (2.0f * zz - xx - yy) * s[36] + kC3_4 * 8.0f * xz * s[39] +
              kC3_5 * (xx - yy) * s[42];
      }
      ddir[0] += gr * dx;
      ddir[1] += gr * dy;
      ddir[2] += gr * dz;
    }
  }
  float basis[16];
  basis[0] = kC0;
  if constexpr (D >= 1) {
    basis[1] = -kC1 * y;
    basis[2] = kC1 * z;
    basis[3] = -kC1 * x;
  }
  if constexpr (D >= 2) {
    basis[4] = kC2_0 * xy;
    basis[5] = kC2_1 * yz;
    basis[6] = kC2_2 * (2.0f * zz - xx - yy);
    basis[7] = kC2_3 * xz;
    basis[8] = kC2_4 * (xx - yy);
  }
  if constexpr (D >= 3) {
    basis[9] = kC3_0 * y * (3.0f * xx - yy);
    basis[10] = kC3_1 * xy * z;
    basis[11] = kC3_2 * y * (4.0f * zz - xx - yy);
    basis[12] = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    basis[13] = kC3_4 * x * (4.0f * zz - xx - yy);
    basis[14] = kC3_5 * z * (xx - yy);
    basis[15] = kC3_6 * x * (xx - 3.0f * yy);
  }
  constexpr int used = (D + 1) * (D + 1);
#pragma unroll
  for (int kk = 0; kk < used; ++kk) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) row[3 * kk + ch] = basis[kk] * dres[ch];
  }
  for (int kk = used; kk < sh_stride; ++kk) {
    row[3 * kk] = 0.0f;
    row[3 * kk + 1] = 0.0f;
    row[3 * kk + 2] = 0.0f;
  }
}

// The backward's warps a block (PERF.md: 8, or a minimum of blocks an SM, was slower).
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
static_assert(kBwdThreads >= kCamFloats, "a block loads the camera one float a thread");

// The backward block's dynamic shared memory: each warp's 32 staged rows.
inline size_t bwd_shared_bytes(int sh_stride) {
  return sizeof(float) * kBwdWarps * 32 * staged_stride(sh_stride);
}

// f(w, s) for the words w = lane, lane + 32, ... < words of a warp's chunk of SH rows
// (rf = 3K floats a row, contiguous in device memory), s the word's offset in the
// staged chunk: row w / rf at `stride` floats a row, column w % rf. Consecutive lanes
// take consecutive words, so each warp-wide access is one contiguous 128-byte run.
template <class F>
__device__ __forceinline__ void for_chunk_words(int lane, int words, int rf, int stride,
                                                F f) {
  const int dr = 32 / rf, dc = 32 % rf;  // a step of 32 words in rows and columns
  int r = lane / rf, c = lane % rf;
  for (int w = lane; w < words; w += 32) {
    f(w, r * stride + c);
    r += dr;
    c += dc;
    if (c >= rf) {
      c -= rf;
      ++r;
    }
  }
}

// One warp takes 32 consecutive Gaussians. It copies their SH rows, one contiguous
// chunk, into shared memory (cp.async, coalesced) and, while the copy runs, each lane
// recomputes its Gaussian's projection and covariance and runs their chain rule to
// the scales', quaternions' and opacity's gradients and the mean's first part. Then
// each lane shades and differentiates from its staged row and writes the row's
// gradient over it, and the warp stores the chunk as g_sh, coalesced. The SH part
// needs only the mean and the camera, so the covariance chain's registers are free
// by then.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
preprocess_backward_kernel(const float* __restrict__ cam_g, const float* __restrict__ means,
                           const float* __restrict__ scales, const float* __restrict__ quats,
                           const float* __restrict__ sh, const unsigned char* __restrict__ mask,
                           int n, int sh_stride, Consts k, Cot d_mean2d, Cot d_depth,
                           Cot d_conic, Cot d_color, Cot d_opacity,
                           float* __restrict__ g_means, float* __restrict__ g_scales,
                           float* __restrict__ g_quats, float* __restrict__ g_opacities,
                           float* __restrict__ g_sh) {
  extern __shared__ float staged[];  // per warp 32 rows, staged_stride(K) floats apart
  __shared__ float cam[kCamFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kBwdThreads + 32 * warp;
  const long long left = n - first;
  const int rows = left <= 0 ? 0 : (left < 32 ? static_cast<int>(left) : 32);
  const int rf = 3 * sh_stride, stride = staged_stride(sh_stride);
  float* chunk = staged + warp * 32 * stride;
  if (rows > 0) {
    const float* src = sh + first * rf;
    for_chunk_words(lane, rows * rf, rf, stride, [&](int w, int s) {
      __pipeline_memcpy_async(chunk + s, src + w, 4);
    });
  }
  __pipeline_commit();
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = cam_g[threadIdx.x];
  __syncthreads();
  if (rows == 0) return;
  const long long i = first + lane;
  const bool live = lane < rows;
  const float* view = cam + kCamView;
  const float* proj = cam + kCamProj;
  const float fx = cam[kCamFocalX], fy = cam[kCamFocalY];
  Geometry g;
  float gm[3];
  if (live) {
    project_geometry(i, cam, means, scales, quats, mask, k, g);

    // mean2d = ((hom / (hom3 + 1e-7) + 1) size - 1) / 2 (+ mean2d_delta).
    const float w = g.w.v;
    const float dndc0 = d_mean2d.at(i, 0) * 0.5f * static_cast<float>(k.width);
    const float dndc1 = d_mean2d.at(i, 1) * 0.5f * static_cast<float>(k.height);
    const float dhom0 = dndc0 * w, dhom1 = dndc1 * w;
    const float dhom3 = -(dndc0 * g.hom0.v + dndc1 * g.hom1.v) * w * w;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gm[j] = dhom0 * proj[j] + dhom1 * proj[4 + j] + dhom3 * proj[12 + j];
    }

    // conic = (c, -b, a) / where(valid, det, 1), det = a c - b^2.
    const float dA = d_conic.at(i, 0), dB = d_conic.at(i, 1), dC = d_conic.at(i, 2);
    const float a = g.a.v, b = g.b.v, c = g.c.v, inv_det = g.inv_det.v;
    float da = dC * inv_det, db = -dB * inv_det, dc = dA * inv_det;
    if (g.valid) {
      const float ddet = -(dA * c - dB * b + dC * a) * inv_det * inv_det;
      da += ddet * c;
      dc += ddet * a;
      db -= 2.0f * b * ddet;
    }

    // a = t0 Sigma t0 + 0.3, b = t1 Sigma t0, c = t1 Sigma t1 + 0.3 (v0 = Sigma t0,
    // v1 = Sigma t1), Sigma symmetric from its six entries.
    float t0[3], t1[3], v0[3], v1[3], dv0[3], dv1[3], dt0[3], dt1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t0[j] = g.t0[j].v; t1[j] = g.t1[j].v; v0[j] = g.v0[j].v; v1[j] = g.v1[j].v;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dv0[j] = da * t0[j] + db * t1[j];
      dv1[j] = dc * t1[j];
      dt0[j] = da * v0[j];
      dt1[j] = db * v0[j] + dc * v1[j];
    }
    const float sig[9] = {g.cov6[0].v, g.cov6[1].v, g.cov6[2].v, g.cov6[1].v, g.cov6[3].v,
                          g.cov6[4].v, g.cov6[2].v, g.cov6[4].v, g.cov6[5].v};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dt0[j] += sig[j] * dv0[0] + sig[3 + j] * dv0[1] + sig[6 + j] * dv0[2];
      dt1[j] += sig[j] * dv1[0] + sig[3 + j] * dv1[1] + sig[6 + j] * dv1[2];
    }
    const float ds00 = dv0[0] * t0[0] + dv1[0] * t1[0];
    const float ds01 = dv0[0] * t0[1] + dv0[1] * t0[0] + dv1[0] * t1[1] + dv1[1] * t1[0];
    const float ds02 = dv0[0] * t0[2] + dv0[2] * t0[0] + dv1[0] * t1[2] + dv1[2] * t1[0];
    const float ds11 = dv0[1] * t0[1] + dv1[1] * t1[1];
    const float ds12 = dv0[1] * t0[2] + dv0[2] * t0[1] + dv1[1] * t1[2] + dv1[2] * t1[1];
    const float ds22 = dv0[2] * t0[2] + dv1[2] * t1[2];

    // T = J W: t0 = jx W0 + jxz W2, t1 = jy W1 + jyz W2, with jx = fx / z,
    // jxz = -fx tx / z^2, tx = clamp(x / z, +-1.3 tan_fov_x) z; z = where(frustum,
    // depth, 1).
    float djx = 0.0f, djy = 0.0f, djxz = 0.0f, djyz = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      djx += dt0[j] * view[j];
      djxz += dt0[j] * view[8 + j];
      djy += dt1[j] * view[4 + j];
      djyz += dt1[j] * view[8 + j];
    }
    const float inv_z = g.inv_z.v, inv_z2 = g.inv_z2.v, tz = g.tz.v;
    const float dinv_z2 = -(djxz * fx * g.tx.v + djyz * fy * g.ty.v);
    const float dinv_z = djx * fx + djy * fy + 2.0f * inv_z * dinv_z2;
    const float dtx = -djxz * fx * inv_z2, dty = -djyz * fy * inv_z2;
    float dtz = -dinv_z * inv_z * inv_z + dtx * g.cux.v + dty * g.cuy.v;
    const float ux = g.ux.v, uy = g.uy.v;
    const float dux = (ux >= -g.lim_x.v && ux <= g.lim_x.v) ? dtx * tz : 0.0f;
    const float duy = (uy >= -g.lim_y.v && uy <= g.lim_y.v) ? dty * tz : 0.0f;
    dtz -= dux * (ux / tz) + duy * (uy / tz);
    const float dmv[3] = {dux / tz, duy / tz, d_depth.at(i, 0) + (g.frustum ? dtz : 0.0f)};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gm[j] += dmv[0] * view[j] + dmv[1] * view[4 + j] + dmv[2] * view[8 + j];
    }

    // Sigma = M M^T (rows m_r), M = R diag(s).
    const float dsig[9] = {ds00, ds01, ds02, ds01, ds11, ds12, ds02, ds12, ds22};
    float dm[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          acc += (q == r ? 2.0f : 1.0f) * dsig[3 * r + q] * g.m[3 * q + cc].v;
        }
        dm[3 * r + cc] = acc;
      }
    }
    float dr[9], dscale[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        dr[3 * r + cc] = dm[3 * r + cc] * scales[3 * i + cc];
        dscale[cc] += dm[3 * r + cc] * g.rot[3 * r + cc].v;
      }
    }
    const float qw = quats[4 * i], qx = quats[4 * i + 1], qy = quats[4 * i + 2],
                qz = quats[4 * i + 3];
    const float dqw = 2.0f * (-qz * dr[1] + qy * dr[2] + qz * dr[3] - qx * dr[5] - qy * dr[6] +
                              qx * dr[7]);
    const float dqx = 2.0f * (qy * dr[1] + qz * dr[2] + qy * dr[3] - 2.0f * qx * dr[4] -
                              qw * dr[5] + qz * dr[6] + qw * dr[7] - 2.0f * qx * dr[8]);
    const float dqy = 2.0f * (-2.0f * qy * dr[0] + qx * dr[1] + qw * dr[2] + qx * dr[3] +
                              qz * dr[5] - qw * dr[6] + qz * dr[7] - 2.0f * qy * dr[8]);
    const float dqz = 2.0f * (-2.0f * qz * dr[0] - qw * dr[1] + qx * dr[2] + qw * dr[3] -
                              2.0f * qz * dr[4] + qy * dr[5] + qx * dr[6] + qy * dr[7]);

#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_scales[3 * i + j] = dscale[j];
    }
    g_quats[4 * i] = dqw;
    g_quats[4 * i + 1] = dqx;
    g_quats[4 * i + 2] = dqy;
    g_quats[4 * i + 3] = dqz;
    g_opacities[i] = (g.frustum && g.valid) ? d_opacity.at(i, 0) : 0.0f;
  }

  __pipeline_wait_prior(0);
  __syncwarp();
  float* row = chunk + lane * stride;
  if (live) {
    // colour = max(rgb + 0.5, 0), rgb the SH sum along dir = dvec / (|dvec| + 1e-12).
    shade<D>(i, cam, means, row, g);
    float dres[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      dres[ch] = (g.rgb[ch] + 0.5f).v >= 0.0f ? d_color.at(i, ch) : 0.0f;
    }
    float ddir[3];
    sh_backward<D>(row, g.dir, dres, sh_stride, ddir);
    const float s = (g.norm + 1e-12f).v;
    const float dnorm =
        -(ddir[0] * g.dir[0].v + ddir[1] * g.dir[1].v + ddir[2] * g.dir[2].v) / s;
    const float dsq = dnorm / (2.0f * g.norm.v);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_means[3 * i + j] = gm[j] + (ddir[j] / s + 2.0f * g.dvec[j].v * dsq);
    }
  }
  __syncwarp();
  float* dst = g_sh + first * rf;
  for_chunk_words(lane, rows * rf, rf, stride, [&](int w, int s) { dst[w] = chunk[s]; });
}

using BackwardKernel = decltype(&preprocess_backward_kernel<0>);

// The backward kernel of SH degree `degree` and its dynamic shared memory for SH rows
// of sh_stride coefficients, the kernel's limit raised where that exceeds the default
// 48 KB; cudaErrorInvalidValue for a degree outside 0-3 or rows shorter than it reads.
cudaError_t prepare_backward(int degree, int sh_stride, BackwardKernel* kernel,
                             size_t* shared) {
  const BackwardKernel kernels[] = {
      preprocess_backward_kernel<0>, preprocess_backward_kernel<1>,
      preprocess_backward_kernel<2>, preprocess_backward_kernel<3>};
  if (degree < 0 || degree > 3 || sh_stride < (degree + 1) * (degree + 1)) {
    return cudaErrorInvalidValue;
  }
  *kernel = kernels[degree];
  *shared = bwd_shared_bytes(sh_stride);
  if (*shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*shared));
}

}  // namespace

// Inputs (N rows, float32 unless stated, contiguous): cam (kCamFloats,), means (N, 3),
// scales (N, 3), quats (N, 4) unit (w, x, y, z), opacities (N,), sh (N, sh_stride, 3),
// mask (N,) bool as bytes, mean2d_delta (N, 2) or null. Outputs, written in full:
// mean2d (N, 2), depth (N,), conic (N, 3), color (N, 3), opacity (N,), radius (N,)
// int32, rect (4, N) int32 (x_min, y_min, x_max, y_max). `degree` is 0-3. Runs on
// `stream` without synchronising; returns cudaGetLastError() after the launch (no
// launch for n = 0).
extern "C" int gsrast_preprocess_forward(
    const float* cam, const float* means, const float* scales, const float* quats,
    const float* opacities, const float* sh, const unsigned char* mask,
    const float* mean2d_delta, int n, int sh_stride, int degree, int width, int height,
    int grid_h, int grid_w, int tile_h, int tile_w, float near_depth, float ndc_margin,
    float dilation, float inv_threshold, float extent_cap, float* mean2d, float* depth,
    float* conic, float* color, float* opacity, int* radius, int* rect, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  ForwardKernel kernel;
  size_t shared;
  int per_sm = 0, sms = 0;
  const cudaError_t e = prepare_forward(degree, sh_stride, &kernel, &shared, &per_sm, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Consts k{width, height, near_depth, ndc_margin, dilation};
  const unsigned vec = (aligned16(means) ? kVecMeans : 0) | (aligned16(scales) ? kVecScales : 0) |
                       (aligned16(quats) ? kVecQuats : 0) |
                       (aligned16(opacities) ? kVecOpacity : 0) |
                       (aligned16(mean2d_delta) ? kVecDelta : 0);
  const FwdArgs a{cam, means, scales, quats, opacities, sh, mask, mean2d_delta, n,
                  sh_stride, vec, k, grid_h, grid_w, tile_h, tile_w, inv_threshold,
                  extent_cap, mean2d, depth, conic, color, opacity, radius, rect};
  const auto blocks = static_cast<unsigned>(forward_blocks(n, per_sm, sms));
  kernel<<<blocks, kFwdThreads, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs (no mean2d_delta, which moves no gradient but its own), and
// the cotangents of mean2d (N, 2), depth (N,), conic (N, 3), color (N, 3) and
// opacity (N,), each a pointer (null: zero) with its row and column strides in
// elements. Writes every element of g_means (N, 3), g_scales (N, 3), g_quats (N, 4),
// g_opacities (N,) and g_sh (N, sh_stride, 3), contiguous. Runs on `stream` without
// synchronising; returns cudaGetLastError() after the launch (no launch for n = 0).
extern "C" int gsrast_preprocess_backward(
    const float* cam, const float* means, const float* scales, const float* quats,
    const float* sh, const unsigned char* mask, int n, int sh_stride, int degree, int width,
    int height, float near_depth, float ndc_margin, float dilation, const float* d_mean2d,
    long long d_mean2d_s0, long long d_mean2d_s1, const float* d_depth, long long d_depth_s0,
    const float* d_conic, long long d_conic_s0, long long d_conic_s1, const float* d_color,
    long long d_color_s0, long long d_color_s1, const float* d_opacity,
    long long d_opacity_s0, float* g_means, float* g_scales, float* g_quats,
    float* g_opacities, float* g_sh, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Consts k{width, height, near_depth, ndc_margin, dilation};
  const Cot cm{d_mean2d, d_mean2d_s0, d_mean2d_s1}, cd{d_depth, d_depth_s0, 0},
      cc{d_conic, d_conic_s0, d_conic_s1}, cl{d_color, d_color_s0, d_color_s1},
      co{d_opacity, d_opacity_s0, 0};
  BackwardKernel kernel;
  size_t shared;
  const cudaError_t e = prepare_backward(degree, sh_stride, &kernel, &shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(n + kBwdThreads - 1) / kBwdThreads, kBwdThreads, shared,
           static_cast<cudaStream_t>(stream)>>>(cam, means, scales, quats, sh, mask, n,
                                                sh_stride, k, cm, cd, cc, cl, co, g_means,
                                                g_scales, g_quats, g_opacities, g_sh);
  return static_cast<int>(cudaGetLastError());
}

// The backward's launch for SH rows of sh_stride coefficients at SH degree `degree`:
// threads and dynamic shared bytes a block, and the blocks of it that one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor); and
// the kernel's registers a thread, local (spilled) bytes a thread and static shared
// bytes a block (cudaFuncGetAttributes).
extern "C" int gsrast_preprocess_backward_occupancy(int sh_stride, int degree, int* threads,
                                                    int* shared_bytes, int* blocks_per_sm,
                                                    int* registers, int* local_bytes,
                                                    int* static_shared_bytes) {
  BackwardKernel kernel;
  size_t shared;
  cudaError_t e = prepare_backward(degree, sh_stride, &kernel, &shared);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kBwdThreads;
  *shared_bytes = static_cast<int>(shared);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kBwdThreads, shared));
}

// The forward's launch for n Gaussians at SH degree `degree` (SH rows of sh_stride
// coefficients): threads and dynamic shared bytes a block, the blocks of it that one
// SM of the current device holds at once, and the grid's blocks; the kernel's
// registers a thread, local (spilled) bytes a thread and static shared bytes a block
// (cudaFuncGetAttributes).
extern "C" int gsrast_preprocess_forward_occupancy(int n, int sh_stride, int degree,
                                                   int* threads, int* shared_bytes,
                                                   int* blocks_per_sm, int* grid,
                                                   int* registers, int* local_bytes,
                                                   int* static_shared_bytes) {
  ForwardKernel kernel;
  size_t shared;
  int sms = 0;
  cudaError_t e = prepare_forward(degree, sh_stride, &kernel, &shared, blocks_per_sm, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kFwdThreads;
  *shared_bytes = static_cast<int>(shared);
  *grid = static_cast<int>(forward_blocks(n, *blocks_per_sm, sms));
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
