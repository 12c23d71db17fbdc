// The viewer's ellipsoid mode for Hopper (sm_90a), bound to Python through ctypes: each
// pixel's ray against every Gaussian drawn as an opaque ellipsoid, the nearest hit's
// colour kept.
//
// Replaces no Pallas kernel. It stands for the reference's ray trace, which XLA compiles
// into the jitted frame as a lax.scan over chunks of 256 Gaussians
// (gsrast_tpu/viz/ellipsoids.py:26-100). Its plain version is
// viz/ellipsoids.py::render_ellipsoids_torch (the prologue `ellipsoid_terms`, the rays
// of camera.py::camera_rays, then (Gaussian, 16x16 tile) pairs solved in chunks). The
// frame here has static shapes and reads nothing on the host, so a CUDA graph captures
// it (render/frame.py::FrameGraph).
//
// What it computes, as the plain version does, each operation rounded alone (the _rn
// intrinsics, never contracted into fused multiply-adds; square roots and divisions
// IEEE), every 3-term sum written out left to right:
// - Per Gaussian (the first launch, `terms_kernel`, `ellipsoid_terms`' order): R from
//   the unit quaternion, isc = 1 / max(2 s, 1e-8), oo = (R^T o - R^T mu) * isc,
//   c = oo.oo - 1, the colour 0.2 SH-DC + 0.5, and the tiles [x0, x1) x [y0, y1) that
//   its bounding sphere (radius: the largest semi-axis x 1.001 + 1e-6 (|mu_cam| + 1))
//   can project to, widened by 2 pixels: empty below opacity 0.3, masked out or
//   non-finite, the whole image where the sphere crosses the camera's plane.
// - Per pixel (camera_rays' order): d = normalise(V^T (px tan_x, py tan_y, 1)).
// - Per (Gaussian, pixel) of a span's tiles: dd = isc * (R^T d), a = dd.dd, and the
//   plain version's b = 2 oo.dd, disc = b b - (4a) c, t0 = (-b - sqrt(disc)) / (2a),
//   t1 = (-b + sqrt(disc)) / (2a), t = t0 where t0 > 1e-4, else t1; a hit where
//   disc >= 0 and 1e-4 < t < inf. The pixel keeps the least 64-bit key (t's bits, then
//   the Gaussian's index) and shows that Gaussian's colour, or the background, clamped
//   to [0, 1].
// The solve drops the exact scalings: with b' = oo.dd and disc' = b' b' - a c,
// t0 = (-b' - sqrt(disc')) / a gives the same bits (x2 and x4 commute with rounding)
// wherever no intermediate overflows and a c is not subnormal. A Gaussian whose terms
// cannot promise that for a unit ray (`scaled_exact`) takes the written-out form.
//
// The launches of a frame (a 1080p image has 510 regions of 4 x 4 tiles):
// 1. `terms_kernel`, a thread a Gaussian: its 16 terms, span and colour into the
//    scratch; its span packed as the regions it meets (16-bit bounds, 8 bytes); and its
//    (Gaussian, tile) pairs added to each region's count (summed per block in shared
//    memory, then one atomic a block and region).
// 2. `plan_kernel`, one block: each region with pairs gets ceil(pairs / q) items, each a
//    range of the Gaussians (q spreads the frame's pairs over about six items a
//    resident block); the regions split in several first.
// 3. `trace_kernel`, persistent blocks (the card's resident blocks, from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor) taking items from a queue. An item
//    walks its range's packed regions 2,048 at a time into a shared list; from the list
//    it stages up to 256 Gaussians' terms in shared memory and expands each into the
//    per-tile lists of the region's 16 tiles it covers. Units of (tile, up to 64
//    Gaussians of its list) go to whichever warp is free (a shared counter); a warp
//    solves its tile, 8 pixels a lane, all discriminants first and then the hits, each
//    hit merged into its pixel's key in shared memory (8 bytes a pixel, a 64-bit
//    atomicMin where it beats the stored key). At the item's end the region's keys go
//    to the frame's key image by a 64-bit atomicMin: a region's items may run on
//    several blocks. 3 blocks of 256 an SM (80 registers, no spills; 63.7 KB of shared
//    memory each); the item's loop state lives in shared memory, read again after each
//    barrier, so that no register holds it through the units.
// 4. `resolve_kernel`, a thread a pixel: its key's colour or the background, clamped.
// The keys' minimum does not depend on the order, so the image is deterministic.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 16;                                  // pixels a tile side
constexpr int kTilePixels = kTile * kTile;                 // 256
constexpr int kRegion = 4;                                 // tiles a region side
constexpr int kRegionTiles = kRegion * kRegion;            // 16
constexpr int kRegionPixels = kRegionTiles * kTilePixels;  // 4,096
constexpr int kThreads = 256;                              // the trace's block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTilePixels / 32;                    // 8 pixels a lane
constexpr int kLoads = 4;                                  // 16-byte loads a thread a pass
constexpr int kPass = kThreads * 2 * kLoads;               // Gaussians tested a pass
constexpr int kStage = kThreads;                           // Gaussians staged at once
constexpr int kList = kStage + kPass;                      // the walk list's room
constexpr int kUnit = 64;                                  // Gaussians of a tile a unit
constexpr int kTerms = 16;                                 // floats of a Gaussian's terms
constexpr int kItemsPerBlock = 6;                          // items planned a resident block
constexpr int kMinRange = 2048;                            // Gaussians an item walks, at least
constexpr int kMaxSplit = 4096;                            // items a region, at most
constexpr int kPrologueThreads = 256;
constexpr int kPairBins = 4096;                            // regions a block sums in shared
constexpr int kPlanThreads = 256;
constexpr int kResolveThreads = 256;
constexpr float kTMin = 1e-4f;                             // viz/ellipsoids.py::T_MIN
constexpr float kFloatMax = 3.402823466e38f;
constexpr unsigned long long kNoHit = ~0ull;
constexpr unsigned kWrittenOut = 0x80000000u;              // a staged index's flag
constexpr int kDevices = 64;                               // devices whose occupancy is kept

#ifdef ELLIPSOID_PROBE
// Counters (diag/ellipsoid_probe.py): per block [cycles, warps, then its cycles in each
// phase: the walk (records read and listed), staging (terms staged, per-tile lists,
// units planned), units (the warps' solves, to the barrier after them), the merge (keys
// into the frame's), the rest (the queue)], then per warp [cycles in units, Gaussian
// iterations, lanes with a pixel in the image, pixel solves in the image,
// discriminants >= 0, hits kept as keys].
constexpr int kPhases = 5;
constexpr int kRecord = 2 + kPhases + 6 * kWarps;
#define PROBE(...) __VA_ARGS__
// The cycles since the last phase's end, added to phase i (block-wide, after a barrier).
#define PHASE(i)                       \
  {                                    \
    const long long now = clock64();   \
    phase[i] += now - phase_mark;      \
    phase_mark = now;                  \
  }
#else
#define PROBE(...)
#endif

// x.y, summed left to right, each operation rounded alone.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1,
                                      float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)), __fmul_rn(x2, y2));
}

// torch.clamp(v, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float v) {
  const float m = v < 0.0f ? 0.0f : v;
  return 1.0f < m ? 1.0f : m;
}

// torch's amax / amin of two: NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// The offsets of the scratch's parts, in bytes: the terms (n x 16 floats), spans (n
// int4), packed regions (n rounded up to even, 8 bytes each), colours (n x 3 floats),
// each region's pairs (int), the queue (next item, items), the items (int2), the key
// image (height x width, 8 bytes each); [8] is the total.
struct Layout {
  long long terms, spans, records, color, pairs, queue, items, keys, total;
};

__host__ __device__ inline int regions_x(int width) {
  return ((width + kTile - 1) / kTile + kRegion - 1) / kRegion;
}
__host__ __device__ inline int regions_y(int height) {
  return ((height + kTile - 1) / kTile + kRegion - 1) / kRegion;
}

// Items a frame may plan: a region's ceil(pairs / q) sums to at most the target plus
// one a region.
inline int item_room(int regions, int resident) { return regions + kItemsPerBlock * resident; }

inline Layout layout(int n, int height, int width, int resident) {
  const auto up = [](long long v) { return (v + 255) / 256 * 256; };
  const int regions = regions_x(width) * regions_y(height);
  Layout l;
  l.terms = 0;
  l.spans = up(l.terms + 64ll * n);
  l.records = up(l.spans + 16ll * n);
  l.color = up(l.records + 8ll * ((n + 1) / 2 * 2));
  l.pairs = up(l.color + 12ll * n);
  l.queue = up(l.pairs + 4ll * regions);
  l.items = up(l.queue + 8);
  l.keys = up(l.items + 8ll * item_room(regions, resident));
  l.total = up(l.keys + 8ll * height * width);
  return l;
}

// Gaussian g's part of the first launch: the prologue of `ellipsoid_terms`; its
// span's (Gaussian, tile) pairs added to each region's count in `pairs`. `view` (4, 4)
// row-major, `position` (3,), `tan_x`, `tan_y` the camera's, on the card.
__device__ __forceinline__ void gaussian_terms(
    int g, const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ quats, const float* __restrict__ opacities,
    const float* __restrict__ sh, int sh_stride, const unsigned char* __restrict__ mask,
    const float* __restrict__ view, const float* __restrict__ position,
    const float* __restrict__ tan_x, const float* __restrict__ tan_y, int height, int width,
    float* __restrict__ terms, int4* __restrict__ spans, uint2* __restrict__ records,
    float* __restrict__ color, int* pairs) {
  const int grid_w = (width + kTile - 1) / kTile, grid_h = (height + kTile - 1) / kTile;
  // R from the quaternion (ops/covariance.py::quat_to_rotmat), then R^T's rows.
  const float qw = quats[4 * g], qx = quats[4 * g + 1], qy = quats[4 * g + 2],
              qz = quats[4 * g + 3];
  const auto one_less = [](float u, float v) {
    return __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(u, v)));
  };
  const auto twice = [](float v) { return __fmul_rn(2.0f, v); };
  const float r00 = one_less(__fmul_rn(qy, qy), __fmul_rn(qz, qz));
  const float r01 = twice(__fsub_rn(__fmul_rn(qx, qy), __fmul_rn(qw, qz)));
  const float r02 = twice(__fadd_rn(__fmul_rn(qx, qz), __fmul_rn(qw, qy)));
  const float r10 = twice(__fadd_rn(__fmul_rn(qx, qy), __fmul_rn(qw, qz)));
  const float r11 = one_less(__fmul_rn(qx, qx), __fmul_rn(qz, qz));
  const float r12 = twice(__fsub_rn(__fmul_rn(qy, qz), __fmul_rn(qw, qx)));
  const float r20 = twice(__fsub_rn(__fmul_rn(qx, qz), __fmul_rn(qw, qy)));
  const float r21 = twice(__fadd_rn(__fmul_rn(qy, qz), __fmul_rn(qw, qx)));
  const float r22 = one_less(__fmul_rn(qx, qx), __fmul_rn(qy, qy));
  const float rt[3][3] = {{r00, r10, r20}, {r01, r11, r21}, {r02, r12, r22}};
  const float o[3] = {position[0], position[1], position[2]};
  const float mu[3] = {means[3 * g], means[3 * g + 1], means[3 * g + 2]};
  float isc[3], oo[3], semi = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float s2 = __fmul_rn(scales[3 * g + i], 2.0f);
    const float clamped = s2 != s2 ? s2 : (s2 < 1e-8f ? 1e-8f : s2);
    isc[i] = __fdiv_rn(1.0f, clamped);
    const float ro = dot3(rt[i][0], rt[i][1], rt[i][2], o[0], o[1], o[2]);
    const float rm = dot3(rt[i][0], rt[i][1], rt[i][2], mu[0], mu[1], mu[2]);
    oo[i] = __fmul_rn(__fsub_rn(ro, rm), isc[i]);
    const float axis = __fdiv_rn(1.0f, isc[i]);
    semi = i == 0 ? axis : max_nan(semi, axis);
  }
  const float c = __fsub_rn(dot3(oo[0], oo[1], oo[2], oo[0], oo[1], oo[2]), 1.0f);
  float4* out = reinterpret_cast<float4*>(terms + static_cast<size_t>(g) * kTerms);
  out[0] = make_float4(r00, r10, r20, r01);
  out[1] = make_float4(r11, r21, r02, r12);
  out[2] = make_float4(r22, isc[0], isc[1], isc[2]);
  out[3] = make_float4(oo[0], oo[1], oo[2], c);
  for (int k = 0; k < 3; ++k)
    color[3 * g + k] = __fadd_rn(__fmul_rn(sh[static_cast<size_t>(g) * sh_stride + k], 0.2f),
                                 0.5f);

  // The bounding sphere in camera space (viz/ellipsoids.py::_to_camera and _spans).
  float mc[3], far = 0.0f;
  for (int j = 0; j < 3; ++j) {
    mc[j] = __fadd_rn(dot3(mu[0], mu[1], mu[2], view[4 * j], view[4 * j + 1], view[4 * j + 2]),
                      view[4 * j + 3]);
    far = j == 0 ? fabsf(mc[j]) : max_nan(far, fabsf(mc[j]));
  }
  const float radius =
      __fadd_rn(__fmul_rn(semi, 1.001f), __fmul_rn(__fadd_rn(far, 1.0f), 1e-6f));
  const float z_lo = __fsub_rn(mc[2], radius), z_hi = __fadd_rn(mc[2], radius);
  int bound[2][2];  // [x | y][first, end)
  for (int axis = 0; axis < 2; ++axis) {
    const float lo = __fsub_rn(mc[axis], radius), hi = __fadd_rn(mc[axis], radius);
    const float tan_half = axis == 0 ? *tan_x : *tan_y;
    const int size = axis == 0 ? width : height, grid = axis == 0 ? grid_w : grid_h;
    const float s0 = __fdiv_rn(lo, z_lo), s1 = __fdiv_rn(lo, z_hi), s2 = __fdiv_rn(hi, z_lo),
                s3 = __fdiv_rn(hi, z_hi);
    const float smin = min_nan(min_nan(min_nan(s0, s1), s2), s3);
    const float smax = max_nan(max_nan(max_nan(s0, s1), s2), s3);
    const float fn = static_cast<float>(size);
    const auto to_pix = [&](float s) {
      return __fsub_rn(
          __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(s, tan_half), 1.0f), 0.5f), fn), 0.5f);
    };
    const auto finite = [](float v, float nan) {
      return v != v ? nan : (v > kFloatMax ? kFloatMax : (v < -kFloatMax ? -kFloatMax : v));
    };
    const auto clamp = [](float v, float lo_, float hi_) {
      const float m = v < lo_ ? lo_ : v;
      return m > hi_ ? hi_ : m;
    };
    const float p_lo = clamp(finite(__fsub_rn(to_pix(smin), 2.0f), fn), 0.0f,
                             __fsub_rn(fn, 1.0f));
    const float p_hi = clamp(finite(__fadd_rn(to_pix(smax), 2.0f), -1.0f), -1.0f,
                             __fsub_rn(fn, 1.0f));
    const int first = static_cast<int>(floorf(__fmul_rn(p_lo, 0.0625f)));
    const int end = p_hi >= p_lo ? static_cast<int>(floorf(__fmul_rn(p_hi, 0.0625f))) + 1
                                 : first;
    bound[axis][0] = min(first, grid);
    bound[axis][1] = min(end, grid);
  }
  if (!(z_lo > 0.0f) && z_hi > 0.0f) {  // across the camera's plane: anywhere
    bound[0][0] = bound[1][0] = 0;
    bound[0][1] = grid_w;
    bound[1][1] = grid_h;
  }
  if (!(z_hi > 0.0f)) bound[0][1] = bound[0][0];  // behind the camera
  const bool live = opacities[g] >= 0.3f && mask[g] != 0;
  if (!live) bound[0][1] = bound[0][0];
  const int x0 = bound[0][0], x1 = bound[0][1], y0 = bound[1][0], y1 = bound[1][1];
  spans[g] = make_int4(x0, x1, y0, y1);
  uint2 r = make_uint2(0u, 0u);
  if (x0 < x1 && y0 < y1) {
    const int rx0 = x0 / kRegion, rx1 = (x1 + kRegion - 1) / kRegion;
    const int ry0 = y0 / kRegion, ry1 = (y1 + kRegion - 1) / kRegion;
    r = make_uint2(static_cast<unsigned>(rx0) | static_cast<unsigned>(rx1) << 16,
                   static_cast<unsigned>(ry0) | static_cast<unsigned>(ry1) << 16);
    const int per_row = regions_x(width);
    for (int ry = ry0; ry < ry1; ++ry) {
      const int h = min(y1, (ry + 1) * kRegion) - max(y0, ry * kRegion);
      for (int rx = rx0; rx < rx1; ++rx) {
        const int w = min(x1, (rx + 1) * kRegion) - max(x0, rx * kRegion);
        atomicAdd(&pairs[ry * per_row + rx], w * h);
      }
    }
  }
  records[g] = r;
}

// The first launch, a thread a Gaussian (`gaussian_terms`), and the padding's empty
// record. A block sums its pairs per region in shared memory first, where the regions
// fit, and adds each nonzero sum to the frame's once: the busy regions' counts are
// otherwise a few addresses that every Gaussian's atomic waits on.
__global__ void __launch_bounds__(kPrologueThreads)
    terms_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                 const float* __restrict__ quats, const float* __restrict__ opacities,
                 const float* __restrict__ sh, int sh_stride,
                 const unsigned char* __restrict__ mask, const float* __restrict__ view,
                 const float* __restrict__ position, const float* __restrict__ tan_x,
                 const float* __restrict__ tan_y, int n, int height, int width,
                 float* __restrict__ terms, int4* __restrict__ spans,
                 uint2* __restrict__ records, float* __restrict__ color,
                 int* __restrict__ pairs) {
  __shared__ int block_pairs[kPairBins];
  const int regions = regions_x(width) * regions_y(height);
  const bool local = regions <= kPairBins;
  if (local)
    for (int r = threadIdx.x; r < regions; r += blockDim.x) block_pairs[r] = 0;
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n)
    gaussian_terms(g, means, scales, quats, opacities, sh, sh_stride, mask, view, position,
                   tan_x, tan_y, height, width, terms, spans, records, color,
                   local ? block_pairs : pairs);
  else if (g < (n + 1) / 2 * 2)
    records[g] = make_uint2(0u, 0u);
  __syncthreads();
  if (local)
    for (int r = threadIdx.x; r < regions; r += blockDim.x)
      if (block_pairs[r] != 0) atomicAdd(&pairs[r], block_pairs[r]);
}

// The second launch, one block: the items. Each region with pairs gets
// k = min(ceil(pairs / q), n / kMinRange, kMaxSplit) items (at least one), item s of k
// walking the Gaussians [s n / k, (s + 1) n / k) rounded down to even; q = the frame's
// pairs over kItemsPerBlock x `resident`. Regions split in two or more are listed
// first. Writes the queue: the next item (0) and the count.
__global__ void __launch_bounds__(kPlanThreads)
    plan_kernel(const int* __restrict__ pairs, int regions, int n, int resident,
                int2* __restrict__ items, int* __restrict__ queue) {
  __shared__ long long sums[kPlanThreads];
  __shared__ int counts[kPlanThreads];
  const int t = threadIdx.x;
  const int chunk = (regions + kPlanThreads - 1) / kPlanThreads;
  const int from = min(regions, t * chunk), to = min(regions, from + chunk);
  long long mine = 0;
  for (int r = from; r < to; ++r) mine += pairs[r];
  sums[t] = mine;
  __syncthreads();
  for (int off = kPlanThreads / 2; off > 0; off /= 2) {  // the frame's pairs
    if (t < off) sums[t] += sums[t + off];
    __syncthreads();
  }
  const long long total = sums[0];
  const long long target = static_cast<long long>(kItemsPerBlock) * resident;
  const long long q = total > 0 ? (total + target - 1) / target : 1;
  const int max_split = max(1, min(kMaxSplit, n / kMinRange));
  const auto splits = [&](int r) {
    const long long p = pairs[r];
    const long long k = (p + q - 1) / q;
    return p == 0 ? 0 : static_cast<int>(k < max_split ? k : max_split);
  };
  int base = 0;
  for (int pass = 0; pass < 2; ++pass) {  // split regions first, then the rest
    int own = 0;
    for (int r = from; r < to; ++r) {
      const int k = splits(r);
      if ((pass == 0) == (k >= 2)) own += k;
    }
    __syncthreads();  // the sums (and the last pass's counts) are read
    counts[t] = own;
    __syncthreads();
    for (int off = 1; off < kPlanThreads; off *= 2) {  // inclusive scan
      const int v = t >= off ? counts[t - off] : 0;
      __syncthreads();
      counts[t] += v;
      __syncthreads();
    }
    int at = base + counts[t] - own;
    for (int r = from; r < to; ++r) {
      const int k = splits(r);
      if ((pass == 0) != (k >= 2)) continue;
      for (int s = 0; s < k; ++s) items[at++] = make_int2(r, s | k << 16);
    }
    base += counts[kPlanThreads - 1];
  }
  if (t == 0) {
    queue[0] = 0;
    queue[1] = base;
  }
}

// Whether the solve without its x2 and x4 is exact for this Gaussian on any unit ray:
// R^T's rows orthonormal to 2^-8 (so |R^T d| >= 0.99), isc in [2^-28, 2^28], |oo| <=
// 2^28 (nothing overflows) and min(isc)^2 |c| >= 2^-98 (so |a c| >= 2^-99 is normal,
// and a b' b' below 2^-126 vanishes against it in both forms). NaN fails.
__device__ __forceinline__ bool scaled_exact(const float4 (&q)[4]) {
  const float r[3][3] = {{q[0].x, q[0].y, q[0].z}, {q[0].w, q[1].x, q[1].y},
                         {q[1].z, q[1].w, q[2].x}};
  const float isc[3] = {q[2].y, q[2].z, q[2].w}, oo[3] = {q[3].x, q[3].y, q[3].z};
  const float tol = 0.00390625f, small = 3.7252903e-09f, big = 268435456.0f;
  bool ok = true;
  for (int i = 0; i < 3; ++i) {
    const float norm = dot3(r[i][0], r[i][1], r[i][2], r[i][0], r[i][1], r[i][2]);
    ok = ok && fabsf(norm - 1.0f) <= tol && isc[i] >= small && isc[i] <= big &&
         fabsf(oo[i]) <= big;
    for (int j = i + 1; j < 3; ++j)
      ok = ok && fabsf(dot3(r[i][0], r[i][1], r[i][2], r[j][0], r[j][1], r[j][2])) <= tol;
  }
  const float m = fminf(fminf(isc[0], isc[1]), isc[2]);
  return ok && m * m * fabsf(q[3].w) >= 3.1554436e-30f;  // 2^-98
}

// This lane's 8 pixels of tile (tx, ty): row 2j + lane / 16, column lane % 16; each ray
// direction as camera_rays computes it (zero outside the image).
__device__ __forceinline__ void tile_directions(int tx, int ty, int lane, int width,
                                                int height, const float* cam,
                                                float (&d)[kRows][3]) {
  const float inv_w = __fdiv_rn(1.0f, static_cast<float>(width));
  const float inv_h = __fdiv_rn(1.0f, static_cast<float>(height));
  const int x = tx * kTile + lane % 16;
  const float px = __fmul_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), inv_w), 2.0f),
                1.0f),
      cam[9]);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = ty * kTile + 2 * j + lane / 16;
    const float py = __fmul_rn(
        __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), inv_h), 2.0f),
                  1.0f),
        cam[10]);
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)  // (px, py, 1) V[:3, :3], the last product exact
      w[k] = __fadd_rn(__fadd_rn(__fmul_rn(px, cam[k]), __fmul_rn(py, cam[3 + k])), cam[6 + k]);
    const float norm = __fsqrt_rn(dot3(w[0], w[1], w[2], w[0], w[1], w[2]));
    const bool inside = x < width && y < height;
#pragma unroll
    for (int k = 0; k < 3; ++k) d[j][k] = inside ? __fdiv_rn(w[k], norm) : 0.0f;
  }
}

struct Counts {
  unsigned long long iterations, lanes, solves, discs, keys;
};

// This lane's 8 pixels against one staged Gaussian (terms q4, index `index`): every
// discriminant first, then the hits, each merged into its pixel's key in shared memory
// (`kept`, pixel j at kept[32 j]) where it beats it. `Scaled`: without the exact x2 and
// x4 (scaled_exact holds), else the plain version's written-out form.
template <bool Scaled>
__device__ __forceinline__ void solve(const float4* q4, unsigned index,
                                      const float (&d)[kRows][3], unsigned long long* kept,
                                      unsigned inside PROBE(, Counts& counts)) {
  const float4 q0 = q4[0], q1 = q4[1], q2 = q4[2], q3 = q4[3];
  const float c = q3.w;
  PROBE(counts.iterations += 1; counts.lanes += inside != 0u;)
  float a[kRows], b[kRows], disc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float dd0 = __fmul_rn(dot3(q0.x, q0.y, q0.z, d[j][0], d[j][1], d[j][2]), q2.y);
    const float dd1 = __fmul_rn(dot3(q0.w, q1.x, q1.y, d[j][0], d[j][1], d[j][2]), q2.z);
    const float dd2 = __fmul_rn(dot3(q1.z, q1.w, q2.x, d[j][0], d[j][1], d[j][2]), q2.w);
    a[j] = dot3(dd0, dd1, dd2, dd0, dd1, dd2);
    const float bp = dot3(q3.x, q3.y, q3.z, dd0, dd1, dd2);
    if (Scaled) {  // b' = b / 2, disc' = disc / 4, a: t0 = (-b' - sqrt(disc')) / a
      b[j] = bp;
      disc[j] = __fsub_rn(__fmul_rn(bp, bp), __fmul_rn(a[j], c));
    } else {
      b[j] = __fmul_rn(2.0f, bp);
      disc[j] = __fsub_rn(__fmul_rn(b[j], b[j]), __fmul_rn(__fmul_rn(4.0f, a[j]), c));
      a[j] = __fmul_rn(2.0f, a[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    PROBE(counts.solves += inside >> j & 1u; counts.discs += (inside >> j & 1u) && disc[j] >= 0.0f;)
    if (!(disc[j] >= 0.0f)) continue;  // no hit (NaN included)
    const float sq = __fsqrt_rn(disc[j]);
    float t = __fdiv_rn(__fsub_rn(-b[j], sq), a[j]);
    if (!(t > kTMin)) t = __fdiv_rn(__fadd_rn(-b[j], sq), a[j]);  // t1 only where needed
    if (t > kTMin && t < INFINITY) {
      PROBE(counts.keys += inside >> j & 1u;)
      const unsigned long long key =
          static_cast<unsigned long long>(__float_as_uint(t)) << 32 | index;
      if (key < kept[32 * j]) atomicMin(&kept[32 * j], key);
    }
  }
}

struct Shared {
  unsigned long long keys[kRegionPixels];          // the region's least keys
  float4 staged[kStage][kTerms / 4];               // the staged Gaussians' terms
  unsigned staged_index[kStage];                   // their indices (| kWrittenOut)
  unsigned char tile_list[kRegionTiles][kStage];   // per tile, the staged slots it holds
  int list[kList];                                 // the walk's listed Gaussians
  int tile_count[kRegionTiles];
  int unit_count[kRegionTiles];
  int unit_start[kRegionTiles + 1];
  int warp_unit[kWarps];
  float cam[11];  // V[:3, :3] row-major, tan_x, tan_y
  // The item's state, block-uniform, read again after each barrier (so no register
  // holds it through the units): its region, its range's next pass and end, the listed
  // Gaussians being staged and the next stage's first.
  int bx, by, first, hi, m, c0, stop;
  int next_unit, listed;
};

extern __shared__ float4 ellipsoid_shared[];

__device__ __forceinline__ bool meets(unsigned rx, unsigned ry, unsigned bx, unsigned by) {
  return bx >= (rx & 0xffffu) && bx < (rx >> 16) && by >= (ry & 0xffffu) && by < (ry >> 16);
}

// The third launch: persistent blocks over the plan's items (see the file's head).
__global__ void __launch_bounds__(kThreads, 3)
    trace_kernel(const float* __restrict__ terms, const int4* __restrict__ spans,
                 const uint4* __restrict__ records, const int2* __restrict__ items,
                 int* __restrict__ queue, const float* __restrict__ view,
                 const float* __restrict__ tan_x, const float* __restrict__ tan_y, int n,
                 int height, int width, unsigned long long* __restrict__ keys,
                 unsigned long long* __restrict__ probe) {
  Shared& s = *reinterpret_cast<Shared*>(ellipsoid_shared);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int per_row = regions_x(width);
  if (t < 9) s.cam[t] = view[4 * (t / 3) + t % 3];
  if (t == 9) s.cam[9] = *tan_x;
  if (t == 10) s.cam[10] = *tan_y;
  PROBE(const long long block_start = clock64(); unsigned long long warp_cycles = 0;
        Counts counts = {0, 0, 0, 0, 0}; long long phase_mark = block_start;
        unsigned long long phase[kPhases] = {};)
  for (int p = t; p < kRegionPixels; p += kThreads) s.keys[p] = kNoHit;
  if (t < kRegionTiles) s.tile_count[t] = 0;
  if (t == 0) s.listed = 0;
  for (;;) {
    if (t == 0) {
      const int it = atomicAdd(&queue[0], 1);
      s.stop = it >= queue[1];
      if (!s.stop) {
        const int2 item = items[it];
        const int split = item.y & 0xffff, parts = item.y >> 16;
        s.bx = item.x % per_row;
        s.by = item.x / per_row;
        s.first = static_cast<int>(static_cast<long long>(split) * n / parts) & ~1;
        s.hi = split + 1 == parts
                   ? n
                   : static_cast<int>(static_cast<long long>(split + 1) * n / parts) & ~1;
      }
    }
    __syncthreads();  // the item, the keys' reset and the list's count
    PROBE(PHASE(4))
    if (s.stop) break;
    int cached = -1;  // the tile whose directions `d` holds
    float d[kRows][3];
    while (s.first < s.hi) {
      {
        const int first = s.first, hi = s.hi, bx = s.bx, by = s.by;
        uint4 r[kLoads];  // two Gaussians' regions a load
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int g = first + 2 * (l * kThreads + t);
          r[l] = g < hi ? records[g / 2] : make_uint4(0u, 0u, 0u, 0u);
          if (g + 1 >= hi) r[l].z = r[l].w = 0u;
        }
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          const int g = first + 2 * (l * kThreads + t);
          if (meets(r[l].x, r[l].y, bx, by)) s.list[atomicAdd(&s.listed, 1)] = g;
          if (meets(r[l].z, r[l].w, bx, by)) s.list[atomicAdd(&s.listed, 1)] = g + 1;
        }
      }
      __syncthreads();  // the list and its count are complete
      if (t == 0) {
        s.m = s.listed;
        s.c0 = s.m >= kStage || s.first + kPass >= s.hi ? 0 : s.m;  // flush: from 0
        if (s.c0 == 0) s.listed = 0;
        s.first += kPass;
      }
      __syncthreads();  // the pass's state is written
      PROBE(PHASE(0))
      while (s.c0 < s.m) {
        {
          const int count = min(kStage, s.m - s.c0), bx = s.bx, by = s.by;
          if (t < count) {  // stage a Gaussian and list it under each tile it covers
            const int g = s.list[s.c0 + t];
            const float4* src =
                reinterpret_cast<const float4*>(terms + static_cast<size_t>(g) * kTerms);
            float4 q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) s.staged[t][i] = q[i] = src[i];
            s.staged_index[t] = static_cast<unsigned>(g) | (scaled_exact(q) ? 0u : kWrittenOut);
            const int4 sp = spans[g];
            const int x0 = max(sp.x - bx * kRegion, 0), x1 = min(sp.y - bx * kRegion, kRegion);
            const int y0 = max(sp.z - by * kRegion, 0), y1 = min(sp.w - by * kRegion, kRegion);
            for (int ty = y0; ty < y1; ++ty)
              for (int tx = x0; tx < x1; ++tx) {
                const int k = ty * kRegion + tx;
                s.tile_list[k][atomicAdd(&s.tile_count[k], 1)] = static_cast<unsigned char>(t);
              }
          }
        }
        __syncthreads();  // staged and listed
        if (t == 0) {  // the units: per tile ceil(count / kUnit)
          s.unit_start[0] = 0;
          for (int k = 0; k < kRegionTiles; ++k) {
            s.unit_count[k] = s.tile_count[k];
            s.unit_start[k + 1] = s.unit_start[k] + (s.tile_count[k] + kUnit - 1) / kUnit;
            s.tile_count[k] = 0;
          }
          s.next_unit = 0;
        }
        __syncthreads();
        PROBE(PHASE(1))
        for (;;) {  // a free warp takes the next unit
          if (lane == 0) s.warp_unit[warp] = atomicAdd(&s.next_unit, 1);
          __syncwarp();
          const int u = s.warp_unit[warp];
          __syncwarp();  // read before lane 0 writes again
          if (u >= s.unit_start[kRegionTiles]) break;
          int k = 0;
          while (u >= s.unit_start[k + 1]) ++k;
          const int from = (u - s.unit_start[k]) * kUnit;
          const int to = min(from + kUnit, s.unit_count[k]);
          const int tx = s.bx * kRegion + k % kRegion, ty = s.by * kRegion + k / kRegion;
          if (k != cached) {
            tile_directions(tx, ty, lane, width, height, s.cam, d);
            cached = k;
          }
          unsigned inside = 0;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            inside |= static_cast<unsigned>(tx * kTile + lane % 16 < width &&
                                            ty * kTile + 2 * j + lane / 16 < height)
                      << j;
          PROBE(const long long unit_start = clock64();)
          unsigned long long* kept = &s.keys[k * kTilePixels + lane];  // pixel j: kept[32 j]
          for (int i = from; i < to; ++i) {
            const int e = s.tile_list[k][i];
            const unsigned index = s.staged_index[e];
            if (index & kWrittenOut)
              solve<false>(s.staged[e], index & ~kWrittenOut, d, kept, inside PROBE(, counts));
            else
              solve<true>(s.staged[e], index, d, kept, inside PROBE(, counts));
          }
          PROBE(warp_cycles += clock64() - unit_start;)
        }
        __syncthreads();  // the stage and the tiles' lists are read before they are rewritten
        PROBE(PHASE(2))
        if (t == 0) s.c0 += kStage;
        __syncthreads();
        PROBE(PHASE(1))
      }
    }
    // The region's keys into the frame's, then reset.
    for (int p = t; p < kRegionPixels; p += kThreads) {
      const int k = p / kTilePixels, in_tile = p % kTilePixels;
      const int x = (s.bx * kRegion + k % kRegion) * kTile + in_tile % kTile;
      const int y = (s.by * kRegion + k / kRegion) * kTile + in_tile / kTile;
      const unsigned long long key = s.keys[p];
      if (key != kNoHit && x < width && y < height)
        atomicMin(&keys[static_cast<size_t>(y) * width + x], key);
      s.keys[p] = kNoHit;
    }
    __syncthreads();  // the keys are reset before the next item's units
    PROBE(PHASE(3))
  }
  PROBE({
    unsigned long long* rec = probe + static_cast<size_t>(blockIdx.x) * kRecord;
    unsigned long long* w = rec + 2 + kPhases + 6 * warp;
    if (lane == 0) {
      w[0] = warp_cycles;
      w[1] = counts.iterations;
    }
    atomicAdd(&w[2], counts.lanes);
    atomicAdd(&w[3], counts.solves);
    atomicAdd(&w[4], counts.discs);
    atomicAdd(&w[5], counts.keys);
    __syncthreads();
    if (t == 0) {
      rec[0] = clock64() - block_start;
      rec[1] = kWarps;
      for (int i = 0; i < kPhases; ++i) rec[2 + i] = phase[i];
    }
  })
}

// The last launch, a thread a pixel: its colour or the background, clamped.
__global__ void __launch_bounds__(kResolveThreads)
    resolve_kernel(const unsigned long long* __restrict__ keys, const float* __restrict__ color,
                   const float* __restrict__ background, int pixels, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const unsigned long long key = keys[p];
  const float* src = key == kNoHit ? background : color + 3 * static_cast<size_t>(key & 0xffffffffu);
  out[3 * p] = clamp01(src[0]);
  out[3 * p + 1] = clamp01(src[1]);
  out[3 * p + 2] = clamp01(src[2]);
}

// The trace's resident blocks on this card. Its dynamic shared memory is set and its
// occupancy asked once a device (again only if the device's SM count differs).
cudaError_t resident_blocks(int* resident, int* per_sm) {
  static std::atomic<long long> known[kDevices];  // SMs << 32 | blocks an SM; 0: not asked
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kDevices;
  const long long seen = kept ? known[dev].load(std::memory_order_relaxed) : 0;
  if (seen != 0 && seen >> 32 == sms) {
    *per_sm = static_cast<int>(seen & 0xffffffff);
  } else {
    e = cudaFuncSetAttribute(trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Shared)));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, trace_kernel, kThreads,
                                                        sizeof(Shared));
    if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidValue;
    if (e != cudaSuccess) return e;
    if (kept) known[dev].store(static_cast<long long>(sms) << 32 | *per_sm);
  }
  *resident = sms * *per_sm;
  return cudaSuccess;
}

struct Frame {
  const float *means, *scales, *quats, *opacities, *sh;
  int sh_stride;
  const unsigned char* mask;
  const float *view, *position, *tan_x, *tan_y;
  int n, height, width;
};

// The Frame of an entry point's leading arguments (gsrast_ellipsoids_terms' inputs).
#define FRAME_OF_ARGS                                                                     \
  Frame {                                                                                 \
    static_cast<const float*>(means), static_cast<const float*>(scales),                 \
        static_cast<const float*>(quats), static_cast<const float*>(opacities),          \
        static_cast<const float*>(sh), sh_stride, static_cast<const unsigned char*>(mask), \
        static_cast<const float*>(view), static_cast<const float*>(position),            \
        static_cast<const float*>(tan_x), static_cast<const float*>(tan_y), n, height, width \
  }

// The first launch (after zeroing the regions' pairs) into the scratch.
cudaError_t launch_terms(const Frame& f, unsigned char* scratch, const Layout& l,
                         cudaStream_t st) {
  const int regions = regions_x(f.width) * regions_y(f.height);
  cudaError_t e = cudaMemsetAsync(scratch + l.pairs, 0, 4ll * regions, st);
  if (e != cudaSuccess) return e;
  const int padded = (f.n + 1) / 2 * 2;
  const int blocks = (padded + kPrologueThreads - 1) / kPrologueThreads;
  if (blocks > 0)
    terms_kernel<<<blocks, kPrologueThreads, 0, st>>>(
        f.means, f.scales, f.quats, f.opacities, f.sh, f.sh_stride, f.mask, f.view, f.position,
        f.tan_x, f.tan_y, f.n, f.height, f.width, reinterpret_cast<float*>(scratch + l.terms),
        reinterpret_cast<int4*>(scratch + l.spans), reinterpret_cast<uint2*>(scratch + l.records),
        reinterpret_cast<float*>(scratch + l.color), reinterpret_cast<int*>(scratch + l.pairs));
  return cudaGetLastError();
}

cudaError_t launch_frame(const Frame& f, const float* background, unsigned char* scratch,
                         float* out, unsigned long long* probe, cudaStream_t st) {
  int resident = 0, per_sm = 0;
  cudaError_t e = resident_blocks(&resident, &per_sm);
  if (e != cudaSuccess) return e;
  const Layout l = layout(f.n, f.height, f.width, resident);
  e = launch_terms(f, scratch, l, st);
  if (e != cudaSuccess) return e;
  const int pixels = f.height * f.width;
  auto* keys = reinterpret_cast<unsigned long long*>(scratch + l.keys);
  e = cudaMemsetAsync(keys, 0xff, 8ll * pixels, st);
  if (e != cudaSuccess) return e;
  const int regions = regions_x(f.width) * regions_y(f.height);
  auto* items = reinterpret_cast<int2*>(scratch + l.items);
  auto* queue = reinterpret_cast<int*>(scratch + l.queue);
  plan_kernel<<<1, kPlanThreads, 0, st>>>(reinterpret_cast<const int*>(scratch + l.pairs),
                                          regions, f.n, resident, items, queue);
  trace_kernel<<<resident, kThreads, sizeof(Shared), st>>>(
      reinterpret_cast<const float*>(scratch + l.terms),
      reinterpret_cast<const int4*>(scratch + l.spans),
      reinterpret_cast<const uint4*>(scratch + l.records), items, queue, f.view, f.tan_x,
      f.tan_y, f.n, f.height, f.width, keys, probe);
  const int blocks = (pixels + kResolveThreads - 1) / kResolveThreads;
  resolve_kernel<<<blocks, kResolveThreads, 0, st>>>(
      keys, reinterpret_cast<const float*>(scratch + l.color), background, pixels, out);
  return cudaGetLastError();
}

bool valid(int n, int height, int width) {
  return n >= 0 && height >= 1 && width >= 1 && regions_x(width) < 65536 &&
         regions_y(height) < 65536 && static_cast<long long>(height) * width < (1ll << 31);
}

}  // namespace

// The scratch's layout for n Gaussians and a height x width image on this card, as
// nine byte offsets (terms, spans, packed regions, colours, regions' pairs, queue,
// items, keys, total).
extern "C" int gsrast_ellipsoids_scratch(int n, int height, int width, long long* offsets) {
  if (!valid(n, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0, per_sm = 0;
  const cudaError_t e = resident_blocks(&resident, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Layout l = layout(n, height, width, resident);
  const long long v[9] = {l.terms, l.spans, l.records, l.color, l.pairs,
                          l.queue, l.items, l.keys, l.total};
  for (int i = 0; i < 9; ++i) offsets[i] = v[i];
  return 0;
}

// The frame's inputs: the activated Gaussians (means, scales (n, 3), quats (n, 4),
// opacities (n,) float32, sh (n, K, 3) with `sh_stride` = 3K floats a Gaussian, mask
// (n,) bytes) and the camera (view (4, 4) row-major, position (3,), tan(fov / 2) of x
// and y), all on the card and contiguous; `scratch` of gsrast_ellipsoids_scratch's
// total bytes. Writes the terms, spans, colours and packed regions (the first launch
// alone, for the debug entry).
extern "C" int gsrast_ellipsoids_terms(const void* means, const void* scales, const void* quats,
                                       const void* opacities, const void* sh, int sh_stride,
                                       const void* mask, const void* view, const void* position,
                                       const void* tan_x, const void* tan_y, int n, int height,
                                       int width, void* scratch, void* stream) {
  if (!valid(n, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0, per_sm = 0;
  cudaError_t e = resident_blocks(&resident, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Frame f = FRAME_OF_ARGS;
  e = launch_terms(f, static_cast<unsigned char*>(scratch), layout(n, height, width, resident),
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// The frame: gsrast_ellipsoids_terms' inputs, `background` (3,) float32; writes `out`
// (height, width, 3) float32. Four launches and two memsets on `stream`.
extern "C" int gsrast_ellipsoids(const void* means, const void* scales, const void* quats,
                                 const void* opacities, const void* sh, int sh_stride,
                                 const void* mask, const void* view, const void* position,
                                 const void* tan_x, const void* tan_y, int n, int height,
                                 int width, const void* background, void* scratch, void* out,
                                 void* stream) {
  if (!valid(n, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f = FRAME_OF_ARGS;
  return static_cast<int>(launch_frame(f, static_cast<const float*>(background),
                                       static_cast<unsigned char*>(scratch),
                                       static_cast<float*>(out), nullptr,
                                       static_cast<cudaStream_t>(stream)));
}

#ifdef ELLIPSOID_PROBE
// The frame with the trace's counters: gsrast_ellipsoids' arguments, then `probe`
// (zeroed) of `blocks` x kRecord 64-bit counters (gsrast_ellipsoid_probe_shape).
extern "C" int gsrast_ellipsoid_probe(const void* means, const void* scales, const void* quats,
                                      const void* opacities, const void* sh, int sh_stride,
                                      const void* mask, const void* view, const void* position,
                                      const void* tan_x, const void* tan_y, int n, int height,
                                      int width, const void* background, void* scratch,
                                      void* out, void* stream, void* probe) {
  if (!valid(n, height, width)) return static_cast<int>(cudaErrorInvalidValue);
  const Frame f = FRAME_OF_ARGS;
  return static_cast<int>(launch_frame(f, static_cast<const float*>(background),
                                       static_cast<unsigned char*>(scratch),
                                       static_cast<float*>(out),
                                       static_cast<unsigned long long*>(probe),
                                       static_cast<cudaStream_t>(stream)));
}

// The trace's blocks and 64-bit counters a block.
extern "C" int gsrast_ellipsoid_probe_shape(int, int, int* blocks, int* record) {
  int per_sm = 0;
  const cudaError_t e = resident_blocks(blocks, &per_sm);
  *record = kRecord;
  return static_cast<int>(e);
}
#endif

// A launch as the library reports it, `kernel` 0 the first launch (terms), 1 the plan,
// 2 the trace, 3 the resolve: threads a block, blocks an SM at once, registers and local
// (spilled) bytes a thread, shared bytes a block (static and dynamic), and the grid of a
// frame of n Gaussians at height x width.
extern "C" int gsrast_ellipsoids_occupancy(int kernel, int n, int height, int width,
                                           int* threads, int* blocks_per_sm, int* registers,
                                           int* local_bytes, int* shared_bytes, int* grid) {
  if (!valid(n, height, width) || kernel < 0 || kernel > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0, per_sm = 0;
  cudaError_t e = resident_blocks(&resident, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  size_t dynamic = 0;
  if (kernel == 0) {
    *threads = kPrologueThreads;
    *grid = ((n + 1) / 2 * 2 + kPrologueThreads - 1) / kPrologueThreads;
    e = cudaFuncGetAttributes(&attr, terms_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, terms_kernel,
                                                        kPrologueThreads, 0);
  } else if (kernel == 1) {
    *threads = kPlanThreads;
    *grid = 1;
    e = cudaFuncGetAttributes(&attr, plan_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, plan_kernel,
                                                        kPlanThreads, 0);
  } else if (kernel == 2) {
    *threads = kThreads;
    *grid = resident;
    dynamic = sizeof(Shared);
    e = cudaFuncGetAttributes(&attr, trace_kernel);
    *blocks_per_sm = per_sm;
  } else {
    *threads = kResolveThreads;
    *grid = (height * width + kResolveThreads - 1) / kResolveThreads;
    e = cudaFuncGetAttributes(&attr, resolve_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, resolve_kernel,
                                                        kResolveThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes + dynamic);
  return 0;
}
