// The viewer's ellipsoid mode for Hopper (sm_90a), bound to Python through ctypes: each
// pixel's ray against every Gaussian drawn as an opaque ellipsoid, the nearest hit's
// colour kept.
//
// Replaces no Pallas kernel. It stands for the reference's ray trace, which XLA compiles
// into the jitted frame as a lax.scan over chunks of 256 Gaussians
// (gsrast_tpu/viz/ellipsoids.py:26-100). Its plain version is
// viz/ellipsoids.py::render_ellipsoids_torch, which solves (Gaussian, 16x16 tile) pairs
// in chunks whose count only the device knows (nonzero, a host loop over the pairs, a
// chunk sized from the free memory); this kernel has static shapes and reads nothing on
// the host, so a CUDA graph captures the frame (render/frame.py::FrameGraph).
//
// Per Gaussian, the caller's prologue (viz/ellipsoids.py::ellipsoid_terms, torch ops
// shared with the plain version) gives 16 floats: R^T (row-major), isc = 1 / (2 s)
// clamped, oo = isc * (R^T o - R^T mu) and c = oo.oo - 1; its colour; and the tiles its
// bounding sphere can project to, [x0, x1) x [y0, y1), empty for a Gaussian culled
// (opacity below 0.3, masked out) or non-finite. Per pixel, with d its unit ray
// direction (camera.py::camera_rays), as the plain version computes them:
//   dd = isc * (R^T d);  a = dd.dd;  b = 2 oo.dd;  disc = b b - (4 a) c;
//   hit where disc >= 0, t0 = (-b - sqrt(disc)) / (2a), t1 = (-b + sqrt(disc)) / (2a),
//   t = t0 where t0 > 1e-4, else t1, and a hit needs 1e-4 < t < inf.
// The pixel keeps the least 64-bit key (t's bits, then the Gaussian's index): the
// nearest hit, the lowest index among equal t. It shows that Gaussian's colour, or the
// background where nothing was hit, clamped to [0, 1].
//
// What bounds it on this card: operations. A (Gaussian, tile) pair costs 256 ray
// solves of about 33 float operations to the discriminant, and a hit a square root and
// two IEEE divisions more; the bytes (each Gaussian's 96 bytes, each pixel's direction
// and colour) are a few tens of MB a frame. The span tests, each Gaussian against each
// block's region, are integer compares and L2 reads of 8 bytes.
//
// The design, simple and right first:
// - A block is a region of 4 x 4 tiles (64 x 64 pixels), 256 threads: a thread a column
//   of one tile, 16 pixels, whose directions and best keys stay in registers. A warp is
//   two neighbouring tiles of one row.
// - A first launch packs each Gaussian's span into the regions it meets, four 16-bit
//   bounds in 8 bytes (empty: all zero), so that the walk below reads half the bytes of
//   the spans: it is bound by the L2's rate (every block reads every Gaussian's).
// - The block walks the Gaussians 2,048 at a time, 8 a thread in 16-byte loads: those
//   whose regions hold the block's go into a list in shared memory (a shared counter).
//   Once the list holds 256 or the Gaussians are done, the block stages the listed
//   Gaussians' terms and spans in shared memory, 256 at a time, and every thread solves
//   its pixels against each staged Gaussian whose span holds its tile; then the list
//   empties. The order of the list does not matter: the least key wins.
// - The writes: each pixel once, 12 bytes, a half-warp a contiguous row of 16 pixels.
// - No allocation (the wrapper gives the packed regions' room), no atomics outside
//   shared memory, no host synchronisation.
//
// Rounding: each operation is rounded alone (the _rn intrinsics, never contracted into
// fused multiply-adds; the square root and the divisions IEEE), in the plain version's
// order, whose 3-term sums are written out left to right; so the kernel equals the
// plain version run on the card pixel for pixel.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 16;                             // pixels a tile side
constexpr int kRegion = 4;                            // tiles a block's region side
constexpr int kThreads = kRegion * kRegion * kTile;   // 256: a thread a tile column
constexpr int kLoads = 4;                             // 16-byte loads a thread a pass
constexpr int kTest = 2 * kLoads;                     // Gaussians a thread tests a pass
constexpr int kPass = kThreads * kTest;               // Gaussians tested a pass
constexpr int kFlush = kThreads;                      // solve once this many are listed
constexpr int kList = kFlush + kPass;                 // the list's room
constexpr int kTerms = 16;                            // floats a Gaussian's terms
constexpr float kTMin = 1e-4f;                        // viz/ellipsoids.py::T_MIN
constexpr unsigned long long kNoHit = ~0ull;

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

__device__ __forceinline__ bool holds(int4 span, int tx, int ty) {
  return tx >= span.x && tx < span.y && ty >= span.z && ty < span.w;
}

// Solves this thread's 16 pixels against Gaussian g, whose terms `q` are staged in
// shared memory, keeping the least keys.
__device__ __forceinline__ void solve(const float4* q, int g, const float (&d)[kTile][3],
                                      unsigned long long (&best)[kTile]) {
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  // R^T's rows (q0.x q0.y q0.z | q0.w q1.x q1.y | q1.z q1.w q2.x), isc, oo, c.
  const float is0 = q2.y, is1 = q2.z, is2 = q2.w;
  const float oo0 = q3.x, oo1 = q3.y, oo2 = q3.z, c = q3.w;
  const unsigned long long index = static_cast<unsigned>(g);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float dd0 = __fmul_rn(dot3(q0.x, q0.y, q0.z, d[j][0], d[j][1], d[j][2]), is0);
    const float dd1 = __fmul_rn(dot3(q0.w, q1.x, q1.y, d[j][0], d[j][1], d[j][2]), is1);
    const float dd2 = __fmul_rn(dot3(q1.z, q1.w, q2.x, d[j][0], d[j][1], d[j][2]), is2);
    const float a = dot3(dd0, dd1, dd2, dd0, dd1, dd2);
    const float b = __fmul_rn(2.0f, dot3(oo0, oo1, oo2, dd0, dd1, dd2));
    const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(__fmul_rn(4.0f, a), c));
    if (!(disc >= 0.0f)) continue;  // no hit (NaN included)
    const float sq = __fsqrt_rn(disc);
    const float a2 = __fmul_rn(2.0f, a);
    const float t0 = __fdiv_rn(__fsub_rn(-b, sq), a2);
    const float t1 = __fdiv_rn(__fadd_rn(-b, sq), a2);
    const float t = t0 > kTMin ? t0 : t1;
    if (t > kTMin && t < INFINITY) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | index;
      best[j] = key < best[j] ? key : best[j];
    }
  }
}

// Each Gaussian's span [x0, x1) x [y0, y1) in tiles as the regions it meets, 16 bits a
// bound: x (first | end << 16), y (first | end << 16); zero for an empty span and past
// n, up to `padded`.
__global__ void regions_kernel(const int4* __restrict__ spans, int n, int padded,
                               uint2* __restrict__ regions) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= padded) return;
  uint2 r = make_uint2(0u, 0u);
  if (g < n) {
    const int4 sp = spans[g];
    if (sp.x < sp.y && sp.z < sp.w)
      r = make_uint2(static_cast<unsigned>(sp.x / kRegion) |
                         static_cast<unsigned>((sp.y + kRegion - 1) / kRegion) << 16,
                     static_cast<unsigned>(sp.z / kRegion) |
                         static_cast<unsigned>((sp.w + kRegion - 1) / kRegion) << 16);
  }
  regions[g] = r;
}

__device__ __forceinline__ bool meets(unsigned rx, unsigned ry, unsigned bx, unsigned by) {
  return bx >= (rx & 0xffffu) && bx < (rx >> 16) && by >= (ry & 0xffffu) && by < (ry >> 16);
}

__global__ void __launch_bounds__(kThreads)
    ellipsoids_kernel(const float* __restrict__ terms, const int4* __restrict__ spans,
                      const uint4* __restrict__ regions, const float* __restrict__ color,
                      const float* __restrict__ dirs, const float* __restrict__ background,
                      int n, int height, int width, float* __restrict__ out) {
  __shared__ int list[kList];
  __shared__ int listed;
  __shared__ float4 staged[kThreads][kTerms / 4];
  __shared__ int4 staged_span[kThreads];
  __shared__ int staged_index[kThreads];

  const int t = threadIdx.x;
  const unsigned bx = blockIdx.x, by = blockIdx.y;
  const int k = t / kTile;  // this thread's tile in the region
  const int tx = bx * kRegion + k % kRegion, ty = by * kRegion + k / kRegion;
  const int x = tx * kTile + t % kTile;

  float d[kTile][3];
  unsigned long long best[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int y = ty * kTile + j;
    const bool inside = x < width && y < height;
    const float* dp = dirs + 3 * (static_cast<size_t>(y) * width + x);
    d[j][0] = inside ? dp[0] : 0.0f;
    d[j][1] = inside ? dp[1] : 0.0f;
    d[j][2] = inside ? dp[2] : 0.0f;
    best[j] = kNoHit;
  }

  if (t == 0) listed = 0;
  __syncthreads();
  for (int first = 0; first < n; first += kPass) {
    uint4 r[kLoads];  // two Gaussians' regions a load
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int g = first + 2 * (s * kThreads + t);
      r[s] = g < n ? regions[g / 2] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int g = first + 2 * (s * kThreads + t);
      if (meets(r[s].x, r[s].y, bx, by)) list[atomicAdd(&listed, 1)] = g;
      if (meets(r[s].z, r[s].w, bx, by)) list[atomicAdd(&listed, 1)] = g + 1;
    }
    __syncthreads();  // the list and its count are complete
    const int m = listed;
    const bool flush = m >= kFlush || first + kPass >= n;  // the same in every thread
    __syncthreads();  // every thread has read the count
    if (!flush) continue;
    if (t == 0) listed = 0;  // read again only after the last barrier below
    for (int c = 0; c < m; c += kThreads) {
      const int count = min(kThreads, m - c);
      if (t < count) {
        const int g = list[c + t];
        const float4* q = reinterpret_cast<const float4*>(terms + static_cast<size_t>(g) * kTerms);
#pragma unroll
        for (int i = 0; i < kTerms / 4; ++i) staged[t][i] = q[i];
        staged_span[t] = spans[g];
        staged_index[t] = g;
      }
      __syncthreads();  // staged
      for (int e = 0; e < count; ++e)
        if (holds(staged_span[e], tx, ty)) solve(staged[e], staged_index[e], d, best);
      __syncthreads();  // the stage and the list are read before they are rewritten
    }
  }

#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int y = ty * kTile + j;
    if (x >= width || y >= height) continue;
    const float* src =
        best[j] == kNoHit ? background : color + 3 * static_cast<size_t>(best[j] & 0xffffffffu);
    float* dst = out + 3 * (static_cast<size_t>(y) * width + x);
    dst[0] = clamp01(src[0]);
    dst[1] = clamp01(src[1]);
    dst[2] = clamp01(src[2]);
  }
}

}  // namespace

// The frame: `terms` (n, 16) float32, `spans` (n, 4) int32, `color` (n, 3) float32,
// `dirs` (height, width, 3) float32, `background` (3,) float32, all contiguous on the
// card; `regions` the room of (n + 1) / 2 * 2 packed regions (8 bytes each, 16-byte
// aligned), which the first launch writes; writes `out` (height, width, 3) float32. Two
// launches on `stream`.
extern "C" int gsrast_ellipsoids(const void* terms, const void* spans, const void* color,
                                 const void* dirs, const void* background, int n, int height,
                                 int width, void* regions, void* out, void* stream) {
  if (n < 0 || height < 1 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int padded = (n + 1) / 2 * 2;
  if (padded > 0)
    regions_kernel<<<(padded + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const int4*>(spans), n, padded, static_cast<uint2*>(regions));
  const int grid_w = (width + kTile - 1) / kTile, grid_h = (height + kTile - 1) / kTile;
  const dim3 grid((grid_w + kRegion - 1) / kRegion, (grid_h + kRegion - 1) / kRegion);
  ellipsoids_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(terms), static_cast<const int4*>(spans),
      static_cast<const uint4*>(regions), static_cast<const float*>(color),
      static_cast<const float*>(dirs), static_cast<const float*>(background), n, height,
      width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch, as the library reports it: threads a block, the blocks one SM
// holds at once, registers and local (spilled) bytes a thread, static shared bytes a
// block.
extern "C" int gsrast_ellipsoids_occupancy(int* threads, int* blocks_per_sm, int* registers,
                                           int* local_bytes, int* static_shared) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ellipsoids_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ellipsoids_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_shared = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
