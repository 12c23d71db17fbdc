// Fault-bisection kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the four toy TPU kernels of scripts/bisect_bwd.py: `kernel_a`, `kernel_b`
// and `kernel_c` (launched by `run`, :20) and the kernel of `run_d` (:147). They
// reproduce, in small, the access pattern of the tile-blend backward: per tile t
// (one block), the tile's chunks of 128 intersections are walked newest first,
// k = nchunks-1 ... 0, where chunk k is the 16 rows x 128 lanes of feat starting at
// row start/8 + 16 k; each chunk is staged into a two-slot shared-memory ring by
// asynchronous copies, the slot of chunk k being k % 2.
//   A: out = 2 feat.
//   B: for each row r = 15 ... 0, lane 16 j (j = 0..7) = 3 feat[r, 16 j], 0 elsewhere.
//   C: a carry t_run of 8 x 128 floats starts at 1 per tile and runs through every
//      step (k, r, j) (r descending, j ascending): v = feat[r, 16 j];
//      t_run /= 1 + 0.001 v; lane 16 j of row r = sum of t_run v over the 1,024
//      elements; 0 on the row's other lanes.
//   D: as C, with idx = 128 k + 8 r + j, a = 0.001 v where idx < nc[t] and v > 0.1
//      (elementwise over the carry), else 0; t_run /= 1 + a; and the sum is of
//      t_run drgb[t, 0] ft[t]. ft, nc and drgb are per-tile (8, 128) blocks.
// Rows that no full chunk covers are not written: the wrapper zero-fills `out`.
//
// A (`bisect_kernel`) reads and writes each chunk once and is bound by memory
// bandwidth: the whole chunk is staged (cp.async, 16 bytes a thread), the next
// chunk's copy issued before the current one is computed, into a two-slot output
// buffer written back as float4.
//
// B (`lanes_kernel`) is bound by memory too. It needs 8 floats of each 512-byte
// row, 64 bytes apart, and writes whole rows; but the L2 fetches 64-byte granules
// from HBM (cudaLimitMaxL2FetchGranularity is 64 on the H100, and a streaming read
// of one float every 64 bytes takes as long as one of every float:
// diag/bisect_timing.py --probe), so its reads cost every byte of its input and it
// moves A's bytes whatever it reads. Its design moves them once, with no shared
// memory and no barrier:
// - Warp w of the block's kLanesWarps = 16 writes row w of every chunk (rows w,
//   w + kLanesWarps, ... with fewer warps), a row of 32 float4 in one warp store;
//   lane l writes quad l, which holds lane 16 j for l = 4 j, so the 8 lanes
//   l % 4 == 0 read the row's values themselves (feat[row, 4 l]) and write
//   (3 v, 0, 0, 0); the other lanes write zeros and read nothing, so NaN or inf on
//   a lane B does not read never reaches the output.
// - The values live in a register ring of kLanesAhead + 1 chunks: chunk k is
//   written while the reads of the 3 chunks after it in the walk are in flight
//   (the TPU kernel's ring is the slot k % 2 of a two-chunk buffer; in registers
//   the slot is the chunk's place in the walk).
// - The product is __fmul_rn(3, v), the plain version's bits.
// Measured against the alternatives on the H100 (PERF.md, Findings): the 128
// values staged by 4-byte cp.async into a shared ring slot k % 2, one barrier a
// chunk, was 1.5-2.5% slower on the full input and slower on the longest tile; 4
// or 8 warps a block 3-4% slower; blocks taking the tiles longest first at most
// 1.5% faster, against the 11% that the order's own launch costs, so B's blocks
// take the tiles in index order.

// C and D (`carry_kernel`) are bound by instruction issue: 1,024 divisions, products
// and sums a step, and a 1,024-element sum a step. Their design:
// - The carry stays a real (8, 128) vector in registers, kCarryPerThread elements a
//   thread, as the blend backward's transmittance is.
// - Only what the steps read is staged: lanes 16 j of the chunk's 16 rows, 128
//   floats by 4-byte cp.async, into the slot k % 2 (the first chunk processed,
//   k = nchunks-1, lands in slot (nchunks-1) % 2, not 0: the fault signature the
//   script was written to find).
// - Once per chunk, 128 threads make the step table: d = 1 + 0.001 v, r = RN(1/d)
//   (__frcp_rn), and for D the step's gate index (idx where v > 0.1, else INT_MAX,
//   so that `gate < nc` is the whole gate); every thread reads it as broadcasts.
// - A step divides each element by one correction of the reciprocal (Markstein):
//   q = RN(t r), e = fma(-q, d, t), t' = fma(e, r, q), which is RN(t / d), the bits
//   of __fdiv_rn, for d in [1, 2^20] and |t| in [2^-100, 2^100] (below that the
//   residual e can be subnormal and inexact). A chunk runs unchecked when its 128
//   divisors lie in that range and every element of the thread starts it above
//   2^-99 times their product, rounded up (so none can fall under 2^-100 within
//   it), and under 2^100; else each element is checked per step and falls to
//   __fdiv_rn outside the range. Both are exact paths of the same division. In D
//   an element that is not gated keeps its carry, as dividing by 1 + 0 does.
// - Products and sums stay separate _rn operations in the order of the plain
//   version (C: carry v; D: (carry dc) ft); only the division uses fma.
// - Each thread keeps a row's 8 partial sums and a warp reduces them together by
//   transposing as it adds (4 + 2 + 1 + 1 + 1 = 9 shuffles for 8 sums, not 40):
//   lane l ends with the warp's sum of step l / 4. The warps' partials go to shared
//   memory; after the chunk's last row the block adds each step's in warp order and
//   writes the chunk's rows whole as float4, after the next chunk's first barrier.
//   Two barriers a chunk; every sum is taken in a fixed order, so two launches give
//   the same bits.
// - Block b takes tile order[b], longest first from the wrapper
//   (render/blend.py::tile_order_cuda): at 1080p the longest tile has 4.5 times
//   the mean's chunks, and started last it would set the kernel's time.
//
// Rounding: the _rn intrinsics throughout (no contracted multiply-adds, denormals
// kept; the file is built without --use_fast_math). The 1,024-element sums are taken
// as a tree, where the plain version and the TPU reference take their own orders.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // A
constexpr int kRows = 16;                    // rows of 128 lanes per chunk
constexpr int kLanes = 128;
constexpr int kChunk = kRows * kLanes;       // floats per chunk
constexpr int kCarry = 8 * kLanes;           // elements of the carry
constexpr int kSteps = 8;                    // scalar reads per row, at lanes 16 j
constexpr int kChunkSteps = kRows * kSteps;  // steps per chunk

constexpr int kCarryThreads = 256;          // C and D
constexpr int kCarryWarps = kCarryThreads / 32;
constexpr int kCarryPerThread = kCarry / kCarryThreads;
static_assert(kCarryThreads >= kChunkSteps && kCarry % kCarryThreads == 0,
              "one table entry a thread, the carry spread evenly");

// B: warps a block, and chunks read ahead of the one written.
constexpr int kLanesWarps = 16;
constexpr int kLanesAhead = 3;

constexpr unsigned kFull = 0xffffffffu;
// The range in which one correction of the reciprocal gives RN(t / d).
constexpr float kDivisorMax = 0x1p20f;
constexpr float kCarryMin = 0x1p-100f;
constexpr float kCarryMax = 0x1p100f;

enum Mode { kModeA = 0, kModeC = 2, kModeD = 3 };

// Issue the asynchronous copy of one chunk (2,048 floats: 512 copies of 16 bytes,
// two a thread) and commit it as one group.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src) {
  for (int s = threadIdx.x; s < kChunk / 4; s += kThreads) {
    __pipeline_memcpy_async(dst + 4 * s, src + 4 * s, 16);
  }
  __pipeline_commit();
}

// A (kModeA, its only instantiation; the template keeps its symbol, and so its
// SASS digest in diag/bisect_timing.py, comparable with earlier builds).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
bisect_kernel(const int* __restrict__ starts, const float* __restrict__ feat,
              float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kChunk];
  __shared__ __align__(16) float obuf[2][kChunk];

  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int nchunks = (starts[tile + 1] - start) / 128;
  if (nchunks <= 0) return;
  const long long row0 = start / 8;

  stage_chunk(buf[(nchunks - 1) % 2], feat + (row0 + kRows * (nchunks - 1)) * kLanes);
  for (int k = nchunks - 1; k >= 0; --k) {
    const int slot = k % 2;
    if (k > 0) {
      // The next chunk's copy goes out before this one is computed. Its slot held
      // chunk k + 1, whose readers all passed the barrier that ended that chunk.
      stage_chunk(buf[(k - 1) % 2], feat + (row0 + kRows * (k - 1)) * kLanes);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // every thread's copies of chunk k have landed
    const float* b = buf[slot];
    float* o = obuf[slot];

    for (int i = threadIdx.x; i < kChunk; i += kThreads) {
      o[i] = __fmul_rn(2.0f, b[i]);
    }
    __syncthreads();  // the chunk's output is complete; its input slot is free
    float4* dst = reinterpret_cast<float4*>(out + (row0 + kRows * k) * kLanes);
    const float4* src = reinterpret_cast<const float4*>(o);
    for (int s = threadIdx.x; s < kChunk / 4; s += kThreads) dst[s] = src[s];
  }
}

// B: block b writes tile b's covered rows, its chunks walked newest first (the
// design in the header).
__global__ void __launch_bounds__(32 * kLanesWarps)
lanes_kernel(const int* __restrict__ starts, const float* __restrict__ feat,
             float* __restrict__ out) {
  static_assert(kRows % kLanesWarps == 0, "every warp writes as many rows");
  constexpr int kPer = kRows / kLanesWarps;  // rows a warp writes per chunk
  constexpr int kRing = kLanesAhead + 1;
  const int start = starts[blockIdx.x];
  const int nchunks = (starts[blockIdx.x + 1] - start) / 128;
  if (nchunks <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool reader = lane % 4 == 0;  // quad `lane` holds lane 16 (lane / 4)
  const long long row0 = start / 8 + warp;
  const float* src = feat + row0 * kLanes + 4 * lane;
  float4* dst = reinterpret_cast<float4*>(out + row0 * kLanes) + lane;
  float v[kRing][kPer];

  // The i-th chunk of the walk is k = nchunks - 1 - i; its rows kLanesWarps q + warp.
  auto read = [&](int i, float (&w)[kPer]) {
    const float* p = src + static_cast<long long>(kRows * (nchunks - 1 - i)) * kLanes;
#pragma unroll
    for (int q = 0; q < kPer; ++q) w[q] = reader ? p[kLanesWarps * q * kLanes] : 0.0f;
  };
  auto write = [&](int i, const float (&w)[kPer]) {
    float4* p = dst + static_cast<long long>(kRows * (nchunks - 1 - i)) * (kLanes / 4);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      p[kLanesWarps * q * (kLanes / 4)] =
          make_float4(reader ? __fmul_rn(3.0f, w[q]) : 0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

#pragma unroll
  for (int s = 0; s < kLanesAhead; ++s) {
    if (s < nchunks) read(s, v[s]);
  }
  for (int base = 0; base < nchunks; base += kRing) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {  // chunk i = base + s sits in slot s
      const int i = base + s;
      if (i < nchunks) {
        if (i + kLanesAhead < nchunks) {
          read(i + kLanesAhead, v[(s + kLanesAhead) % kRing]);
        }
        write(i, v[s]);
      }
    }
  }
}

// RN(t / d) from r = RN(1 / d): exact for d in [1, kDivisorMax] and |t| in
// [kCarryMin, kCarryMax].
__device__ __forceinline__ float div_corrected(float t, float d, float r) {
  const float q = __fmul_rn(t, r);
  const float e = __fmaf_rn(-q, d, t);
  return __fmaf_rn(e, r, q);
}

// RN(t / d) for any t and d: the correction inside its range, __fdiv_rn outside.
__device__ __forceinline__ float div_checked(float t, float d, float r) {
  const float a = fabsf(t);
  if (d >= 1.0f && d <= kDivisorMax && a >= kCarryMin && a <= kCarryMax) {
    return div_corrected(t, d, r);
  }
  return __fdiv_rn(t, d);
}

// One row's 8 steps on this thread's elements; p[j] = this thread's sum for step j.
template <int kMode, bool kUnchecked>
__device__ __forceinline__ void row_steps(const float4* __restrict__ tab,
                                          float (&carry)[kCarryPerThread],
                                          const float (&ftv)[kCarryPerThread],
                                          const float (&dcv)[kCarryPerThread],
                                          const int (&ncv)[kCarryPerThread],
                                          float (&p)[kSteps]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const float4 e = tab[j];  // a broadcast read: v, d, RN(1/d), D's gate index
    const int gate = __float_as_int(e.w);
#pragma unroll
    for (int q = 0; q < kCarryPerThread; ++q) {
      if (kMode == kModeC || gate < ncv[q]) {
        carry[q] = kUnchecked ? div_corrected(carry[q], e.y, e.z)
                              : div_checked(carry[q], e.y, e.z);
      }
      const float term = kMode == kModeC
                             ? __fmul_rn(carry[q], e.x)
                             : __fmul_rn(__fmul_rn(carry[q], dcv[q]), ftv[q]);
      p[j] = q == 0 ? term : __fadd_rn(p[j], term);
    }
  }
}

// The warp's sums of p[0..7], transposed as they are added: each butterfly stage
// sends half of the values still held, so lane l ends with the sum of p[l / 4] over
// the 32 lanes. Every lane adds in the same fixed order.
__device__ __forceinline__ float warp_sums8(const float (&p)[kSteps], int lane) {
  float a[4], b[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = __fadd_rn(h16 ? p[i + 4] : p[i],
                     __shfl_xor_sync(kFull, h16 ? p[i] : p[i + 4], 16));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b[i] = __fadd_rn(h8 ? a[i + 2] : a[i],
                     __shfl_xor_sync(kFull, h8 ? a[i] : a[i + 2], 8));
  }
  float c = __fadd_rn(h4 ? b[1] : b[0], __shfl_xor_sync(kFull, h4 ? b[0] : b[1], 4));
  c = __fadd_rn(c, __shfl_xor_sync(kFull, c, 2));
  return __fadd_rn(c, __shfl_xor_sync(kFull, c, 1));
}

// The minimum of one block an SM lets ptxas keep more values in flight (C 48 and
// D 56 registers, against 32 and 48 without it), which ran faster on the H100.
template <int kMode>
__global__ void __launch_bounds__(kCarryThreads, 1)
carry_kernel(const int* __restrict__ starts, const float* __restrict__ feat,
             const float* __restrict__ ft, const int* __restrict__ nc,
             const float* __restrict__ drgb, const int* __restrict__ order,
             float* __restrict__ out) {
  __shared__ float staged[2][kChunkSteps];           // v of each step
  __shared__ float4 table[2][kChunkSteps];           // v, d, RN(1/d), gate index
  __shared__ __align__(16) float warp_product[2][4];  // the stager warps' divisors
  __shared__ float red[2][kRows][kSteps][kCarryWarps];  // warps' partial sums

  const int tile = order[blockIdx.x];
  const int start = starts[tile];
  const int nchunks = (starts[tile + 1] - start) / 128;
  if (nchunks <= 0) return;
  const long long row0 = start / 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool stager = threadIdx.x < kChunkSteps;  // thread s owns step s = 8 r + j
  const int s_row = threadIdx.x / kSteps, s_lane = 16 * (threadIdx.x % kSteps);

  float carry[kCarryPerThread], ftv[kCarryPerThread], dcv[kCarryPerThread];
  int ncv[kCarryPerThread];
#pragma unroll
  for (int q = 0; q < kCarryPerThread; ++q) {
    carry[q] = 1.0f;
    ftv[q] = dcv[q] = 0.0f;
    ncv[q] = 0;
    if (kMode == kModeD) {
      const long long e = static_cast<long long>(tile) * kCarry +
                          threadIdx.x * kCarryPerThread + q;
      ftv[q] = ft[e];
      ncv[q] = nc[e];
      // drgb is (T, 3, 8, 128): channel 0 of this tile.
      dcv[q] = drgb[static_cast<long long>(tile) * 3 * kCarry +
                    threadIdx.x * kCarryPerThread + q];
    }
  }

  auto stage = [&](int k) {
    if (stager) {
      __pipeline_memcpy_async(&staged[k % 2][threadIdx.x],
                              feat + (row0 + kRows * k + s_row) * kLanes + s_lane, 4);
    }
    __pipeline_commit();
  };
  // Chunk k's rows, whole: lane 16 j of row r is the warps' sum for step (r, j),
  // added in warp order; the other lanes 0.
  auto write_rows = [&](int k) {
    float4* dst = reinterpret_cast<float4*>(out + (row0 + kRows * k) * kLanes);
    for (int f = threadIdx.x; f < kChunk / 4; f += kCarryThreads) {
      const int r = f / (kLanes / 4), quad = f % (kLanes / 4);
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (quad % 4 == 0) {
#pragma unroll
        for (int w = 0; w < kCarryWarps; ++w) {
          o.x = __fadd_rn(o.x, red[k % 2][r][quad / 4][w]);
        }
      }
      dst[f] = o;
    }
  };

  stage(nchunks - 1);
  for (int k = nchunks - 1; k >= 0; --k) {
    const int slot = k % 2;
    if (k > 0) {
      // The next chunk's copy goes out before this one is computed. Its slot held
      // chunk k + 1, whose readers all passed the barrier that ended its table.
      stage(k - 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk k's values have landed; chunk k + 1's partials are in
    if (k + 1 < nchunks) write_rows(k + 1);
    if (stager) {
      const float v = staged[slot][threadIdx.x];
      const float d = __fadd_rn(1.0f, __fmul_rn(0.001f, v));
      const int idx = 128 * k + threadIdx.x;
      table[slot][threadIdx.x] = make_float4(
          v, d, __frcp_rn(d), __int_as_float(v > 0.1f ? idx : INT_MAX));
      // The product of the warp's 32 divisors, rounded up, or +inf where one lies
      // outside [1, kDivisorMax] (NaN included), for the chunk's bound.
      float f = (d >= 1.0f && d <= kDivisorMax) ? d : __int_as_float(0x7f800000);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        f = __fmul_ru(f, __shfl_xor_sync(kFull, f, off));
      }
      if (lane == 0) warp_product[slot][warp] = f;
    }
    __syncthreads();  // the step table is complete

    const float4* tab = table[slot];
    auto finish_row = [&](int r, const float (&p)[kSteps]) {
      const float sum = warp_sums8(p, lane);
      if (lane % 4 == 0) red[slot][r][lane / 4][warp] = sum;
    };
    // The carry's range, checked once for the chunk where all its divisors allow
    // it, else per element and step.
    const float4 qp = *reinterpret_cast<const float4*>(warp_product[slot]);
    const float chunk_floor = __fmul_ru(
        0x1p-99f, __fmul_ru(__fmul_ru(qp.x, qp.y), __fmul_ru(qp.z, qp.w)));
    float lo = fabsf(carry[0]), hi = lo;
#pragma unroll
    for (int q = 1; q < kCarryPerThread; ++q) {
      lo = fminf(lo, fabsf(carry[q]));
      hi = fmaxf(hi, fabsf(carry[q]));
    }
    if (lo >= chunk_floor && hi <= kCarryMax) {
      auto unchecked_row = [&](int r) {
        float p[kSteps];
        row_steps<kMode, true>(tab + kSteps * r, carry, ftv, dcv, ncv, p);
        finish_row(r, p);
      };
      if (kMode == kModeC) {
        // Two rows at a time: a row's sum overlaps the next row's divisions (D's
        // larger register set does better one row at a time).
#pragma unroll 2
        for (int r = kRows - 1; r >= 0; --r) unchecked_row(r);
      } else {
        for (int r = kRows - 1; r >= 0; --r) unchecked_row(r);
      }
    } else {
      for (int r = kRows - 1; r >= 0; --r) {
        float p[kSteps];
        row_steps<kMode, false>(tab + kSteps * r, carry, ftv, dcv, ncv, p);
        finish_row(r, p);
      }
    }
  }
  __syncthreads();  // chunk 0's partials are in
  write_rows(0);
}

template <int kMode>
int launch(const int* starts, int num_tiles, const float* feat, float* out,
           void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  bisect_kernel<kMode><<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, feat, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_carry(const int* starts, int num_tiles, const float* feat, const float* ft,
                 const int* nc, const float* drgb, const int* order, float* out,
                 void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  carry_kernel<kMode><<<num_tiles, kCarryThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, feat, ft, nc, drgb, order, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// starts: (num_tiles + 1,) int32; feat, out: (R, 128) float32, 16-byte aligned, with
// every tile's full chunks inside R rows (the wrapper checks); out zero-filled by the
// caller. D also takes ft (num_tiles, 8, 128) float32, nc (num_tiles, 8, 128) int32
// and drgb (num_tiles, 3, 8, 128) float32. C's and D's block b takes tile order[b]
// ((num_tiles,) int32, a permutation of the tiles). Each runs on `stream` without
// synchronising and returns cudaGetLastError() after the launch.
extern "C" int gsrast_bisect_a(const int* starts, int num_tiles, const float* feat,
                               float* out, void* stream) {
  return launch<kModeA>(starts, num_tiles, feat, out, stream);
}

extern "C" int gsrast_bisect_b(const int* starts, int num_tiles, const float* feat,
                               float* out, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  lanes_kernel<<<num_tiles, 32 * kLanesWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, feat, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsrast_bisect_c(const int* starts, int num_tiles, const float* feat,
                               const int* order, float* out, void* stream) {
  return launch_carry<kModeC>(starts, num_tiles, feat, nullptr, nullptr, nullptr,
                              order, out, stream);
}

extern "C" int gsrast_bisect_d(const int* starts, int num_tiles, const float* feat,
                               const float* ft, const int* nc, const float* drgb,
                               const int* order, float* out, void* stream) {
  return launch_carry<kModeD>(starts, num_tiles, feat, ft, nc, drgb, order, out,
                              stream);
}
