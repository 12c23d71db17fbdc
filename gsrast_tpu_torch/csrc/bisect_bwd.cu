// Fault-bisection kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the four toy TPU kernels of scripts/bisect_bwd.py: `kernel_a`, `kernel_b`
// and `kernel_c` (launched by `run`, :20) and the kernel of `run_d` (:147). They
// reproduce, in small, the access pattern of the tile-blend backward: per tile t
// (one block), the tile's chunks of 128 intersections are walked newest first,
// k = nchunks-1 ... 0, where chunk k is the 16 rows x 128 lanes of feat starting at
// row start/8 + 16 k; each chunk is staged into a two-slot shared-memory buffer by
// asynchronous copies, computed into a two-slot output buffer, and written back.
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
// What bounds it on this card: C and D are a chain of 128 dependent steps per chunk,
// each a division of the carry and a 1,024-element sum, so a tile takes its number
// of steps times the latency of one block reduction; A and B read and write each
// chunk once and are bound by memory bandwidth. The design keeps the TPU kernel's
// pattern, which is what the script is for: the carry spread over the block's 256
// threads (4 elements each, in registers), the next chunk's copy (cp.async, 16 bytes
// a thread) issued before the current chunk is computed, and the slot of chunk k is
// k % 2, so the first chunk processed (k = nchunks-1) lands in slot (nchunks-1) % 2,
// not 0 (the fault signature the script was written to find). Per (r, j) step each
// warp sums its lanes by shuffles and lane 0 leaves the partial in shared memory; one
// barrier per row, then 8 threads add the 8 warps' partials for the row's 8 sums.
//
// Rounding: products, sums and the division use the _rn intrinsics (no fused
// multiply-adds, IEEE division, denormals kept; the file is built without
// --use_fast_math). The 1,024-element sums are taken as a tree, where the plain
// version and the TPU reference take their own orders.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // rows of 128 lanes per chunk
constexpr int kLanes = 128;
constexpr int kChunk = kRows * kLanes;       // floats per chunk
constexpr int kCarry = 8 * kLanes;           // elements of the carry
constexpr int kPerThread = kCarry / kThreads;  // 4 carry elements a thread
constexpr int kSteps = 8;                    // scalar reads per row, at lanes 16 j

enum Mode { kModeA = 0, kModeB = 1, kModeC = 2, kModeD = 3 };

// Issue the asynchronous copy of one chunk (2,048 floats: 512 copies of 16 bytes,
// two a thread) and commit it as one group.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src) {
  for (int s = threadIdx.x; s < kChunk / 4; s += kThreads) {
    __pipeline_memcpy_async(dst + 4 * s, src + 4 * s, 16);
  }
  __pipeline_commit();
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
bisect_kernel(const int* __restrict__ starts, const float* __restrict__ feat,
              const float* __restrict__ ft, const int* __restrict__ nc,
              const float* __restrict__ drgb, float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kChunk];
  __shared__ __align__(16) float obuf[2][kChunk];
  __shared__ float red[2][kSteps][kWarps];

  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int nchunks = (starts[tile + 1] - start) / 128;
  if (nchunks <= 0) return;
  const long long row0 = start / 8;
  const int warp = threadIdx.x / 32;
  const int lane_id = threadIdx.x % 32;

  float carry[kPerThread], ftv[kPerThread], dcv[kPerThread];
  int ncv[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    carry[q] = 1.0f;
    if (kMode == kModeD) {
      const long long e = static_cast<long long>(tile) * kCarry +
                          threadIdx.x * kPerThread + q;
      ftv[q] = ft[e];
      ncv[q] = nc[e];
      // drgb is (T, 3, 8, 128): channel 0 of this tile.
      dcv[q] = drgb[static_cast<long long>(tile) * 3 * kCarry +
                    threadIdx.x * kPerThread + q];
    }
  }

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

    if (kMode == kModeA) {
      for (int i = threadIdx.x; i < kChunk; i += kThreads) {
        o[i] = __fmul_rn(2.0f, b[i]);
      }
    } else {
      for (int r = kRows - 1; r >= 0; --r) {
        if (kMode == kModeB) {
          if (threadIdx.x < kLanes) {
            const int l = threadIdx.x;
            o[r * kLanes + l] = (l % 16 == 0) ? __fmul_rn(3.0f, b[r * kLanes + l]) : 0.0f;
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const float v = b[r * kLanes + 16 * j];  // a broadcast read
          float p = 0.0f;
          if (kMode == kModeC) {
            const float div = __fadd_rn(1.0f, __fmul_rn(0.001f, v));
#pragma unroll
            for (int q = 0; q < kPerThread; ++q) {
              carry[q] = __fdiv_rn(carry[q], div);
              p = __fadd_rn(p, __fmul_rn(carry[q], v));
            }
          } else {
            const int idx = 128 * k + 8 * r + j;
            const float a_on = __fmul_rn(0.001f, v);
#pragma unroll
            for (int q = 0; q < kPerThread; ++q) {
              const float a = (idx < ncv[q] && v > 0.1f) ? a_on : 0.0f;
              carry[q] = __fdiv_rn(carry[q], __fadd_rn(1.0f, a));
              p = __fadd_rn(p, __fmul_rn(__fmul_rn(carry[q], dcv[q]), ftv[q]));
            }
          }
          p = warp_sum(p);
          if (lane_id == 0) red[r % 2][j][warp] = p;
        }
        // One barrier per row. The partials alternate between two buffers by row
        // parity, so row r - 1's writers never meet row r's readers.
        __syncthreads();
        if (threadIdx.x < kLanes) {
          const int l = threadIdx.x;
          float s = 0.0f;
          if (l % 16 == 0) {
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[r % 2][l / 16][w]);
          }
          o[r * kLanes + l] = s;
        }
      }
    }
    __syncthreads();  // the chunk's output is complete; its input slot is free
    float4* dst = reinterpret_cast<float4*>(out + (row0 + kRows * k) * kLanes);
    const float4* src = reinterpret_cast<const float4*>(o);
    for (int s = threadIdx.x; s < kChunk / 4; s += kThreads) dst[s] = src[s];
  }
}

template <int kMode>
int launch(const int* starts, int num_tiles, const float* feat, const float* ft,
           const int* nc, const float* drgb, float* out, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  bisect_kernel<kMode><<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      starts, feat, ft, nc, drgb, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// starts: (num_tiles + 1,) int32; feat, out: (R, 128) float32, 16-byte aligned, with
// every tile's full chunks inside R rows (the wrapper checks); out zero-filled by the
// caller. D also takes ft (num_tiles, 8, 128) float32, nc (num_tiles, 8, 128) int32
// and drgb (num_tiles, 3, 8, 128) float32. Each runs on `stream` without
// synchronising and returns cudaGetLastError() after the launch.
extern "C" int gsrast_bisect_a(const int* starts, int num_tiles, const float* feat,
                               float* out, void* stream) {
  return launch<kModeA>(starts, num_tiles, feat, nullptr, nullptr, nullptr, out, stream);
}

extern "C" int gsrast_bisect_b(const int* starts, int num_tiles, const float* feat,
                               float* out, void* stream) {
  return launch<kModeB>(starts, num_tiles, feat, nullptr, nullptr, nullptr, out, stream);
}

extern "C" int gsrast_bisect_c(const int* starts, int num_tiles, const float* feat,
                               float* out, void* stream) {
  return launch<kModeC>(starts, num_tiles, feat, nullptr, nullptr, nullptr, out, stream);
}

extern "C" int gsrast_bisect_d(const int* starts, int num_tiles, const float* feat,
                               const float* ft, const int* nc, const float* drgb,
                               float* out, void* stream) {
  return launch<kModeD>(starts, num_tiles, feat, ft, nc, drgb, out, stream);
}
