// The optimizer half of the train step, for Hopper (sm_90a), bound to Python through
// ctypes: the SH rest-band scale, the live mask and Adam over the parameter groups, in
// one launch.
//
// Replaces no Pallas kernel. It stands for the reference's update, which XLA fuses into
// the jitted train step: the rest-band scale (gsrast_tpu/train/trainer.py:80-86, 113),
// the live mask (:115-118) and one optax.adam a group under optax.multi_transform
// (:52-77, :119-120). Its plain version is train/adam.py::adam_update_torch; the port
// ran the same update as a rest-band multiply, a mask multiply a group and
// torch.optim.Adam's foreach passes.
//
// Per float of a group, with live the Gaussian's mask bit and count the group's update
// count before this update, in optax's order:
//   g' = g * rest_scale where the float is in an SH band past the first, then g' *= live;
//   m = (1 - b1) g' + b1 m;  v = (1 - b2) g'^2 + b2 v;
//   u = (m / (1 - b1^(count + 1))) / (sqrt(v / (1 - b2^(count + 1))) + eps);
//   p = p + (-lr) u.
// Dead slots take the same arithmetic: their g' is 0, and moment surgery zeroed their
// moments.
//
// What bounds it on this card: bytes. Each float is read four times (gradient,
// parameter, two moments) and written three times (parameter, two moments): 28 bytes a
// float, plus the mask's byte a Gaussian. At 1M Gaussians of SH degree 3 (59 floats a
// Gaussian) that is 1.65 GB, 0.49 ms at 3.35 TB/s; about 15 float operations a float
// (three IEEE divisions and a square root among them) are far below the operations
// bound.
//
// The design, a streaming pass that reads each byte once and writes each output once,
// in one launch:
// - A thread takes chunks of kChunk (4) consecutive floats of one group. The groups'
//   chunks are numbered one after another (the table holds each group's first), so one
//   grid covers all the groups. The grid is one wave of 256-thread blocks, as many as
//   the card holds at once (3 an SM at this kernel's 72 registers), each thread walking
//   the chunks in strides of the grid with the next chunk's loads in flight while it
//   works on this one. On an H100 (diag/adam_timing.py) this beat a thread a chunk,
//   which ends in a part-empty wave at trained_116k (1,641 blocks) and took a ticket
//   for each of 57,600 blocks at 1M; a grid of 2 or 4 waves; a wave without the
//   prefetch; a thread a chunk with each block's slice brought into shared memory by
//   cp.async.bulk; and capping the registers at 64 (spills).
// - Loads first: each thread finds its chunk's group in the table (a kernel parameter
//   read in place, __grid_constant__) and issues its first chunk's loads, the mask
//   bytes among them, before anything else. Only then do the block's first threads,
//   one a group, work out the group's bias corrections from its count, and its rate
//   (from device memory where the caller recomputes it on the device each step: the
//   means' decayed rate), into shared memory, while the loads are in flight.
// - Where a group's four arrays are 16-byte aligned, a whole chunk is one 16-byte load
//   of each input and one 16-byte store of each output; a group's ragged last chunk
//   (the means are 3N floats) and an unaligned group go float by float.
// - A chunk's first float's row (Gaussian) and column come from one division; the
//   others step along the row. The column says whether the float is in a rest band.
// - The count: every block reads it, so no block may add to it before all have read
//   it. Each block takes a ticket (atomicInc on a per-device int, which wraps back to 0
//   for the next update) after its reads of the counts, and the block that takes the
//   last ticket writes each count + 1: every other block has read the counts by then.
//   Its thread 0 takes the ticket as soon as the block has read them and looks at it
//   only after its chunks, so the atomic's round trip hides behind the block's loads.
// - Zero operands: a Gaussian that no pixel reached has a zero gradient, and after
//   a step zero moments (53-76% of the floats of the train cells). The IEEE division
//   and square root leave their fast path for zeros and subnormals; `div_pos` and
//   `sqrt_nonneg` keep them on it with the same bits (at 1M on an H100, 0.74 to 0.60
//   ms).
// - Graph-safe: no allocation and no host synchronisation; the counts and the rate are
//   read on the device, and the ticket is 0 again when the launch ends.
//
// Rounding: each operation is rounded alone (the _rn intrinsics, never contracted into
// fused multiply-adds; the divisions and the square root IEEE), and the bias
// corrections are 1 - powf(b, count + 1) in float32, as the plain version's torch ops
// compute them; so the kernel equals the plain version run on the card bit for bit.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxGroups = 8;  // train/adam.py::MAX_GROUPS
constexpr int kTensors = 6;    // a group's pointers in the caller's table
constexpr int kScalars = 6;    // a group's floats in the caller's table
constexpr int kThreads = 256;
// Floats a thread takes: kChunk / 4 16-byte accesses of each array.
constexpr int kChunk = 4;
// The grid: at most kWaves waves of the blocks the card holds at once.
constexpr int kWaves = 1;
constexpr int kDevices = 64;  // devices whose occupancy is kept

struct Group {
  float* param;
  const float* grad;
  float* exp_avg;
  float* exp_avg_sq;
  float* count;         // the update count so far (one float32)
  const float* lr_ptr;  // the rate in device memory, or null: `lr`
  float lr, b1, b2, c1, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2, rounded to float32
  long long numel;
  long long first;  // the group's first chunk
  int row;          // floats a row (a Gaussian)
  int rest;         // the row's first rest-band float; `row` where it has none
  int vec;          // the four arrays are 16-byte aligned
};

struct Table {
  Group group[kMaxGroups];
  int groups;
  long long chunks;  // all the groups' chunks
  const unsigned char* live;
  float rest_scale;
  unsigned* ticket;  // 0 between updates
};

// A group's per-update values, worked out once a block.
struct Step {
  float bc1, bc2, neg_lr;
  float count;  // the count after this update
};

// The IEEE division and square root are software sequences with a slow path for
// operands outside the normal range, zero among them; every float of a Gaussian
// that no pixel reached has m = v = 0. These give the same bits and stay on the fast
// path there. a / b for b > 0: a zero a is the quotient itself.
__device__ __forceinline__ float div_pos(float a, float b) {
  const float q = __fdiv_rn(a == 0.0f ? 1.0f : a, b);
  return a == 0.0f ? a : q;
}

// sqrt(a) for a >= 0: zero is its own root, and a subnormal a is scaled by 2^64
// into the normal range, where the root's rounding commutes with the exact 2^-32.
__device__ __forceinline__ float sqrt_nonneg(float a) {
  constexpr float kMinNormal = 1.17549435e-38f;        // 2^-126
  constexpr float kUp = 18446744073709551616.0f;       // 2^64
  constexpr float kDown = 2.3283064365386963e-10f;     // 2^-32
  const bool tiny = a < kMinNormal;  // zero or subnormal
  const float r = __fsqrt_rn(a == 0.0f ? 1.0f : tiny ? __fmul_rn(a, kUp) : a);
  return a == 0.0f ? a : tiny ? __fmul_rn(r, kDown) : r;
}

__device__ __forceinline__ void adam_float(float& p, float g, float& m, float& v,
                                           float live, bool rest, float rest_scale,
                                           const Group& gr, const Step& s) {
  if (rest) g = __fmul_rn(g, rest_scale);
  g = __fmul_rn(g, live);
  m = __fadd_rn(__fmul_rn(gr.c1, g), __fmul_rn(gr.b1, m));
  v = __fadd_rn(__fmul_rn(gr.c2, __fmul_rn(g, g)), __fmul_rn(gr.b2, v));
  const float u = div_pos(div_pos(m, s.bc1),
                          __fadd_rn(sqrt_nonneg(div_pos(v, s.bc2)), gr.eps));
  p = __fadd_rn(p, __fmul_rn(u, s.neg_lr));
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
}

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// One chunk, kChunk consecutive floats of one group from the chunk's first: where it
// lies, and its inputs once loaded.
struct Chunk {
  int k;         // its group
  int n;         // its floats (kChunk but in a group's ragged last chunk)
  int col;       // its first float's column
  long long e0;  // its first float in the group
  float p[kChunk], g[kChunk], m[kChunk], v[kChunk];
  float live[kChunk];  // 1 where the float's Gaussian is live, else 0
};

// Issue the loads of chunk `chunk` (< t.chunks) into c.
__device__ __forceinline__ void load_chunk(const Table& t, long long chunk, Chunk& c) {
  c.k = 0;
  for (int j = 1; j < t.groups; ++j) {
    if (chunk >= t.group[j].first) c.k = j;
  }
  const Group& gr = t.group[c.k];
  c.e0 = (chunk - gr.first) * kChunk;
  c.n = static_cast<int>(min(static_cast<long long>(kChunk), gr.numel - c.e0));
  long long row = c.e0 <= 0xffffffffLL
                      ? static_cast<long long>(static_cast<unsigned>(c.e0) /
                                               static_cast<unsigned>(gr.row))
                      : c.e0 / gr.row;
  c.col = static_cast<int>(c.e0 - row * gr.row);
  if (gr.vec && c.n == kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) {
      load4(c.p + q, gr.param + c.e0 + q);
      load4(c.g + q, gr.grad + c.e0 + q);
      load4(c.m + q, gr.exp_avg + c.e0 + q);
      load4(c.v + q, gr.exp_avg_sq + c.e0 + q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < c.n) {
        c.p[j] = gr.param[c.e0 + j];
        c.g[j] = gr.grad[c.e0 + j];
        c.m[j] = gr.exp_avg[c.e0 + j];
        c.v[j] = gr.exp_avg_sq[c.e0 + j];
      }
    }
  }
  int col = c.col;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < c.n) {
      c.live[j] = t.live[row] != 0 ? 1.0f : 0.0f;
      if (++col == gr.row) col = 0, ++row;
    }
  }
}

// Update the loaded chunk c and store it.
__device__ __forceinline__ void update_chunk(const Table& t, const Step* steps, Chunk& c) {
  const Group& gr = t.group[c.k];
  const Step s = steps[c.k];
  int col = c.col;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < c.n) {
      adam_float(c.p[j], c.g[j], c.m[j], c.v[j], c.live[j], col >= gr.rest, t.rest_scale,
                 gr, s);
      if (++col == gr.row) col = 0;
    }
  }
  if (gr.vec && c.n == kChunk) {
#pragma unroll
    for (int q = 0; q < kChunk; q += 4) {
      store4(gr.param + c.e0 + q, c.p + q);
      store4(gr.exp_avg + c.e0 + q, c.m + q);
      store4(gr.exp_avg_sq + c.e0 + q, c.v + q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < c.n) {
        gr.param[c.e0 + j] = c.p[j];
        gr.exp_avg[c.e0 + j] = c.m[j];
        gr.exp_avg_sq[c.e0 + j] = c.v[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) adam_update_kernel(const __grid_constant__ Table t) {
  __shared__ Step steps[kMaxGroups];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long chunk = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Chunk c;
  if (chunk < t.chunks) load_chunk(t, chunk, c);  // in flight through the prologue
  if (static_cast<int>(threadIdx.x) < t.groups) {
    const Group& gr = t.group[threadIdx.x];
    const float count = __fadd_rn(*gr.count, 1.0f);
    steps[threadIdx.x] = Step{__fsub_rn(1.0f, powf(gr.b1, count)),
                              __fsub_rn(1.0f, powf(gr.b2, count)),
                              -(gr.lr_ptr != nullptr ? *gr.lr_ptr : gr.lr), count};
  }
  __syncthreads();
  unsigned ticket = 0;
  if (threadIdx.x == 0) {
    __threadfence();  // the block's reads of the counts, before its ticket
    ticket = atomicInc(t.ticket, gridDim.x - 1);
  }
  while (chunk < t.chunks) {  // the next chunk's loads in flight during this one's
    const long long following = chunk + stride;
    Chunk next;
    if (following < t.chunks) load_chunk(t, following, next);
    update_chunk(t, steps, c);
    chunk = following;
    c = next;
  }
  if (threadIdx.x == 0 && ticket == gridDim.x - 1) {  // every block has read the counts
    for (int k = 0; k < t.groups; ++k) *t.group[k].count = steps[k].count;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// The update kernel's blocks an SM and the card's SMs. The occupancy query runs once a
// device (and again if its SM count changes); the SM count is read each call.
cudaError_t occupancy(int* sms, int* per_sm) {
  static std::atomic<long long> known[kDevices];  // SMs << 32 | blocks an SM; 0: not asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kDevices;
  const long long seen = kept ? known[dev].load(std::memory_order_relaxed) : 0;
  if (seen != 0 && seen >> 32 == *sms) {
    *per_sm = static_cast<int>(seen & 0xffffffff);
    return cudaSuccess;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, adam_update_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (kept) known[dev].store(static_cast<long long>(*sms) << 32 | *per_sm);
  return cudaSuccess;
}

// The update kernel's blocks: a thread a chunk, at most kWaves waves.
cudaError_t grid_of(long long chunks, long long* blocks) {
  *blocks = max((chunks + kThreads - 1) / kThreads, 1LL);
  int sms = 0, per_sm = 0;
  const cudaError_t e = occupancy(&sms, &per_sm);
  if (e != cudaSuccess) return e;
  *blocks = min(*blocks, max(static_cast<long long>(kWaves) * sms * per_sm, 1LL));
  return cudaSuccess;
}

}  // namespace

// One update of `groups` (1 to kMaxGroups) parameter groups. Per group k:
// tensors[6k..6k+5] are its parameter, gradient, first and second moments (float32,
// contiguous, numels[k] floats each, rows of rows[2k] floats), its count (one float32)
// and its rate in device memory or null; scalars[6k..6k+5] its rate (read where the
// pointer is null), b1, b2, 1 - b1, 1 - b2 and eps, rounded to float32; rows[2k + 1] the
// row's first float that takes rest_scale (rows[2k] where none does). live: one byte a
// row, nonzero where the Gaussian is live. ticket: an int32 that is 0 (and is 0 again
// when the launch ends); no other update may run on the device at the same time.
// Updates the parameters and moments in place and adds one to each count, in one
// launch on `stream`, without synchronising; returns cudaGetLastError() after it.
extern "C" int gsrast_adam_update(int groups, void* const* tensors, const float* scalars,
                                  const long long* numels, const int* rows,
                                  const void* live, float rest_scale, void* ticket,
                                  void* stream) {
  if (groups < 1 || groups > kMaxGroups || ticket == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  long long chunks = 0;
  for (int k = 0; k < groups; ++k) {
    Group& gr = t.group[k];
    void* const* p = tensors + kTensors * k;
    const float* s = scalars + kScalars * k;
    gr.param = static_cast<float*>(p[0]);
    gr.grad = static_cast<const float*>(p[1]);
    gr.exp_avg = static_cast<float*>(p[2]);
    gr.exp_avg_sq = static_cast<float*>(p[3]);
    gr.count = static_cast<float*>(p[4]);
    gr.lr_ptr = static_cast<const float*>(p[5]);
    gr.lr = s[0], gr.b1 = s[1], gr.b2 = s[2], gr.c1 = s[3], gr.c2 = s[4], gr.eps = s[5];
    gr.numel = numels[k];
    gr.first = chunks;
    gr.row = rows[2 * k];
    gr.rest = rows[2 * k + 1];
    gr.vec = aligned16(gr.param) && aligned16(gr.grad) && aligned16(gr.exp_avg) &&
             aligned16(gr.exp_avg_sq);
    if (gr.numel < 0 || (gr.numel > 0 && gr.row < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks += (gr.numel + kChunk - 1) / kChunk;
  }
  t.groups = groups;
  t.chunks = chunks;
  t.live = static_cast<const unsigned char*>(live);
  t.rest_scale = rest_scale;
  t.ticket = static_cast<unsigned*>(ticket);
  long long blocks = 0;
  const cudaError_t e = grid_of(chunks, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  adam_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// The update kernel's launch, as the library reports it: threads a block, the blocks
// one SM holds at once, registers and local (spilled) bytes a thread, static shared
// bytes a block.
extern "C" int gsrast_adam_occupancy(int* threads, int* blocks_per_sm, int* registers,
                                     int* local_bytes, int* static_shared) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, adam_update_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = occupancy(&sms, blocks_per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *static_shared = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
