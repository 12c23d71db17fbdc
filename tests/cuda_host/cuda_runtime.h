// A host stand-in for the CUDA runtime, enough to compile a kernel source of
// gsrast_tpu_torch/csrc with g++ and run it on the CPU (tests only).
//
// A block's threads are std::threads that meet at a std::barrier, so
// __syncthreads and per-thread state (registers) behave as on the card;
// blocks run one after another, and a kernel's dynamic shared memory is one
// host array that the test defines. Each warp's 32 threads meet at a barrier of
// their own in __syncwarp, and exchange values through slots of their own in the
// vote, match and shuffle intrinsics. The _rn intrinsics are plain float
// operations: build with -ffp-contract=off. `launch(grid, block, kernel,
// args...)` stands for `kernel<<<grid, block, shared, stream>>>(args...)`.
#pragma once
#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::isinf;
using std::isnan;
using std::max;
using std::min;

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>>* host_warp_barriers;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*host_warp_barriers)[threadIdx.x / 32]->arrive_and_wait();
}
// The warp vote and match intrinsics: each lane publishes a value in its warp's slots,
// the warp meets at its barrier, every lane reads the others', and the warp meets again
// before the slots are reused. Every lane of the warp must call them (as with a full
// mask on the card); lanes outside `mask` are not counted.
inline std::vector<std::array<unsigned long long, 32>>* host_warp_slots;
template <class T>
unsigned host_warp_vote(unsigned mask, T value, bool match) {
  auto& slots = (*host_warp_slots)[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  unsigned long long bits = 0;
  std::memcpy(&bits, &value, sizeof value);
  slots[lane] = bits;
  __syncwarp();
  const unsigned width = std::min(32u, blockDim.x - threadIdx.x / 32 * 32);
  unsigned out = 0;
  for (unsigned l = 0; l < width; ++l) {
    if ((mask >> l & 1u) && (match ? slots[l] == bits : slots[l] != 0)) out |= 1u << l;
  }
  __syncwarp();
  return out;
}
template <class T>
unsigned __match_any_sync(unsigned mask, T value) { return host_warp_vote(mask, value, true); }
inline unsigned __ballot_sync(unsigned mask, int predicate) {
  return host_warp_vote(mask, static_cast<unsigned long long>(predicate != 0), false);
}
// __shfl_up_sync: lane l reads lane l - delta's value, its own below delta.
template <class T>
T __shfl_up_sync(unsigned, T value, unsigned delta) {
  auto& slots = (*host_warp_slots)[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  unsigned long long bits = 0;
  std::memcpy(&bits, &value, sizeof value);
  slots[lane] = bits;
  __syncwarp();
  T out = value;
  if (lane >= delta) std::memcpy(&out, &slots[lane - delta], sizeof out);
  __syncwarp();
  return out;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
template <class T>
T __ldcg(const T* address) { return *address; }

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct int2 {
  int x, y;
};
struct int4 {
  int x, y, z, w;
};
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct double2 {
  double x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fdividef(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __float_as_uint(float a) {
  unsigned u;
  std::memcpy(&u, &a, sizeof u);
  return u;
}
inline int __float_as_int(float a) {
  int i;
  std::memcpy(&i, &a, sizeof i);
  return i;
}
// A block's threads are real threads: shared-memory atomics are atomic.
inline int atomicAdd(int* address, int value) {
  return std::atomic_ref<int>(*address).fetch_add(value);
}
// atomicInc: the old value; stores 0 where it was >= limit, else old + 1.
inline unsigned atomicInc(unsigned* address, unsigned limit) {
  std::atomic_ref<unsigned> ref(*address);
  unsigned old = ref.load();
  while (!ref.compare_exchange_weak(old, old >= limit ? 0u : old + 1u)) {
  }
  return old;
}
inline unsigned long long atomicMin(unsigned long long* address, unsigned long long value) {
  std::atomic_ref<unsigned long long> ref(*address);
  unsigned long long old = ref.load();
  while (value < old && !ref.compare_exchange_weak(old, value)) {
  }
  return old;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes, sharedSizeBytes;
};

// The SMs the host "card" reports (an H100's 132 unless a test sets it).
inline int host_multiprocessors = 132;
constexpr size_t kHostSharedPerSm = 232448;  // an H100's shared memory a block

template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = host_multiprocessors;
  return cudaSuccess;
}
// Blocks an SM holds by shared memory alone (registers are not modelled).
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, T, int, size_t shared) {
  *blocks = static_cast<int>(std::min<size_t>(kHostSharedPerSm / std::max<size_t>(shared, 1), 32));
  return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, T) {
  *attr = {0, 0, 0};
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t = nullptr) {
  std::memset(p, value, bytes);
  return cudaSuccess;
}

// Launches so far (a test reads it to see that an entry point launched nothing).
inline int host_launches = 0;

template <class K, class... A>
void launch(dim3 grid, dim3 block, K kernel, A... args) {
  ++host_launches;
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::barrier<> barrier(block.x);
        host_block_barrier = &barrier;
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
          warps.push_back(std::make_unique<std::barrier<>>(std::min(32u, block.x - 32 * w)));
        host_warp_barriers = &warps;
        std::vector<std::array<unsigned long long, 32>> slots((block.x + 31) / 32);
        host_warp_slots = &slots;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t) {
          threads.emplace_back([&, t] {
            threadIdx = {t, 0, 0};
            kernel(args...);
          });
        }
        for (auto& thread : threads) thread.join();
      }
    }
  }
}
