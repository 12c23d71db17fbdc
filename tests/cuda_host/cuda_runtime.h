// A host stand-in for the CUDA runtime, enough to compile a kernel source of
// gsrast_tpu_torch/csrc with g++ and run it on the CPU (tests only).
//
// A block's threads are std::threads that meet at a std::barrier, so
// __syncthreads and per-thread state (registers) behave as on the card;
// blocks run one after another, and a kernel's dynamic shared memory is one
// host array that the test defines. The _rn intrinsics are plain float
// operations: build with -ffp-contract=off. `launch(grid, block, kernel,
// args...)` stands for `kernel<<<grid, block, shared, stream>>>(args...)`.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
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
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct double2 {
  double x, y;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fdividef(float a, float b) { return a / b; }

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

template <class K, class... A>
void launch(dim3 grid, dim3 block, K kernel, A... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z) {
    for (unsigned y = 0; y < grid.y; ++y) {
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::barrier<> barrier(block.x);
        host_block_barrier = &barrier;
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
