// The order in which the blocks of the two tile-blend kernels take the tiles, for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Both blend kernels run one block per tile, and a tile's whole segment is one
// block's chain of positions: on a scene whose longest segment is several times the
// mean, a long tile that starts last sets the kernel's time. Their block b takes
// tile order[b]; this kernel writes the tiles longest segment first, by a counting
// sort on 256 buckets of 32 positions (longer segments share the last bucket), in one
// block of 1,024 threads. Tiles of one bucket come in no fixed order, which changes
// no output: each tile's outputs depend on its own segment only.
// `render/blend.py::tile_order` is its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 256;
constexpr int kBucketPositions = 32;
constexpr int kThreads = 1024;

__device__ __forceinline__ int bucket_of(const int* tile_starts, int t) {
  return min((tile_starts[t + 1] - tile_starts[t]) / kBucketPositions, kBuckets - 1);
}

__global__ void __launch_bounds__(kThreads)
tile_order_kernel(const int* __restrict__ tile_starts, int num_tiles,
                  int* __restrict__ order) {
  __shared__ int next[kBuckets];
  for (int b = threadIdx.x; b < kBuckets; b += kThreads) next[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += kThreads) {
    atomicAdd(&next[bucket_of(tile_starts, t)], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // each bucket's first slot, the longest bucket first
    int sum = 0;
    for (int b = kBuckets - 1; b >= 0; --b) {
      const int count = next[b];
      next[b] = sum;
      sum += count;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += kThreads) {
    order[atomicAdd(&next[bucket_of(tile_starts, t)], 1)] = t;
  }
}

}  // namespace

// tile_starts: (num_tiles + 1,) int32; order: (num_tiles,) int32, written in full.
// Runs on `stream` and does not synchronise; returns cudaGetLastError() after the
// launch (no launch for num_tiles = 0).
extern "C" int gsrast_tile_order(const int* tile_starts, int num_tiles, int* order,
                                 void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  tile_order_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_starts, num_tiles, order);
  return static_cast<int>(cudaGetLastError());
}
