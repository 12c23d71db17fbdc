// The order in which the blocks of the two tile-blend kernels take the tiles, for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces no Pallas kernel: on the TPU the grid runs in order on one core. Both blend
// kernels run one block per tile, and a tile's whole segment is one block's chain of
// positions: on a scene whose longest segment is several times the mean, a long tile
// that starts last sets the kernel's time. Their block b takes tile order[b]; this
// kernel writes the tiles longest segment first, in 256 buckets of 32 positions (longer
// segments share the last bucket), ties in tile order: a stable counting sort, equal to
// its plain version `render/blend.py::tile_order` (a stable torch.sort) element for
// element. tile_starts must not decrease.
//
// What bounds it on this card: neither bytes nor operations (8 bytes a tile read, 4
// written: 0.2 MB at 4K's 16,200 tiles) but latency and issue: the launch, a chain of
// dependent steps, and about 90 instructions a warp a round of 32 tiles on the SMs that
// hold the tiles (an H100 SM takes a round of its 32 warps in about 0.6 us). The design,
// one launch, blocks of 1,024 threads (32 warps), each block a slice of consecutive
// tiles, at most kRounds rounds of 1,024 tiles (4,096 tiles): one block takes them all
// up to there (the 1080p cells), else slices of kRounds rounds (a 4K render's 16,200
// tiles of 16x32: 4 slices):
// 1. Each tile's bucket is computed once, all of the slice's loads in flight at once,
//    into shared memory as a byte.
// 2. Warp w takes a run of `rounds` x 32 consecutive tiles of the slice, 32 a round,
//    and counts its tiles of each bucket into a row of its own in shared memory (a
//    shared atomic a tile: no two warps on one row, and a count takes no order).
// 3. Each bucket's first place: with one slice, the block's 256 first threads, one a
//    bucket in output order (longest first), sum the bucket over the warps and scan the
//    totals by warp shuffles. With several, the grid is two blocks a slice, each block's
//    phase and slice from a ticket taken as it starts (so that a block of the second
//    phase waits only on blocks that have started): a first-phase block writes its
//    slice's bucket counts to a column of the table, and the last of them to finish
//    (a count taken with atomicAdd) scans the table into each slice's first place in
//    each bucket and raises a flag; a second-phase block counts its slice as in 2,
//    waits for the flag and reads its slice's column. On an H100, on the plan of a
//    3840x2160 render of 16,200 tiles (diag/bisect_timing.py --order), slices of 4,096
//    tiles took 14.0-14.3 us, of 2,048 14.8-15.1 and one block of 16 rounds 18.3-18.6.
// 4. The warps' counts become each warp's first place in each bucket, and each warp
//    walks its run again: a tile's place is its warp's next place in its bucket plus
//    the lanes of its bucket below it in the round, found by eight ballots, one a bit of
//    the bucket (on an H100, __match_any_sync was no faster).
// Stability: the slices, the warps' runs, their rounds and the lanes of a round all go
// in tile order. The last second-phase block takes the counters back to 0 for the next
// launch. A CUDA graph captures the launch: nothing syncs with the host or allocates.

#include <cuda_runtime.h>

namespace {

constexpr int kBuckets = 256;          // render/blend.py::ORDER_BUCKETS
constexpr int kBucketPositions = 32;   // render/blend.py::ORDER_BUCKET_POSITIONS
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // rounds of kThreads tiles a block takes at most
// The counters: tickets taken, first-phase blocks done, the table scanned, second-phase
// blocks done.
constexpr int kTicket = 0, kCounted = 1, kScanned = 2, kPlaced = 3;

struct Order {
  const int* tile_starts;  // (num_tiles + 1,)
  int num_tiles, slices, rounds;  // a slice's rounds of kThreads tiles
  int* order;     // (num_tiles,)
  int* table;     // (kBuckets, slices): counts, then first places; null for one slice
  int* counters;  // four ints, 0 between launches; null for one slice
};

// Round k of a warp's run (from tile `first`, tiles below `end`): the lanes that hold a
// tile, a prefix of the warp.
__device__ __forceinline__ unsigned lanes_with_tile(int first, int k, int end) {
  const int n = end - (first + 32 * k);
  return n >= 32 ? 0xffffffffu : n <= 0 ? 0u : (1u << n) - 1u;
}

// The lanes among `valid` whose bucket is q (this lane's), from q's 8 bits, a ballot
// each. Every lane of the warp calls it.
__device__ __forceinline__ unsigned peers_of(int q, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool set = (q >> b) & 1;
    const unsigned bits = __ballot_sync(0xffffffffu, set);
    peers &= set ? bits : ~bits;
  }
  return peers;
}

// The exclusive scan of the 256 bucket totals in output order (longest bucket first):
// thread i < 256 holds bucket 255 - i's total and gets the sum of the totals before it.
// Every thread of the block calls it.
__device__ __forceinline__ int bucket_base(int total, int* warp_sums) {
  const int tid = static_cast<int>(threadIdx.x), lane = tid % 32, warp = tid / 32;
  int scan = total;  // inclusive, over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, scan, d);
    if (lane >= d) scan += v;
  }
  if (tid < kBuckets && lane == 31) warp_sums[warp] = scan;
  __syncthreads();
  int base = scan - total;
  for (int w = 0; w < warp && tid < kBuckets; ++w) base += warp_sums[w];
  return base;
}

__global__ void __launch_bounds__(kThreads) tile_order_kernel(const Order o) {
  __shared__ int counts[kWarps * kBuckets];  // [warp][bucket]
  __shared__ unsigned char buckets[kRounds * kThreads];
  __shared__ int warp_sums[kBuckets / 32];
  __shared__ int role;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 0) role = o.slices == 1 ? 0 : atomicAdd(o.counters + kTicket, 1);
  __syncthreads();
  const int slice = role % o.slices;
  const bool placing = o.slices == 1 || role >= o.slices;
  const int first_tile = slice * o.rounds * kThreads;
  const int end = min(o.num_tiles, first_tile + o.rounds * kThreads);
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {  // every load in flight at once
    const int t = first_tile + k * kThreads + tid;
    if (t < end) {
      const int length = o.tile_starts[t + 1] - o.tile_starts[t];
      buckets[t - first_tile] =
          static_cast<unsigned char>(min(length / kBucketPositions, kBuckets - 1));
    }
  }
  for (int e = tid; e < kWarps * kBuckets; e += kThreads) counts[e] = 0;
  __syncthreads();
  int* const own = counts + warp * kBuckets;
  const int run = first_tile + warp * 32 * o.rounds;  // the warp's run
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int t = run + 32 * k + lane;
    if (k < o.rounds && t < end) atomicAdd(own + buckets[t - first_tile], 1);
  }
  __syncthreads();
  // Thread i < 256 takes bucket 255 - i: threads in output order.
  const int q = kBuckets - 1 - tid;
  int total = 0;  // the slice's tiles in bucket q
  if (tid < kBuckets) {
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) total += counts[w * kBuckets + q];
  }
  int place = 0;  // the slice's first place in bucket q
  if (o.slices == 1) {
    place = bucket_base(total, warp_sums);
  } else if (!placing) {
    if (tid < kBuckets) o.table[q * o.slices + slice] = total;
    __threadfence();
    __syncthreads();
    if (tid == 0) role = atomicAdd(o.counters + kCounted, 1) == o.slices - 1;
    __syncthreads();
    if (!role) return;
    // The last first-phase block: each slice's first place in each bucket.
    __threadfence();
    int* const column = tid < kBuckets ? o.table + q * o.slices : nullptr;
    int sum = 0;
    for (int r = 0; column != nullptr && r < o.slices; ++r) sum += __ldcg(column + r);
    place = bucket_base(sum, warp_sums);
    for (int r = 0; column != nullptr && r < o.slices; ++r) {
      const int c = __ldcg(column + r);
      column[r] = place;
      place += c;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(o.counters + kScanned, 1);
    return;
  } else {
    if (tid == 0) {
      while (atomicAdd(o.counters + kScanned, 0) == 0) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    if (tid < kBuckets) place = __ldcg(o.table + q * o.slices + slice);
  }
  if (tid < kBuckets) {  // each warp's first place in bucket q
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const int c = counts[w * kBuckets + q];
      counts[w * kBuckets + q] = place;
      place += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (k == o.rounds) break;
    const int t = run + 32 * k + lane;
    const unsigned valid = lanes_with_tile(run, k, end);
    const bool mine = (valid >> lane) & 1;
    const int b = mine ? buckets[t - first_tile] : 0;
    const unsigned peers = peers_of(b, valid);
    const unsigned below = peers & ((1u << lane) - 1u);
    const int at = own[b] + __popc(below);
    __syncwarp();
    if (mine && below == 0) own[b] += __popc(peers);
    __syncwarp();
    if (mine) o.order[at] = t;
  }
  if (o.slices > 1) {
    __syncthreads();
    if (tid == 0 && atomicAdd(o.counters + kPlaced, 1) == o.slices - 1) {
      for (int c = 0; c < 4; ++c) o.counters[c] = 0;  // every block has taken its ticket
    }
  }
}

// num_tiles tiles as slices: (slices, rounds a slice).
int2 slices_of(int num_tiles) {
  const int rounds = (num_tiles + kThreads - 1) / kThreads;
  if (rounds <= kRounds) return make_int2(1, rounds);
  return make_int2((rounds + kRounds - 1) / kRounds, kRounds);
}

}  // namespace

// The ints of the table `gsrast_tile_order` takes for num_tiles tiles (0 where one
// slice holds them all).
extern "C" long long gsrast_tile_order_table(int num_tiles) {
  const int slices = slices_of(max(num_tiles, 0)).x;
  return slices > 1 ? static_cast<long long>(kBuckets) * slices : 0;
}

// tile_starts: (num_tiles + 1,) int32, not decreasing; order: (num_tiles,) int32,
// written in full. table: `gsrast_tile_order_table(num_tiles)` int32 of scratch, and
// counters four int32 that are 0 (and are 0 again when the launch ends); both may be
// null where the table takes no int. No other order may run on the device at the same
// time. Runs on `stream` and does not synchronise; returns cudaGetLastError() after the
// launch (no launch for num_tiles = 0).
extern "C" int gsrast_tile_order(const int* tile_starts, int num_tiles, int* order,
                                 void* table, void* counters, void* stream) {
  if (num_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int2 shape = slices_of(num_tiles);
  const Order o{tile_starts, num_tiles, shape.x, shape.y, order, static_cast<int*>(table),
                static_cast<int*>(counters)};
  if (o.slices > 1 && (o.table == nullptr || o.counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = o.slices == 1 ? 1u : 2u * static_cast<unsigned>(o.slices);
  tile_order_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(o);
  return static_cast<int>(cudaGetLastError());
}
