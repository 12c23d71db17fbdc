// The multi-tier tile plan for Hopper (sm_90a), bound to Python through ctypes: every
// visible Gaussian's (tile, depth) slots on a grid sized near the true intersection
// count, with the plan's two counts.
//
// Replaces no Pallas kernel. It stands for the reference's `plan_tiers`, which XLA fuses
// into the jitted step (gsrast_tpu/ops/binning.py:256-429): a stable sort of the counts
// carrying ten payloads, a few fusions that build each tier's (w_j, B_j) slot grid, and
// two sums. Its plain version is ops/binning.py::plan_tiers_torch, which runs the same
// work as some 470 small torch kernels a render.
//
// What it computes, as the plain version does (every TierPlan field bit for bit):
// - Per Gaussian: its tile rectangle's width rw (>= 0) and rw_safe = max(rw, 1); its
//   owned tile rows (`owned_row_range`: rows row0 + r row_stride, r < num_rows, within
//   [y_min, y_max)), their first y0, count nrows and first local row rho0; its tile count
//   counts_full = nrows rw where radius > 0, else 0, and counts = min(counts_full,
//   k_last); its depth's float32 bits; and the cull's inputs (`cull_bounds`):
//   lam_min = max(0.5 (a + c) - sqrt(max(0.25 (a - c)^2 + b b, 0)), 0) and
//   cull_thresh = 2 log(max(opacity, 1e-12) / (0.98 ALPHA_MIN)).
// - The ranking `order`: Gaussians by count descending, ties in index order.
// - Tier j (tile ordinals k_{j-1} <= ks < k_j, the first B_j ranks; slot
//   off_j + (ks - k_{j-1}) B_j + r): the ks-th tile of rank r's Gaussian, its rows walked
//   row-major (ry = ks / rw_safe, rx = ks - ry rw_safe), keyed by its local tile (or, in
//   routed mode, `dest << route_bits | tile on dest`); the sentinel where ks >= counts
//   or, from tier 1 on, where the splat cannot reach ALPHA_MIN on the tile
//   (`tile_reachable`); the depth bits on every slot of the grid; the Gaussian on a
//   live slot and -1 on a dead one. Slots past the grid up to a multiple of 128 are
//   padding: the sentinel, depth 0, -1.
// - total = the live slots; overflow_tile_cap = sum(counts_full - counts) +
//   sum over ranks of max(counts - granted_k, 0), granted_k the k_j of the last tier
//   that holds the rank (and, from tier 1 on, whose k_{j-1} its count passes).
//
// Where bit-exactness is at risk, and what this source does about it:
// - Integer division and modulo: torch's // and % on integers round towards minus
//   infinity, C's towards zero. `owned_row_range` takes (row0 - y_lo) mod row_stride of
//   a dividend <= 0 (row-local plans with row0 > 0 hit it), so every division and
//   modulo of a possibly negative value goes through `floor_div` / `floor_mod`. The
//   tile ordinal's row ks / rw_safe is exact integer division of non-negative values,
//   as in the plain version (the reference's float reciprocal agrees with it wherever
//   k_last grid_w < 4e6, which the host checks).
// - Contraction: nvcc fuses a b + c into one FMA by default, torch rounds each
//   operation alone; every float operation here is an _rn intrinsic, never contracted.
//   (a - c)^2 is torch's pow with exponent 2, which multiplies the base by itself.
// - Library rounding: the square root is IEEE's (__fsqrt_rn, as torch's sqrt on the
//   card); the logarithm is the CUDA math library's logf, as torch's log on the card
//   (this source is built without --use_fast_math); the division by 0.98 ALPHA_MIN is a
//   true IEEE division by the constant rounded to float32 (the caller passes it), as the
//   plain version divides by a float32 tensor (a division by a host scalar on the card
//   would multiply by its reciprocal).
//   On the CPU, torch's vectorized float32 sqrt and log can be an ulp off; the host
//   tests hold this source's cull values to correctly rounded ones there.
// - NaN: torch's clamp and maximum propagate NaN; `clamp_min` and `max_nan` do too, so
//   a NaN input makes the cull test false in both.
// - The ranking: a stable counting sort (no library sort). The key k_last - counts has Q = k_last + 1
//   values (buckets), so a Gaussian's rank is the number of Gaussians in lower buckets
//   plus the number in its own bucket at a lower index: exact integers, the ranking of
//   the plain version's stable torch.sort of -counts, whatever the launch order.
// - Sums: integer atomics are order-free, and 32-bit wrap-around gives the plain
//   version's int64 sums cast to int32. So total and overflow_tile_cap are exact.
//
// What bounds it on this card: bytes. The function reads each Gaussian's preprocess
// fields once (rect 16 bytes, radius, depth, conic 12, opacity, mean2d 8: 48 bytes) and
// writes `order` (4 bytes a Gaussian) and 12 bytes a slot: at 1M Gaussians and 3.24M
// slots, 91 MB, 0.027 ms at 3.35 TB/s. At 116k Gaussians the bytes take 0.0054 ms,
// less than a few dependent launches and their gaps: there the plan is bound by
// latency, and the design keeps the chain to two launches.
//
// The design: two launches a plan (the caller counts them as one), no library sort and
// no memset.
// 1. `rank_kernel`. A block takes M = 256 rounds consecutive Gaussians, warp w the w-th
//    run of 32 rounds of them (`plan_rounds` picks rounds so that the bucket table,
//    blocks x Q ints, stays near kTableTarget entries). The block first stages every
//    bucket of its Gaussians in shared memory, from their rect and radius alone (20
//    bytes; all loads in flight at once). Pass 1: each warp counts its buckets, a round
//    of 32 Gaussians at a time, the lanes of one bucket found by __match_any_sync and
//    counted by __popc, the count added by the bucket's lowest lane to the warp's row of
//    counts (shared memory up to kSharedBuckets buckets, else the caller's scratch). The
//    block turns the rows into each warp's offset in each bucket and writes its totals
//    to column b of the table, stored bucket-major (entry q blocks + b). Pass 2 walks
//    the rounds again and writes each Gaussian's rank within its block's bucket (its
//    warp's offset, its earlier rounds, its lower lanes). The last block to finish its
//    column (a ticket taken with atomicInc, which wraps to 0 for the next plan) then
//    scans the whole table through shared memory: entry (q, b) becomes the first rank of
//    bucket q's Gaussians in block b. It also zeroes the four counts.
// 2. `slots_kernel`, a thread a Gaussian: its rank is its table entry plus its rank in
//    the block; it writes order[rank] and recomputes its rect, depth and cull values
//    from the inputs (fewer bytes than records written by launch 1 and read back). Where
//    every tier is narrow, the thread then writes every slot of its rank (a rank's slots
//    at ordinal t of a tier are adjacent to the next rank's, so lanes of one bucket,
//    consecutive ranks, store to adjacent words). Where a tier is wide (the caller's
//    `by_rank`; trained scenes have tiers of hundreds of ordinals), one thread would
//    write a long row alone, each store to another rank's line: the thread writes a
//    record at its rank instead, and the same launch's second phase writes the slots by
//    rank, a thread a rank's chunk of kChunk ordinals, after every block of the first
//    phase has finished
//    (a count the blocks raise; a block's phase comes from a ticket taken as it starts,
//    so that a waiting block waits only on blocks already running). Live slots and
//    dropped tiles are summed in shared memory and added by one atomic a block.
// Launch 1 must finish before launch 2 reads the table: stream order. Nothing syncs with
// the host or allocates, so a CUDA graph captures the plan. The ticket is a device int
// the caller keeps per device, zero before the first plan; two plans on one device must
// not run at once (one stream, or a graph replayed on one).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTiers = 24;        // ops/binning.py::PLAN_MAX_TIERS
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBuckets = 1024;  // buckets whose warp counts stay in shared memory
constexpr long long kTableTarget = 8192;  // the bucket table's entries aimed at
constexpr int kMaxRounds = 64;            // 16,384 Gaussians a block
constexpr int kScanItems = 16;            // table entries a thread scans a tile
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kScanShared = kScanTile + kScanTile / 32;  // a tile, a pad a 32 entries
constexpr int kChunk = 8;                 // tile ordinals a rank item writes

struct Inputs {
  const float* mean2d;   // (N, 2)
  const float* depth;    // (N,)
  const float* conic;    // (N, 3)
  const float* opacity;  // (N,)
  const int* radius;     // (N,)
  const int* x_min;
  const int* y_min;
  const int* x_max;
  const int* y_max;
  int n, num_rows, row0, row_stride, k_last;
};

struct Rank {
  Inputs in;
  int rounds, blocks, buckets;  // a block's rounds; the grid; Q = k_last + 1
  int* table;                   // (Q, blocks): counts, then first ranks
  int* local;                   // (N,) rank within the block's bucket
  int* warp_counts;             // (blocks, kWarps, Q) where Q > kSharedBuckets
  unsigned* ticket;             // zero between plans
  int* counters;                // [live slots, dropped tiles, and the slots launch's two]
};

struct Tier {
  int k_lo, k, w, b;  // tile ordinals [k_lo, k), w = k - k_lo; B_j ranks
  int c0;             // by rank: the tier's first chunk in its segment
  long long off;      // the tier's first slot
  long long first;    // by rank: the segment's first item
};

struct Slots {
  Inputs in;
  float alpha_div;          // 0.98 ALPHA_MIN, rounded to float32
  const int* table;
  const int* local;
  int* tile_key;            // (S,)
  int* depth_key;           // (S,)
  int* gauss;               // (S,)
  int* order;               // (N,)
  int* counters;            // [live slots, dropped tiles, blocks started, ranked blocks]
  int4* rec_a;              // by rank (N,): x_min, rw_safe, rho0, counts
  float4* rec_cull;         // by rank (N,): mean x, mean y, lam_min, cull_thresh
  int* rec_depth;           // by rank (N,): the depth's bits
  int per_block, blocks;    // launch 1's Gaussians a block, and its grid
  int grid_w, routed, dest_rows, route_bits, sentinel;
  int tile_h, tile_w, tiers, pad, by_rank;
  int gauss_blocks;         // the first phase's blocks
  long long s0;             // the grid's slots; the padding follows
  long long pad_first;      // the padding's first item (by rank; else N)
  long long items;          // the second phase's items (by rank) or the first's
  Tier tier[kMaxTiers];
};

// A Gaussian's tile rectangle on the owned rows, and its counts.
struct Rect {
  int x_min, rw_safe, rho0, counts_full, counts;
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {  // b > 0: in [0, b)
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// torch.clamp(x, min=lo) and torch.maximum: NaN propagates.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ Rect rect_of(const Inputs& in, long long i) {
  Rect r;
  r.x_min = in.x_min[i];
  const int rw = max(in.x_max[i] - r.x_min, 0);
  r.rw_safe = max(rw, 1);
  // owned_row_range
  const int y_lo = max(in.y_min[i], in.row0);
  const int y_hi = min(in.y_max[i], in.row0 + in.num_rows * in.row_stride);
  const int y0 = y_lo + floor_mod(in.row0 - y_lo, in.row_stride);
  const int nrows = max(floor_div(y_hi - y0 + in.row_stride - 1, in.row_stride), 0);
  r.rho0 = floor_div(y0 - in.row0, in.row_stride);
  r.counts_full = in.radius[i] > 0 ? nrows * rw : 0;
  r.counts = min(r.counts_full, in.k_last);
  return r;
}

// cull_bounds: (lam_min, cull_thresh).
__device__ __forceinline__ float2 cull_of(const Inputs& in, long long i, float alpha_div) {
  const float a = in.conic[3 * i], b = in.conic[3 * i + 1], c = in.conic[3 * i + 2];
  const float amc = __fsub_rn(a, c);
  const float disc = clamp_min(__fadd_rn(__fmul_rn(0.25f, __fmul_rn(amc, amc)),
                                         __fmul_rn(b, b)),
                               0.0f);
  const float lam = clamp_min(
      __fsub_rn(__fmul_rn(0.5f, __fadd_rn(a, c)), __fsqrt_rn(disc)), 0.0f);
  const float op = clamp_min(in.opacity[i], static_cast<float>(1e-12));
  return make_float2(lam, __fmul_rn(2.0f, logf(__fdiv_rn(op, alpha_div))));
}

// A round of 32 consecutive Gaussians of a warp: each lane's bucket (-1 past N), the
// lanes of its bucket, and those of them below it.
struct Round {
  int q;
  unsigned peers, below;
};

__device__ __forceinline__ Round round_of(const int* buckets, int k, int lane) {
  Round r;
  r.q = buckets[32 * k + lane];
  r.peers = __match_any_sync(0xffffffffu, r.q);
  r.below = r.peers & ((1u << lane) - 1u);
  return r;
}

// A tile entry's place in shared memory: a pad word after each 32, so that a thread's
// kScanItems consecutive entries and its neighbours' lie in different banks.
__device__ __forceinline__ int padded(int e) { return e + e / 32; }

// The table's exclusive scan in place, by the block, a tile of kScanTile entries at a
// time through `tile` (kScanShared ints of shared memory): the tile's loads all in
// flight, each thread's kScanItems consecutive entries summed, the threads' sums
// scanned, the entries written back. Entry e becomes the sum of the entries before it.
__device__ void scan_table(int* table, long long entries, int* tile, int* sums) {
  const int t = static_cast<int>(threadIdx.x);
  int carry = 0;
  for (long long t0 = 0; t0 < entries; t0 += kScanTile) {
    const int n = static_cast<int>(min(static_cast<long long>(kScanTile), entries - t0));
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int e = k * kThreads + t;
      tile[padded(e)] = e < n ? __ldcg(table + t0 + e) : 0;
    }
    __syncthreads();
    int own = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) own += tile[padded(kScanItems * t + i)];
    sums[t] = own;
    __syncthreads();
    for (int d = 1; d < kThreads; d <<= 1) {  // inclusive scan of the threads' sums
      const int v = t >= d ? sums[t - d] : 0;
      __syncthreads();
      sums[t] += v;
      __syncthreads();
    }
    int run = carry + sums[t] - own;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int v = tile[padded(kScanItems * t + i)];
      tile[padded(kScanItems * t + i)] = run;
      run += v;
    }
    carry += sums[kThreads - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int e = k * kThreads + t;
      if (e < n) table[t0 + e] = tile[padded(e)];
    }
    __syncthreads();
  }
}

// Dynamic shared memory: the block's buckets, then (up to kSharedBuckets buckets) each
// warp's row of counts.
extern __shared__ int rank_shared[];

__global__ void __launch_bounds__(kThreads) rank_kernel(const Rank p) {
  __shared__ int sums[kThreads];
  __shared__ bool last;
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const int per_block = kThreads * p.rounds, q_n = p.buckets;
  int* const buckets = rank_shared;
  int* const counts = q_n <= kSharedBuckets
                          ? rank_shared + per_block
                          : p.warp_counts + static_cast<long long>(blockIdx.x) * kWarps * q_n;
  int* const own = counts + warp * q_n;
  const long long base = static_cast<long long>(blockIdx.x) * per_block;
  // The block's buckets, all loads in flight at once: from the rect and radius alone.
#pragma unroll 8
  for (int k = static_cast<int>(threadIdx.x); k < per_block; k += kThreads) {
    buckets[k] = base + k < p.in.n ? p.in.k_last - rect_of(p.in, base + k).counts : -1;
  }
  for (int q = lane; q < q_n; q += 32) own[q] = 0;
  __syncthreads();
  const int* const mine = buckets + warp * 32 * p.rounds;  // the warp's run
  // Pass 1: the warp's Gaussians in each bucket.
  for (int k = 0; k < p.rounds; ++k) {
    const Round r = round_of(mine, k, lane);
    if (r.q >= 0 && r.below == 0) own[r.q] += __popc(r.peers);
    __syncwarp();
  }
  __syncthreads();
  // Each warp's offset in each bucket, and the block's column of the table.
  for (int q = static_cast<int>(threadIdx.x); q < q_n; q += kThreads) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = counts[w * q_n + q];
      counts[w * q_n + q] = total;
      total += c;
    }
    p.table[static_cast<long long>(q) * p.blocks + blockIdx.x] = total;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicInc(p.ticket, static_cast<unsigned>(p.blocks - 1)) ==
           static_cast<unsigned>(p.blocks - 1);
  }
  __syncthreads();
  // Pass 2: each Gaussian's rank within its block's bucket.
  const long long first = base + warp * 32LL * p.rounds;
  for (int k = 0; k < p.rounds; ++k) {
    const Round r = round_of(mine, k, lane);
    const int rank = r.q >= 0 ? own[r.q] + __popc(r.below) : 0;
    __syncwarp();
    if (r.q >= 0 && r.below == 0) own[r.q] += __popc(r.peers);
    __syncwarp();
    if (r.q >= 0) p.local[first + 32LL * k + lane] = rank;
  }
  if (last) {  // every column is written: the first ranks
    __syncthreads();  // the shared memory is the scan's now
    __threadfence();
    scan_table(p.table, static_cast<long long>(q_n) * p.blocks, rank_shared, sums);
    if (threadIdx.x < 4) p.counters[threadIdx.x] = 0;
  }
}

// The rank launch's dynamic shared bytes.
size_t rank_shared_bytes(int rounds, int buckets) {
  const size_t ints = static_cast<size_t>(kThreads) * rounds +
                      (buckets <= kSharedBuckets ? static_cast<size_t>(kWarps) * buckets : 0);
  return max(ints, static_cast<size_t>(kScanShared)) * sizeof(int);
}

// tile_reachable: may a splat at (mx, my) with cull (lam_min, cull_thresh) reach
// ALPHA_MIN on tile (gy, gx)?
__device__ __forceinline__ bool reachable(int gx, int gy, float mx, float my, float2 cull,
                                          int tile_h, int tile_w) {
  const float px_lo = __fmul_rn(static_cast<float>(gx), static_cast<float>(tile_w));
  const float py_lo = __fmul_rn(static_cast<float>(gy), static_cast<float>(tile_h));
  const float dx = clamp_min(
      max_nan(__fsub_rn(px_lo, mx), __fsub_rn(mx, __fadd_rn(px_lo, static_cast<float>(tile_w - 1)))),
      0.0f);
  const float dy = clamp_min(
      max_nan(__fsub_rn(py_lo, my), __fsub_rn(my, __fadd_rn(py_lo, static_cast<float>(tile_h - 1)))),
      0.0f);
  return __fmul_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), cull.x) <= cull.y;
}

// What a rank's slots need of its Gaussian.
struct Record {
  int4 a;       // x_min, rw_safe, rho0, counts
  int depth;    // the depth's bits
  int g;        // the Gaussian
  float4 cull;  // mean x, mean y, lam_min, cull_thresh (where a tier from 1 on holds it)
};

// Rank r's tile ordinals [t_begin, t_end) of tier `j`: writes their slots and returns
// the live ones.
__device__ int write_chunk(const Slots& s, const Tier& tier, int j, int r, const Record& x,
                           int t_begin, int t_end) {
  int ks = tier.k_lo + t_begin;
  int ry = ks / x.a.y;  // ks >= 0, rw_safe >= 1
  int rx = ks - ry * x.a.y;
  int live = 0;
  long long slot = tier.off + static_cast<long long>(t_begin) * tier.b + r;
  for (int t = t_begin; t < t_end; ++t) {
    const int ly = x.a.z + ry;  // local tile row
    const int gy = s.in.row0 + ly * s.in.row_stride;
    const int gx = x.a.x + rx;
    int local;
    if (s.routed) {
      const int dest = floor_div(gy, s.dest_rows);
      local = (dest << s.route_bits) | ((gy - dest * s.dest_rows) * s.grid_w + gx);
    } else {
      local = ly * s.grid_w + gx;
    }
    const bool valid =
        ks < x.a.w && (j == 0 || reachable(gx, gy, x.cull.x, x.cull.y,
                                           make_float2(x.cull.z, x.cull.w), s.tile_h,
                                           s.tile_w));
    const int key = valid ? local : s.sentinel;
    const bool is_live = key != s.sentinel;
    s.tile_key[slot] = key;
    s.depth_key[slot] = x.depth;
    s.gauss[slot] = is_live ? x.g : -1;
    live += is_live;
    slot += tier.b;
    ++ks;
    if (++rx == x.a.y) rx = 0, ++ry;
  }
  return live;
}

// The slots launch, in two phases. Each block takes its phase and place from a ticket
// (blocks take tickets in the order they start), so that a block of the second phase
// waits only on blocks that have started.
// 1. A thread a Gaussian: its rank (its table entry plus its rank in the block), its
//    place in `order`, its dropped tiles. Where no tier is wide (`by_rank` 0), it then
//    writes every slot of its rank itself (a thread a padding slot after the Gaussians);
//    else it writes its record at its rank.
// 2. By rank, after every block of phase 1 has finished: a thread an item, rank r < N
//    (tier 0's first kChunk tile ordinals), then (tier j, chunk, rank r < B_j) for the
//    rest of each tier, then the padding slots. Consecutive items are consecutive ranks:
//    the records are read, and the slots written, coalesced.
__global__ void __launch_bounds__(kThreads) slots_kernel(const Slots s) {
  // The tier table in shared memory: a kernel parameter indexed by a register would be
  // copied to local memory.
  __shared__ Tier tiers[kMaxTiers];
  __shared__ int live_sum, dropped_sum, block;
#pragma unroll
  for (int j = 0; j < kMaxTiers; ++j) {  // constant indices into the parameter
    if (j < s.tiers && static_cast<int>(threadIdx.x) == j) tiers[j] = s.tier[j];
  }
  if (threadIdx.x == 0) {
    live_sum = dropped_sum = 0;
    block = atomicAdd(&s.counters[2], 1);
  }
  __syncthreads();
  int live = 0, dropped = 0;
  if (block < s.gauss_blocks) {
    const long long item = static_cast<long long>(block) * kThreads + threadIdx.x;
    if (item < s.in.n) {
      const int g = static_cast<int>(item);
      const Rect rect = rect_of(s.in, g);
      const int q = s.in.k_last - rect.counts;
      const int r = s.table[static_cast<long long>(q) * s.blocks + g / s.per_block] + s.local[g];
      s.order[r] = g;
      int granted = r < tiers[0].b ? tiers[0].k : 0;
      for (int j = 1; j < s.tiers; ++j) {
        if (r < tiers[j].b && rect.counts > tiers[j].k_lo) granted = tiers[j].k;
      }
      dropped = rect.counts_full - rect.counts + max(rect.counts - granted, 0);
      Record x;
      x.a = make_int4(rect.x_min, rect.rw_safe, rect.rho0, rect.counts);
      x.depth = __float_as_int(s.in.depth[g]);
      x.g = g;
      x.cull = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s.tiers > 1 && r < tiers[1].b) {
        const float2 cull = cull_of(s.in, g, s.alpha_div);
        x.cull = make_float4(s.in.mean2d[2LL * g], s.in.mean2d[2LL * g + 1], cull.x, cull.y);
      }
      if (s.by_rank) {
        s.rec_a[r] = x.a;
        s.rec_depth[r] = x.depth;
        if (s.tiers > 1 && r < tiers[1].b) s.rec_cull[r] = x.cull;
      } else {
        // Budgets nest (B_j non-increasing): the tiers that hold rank r come first.
        for (int j = 0; j < s.tiers && r < tiers[j].b; ++j) {
          live += write_chunk(s, tiers[j], j, r, x, 0, tiers[j].w);
        }
      }
    } else if (!s.by_rank && item < s.in.n + static_cast<long long>(s.pad)) {
      const long long slot = s.s0 + (item - s.in.n);
      s.tile_key[slot] = s.sentinel;
      s.depth_key[slot] = 0;
      s.gauss[slot] = -1;
    }
    if (s.by_rank) {
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicAdd(&s.counters[3], 1);
    }
  } else {
    if (threadIdx.x == 0) {
      while (atomicAdd(&s.counters[3], 0) < s.gauss_blocks) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    const long long item =
        static_cast<long long>(block - s.gauss_blocks) * kThreads + threadIdx.x;
    int j = -1, r = 0, t_begin = 0;
    if (item < s.in.n) {
      r = static_cast<int>(item);
      if (r < tiers[0].b) j = 0;
    } else if (item < s.pad_first) {
      // (tier j, chunk, rank r): the last tier whose segment starts at or before the
      // item (an empty segment starts where the next one does).
      j = 0;
      while (j + 1 < s.tiers && item >= tiers[j + 1].first) ++j;
      const long long k = item - tiers[j].first;
      t_begin = (tiers[j].c0 + static_cast<int>(k / tiers[j].b)) * kChunk;
      r = static_cast<int>(k % tiers[j].b);
    } else if (item < s.items) {
      const long long slot = s.s0 + (item - s.pad_first);
      s.tile_key[slot] = s.sentinel;
      s.depth_key[slot] = 0;
      s.gauss[slot] = -1;
    }
    if (j >= 0) {
      Record x;
      x.a = __ldcg(s.rec_a + r);
      x.depth = __ldcg(s.rec_depth + r);
      x.g = __ldcg(s.order + r);
      x.cull = j > 0 ? __ldcg(s.rec_cull + r) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      live = write_chunk(s, tiers[j], j, r, x, t_begin, min(t_begin + kChunk, tiers[j].w));
    }
  }
  if (live != 0) atomicAdd(&live_sum, live);
  if (dropped != 0) atomicAdd(&dropped_sum, dropped);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (live_sum != 0) atomicAdd(&s.counters[0], live_sum);
    if (dropped_sum != 0) atomicAdd(&s.counters[1], dropped_sum);
  }
}

// cull_bounds alone, a thread a Gaussian (a check of the slots kernel's arithmetic).
__global__ void __launch_bounds__(kThreads) cull_kernel(const Inputs in, float alpha_div,
                                                        float2* out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < in.n) out[i] = cull_of(in, i, alpha_div);
}

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

// The rank launch's rounds a block for N Gaussians and Q buckets: the fewest that keep
// the table (blocks x Q) near kTableTarget entries, at most kMaxRounds.
int plan_rounds(long long n, long long q) {
  const long long per = kThreads * kTableTarget;
  return static_cast<int>(max(1LL, min(static_cast<long long>(kMaxRounds), (n * q + per - 1) / per)));
}

Inputs inputs_of(const void* const* inputs, const int* dims) {
  Inputs in{};
  in.mean2d = static_cast<const float*>(inputs[0]);
  in.depth = static_cast<const float*>(inputs[1]);
  in.conic = static_cast<const float*>(inputs[2]);
  in.opacity = static_cast<const float*>(inputs[3]);
  in.radius = static_cast<const int*>(inputs[4]);
  in.x_min = static_cast<const int*>(inputs[5]);
  in.y_min = static_cast<const int*>(inputs[6]);
  in.x_max = static_cast<const int*>(inputs[7]);
  in.y_max = static_cast<const int*>(inputs[8]);
  in.n = dims[0], in.num_rows = dims[1], in.row0 = dims[2], in.row_stride = dims[3];
  in.k_last = dims[4];
  return in;
}

bool bad_inputs(const Inputs& in) { return in.n < 0 || in.row_stride < 1 || in.k_last < 1; }

}  // namespace

// The rank launch's shape for N Gaussians and a last tier ending at k_last: shape[0]
// its rounds a block, [1] its blocks, [2] the table's ints (blocks x (k_last + 1)), [3]
// the ints of scratch it needs for warp counts (0 where they fit in shared memory).
extern "C" void gsrast_plan_shape(long long n, int k_last, long long* shape) {
  const long long q = static_cast<long long>(k_last) + 1;
  const int rounds = plan_rounds(n, q);
  const long long per_block = static_cast<long long>(kThreads) * rounds;
  const long long blocks = max(1LL, (n + per_block - 1) / per_block);
  shape[0] = rounds;
  shape[1] = blocks;
  shape[2] = blocks * q;
  shape[3] = q > kSharedBuckets ? blocks * kWarps * q : 0;
}

// The first launch of a plan. inputs: mean2d (N, 2), depth, conic (N, 3), opacity
// (float32), radius, x_min, y_min, x_max, y_max (int32), each contiguous. dims: N, the
// owned rows' count, first row and stride, k_last. table, warp_counts: int32 scratch of
// `gsrast_plan_shape`'s sizes (warp_counts may be null where that size is 0); local:
// (N,) int32; ticket: an int32 that is 0 (and is 0 again when the launch ends);
// counters: two int32, zeroed here. On `stream`, without synchronising; returns
// cudaGetLastError().
extern "C" int gsrast_plan_rank(const void* const* inputs, const int* dims, void* table,
                                void* local, void* warp_counts, void* ticket,
                                void* counters, void* stream) {
  Rank p{};
  p.in = inputs_of(inputs, dims);
  if (bad_inputs(p.in)) return static_cast<int>(cudaErrorInvalidValue);
  long long shape[4];
  gsrast_plan_shape(p.in.n, p.in.k_last, shape);
  if (shape[3] > 0 && warp_counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.rounds = static_cast<int>(shape[0]);
  p.blocks = static_cast<int>(shape[1]);
  p.buckets = p.in.k_last + 1;
  p.table = static_cast<int*>(table);
  p.local = static_cast<int*>(local);
  p.warp_counts = static_cast<int*>(warp_counts);
  p.ticket = static_cast<unsigned*>(ticket);
  p.counters = static_cast<int*>(counters);
  const size_t shared = rank_shared_bytes(p.rounds, p.buckets);
  cudaError_t e = cudaFuncSetAttribute(rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(shared));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  rank_kernel<<<static_cast<unsigned>(p.blocks), kThreads, shared, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The second launch, after `gsrast_plan_rank` on the same stream. inputs and dims[0:5]
// as there; dims[5:]: grid_w, routed (0 or 1), the destinations' rows, the route bits,
// the sentinel, tile_h, tile_w, the tier count, the padding slots, and by_rank (1: the
// slots written by rank from records, 0: each Gaussian writes its own). tier_k / tier_b:
// each tier's k_j and B_j; tier_off its first slot; s0 the grid's slots; records: by
// rank, 9 N int32 of scratch (null where by_rank is 0). Writes tile_key, depth_key,
// gauss (s0 + padding slots) and order (N), and adds to both counts (counters: the
// rank launch's four), on `stream`, without synchronising; returns cudaGetLastError().
extern "C" int gsrast_plan_slots(const void* const* inputs, const int* dims, float alpha_div,
                                 const void* table, const void* local, void* records,
                                 void* tile_key, void* depth_key, void* gauss, void* order,
                                 void* counters, const int* tier_k, const int* tier_b,
                                 const long long* tier_off, long long s0, void* stream) {
  Slots s{};
  s.in = inputs_of(inputs, dims);
  s.alpha_div = alpha_div;
  s.table = static_cast<const int*>(table);
  s.local = static_cast<const int*>(local);
  s.tile_key = static_cast<int*>(tile_key);
  s.depth_key = static_cast<int*>(depth_key);
  s.gauss = static_cast<int*>(gauss);
  s.order = static_cast<int*>(order);
  s.counters = static_cast<int*>(counters);
  s.grid_w = dims[5], s.routed = dims[6], s.dest_rows = dims[7], s.route_bits = dims[8];
  s.sentinel = dims[9], s.tile_h = dims[10], s.tile_w = dims[11], s.tiers = dims[12];
  s.pad = dims[13], s.by_rank = dims[14];
  s.s0 = s0;
  if (bad_inputs(s.in) || s.tiers < 1 || s.tiers > kMaxTiers || s.pad < 0 ||
      (s.routed && s.dest_rows < 1) || (s.by_rank && records == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s.by_rank) {
    s.rec_a = static_cast<int4*>(records);
    s.rec_cull = reinterpret_cast<float4*>(s.rec_a + s.in.n);
    s.rec_depth = reinterpret_cast<int*>(s.rec_cull + s.in.n);
  }
  long long shape[4];
  gsrast_plan_shape(s.in.n, s.in.k_last, shape);
  s.per_block = kThreads * static_cast<int>(shape[0]);
  s.blocks = static_cast<int>(shape[1]);
  int k_lo = 0;
  long long items = s.in.n;
  for (int j = 0; j < s.tiers; ++j) {
    Tier& t = s.tier[j];
    t.k_lo = k_lo, t.k = tier_k[j], t.w = t.k - k_lo, t.b = tier_b[j];
    t.off = tier_off[j];
    if (t.w < 1 || t.b < 0 || t.b > s.in.n || (j > 0 && t.b > s.tier[j - 1].b))
      return static_cast<int>(cudaErrorInvalidValue);
    t.c0 = j == 0 ? 1 : 0;  // rank r's own item writes tier 0's first chunk
    t.first = items;
    items += static_cast<long long>((t.w + kChunk - 1) / kChunk - t.c0) * t.b;
    k_lo = t.k;
  }
  if (k_lo != s.in.k_last) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks;
  if (s.by_rank) {
    s.pad_first = items;
    s.items = items + s.pad;
    s.gauss_blocks = static_cast<int>(blocks_for(s.in.n));
    blocks = s.gauss_blocks + static_cast<long long>(blocks_for(s.items));
  } else {
    s.pad_first = s.in.n;
    s.items = s.in.n + static_cast<long long>(s.pad);
    s.gauss_blocks = static_cast<int>(blocks_for(s.items));
    blocks = s.gauss_blocks;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) slots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// cull_bounds of each Gaussian (lam_min, cull_thresh) into out (N, 2) float32, as the
// slots launch computes them (inputs and dims as `gsrast_plan_rank`'s); on `stream`,
// without synchronising; returns cudaGetLastError().
extern "C" int gsrast_plan_cull(const void* const* inputs, const int* dims, float alpha_div,
                                void* out, void* stream) {
  const Inputs in = inputs_of(inputs, dims);
  if (bad_inputs(in)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (in.n > 0) cull_kernel<<<blocks_for(in.n), kThreads, 0, st>>>(in, alpha_div, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
