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
//   tests hold this source's prologue to correctly rounded values there.
// - NaN: torch's clamp and maximum propagate NaN; `clamp_min` and `max_nan` do too, so
//   a NaN input makes the cull test false in both.
// - Sums: integer atomics are order-free, and 32-bit wrap-around gives the plain
//   version's int64 sums cast to int32. So total and overflow_tile_cap are exact.
//
// What bounds it on this card: bytes. The function reads each Gaussian's preprocess
// fields once (rect 16 bytes, radius, depth, conic 12, opacity, mean2d 8: 48 bytes) and
// writes `order` (4 bytes a Gaussian) and 12 bytes a slot: at 1M Gaussians and 3.24M
// slots, 91 MB, 0.027 ms at 3.35 TB/s. Its plain version's cost on the card is its
// kernels' count, not its bytes.
//
// The design, three launches a plan (the caller counts them as one):
// 1. `prologue_kernel`, a thread a Gaussian: the per-Gaussian values above, written as
//    a sort key (counts descending as an ascending key k_last - counts, in the narrowest
//    of 1, 2 or 4 bytes that holds k_last) and three records (int4: x_min, rw_safe,
//    rho0, counts; the depth bits; float4: the mean and the cull's two values), and
//    sum(counts_full - counts) by one atomic a block.
// 2. The caller's stable torch.sort of the keys: the ranking, a library sort of N keys
//    (the reference's is an XLA sort too, outside any Pallas kernel). A narrower key
//    takes fewer of its radix passes.
// 3. `slots_kernel`, a thread an item: item r < N is rank r (its `order`, its granted
//    tiers and dropped tiles, and tier 0's first kChunk tile ordinals); the later items
//    are (tier j, chunk c, rank r < B_j) for the rest of each tier's tile ordinals,
//    kChunk of them, then the padding slots. Consecutive items are consecutive ranks,
//    so a warp's stores to slot off_j + t B_j + r are coalesced, and each record is
//    gathered once a chunk. Live slots and dropped tiles are summed in shared memory and
//    added by one atomic a block. The tier table (at most kMaxTiers tiers) goes by value
//    and is copied into shared memory.
// The two counts are zeroed by one memset on the stream before the first launch. Nothing
// syncs with the host or allocates, so a CUDA graph captures the plan.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTiers = 24;  // ops/binning.py::PLAN_MAX_TIERS
constexpr int kThreads = 256;
constexpr int kChunk = 8;      // tile ordinals a slot item writes

struct Prologue {
  const float* mean2d;   // (N, 2)
  const float* depth;    // (N,)
  const float* conic;    // (N, 3)
  const float* opacity;  // (N,)
  const int* radius;     // (N,)
  const int* x_min;
  const int* y_min;
  const int* x_max;
  const int* y_max;
  void* key;             // (N,) uint8, int16 or int32: k_last - counts
  int4* rec_a;           // (N,) x_min, rw_safe, rho0, counts
  int* rec_depth;        // (N,) depth bits
  float4* rec_cull;      // (N,) mean x, mean y, lam_min, cull_thresh
  int* counters;         // [live slots, dropped tiles]
  int n, num_rows, row0, row_stride, k_last, key_bytes;
  float alpha_div;       // 0.98 ALPHA_MIN, rounded to float32
};

struct Tier {
  int k_lo, k, w, b;  // tile ordinals [k_lo, k), w = k - k_lo; B_j ranks
  int c0;             // the tier's first chunk in its segment (tier 0's first is rank r's)
  int chunks;         // ceil(w / kChunk)
  long long off;      // the tier's first slot
  long long first;    // the segment's first item
};

struct Slots {
  const long long* sorted;  // (N,) the ranking: torch.sort's indices
  const int4* rec_a;
  const int* rec_depth;
  const float4* rec_cull;
  int* tile_key;            // (S,)
  int* depth_key;           // (S,)
  int* gauss;               // (S,)
  int* order;               // (N,)
  int* counters;
  int n, grid_w, row0, row_stride, routed, dest_rows, route_bits, sentinel;
  int tile_h, tile_w, tiers, pad;
  long long s0;             // the grid's slots; the padding follows
  long long pad_first;      // the padding's first item
  long long items;
  Tier tier[kMaxTiers];
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

__global__ void __launch_bounds__(kThreads) prologue_kernel(const Prologue p) {
  __shared__ int dropped;
  if (threadIdx.x == 0) dropped = 0;
  __syncthreads();
  const int i = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (i < p.n) {
    const int x_min = p.x_min[i];
    const int rw = max(p.x_max[i] - x_min, 0);
    const int rw_safe = max(rw, 1);
    // owned_row_range
    const int y_lo = max(p.y_min[i], p.row0);
    const int y_hi = min(p.y_max[i], p.row0 + p.num_rows * p.row_stride);
    const int y0 = y_lo + floor_mod(p.row0 - y_lo, p.row_stride);
    const int nrows = max(floor_div(y_hi - y0 + p.row_stride - 1, p.row_stride), 0);
    const int rho0 = floor_div(y0 - p.row0, p.row_stride);
    const int counts_full = p.radius[i] > 0 ? nrows * rw : 0;
    const int counts = min(counts_full, p.k_last);
    const unsigned key = static_cast<unsigned>(p.k_last - counts);
    if (p.key_bytes == 1) {
      static_cast<unsigned char*>(p.key)[i] = static_cast<unsigned char>(key);
    } else if (p.key_bytes == 2) {
      static_cast<short*>(p.key)[i] = static_cast<short>(key);
    } else {
      static_cast<int*>(p.key)[i] = static_cast<int>(key);
    }
    // cull_bounds
    const float a = p.conic[3 * i], b = p.conic[3 * i + 1], c = p.conic[3 * i + 2];
    const float amc = __fsub_rn(a, c);
    const float disc = clamp_min(__fadd_rn(__fmul_rn(0.25f, __fmul_rn(amc, amc)),
                                           __fmul_rn(b, b)),
                                 0.0f);
    const float lam = clamp_min(
        __fsub_rn(__fmul_rn(0.5f, __fadd_rn(a, c)), __fsqrt_rn(disc)), 0.0f);
    const float op = clamp_min(p.opacity[i], static_cast<float>(1e-12));
    const float thr = __fmul_rn(2.0f, logf(__fdiv_rn(op, p.alpha_div)));
    p.rec_a[i] = make_int4(x_min, rw_safe, rho0, counts);
    p.rec_depth[i] = __float_as_int(p.depth[i]);
    p.rec_cull[i] = make_float4(p.mean2d[2 * i], p.mean2d[2 * i + 1], lam, thr);
    if (counts_full != counts) atomicAdd(&dropped, counts_full - counts);
  }
  __syncthreads();
  if (threadIdx.x == 0 && dropped != 0) atomicAdd(&p.counters[1], dropped);
}

// tile_reachable: may a splat at (mx, my) with (lam_min, cull_thresh) reach ALPHA_MIN on
// tile (gy, gx)?
__device__ __forceinline__ bool reachable(int gx, int gy, const float4& cull, int tile_h,
                                          int tile_w) {
  const float px_lo = __fmul_rn(static_cast<float>(gx), static_cast<float>(tile_w));
  const float py_lo = __fmul_rn(static_cast<float>(gy), static_cast<float>(tile_h));
  const float dx = clamp_min(
      max_nan(__fsub_rn(px_lo, cull.x),
              __fsub_rn(cull.x, __fadd_rn(px_lo, static_cast<float>(tile_w - 1)))),
      0.0f);
  const float dy = clamp_min(
      max_nan(__fsub_rn(py_lo, cull.y),
              __fsub_rn(cull.y, __fadd_rn(py_lo, static_cast<float>(tile_h - 1)))),
      0.0f);
  return __fmul_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), cull.z) <= cull.w;
}

// Rank r's tile ordinals [t_begin, t_end) of tier `j`: writes their slots and returns
// the live ones.
__device__ __forceinline__ int write_chunk(const Slots& s, const Tier tier, int j,
                                           int r, int g, int t_begin, int t_end) {
  const int4 rec = s.rec_a[g];  // x_min, rw_safe, rho0, counts
  const int depth = s.rec_depth[g];
  float4 cull = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (j > 0) cull = s.rec_cull[g];
  int ks = tier.k_lo + t_begin;
  int ry = ks / rec.y;  // ks >= 0, rw_safe >= 1
  int rx = ks - ry * rec.y;
  int live = 0;
  long long slot = tier.off + static_cast<long long>(t_begin) * tier.b + r;
  for (int t = t_begin; t < t_end; ++t) {
    const int ly = rec.z + ry;  // local tile row
    const int gy = s.row0 + ly * s.row_stride;
    const int gx = rec.x + rx;
    int local;
    if (s.routed) {
      const int dest = floor_div(gy, s.dest_rows);
      local = (dest << s.route_bits) | ((gy - dest * s.dest_rows) * s.grid_w + gx);
    } else {
      local = ly * s.grid_w + gx;
    }
    const bool valid = ks < rec.w && (j == 0 || reachable(gx, gy, cull, s.tile_h, s.tile_w));
    const int key = valid ? local : s.sentinel;
    const bool is_live = key != s.sentinel;
    s.tile_key[slot] = key;
    s.depth_key[slot] = depth;
    s.gauss[slot] = is_live ? g : -1;
    live += is_live;
    slot += tier.b;
    ++ks;
    if (++rx == rec.y) rx = 0, ++ry;
  }
  return live;
}

__global__ void __launch_bounds__(kThreads) slots_kernel(const Slots s) {
  // The tier table in shared memory: a kernel parameter indexed by a register would be
  // copied to local memory.
  __shared__ Tier tiers[kMaxTiers];
  __shared__ int live_sum, dropped_sum;
#pragma unroll
  for (int j = 0; j < kMaxTiers; ++j) {  // constant indices into the parameter
    if (j < s.tiers && static_cast<int>(threadIdx.x) == j) tiers[j] = s.tier[j];
  }
  if (threadIdx.x == 0) live_sum = dropped_sum = 0;
  __syncthreads();
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int live = 0, dropped = 0;
  if (item < s.n) {
    // Rank r: its Gaussian, the tiers that hold it, and tier 0's first chunk.
    const int r = static_cast<int>(item);
    const int g = static_cast<int>(s.sorted[r]);
    s.order[r] = g;
    const int counts = s.rec_a[g].w;
    int granted = r < tiers[0].b ? tiers[0].k : 0;
    for (int j = 1; j < s.tiers; ++j) {
      if (r < tiers[j].b && counts > tiers[j].k_lo) granted = tiers[j].k;
    }
    dropped = max(counts - granted, 0);
    if (r < tiers[0].b) live = write_chunk(s, tiers[0], 0, r, g, 0, min(kChunk, tiers[0].w));
  } else if (item < s.pad_first) {
    // (tier j, chunk, rank r): the last tier whose segment starts at or before the
    // item (an empty segment starts where the next one does).
    int j = 0;
    while (j + 1 < s.tiers && item >= tiers[j + 1].first) ++j;
    const Tier tier = tiers[j];
    const long long k = item - tier.first;
    const int chunk = tier.c0 + static_cast<int>(k / tier.b);
    const int r = static_cast<int>(k % tier.b);
    const int g = static_cast<int>(s.sorted[r]);
    const int t_begin = chunk * kChunk;
    live = write_chunk(s, tier, j, r, g, t_begin, min(t_begin + kChunk, tier.w));
  } else if (item < s.items) {
    const long long slot = s.s0 + (item - s.pad_first);
    s.tile_key[slot] = s.sentinel;
    s.depth_key[slot] = 0;
    s.gauss[slot] = -1;
  }
  if (live != 0) atomicAdd(&live_sum, live);
  if (dropped != 0) atomicAdd(&dropped_sum, dropped);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (live_sum != 0) atomicAdd(&s.counters[0], live_sum);
    if (dropped_sum != 0) atomicAdd(&s.counters[1], dropped_sum);
  }
}

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

}  // namespace

// The first launch of a plan of `dims[0]` Gaussians. inputs: mean2d (N, 2), depth,
// conic (N, 3), opacity (float32), radius, x_min, y_min, x_max, y_max (int32), each
// contiguous. dims: N, the owned rows' count, first row and stride, k_last, the key's
// bytes (1, 2 or 4). Writes the sort key and the three records, and zeroes then adds
// to counters[1] (counters: two int32, [live slots, dropped tiles]), on `stream`,
// without synchronising; returns cudaGetLastError().
extern "C" int gsrast_plan_prologue(const void* const* inputs, const int* dims,
                                    float alpha_div, void* key, void* rec_a,
                                    void* rec_depth, void* rec_cull, void* counters,
                                    void* stream) {
  Prologue p{};
  p.mean2d = static_cast<const float*>(inputs[0]);
  p.depth = static_cast<const float*>(inputs[1]);
  p.conic = static_cast<const float*>(inputs[2]);
  p.opacity = static_cast<const float*>(inputs[3]);
  p.radius = static_cast<const int*>(inputs[4]);
  p.x_min = static_cast<const int*>(inputs[5]);
  p.y_min = static_cast<const int*>(inputs[6]);
  p.x_max = static_cast<const int*>(inputs[7]);
  p.y_max = static_cast<const int*>(inputs[8]);
  p.n = dims[0], p.num_rows = dims[1], p.row0 = dims[2], p.row_stride = dims[3];
  p.k_last = dims[4], p.key_bytes = dims[5];
  if (p.n < 0 || p.row_stride < 1 || p.k_last < 1 ||
      !(p.key_bytes == 1 || p.key_bytes == 2 || p.key_bytes == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  p.alpha_div = alpha_div;
  p.key = key;
  p.rec_a = static_cast<int4*>(rec_a);
  p.rec_depth = static_cast<int*>(rec_depth);
  p.rec_cull = static_cast<float4*>(rec_cull);
  p.counters = static_cast<int*>(counters);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.n > 0) prologue_kernel<<<blocks_for(p.n), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The last launch, after the caller's stable sort of the prologue's keys (`sorted`: its
// int64 indices). dims: N, grid_w, the first owned row and the row stride, routed (0 or
// 1), the destinations' rows, the route bits, the sentinel, tile_h, tile_w, the tier
// count and the padding slots. tier_k / tier_b: each tier's k_j and B_j; tier_off its
// first slot; s0 the grid's slots. Writes tile_key, depth_key, gauss (s0 + padding
// slots) and order (N), and adds to both counters, on `stream`, without synchronising;
// returns cudaGetLastError().
extern "C" int gsrast_plan_slots(const void* sorted, const void* rec_a,
                                 const void* rec_depth, const void* rec_cull,
                                 void* tile_key, void* depth_key, void* gauss,
                                 void* order, void* counters, const int* dims,
                                 const int* tier_k, const int* tier_b,
                                 const long long* tier_off, long long s0, void* stream) {
  Slots s{};
  s.sorted = static_cast<const long long*>(sorted);
  s.rec_a = static_cast<const int4*>(rec_a);
  s.rec_depth = static_cast<const int*>(rec_depth);
  s.rec_cull = static_cast<const float4*>(rec_cull);
  s.tile_key = static_cast<int*>(tile_key);
  s.depth_key = static_cast<int*>(depth_key);
  s.gauss = static_cast<int*>(gauss);
  s.order = static_cast<int*>(order);
  s.counters = static_cast<int*>(counters);
  s.n = dims[0], s.grid_w = dims[1], s.row0 = dims[2], s.row_stride = dims[3];
  s.routed = dims[4], s.dest_rows = dims[5], s.route_bits = dims[6], s.sentinel = dims[7];
  s.tile_h = dims[8], s.tile_w = dims[9], s.tiers = dims[10], s.pad = dims[11];
  s.s0 = s0;
  if (s.n < 0 || s.tiers < 1 || s.tiers > kMaxTiers || s.pad < 0 ||
      (s.routed && s.dest_rows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  long long items = s.n;
  int k_lo = 0;
  for (int j = 0; j < s.tiers; ++j) {
    Tier& t = s.tier[j];
    t.k_lo = k_lo, t.k = tier_k[j], t.w = t.k - k_lo, t.b = tier_b[j];
    t.off = tier_off[j];
    if (t.w < 1 || t.b < 0 || t.b > s.n || (j > 0 && t.b > s.tier[j - 1].b))
      return static_cast<int>(cudaErrorInvalidValue);
    t.chunks = (t.w + kChunk - 1) / kChunk;
    t.c0 = j == 0 ? 1 : 0;  // rank r's own item writes tier 0's first chunk
    t.first = items;
    items += static_cast<long long>(t.chunks - t.c0) * t.b;
    k_lo = t.k;
  }
  s.pad_first = items;
  s.items = items + s.pad;
  const auto st = static_cast<cudaStream_t>(stream);
  if (s.items > 0) slots_kernel<<<blocks_for(s.items), kThreads, 0, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}
