"""Tile planning: the slot grids of (tile, depth) keys.

Port of the reference's planners (`gsrast_tpu/ops/binning.py`), with their
row-local and routed modes for the sharded paths (`parallel/`):

  * the multi-tier plan (`owned_row_range`, `tier_dims`, `shard_tiers`,
    `auto_tiers`, `plan_tiers`), for a non-empty `RenderConfig.tiers`:
    every visible Gaussian is enumerated over the tiles of its rectangle
    on a slot grid sized near the true intersection count: Gaussians are
    ranked by tile count (descending), and tier j gives the top B_j of them
    slots for tile ordinals k_{j-1}..k_j, laid out t-major;
  * the legacy two-tier binning (`build_binning`), the reference's default
    (`tiers=()`): an (N, K1) grid for every Gaussian, K2 - K1 more slots
    for a budget of the heaviest, one 31-bit `tile | quantized depth` key
    per slot, one stable sort, truncation to a static capacity;
  * `expand_intersections`, the exact expansion of per-Gaussian counts
    that the legacy primitive-sharded path routes.

The integer structure is identical to the reference's, slot for slot, so
the sorts in `render.pipeline` order intersections exactly as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config as cfg
from . import projection
from .preprocess import Preprocessed


def owned_row_range(y_min, y_max, row0: int, row_stride: int, num_rows: int):
    """Rows {row0 + r*row_stride : 0 <= r < num_rows} intersected with
    [y_min, y_max), as (first owned row y0, count)."""
    y_lo = torch.clamp(y_min, min=row0)
    y_hi = torch.clamp(y_max, max=row0 + num_rows * row_stride)
    y0 = y_lo + (row0 - y_lo) % row_stride
    nrows = torch.clamp((y_hi - y0 + row_stride - 1) // row_stride, min=0)
    return y0, nrows


def tile_counts(prep: Preprocessed, grid_h: int):
    """Per-Gaussian tile counts over the whole grid (0 when culled), with
    the first covered tile row y0 and the rect width rw, all int32."""
    rect = prep.rect
    rw = torch.clamp(rect.x_max - rect.x_min, min=0)
    y0, nrows = owned_row_range(rect.y_min, rect.y_max, 0, 1, grid_h)
    counts = torch.where(prep.radius > 0, nrows * rw, 0).to(torch.int32)
    return counts, y0, rw


class TierPlan(NamedTuple):
    """Integer structure of the multi-tier slot grid (all int32).

    Slot (rank r, tile ordinal t) of tier j is off_j + (t - k_{j-1})*B_j + r
    over the count-ranked order `order`."""

    tile_key: torch.Tensor   # (S,) tile id; num_tiles marks a dead slot
    depth_key: torch.Tensor  # (S,) float32 depth bits (0 on padding)
    gauss: torch.Tensor      # (S,) Gaussian index; -1 on dead slots
    order: torch.Tensor      # (N,) count-descending Gaussian ranking
    total: torch.Tensor      # () live slots = intersections
    overflow_tile_cap: torch.Tensor  # () tiles dropped by k_last or a budget


def tier_dims(n: int, tiers) -> tuple:
    """Static per-tier (width w_j, rows B_j, slot offset off_j) and the total
    slot count. Budgets are rounded up to 128 rows, clamped to n and to
    nesting (non-increasing); tier 0 with frac >= 1 covers every Gaussian."""
    dims = []
    off = 0
    prev_b = n
    prev_k = 0
    for j, (k, frac) in enumerate(tiers):
        if k <= prev_k:
            raise ValueError(f"tier ks must ascend, got {tiers}")
        if j == 0 and frac >= 1.0:
            b = n
        else:
            b = min(n, max(128, -(-int(n * frac) // 128) * 128), prev_b)
        dims.append((k - prev_k, b, off))
        off += (k - prev_k) * b
        prev_b, prev_k = b, k
    return tuple(dims), off


def shard_tiers(tiers, n_dev: int, headroom: float = 2.0) -> tuple:
    """Per-device tier spec for tile sharding, the reference's: with
    interleaved row ownership each device owns ~1/D of every Gaussian's tile
    rows, so tier widths divide by D (ceil; the last tier keeps `headroom`
    for row-quantization skew, at most its global k) and budget fractions
    keep their global values. Tier 0 keeps a full budget (frac >= 1):
    nearly every visible Gaussian still owns a tile on every device.
    Tiers that collapse to the same k merge, keeping the earlier frac; a
    frac above its predecessor's (from the second tier on) is lowered to
    it. Drops are counted by `plan_tiers`, never silent."""
    if n_dev <= 1:
        return tuple(tiers)
    out = []
    for i, (k, f) in enumerate(tiers):
        kd = -(-k // n_dev)
        if i == len(tiers) - 1:
            kd = max(kd, min(k, int(-(-k * headroom // n_dev))))
        if i == 0:
            f = max(f, 1.0)
        if not out or out[-1][0] < kd:
            out.append((kd, f))
    fixed = []
    for k, f in out:
        if fixed and f > fixed[-1][1] and len(fixed) > 1:
            f = fixed[-1][1]
        fixed.append((k, f))
    return tuple(fixed)


def auto_tiers(counts, margin: float = 1.12, k0_max: int = 4,
               tier_penalty: float = 0.08):
    """A near-minimal tier spec for a scene's per-Gaussian tile counts
    (host numpy): minimises the slot volume sum_j w_j * B_j over tier cut
    points by a shortest path on a candidate k grid, with `margin` headroom
    on every budget. Gaussians with count 0 get no slots."""
    counts = np.asarray(counts)
    n = max(int(counts.shape[0]), 1)
    cmax = max(int(counts.max()) if counts.size else 1, 1)
    cands = sorted({1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                    192, 256, 384, 512, 768, 1024, cmax})
    cands = [c for c in cands if c <= cmax]
    # frac(count > k) with headroom; budgets never below one 128-row block.
    frac = {k: min(1.0, float((counts > k).mean()) * margin + 128.0 / n)
            for k in [0] + cands}
    f0 = frac[0]
    # best[i] = (least slot volume covering counts <= cands[i], tiers)
    best = {}
    for i, ci in enumerate(cands):
        best[i] = ((ci * f0, [(ci, f0)]) if ci <= k0_max
                   else (float("inf"), None))
        for j in range(i):
            cj = cands[j]
            if best[j][1] is None:
                continue
            # tier_penalty charges each extra tier's fixed cost so thin
            # tiers merge away.
            cost = best[j][0] + (ci - cj) * frac[cj] + tier_penalty
            if cost < best[i][0]:
                best[i] = (cost, best[j][1] + [(ci, frac[cj])])
    tiers = best[len(cands) - 1][1]
    return tuple((int(k), round(float(f), 4)) for k, f in tiers)


class Binning(NamedTuple):
    """The legacy binning's result (all int32), the reference's `Binning`.

    Slots are numbered tier 1 first, (i, k) -> i K1 + k for k < K1, then
    tier 2, (h, k) -> N K1 + h (K2 - K1) + (k - K1) over the heavy rows h;
    padding slots up to the capacity carry the number of real slots."""

    sorted_tile: torch.Tensor   # (C,) local tile; num_local_tiles when dead
    sorted_gauss: torch.Tensor  # (C,) Gaussian index; -1 when dead
    sorted_slot: torch.Tensor   # (max(S, C),) slot at each sorted position;
                                # positions >= C fell to the truncation
    heavy_idx: torch.Tensor     # (H,) Gaussians granted a tier-2 row, padded
                                # with N; (0,) without tier 2
    tile_starts: torch.Tensor   # (T+1,) half-open ranges of the local tiles
    num_intersections: torch.Tensor  # () written intersections, <= C
    overflow_capacity: torch.Tensor  # () intersections past the capacity
    overflow_tile_cap: torch.Tensor  # () tiles dropped by K2 or the heavy
                                     # budget


IMAX = 2**31 - 1  # the legacy keys' sentinel, int32's largest value


def expand_intersections(counts: torch.Tensor, capacity: int) -> tuple:
    """Exact expansion of per-Gaussian counts (N,): position j of
    [0, capacity) -> (Gaussian i, ordinal k within i), by a binary search
    of the exclusive prefix sum. Positions at or past the total map to the
    last Gaussian with a count, with k past its count. Returns (i (C,),
    k (C,), offsets (N,), total ()), all int32."""
    counts = counts.long()
    offsets = torch.cumsum(counts, 0) - counts
    total = offsets[-1] + counts[-1]
    j = torch.arange(capacity, dtype=torch.int64, device=counts.device)
    i = torch.clamp(torch.searchsorted(offsets, j, right=True) - 1, min=0)
    k = j - offsets.index_select(0, i)
    i32 = torch.int32
    return i.to(i32), k.to(i32), offsets.to(i32), total.to(i32)


def build_binning(prep: Preprocessed, grid_h: int, grid_w: int,
                  render_cfg: cfg.RenderConfig, capacity: int,
                  num_local_rows: int | None = None, row0: int = 0,
                  row_stride: int = 1) -> Binning:
    """The legacy two-tier binning of the reference (`build_binning`).

    Tier 1 is the (N, K1) grid: slot (i, k) is the k-th owned tile of
    Gaussian i, its owned rows walked row-major. Tier 2 gives the H heavy
    Gaussians (more than K1 tiles; H = heavy_fraction N rounded up to 128,
    at most N; the first H in index order) tiles K1..K2, each culled
    where the splat's ellipse cannot reach ALPHA_MIN on the tile. A slot's
    key is `local tile << depth_bits | depth bits >> (31 - depth_bits)`
    with depth_bits = 31 - bit_length(num_local_tiles + 1); dead slots key
    int32's largest value. One stable sort of the keys in slot order (ties,
    including quantized depths, keep slot order), truncation to
    `capacity`, and searchsorted tile ranges. Drops are counted, never
    silent.

    Row-local mode (the tile-sharded path): only rows {row0 + r row_stride
    : r < num_local_rows} are binned, tile ids local (r grid_w + x)."""
    if num_local_rows is None:
        num_local_rows, row0 = grid_h, 0
    num_local_tiles = num_local_rows * grid_w
    k2 = render_cfg.max_tiles_per_gaussian
    k1 = min(render_cfg.base_tiles_per_gaussian, k2)
    n = prep.depth.shape[0]
    device = prep.depth.device
    i32 = torch.int32
    h_budget = (min(n, max(128, -(-int(n * render_cfg.heavy_fraction)
                                  // 128) * 128)) if k2 > k1 else 0)
    # +1 keeps the sentinel's tile (IMAX >> depth_bits) above every tile.
    depth_bits = 31 - (num_local_tiles + 1).bit_length()
    if depth_bits < 12:
        raise ValueError(
            f"{num_local_tiles} tiles leave only {depth_bits} depth bits; "
            "use a larger tile shape or shard the tile grid")

    rect = prep.rect
    rw = rect.x_max - rect.x_min
    rw_safe = torch.clamp(rw, min=1)
    y0, nrows = owned_row_range(rect.y_min, rect.y_max, row0, row_stride,
                                num_local_rows)
    rho0 = (y0 - row0) // row_stride  # first owned local row
    counts_full = torch.where(prep.radius > 0, nrows * rw, 0).to(i32)
    counts = torch.clamp(counts_full, max=k2)
    depth_q = projection.depth_order_key(prep.depth) >> (31 - depth_bits)

    # The tier-2 cull (`tile_reachable`), the tier-1 grid's slots uncut.
    lam_min, cull_thresh = cull_bounds(prep)

    # Tier 1: the (N, K1) grid, built elementwise.
    ks = torch.arange(k1, dtype=i32, device=device)[None, :]
    ry = ks // rw_safe[:, None]
    rx = ks - ry * rw_safe[:, None]
    local = (rho0[:, None] + ry) * grid_w + rect.x_min[:, None] + rx
    valid1 = ks < torch.clamp(counts, max=k1)[:, None]
    key1 = torch.where(valid1, (local << depth_bits) | depth_q[:, None],
                       IMAX).to(i32).reshape(-1)
    gauss1 = torch.arange(n, dtype=i32, device=device)[:, None].expand(
        n, k1).reshape(-1)
    ns = n * k1
    total = torch.sum(valid1, dtype=i32)

    if h_budget > 0:
        # Tier 2: the heavy Gaussians (counts > K1), first in index order,
        # on H rows for their tiles K1..K2; demand past the budget counts.
        kh = k2 - k1
        heavy = counts > k1
        order = torch.sort((~heavy).to(torch.uint8), stable=True).indices
        n_sel = torch.clamp(torch.sum(heavy, dtype=i32), max=h_budget)
        sel_ok = torch.arange(h_budget, dtype=i32, device=device) < n_sel
        h_idx = torch.where(sel_ok, order[:h_budget].to(i32), n)
        h_c = torch.clamp(h_idx, max=n - 1).long()
        counts_h = torch.where(sel_ok, counts[h_c], 0)
        ks2 = k1 + torch.arange(kh, dtype=i32, device=device)[None, :]
        rw_h = rw_safe[h_c][:, None]
        ry2 = ks2 // rw_h
        rx2 = ks2 - ry2 * rw_h
        x2 = rect.x_min[h_c][:, None] + rx2
        local2 = (rho0[h_c][:, None] + ry2) * grid_w + x2
        valid2 = (ks2 < counts_h[:, None]) & tile_reachable(
            x2, y0[h_c][:, None] + ry2 * row_stride,
            prep.mean2d[h_c, 0][:, None], prep.mean2d[h_c, 1][:, None],
            lam_min[h_c][:, None], cull_thresh[h_c][:, None],
            render_cfg.tile_h, render_cfg.tile_w)
        key2 = torch.where(valid2,
                           (local2 << depth_bits) | depth_q[h_c][:, None],
                           IMAX).to(i32).reshape(-1)
        granted2 = torch.sum(torch.clamp(counts_h - k1, min=0))
        key = torch.cat([key1, key2])
        gauss = torch.cat([gauss1, h_c.to(i32)[:, None].expand(
            h_budget, kh).reshape(-1)])
        ns += h_budget * kh
        total = total + torch.sum(valid2, dtype=i32)
        dropped = torch.sum(counts_full - counts) + (
            torch.sum(torch.clamp(counts - k1, min=0)) - granted2)
    else:
        h_idx = torch.zeros((0,), dtype=i32, device=device)
        key, gauss = key1, gauss1
        dropped = torch.sum(counts_full - torch.clamp(counts, max=k1))

    slot = torch.arange(ns, dtype=i32, device=device)
    if ns < capacity:  # pad, so that the truncation keeps every slot
        pad = capacity - ns
        key = torch.cat([key, torch.full((pad,), IMAX, dtype=i32,
                                         device=device)])
        slot = torch.cat([slot, torch.full((pad,), ns, dtype=i32,
                                           device=device)])
        gauss = torch.cat([gauss, torch.full((pad,), -1, dtype=i32,
                                             device=device)])

    # One stable sort of the keys, which lie in slot order: ties keep it.
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_slot = slot[perm]
    sorted_key_c = sorted_key[:capacity]
    is_real = sorted_key_c != IMAX
    sorted_gauss = torch.where(is_real, gauss[perm[:capacity]], -1)
    sorted_tile = torch.clamp(sorted_key_c >> depth_bits,
                              max=num_local_tiles).to(i32)
    tile_starts = torch.searchsorted(
        sorted_tile, torch.arange(num_local_tiles + 1, dtype=i32,
                                  device=device), side="left", out_int32=True)
    return Binning(
        sorted_tile=sorted_tile, sorted_gauss=sorted_gauss,
        sorted_slot=sorted_slot, heavy_idx=h_idx, tile_starts=tile_starts,
        num_intersections=torch.clamp(total, max=capacity).to(i32),
        overflow_capacity=torch.clamp(total - capacity, min=0).to(i32),
        overflow_tile_cap=dropped.to(i32))


def sort_key(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (high, low) int32 pairs lexicographically as
    signed values: (tile, depth bits) for the (tile, depth) sort, whose
    depth bits order positive depths as the depths."""
    return (high.long() << 32) | (low.long() + 2**31)


def binning_from_plan(plan: TierPlan, num_tiles: int) -> Binning:
    """A multi-tier plan's slots as a `Binning` for the 'autograd' oracle:
    one stable sort by (tile, full depth), as the reference's oracle sorts
    the plan (`render/tiled.py:216-221`), the dead slots last. Its
    `sorted_slot` is empty (no consumer reads it on this path) and nothing
    is truncated."""
    perm = torch.sort(sort_key(plan.tile_key, plan.depth_key),
                      stable=True).indices
    tile = plan.tile_key[perm]
    dev = tile.device
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    return Binning(
        sorted_tile=tile, sorted_gauss=plan.gauss[perm], sorted_slot=empty,
        heavy_idx=empty,
        tile_starts=torch.searchsorted(
            tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
            side="left", out_int32=True),
        num_intersections=plan.total,
        overflow_capacity=torch.zeros((), dtype=torch.int32, device=dev),
        overflow_tile_cap=plan.overflow_tile_cap)


def route_bits(dest_rows: int, grid_w: int, n_dest: int) -> int:
    """Bits of the local tile id in a routed plan's key `dest << bits |
    local tile`; raises where n_dest destinations overflow int32 (the
    sentinel is n_dest << bits)."""
    bits = (dest_rows * grid_w + 1).bit_length()
    if (n_dest << bits) >= 1 << 31:
        raise ValueError(f"{n_dest} devices x {bits} tile bits overflow int32")
    return bits


def cull_bounds(prep: Preprocessed) -> tuple:
    """(lam_min, cull_thresh) per Gaussian for the tile-vs-ellipse cull:
    alpha at the tile's closest pixel, d from the mean, is bounded by
    opacity exp(-lam_min d^2 / 2) (lam_min the conic's smallest
    eigenvalue), which is under 0.98 ALPHA_MIN where lam_min d^2 >
    cull_thresh = 2 ln(opacity / (0.98 ALPHA_MIN))."""
    a, b, c = prep.conic.unbind(-1)
    lam_min = torch.clamp(
        0.5 * (a + c)
        - torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0)),
        min=0.0)
    cull_thresh = 2.0 * torch.log(
        torch.clamp(prep.opacity, min=1e-12) / (0.98 * cfg.ALPHA_MIN))
    return lam_min, cull_thresh


def tile_reachable(gx, gy, mx, my, lam_min, cull_thresh, tile_h: int,
                   tile_w: int) -> torch.Tensor:
    """Whether a splat at (mx, my) with `cull_bounds` (lam_min,
    cull_thresh) may reach ALPHA_MIN on global tile (gy, gx)."""
    px_lo = gx.to(torch.float32) * tile_w
    py_lo = gy.to(torch.float32) * tile_h
    dx = torch.clamp(torch.maximum(px_lo - mx, mx - (px_lo + (tile_w - 1))),
                     min=0.0)
    dy = torch.clamp(torch.maximum(py_lo - my, my - (py_lo + (tile_h - 1))),
                     min=0.0)
    return (dx * dx + dy * dy) * lam_min <= cull_thresh


def plan_tiers(prep: Preprocessed, grid_h: int, grid_w: int,
               render_cfg: cfg.RenderConfig, num_local_rows: int | None = None,
               row0: int = 0, row_stride: int = 1, dest_rows: int | None = None,
               n_dest: int = 1) -> TierPlan:
    """The slot grid of (tile, depth) keys for `render_cfg.tiers`.

    By default over the whole tile grid. Row-local mode (the tile-sharded
    path): only the owned rows {row0 + r * row_stride : r < num_local_rows}
    are enumerated, and tile ids are local (r * grid_w + x; the sentinel is
    num_local_rows * grid_w). Routed mode (the primitive-sharded path,
    `dest_rows`/`n_dest`): the whole grid, each key the route key
    `(gy // dest_rows) << route_bits | local tile on that device` of
    contiguous ownership, `dest_rows` rows a device; the sentinel is
    `n_dest << route_bits`.

    The reference floors k / rect_width through a float32 reciprocal, which
    is exact only while k_last * grid_w < 4e6; this port divides integers
    exactly and keeps the same bound, so both stay identical wherever the
    reference is defined."""
    tiers = render_cfg.tiers
    if not tiers:
        raise ValueError("plan_tiers requires render_cfg.tiers")
    if dest_rows is not None:
        if num_local_rows not in (None, grid_h) or row_stride != 1:
            raise ValueError("routed mode enumerates the whole grid")
        ltile_bits = route_bits(dest_rows, grid_w, n_dest)
    if tiers[-1][0] * grid_w >= 4_000_000:
        raise ValueError(
            f"k_last={tiers[-1][0]} x grid_w={grid_w} exceeds the bound the "
            "reference planner is exact under; use wider tiles")
    n = prep.depth.shape[0]
    device = prep.depth.device
    if num_local_rows is None:
        num_local_rows, row0 = grid_h, 0
    num_tiles = num_local_rows * grid_w
    sentinel = num_tiles if dest_rows is None else n_dest << ltile_bits
    k_last = tiers[-1][0]
    i32 = torch.int32

    rect = prep.rect
    rw = torch.clamp(rect.x_max - rect.x_min, min=0)
    rw_safe = torch.clamp(rw, min=1)
    # Owned tile rows only; rho0 is the first owned local row.
    y0, nrows = owned_row_range(rect.y_min, rect.y_max, row0, row_stride,
                                num_local_rows)
    rho0 = (y0 - row0) // row_stride
    counts_full = torch.where(prep.radius > 0, nrows * rw, 0).to(i32)
    counts = torch.clamp(counts_full, max=k_last)
    depth_q = projection.depth_order_key(prep.depth)

    # The tile-vs-ellipse cull's inputs (tiers >= 1).
    lam_min, cull_thresh = cull_bounds(prep)

    # One count-descending ranking; stable, so ties keep index order.
    order_l = torch.sort(-counts, stable=True).indices
    order = order_l.to(i32)
    r_xmin, r_rw, r_rho0, r_counts, r_depthq, r_mx, r_my, r_lam, r_thr = (
        x[order_l] for x in (rect.x_min, rw_safe, rho0, counts, depth_q,
                           prep.mean2d[..., 0], prep.mean2d[..., 1],
                           lam_min, cull_thresh))

    dims, s0 = tier_dims(n, tiers)
    tkeys, gausses = [], []
    rank = torch.arange(n, dtype=i32, device=device)
    granted_k = torch.where(rank < dims[0][1], tiers[0][0], 0).to(i32)
    k_lo = 0
    for j, ((w_j, b_j, _off), (k_j, _)) in enumerate(zip(dims, tiers)):
        # T-major (w_j, B_j): tile ordinal down, rank across.
        ks = k_lo + torch.arange(w_j, dtype=i32, device=device)[:, None]
        rw_j = r_rw[None, :b_j]
        ry = ks // rw_j
        rx = ks - ry * rw_j
        ly = r_rho0[None, :b_j] + ry  # local tile row
        gy = row0 + ly * row_stride   # global tile row
        gx = r_xmin[None, :b_j] + rx
        if dest_rows is None:
            local = ly * grid_w + gx
        else:
            dest = gy // dest_rows
            local = (dest << ltile_bits) | ((gy - dest * dest_rows) * grid_w
                                            + gx)
        valid = ks < r_counts[None, :b_j]
        if j > 0:
            valid &= tile_reachable(gx, gy, r_mx[None, :b_j],
                                    r_my[None, :b_j], r_lam[None, :b_j],
                                    r_thr[None, :b_j], render_cfg.tile_h,
                                    render_cfg.tile_w)
            granted_k = torch.where((rank < b_j) & (r_counts > k_lo),
                                    k_j, granted_k).to(i32)
        tkeys.append(torch.where(valid, local, sentinel)
                     .to(i32).reshape(-1))
        gausses.append(order[None, :b_j].expand(w_j, b_j).reshape(-1))
        k_lo = k_j

    tile_key = torch.cat(tkeys)
    depth_key = torch.cat([r_depthq[None, :b_j].expand(w_j, b_j).reshape(-1)
                           for (w_j, b_j, _off) in dims])
    gauss = torch.cat(gausses)
    # The reference pads the grid to a multiple of 128 slots; so does this
    # port, so that plans compare slot for slot.
    pad = -(-s0 // 128) * 128 - s0
    if pad:
        tile_key = torch.cat(
            [tile_key, torch.full((pad,), sentinel, dtype=i32, device=device)])
        depth_key = torch.cat(
            [depth_key, torch.zeros((pad,), dtype=i32, device=device)])
        gauss = torch.cat(
            [gauss, torch.full((pad,), -1, dtype=i32, device=device)])

    live = tile_key != sentinel
    total = torch.sum(live, dtype=i32)
    dropped = torch.sum(counts_full - counts) + torch.sum(
        torch.clamp(torch.clamp(r_counts, max=k_last) - granted_k, min=0))
    return TierPlan(tile_key=tile_key, depth_key=depth_key,
                    gauss=torch.where(live, gauss, -1), order=order,
                    total=total, overflow_tile_cap=dropped.to(i32))
