"""Sharded rendering and training over the (data, tiles) mesh: the port of
`gsrast_tpu/parallel/sharded.py`, each rank one process of
`torch.distributed` where the reference runs one `shard_map` program.

  * Tile sharding: rank d of D owns tile ROWS, interleaved ({d, d+D, ...},
    for load balance) or contiguous. With tiers, each rank preprocesses
    1/D of the Gaussians; their screen state reaches the ranks whose rows
    their rects touch (`_relevance_exchange`, one all_to_all of the
    relevant set) or every rank (`_sharded_prep`, an all_gather); each
    rank plans, sorts and blends its own rows only (`plan_tiers`'
    row-local mode and the blend kernels' local tiles). With `tiers=()`
    (the legacy branches), every rank preprocesses all the Gaussians and
    bins its own rows (`build_binning`'s row-local mode). The image is the
    all_gather of the ranks' tiles.
  * Primitive sharding: each rank holds 1/D of the Gaussians, routes its
    (tile, depth, features) intersection records to the tile rows' owners
    with one all_to_all (`plan_tiers`' routed mode, or with `tiers=()` the
    exact expansion, `expand_intersections`), and restores the exact
    global blend order by a (tile, depth, Gaussian id) sort.
  * Data parallelism: a camera batch over the data axis, the loss averaged
    over it (`make_sharded_train_step`).

Every collective is differentiable with the reference's transposes, and the
mesh's boundaries follow `shard_map` (`parallel.comm`), so gradients equal
`jax.grad` of the reference's sharded functions. Each function returns on
every rank the whole image (and `stats` summed over the tile axis).

The backends: 'cuda' (the kernels, on local tiles) and 'torch' (their
plain versions), and 'autograd', the capped oracle (`render.tiled`), the
reference's 'xla', whose per-tile cap counts in overflow_per_tile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.binning import IMAX, sort_key
from ..ops.preprocess import Preprocessed, preprocess
from ..ops.projection import TileRect
from ..ops.projection import depth_order_key
from ..render.blend import BlendFunction
from ..render.pipeline import (feature_rows, pack_features,
                               pack_sorted_features, sort_pack)
from ..render.tiled import (RenderOutput, blend_sorted_xla, blend_tiles_xla,
                            untile, untile_cf)
from ..scene.gaussians import ActivatedGaussians
from . import comm
from .mesh import DATA_AXIS, TILE_AXIS, axis_size


def _rows_per_device(grid_h: int, n_dev: int) -> int:
    return -(-grid_h // n_dev)


def _tile_perm(grid_h: int, grid_w: int, n_dev: int, rpd: int,
               interleave: bool, device) -> Optional[torch.Tensor]:
    """Global tile t -> its row in the all-gathered (n_dev * rpd * grid_w)
    tile stack under row ownership (None = the identity)."""
    if n_dev == 1:
        return None
    t = torch.arange(grid_h * grid_w, device=device)
    y, x = t // grid_w, t % grid_w
    if interleave:
        dev, rho = y % n_dev, y // n_dev
    else:
        dev, rho = y // rpd, y % rpd
    return dev * (rpd * grid_w) + rho * grid_w + x


def exchange_budget(tiers, n_pad: int, n_dev: int, interleave: bool,
                    send_capacity: Optional[int] = None) -> tuple:
    """(c_send, per-device tiers) of the relevance exchange: the one place
    its budgets are computed (the reference repeats them at
    `sharded.py:158-161, 333-344, 757-763`).

    c_send is the per-(source, destination) row budget: by default
    min(nl, ceil(6 nl / D)) for nl = n_pad / D (rows ~ nl E[min(rows, D)]
    / D, E[..] typically 1-3, with 2x skew headroom, capped at nl), rounded
    up to 128, at least 128. The tiers are `shard_tiers`' (scaled ~1/D
    only under interleaved rows), their budget fractions rescaled from the
    full population to the plan's c_recv = D c_send received rows so the
    absolute budgets stay (clipped at 1). One rank exchanges nothing:
    (None, `shard_tiers(tiers, 1)`)."""
    if n_dev == 1:
        return None, binning.shard_tiers(tiers, 1)
    tiers_d = binning.shard_tiers(tiers, n_dev if interleave else 1)
    nl = n_pad // n_dev
    if send_capacity is None:
        send_capacity = min(nl, -(-6 * nl // n_dev))
    c_send = max(128, -(-send_capacity // 128) * 128)
    c_recv = n_dev * c_send
    return c_send, tuple((k, min(1.0, f * n_pad / c_recv))
                         for k, f in tiers_d)


SHARDED_BACKENDS = ("cuda", "torch", "autograd")


def _blend_backend(backend: str) -> str:
    if backend not in SHARDED_BACKENDS:
        raise ValueError(f"the sharded paths blend with {SHARDED_BACKENDS}, "
                         f"got {backend!r}")
    return backend


def pad_gaussians(g: ActivatedGaussians, n_dev: int) -> ActivatedGaussians:
    """Pad N to a multiple of n_dev with inert Gaussians: zero rows, so
    opacity 0 and mask False."""
    n = g.means.shape[0]
    pad = -(-n // n_dev) * n_dev - n
    if pad == 0:
        return g
    return ActivatedGaussians(**{
        f.name: torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        for f in dataclasses.fields(g)
        for x in (getattr(g, f.name),)})


def _shard(g: ActivatedGaussians, mesh) -> ActivatedGaussians:
    """This rank's tile-axis shard of Gaussians every rank holds whole
    (N divisible by D), its gradient summed over the mesh."""
    return ActivatedGaussians(**{
        f.name: comm.shard_replicated(getattr(g, f.name), mesh)
        for f in dataclasses.fields(g)})


def _replicated(g: ActivatedGaussians, mesh) -> ActivatedGaussians:
    """Gaussians every rank holds and uses whole (the legacy branches),
    their gradient summed over the mesh."""
    return ActivatedGaussians(**{
        f.name: comm.replicated_input(getattr(g, f.name), mesh)
        for f in dataclasses.fields(g)})


def _prep_from_columns(rec: torch.Tensor, ints: torch.Tensor
                       ) -> Preprocessed:
    """Preprocessed from (rows, 10) float records and (rows, 5) int32
    structure; a row with radius 0 is inert (depth 1)."""
    radius = ints[:, 4]
    return Preprocessed(
        mean2d=rec[:, 0:2], conic=rec[:, 2:5], opacity=rec[:, 5],
        color=rec[:, 6:9],
        depth=torch.where(radius > 0, rec[:, 9].detach(), 1.0),
        radius=radius,
        rect=TileRect(x_min=ints[:, 0], y_min=ints[:, 2], x_max=ints[:, 1],
                      y_max=ints[:, 3]))


def _columns(prep: Preprocessed) -> tuple:
    """(rows, 10) float records (depth as structure, no gradient) and
    (rows, 5) int32 structure of a Preprocessed."""
    rect = prep.rect
    rec = torch.cat([prep.mean2d, prep.conic, prep.opacity[:, None],
                     prep.color, prep.depth.detach()[:, None]], dim=1)
    ints = torch.stack([rect.x_min, rect.x_max, rect.y_min, rect.y_max,
                        prep.radius], dim=1).to(torch.int32)
    return rec, ints


def _sharded_prep(g_local: ActivatedGaussians, camera: Camera,
                  render_cfg: cfg.RenderConfig, mesh) -> Preprocessed:
    """Preprocess this rank's 1/D of the Gaussians, then all_gather the
    per-Gaussian screen state over the tile axis: every rank gets all N
    rows. The gather's transpose reduce-scatters the cotangents."""
    rec, ints = _columns(preprocess(g_local, camera, render_cfg))
    return _prep_from_columns(comm.all_gather(rec, mesh, TILE_AXIS),
                              comm.all_gather(ints, mesh, TILE_AXIS))


def _relevance_exchange(g_local: ActivatedGaussians, camera: Camera,
                        render_cfg: cfg.RenderConfig, mesh, rpd: int,
                        interleave: bool, c_send: int) -> tuple:
    """Preprocess this rank's 1/D of the Gaussians and route each visible
    one to only the ranks whose owned tile rows its rect touches: one
    all_to_all of fixed (D, c_send) buffers, filled by a stable sort of the
    (Gaussian, destination) pairs by destination. Returns (the received
    Preprocessed, D c_send rows, and the send-budget overflow: pairs that
    found no room, counted, never silent)."""
    n_dev = axis_size(mesh, TILE_AXIS)
    dev = g_local.means.device
    nl = g_local.means.shape[0]
    prep = preprocess(g_local, camera, render_cfg)
    rect = prep.rect
    y_min, y_max = rect.y_min.long(), rect.y_max.long()
    nrows = torch.clamp(y_max - y_min, min=0)
    live = prep.radius > 0

    # Destination enumeration: (nl, D), the j-th destination of Gaussian g.
    j = torch.arange(n_dev, device=dev)[None, :]
    if interleave:
        # Rows of rank d' are {d' + r D}: a rect of `nrows` consecutive rows
        # touches the residues (y_min + j) % D, j < nrows.
        ndest = torch.clamp(nrows, max=n_dev)[:, None]
        dest = (y_min[:, None] + j) % n_dev
    else:
        d_lo = y_min // rpd
        d_hi = torch.maximum((y_max - 1) // rpd, d_lo)
        ndest = torch.where(nrows > 0, d_hi - d_lo + 1, 0)[:, None]
        dest = torch.clamp(d_lo[:, None] + j, max=n_dev - 1)
    valid = (j < ndest) & live[:, None]
    route = torch.where(valid, dest, n_dev).reshape(-1)
    gidx = torch.arange(nl, device=dev)[:, None].expand(nl, n_dev).reshape(-1)
    sroute, by_dest = torch.sort(route, stable=True)
    src = gidx[by_dest]
    dest_starts = torch.searchsorted(
        sroute, torch.arange(n_dev + 1, device=dev), side="left")
    ovf_send = torch.clamp(dest_starts[1:] - dest_starts[:-1] - c_send,
                           min=0).sum()

    idx = dest_starts[:-1, None] + torch.arange(c_send, device=dev)[None, :]
    ok = idx < dest_starts[1:, None]  # (D, c_send)
    src_g = torch.where(ok, src[torch.clamp(idx, max=src.shape[0] - 1)], 0)
    rec, ints = _columns(prep)
    send_rec = rec.index_select(0, src_g.reshape(-1)) * ok.reshape(
        -1, 1).to(rec.dtype)
    send_ints = torch.where(ok.reshape(-1, 1),
                            ints.index_select(0, src_g.reshape(-1)), 0)
    prep_r = _prep_from_columns(comm.all_to_all(send_rec, mesh, TILE_AXIS),
                                comm.all_to_all(send_ints, mesh, TILE_AXIS))
    return prep_r, ovf_send


def _tile_inputs(gaussians: ActivatedGaussians, render_cfg: cfg.RenderConfig,
                 mesh, interleave: bool, prep_exchange: bool = True,
                 send_capacity: Optional[int] = None) -> tuple:
    """The tier path's set-up for one scene on this rank: (its shard of the
    Gaussians padded to a multiple of D, the exchange's c_send, the config
    with the row-local tiers). c_send is None where nothing is exchanged:
    on one rank, or without `prep_exchange` (then the tiers are
    `shard_tiers`' unscaled budgets, as the plan sees every Gaussian)."""
    n_dev = axis_size(mesh, TILE_AXIS)
    gaussians = pad_gaussians(gaussians, n_dev)
    if prep_exchange:
        c_send, tiers_d = exchange_budget(
            render_cfg.tiers, gaussians.means.shape[0], n_dev, interleave,
            send_capacity)
    else:
        c_send, tiers_d = None, binning.shard_tiers(
            render_cfg.tiers, n_dev if interleave else 1)
    return _shard(gaussians, mesh), c_send, render_cfg.replace(tiers=tiers_d)


def _tile_prep(g_local: ActivatedGaussians, camera: Camera,
               render_cfg: cfg.RenderConfig, mesh, rpd: int, interleave: bool,
               c_send: Optional[int]) -> tuple:
    """(the Preprocessed rows this rank's plan takes, the exchange's send
    overflow): the relevance exchange where c_send is set, else the
    all_gather of every rank's shard (`_tile_inputs`)."""
    if c_send is None:
        return _sharded_prep(g_local, camera, render_cfg, mesh), 0
    return _relevance_exchange(g_local, camera, render_cfg, mesh, rpd,
                               interleave, c_send)


def _blend_local(prep: Preprocessed, bins: binning.Binning, grid_h: int,
                 grid_w: int, render_cfg: cfg.RenderConfig, rpd: int,
                 row0: int, row_stride: int, backend: str) -> tuple:
    """Blend this rank's tiles (rows {row0 + r row_stride : r < rpd}) of a
    `Binning`: 'cuda'/'torch' through `pack_features` and the blend on the
    local tiles, 'autograd' through the oracle on the local rows. Returns
    (rgb (T, 3, P) over the background, final_t (T, P), n_contrib (T, P),
    overflow_per_tile: the oracle's cap's drops, else 0)."""
    if backend == "autograd":
        rgb, ft, nc, ovf = blend_tiles_xla(
            prep, bins, grid_h, grid_w, render_cfg, num_local_rows=rpd,
            row0=row0, row_stride=row_stride)
        return rgb.transpose(1, 2), ft, nc, ovf
    rgb, ft, nc = BlendFunction.apply(
        pack_features(prep, bins), bins.tile_starts, grid_h, grid_w,
        render_cfg.tile_h, render_cfg.tile_w, backend, rpd * grid_w,
        (row0, row_stride))
    return _over_background(rgb, ft, render_cfg), ft, nc, 0


def _local_tiles(prep: Preprocessed, render_cfg: cfg.RenderConfig,
                 cfg_d: cfg.RenderConfig, grid_h: int, grid_w: int, rpd: int,
                 row0: int, row_stride: int, backend: str) -> tuple:
    """This rank's tiles (rows {row0 + r row_stride : r < rpd}) through the
    fused path with the device-scaled tiers of cfg_d: the row-local plan,
    the sort-pack at the local tile count, the blend on the local tiles and
    the background (the oracle: the plan's (tile, depth) order and
    `_blend_local`). Returns (rgb (T, 3, P), final_t (T, P), n_contrib
    (T, P), overflow_per_tile, the plan)."""
    tpd = rpd * grid_w
    plan = binning.plan_tiers(prep.detach(), grid_h, grid_w, cfg_d,
                              num_local_rows=rpd, row0=row0,
                              row_stride=row_stride)
    if backend == "autograd":
        return (*_blend_local(prep, binning.binning_from_plan(plan, tpd),
                              grid_h, grid_w, render_cfg, rpd, row0,
                              row_stride, backend), plan)
    feat, tile_starts = sort_pack(feature_rows(prep), plan, tpd)
    rgb, ft, nc = BlendFunction.apply(
        feat, tile_starts, grid_h, grid_w, render_cfg.tile_h,
        render_cfg.tile_w, backend, tpd, (row0, row_stride))
    return _over_background(rgb, ft, render_cfg), ft, nc, 0, plan


def _legacy_local_binning(act: ActivatedGaussians, camera: Camera,
                          render_cfg: cfg.RenderConfig, grid_h: int,
                          grid_w: int, rpd: int, row0: int, row_stride: int,
                          capacity: int) -> tuple:
    """The legacy branches' local work: preprocess all the Gaussians and
    bin this rank's rows. Returns (prep, the Binning)."""
    prep = preprocess(act, camera, render_cfg)
    return prep, binning.build_binning(
        prep.detach(), grid_h, grid_w, render_cfg, capacity,
        num_local_rows=rpd, row0=row0, row_stride=row_stride)


def _over_background(rgb, ft, render_cfg: cfg.RenderConfig):
    """Tile rgb (T, 3, P) over the background, by the residual
    transmittance ft (T, P)."""
    background = torch.tensor(render_cfg.background, dtype=torch.float32,
                              device=rgb.device)
    return rgb + ft[:, None, :] * background[None, :, None]


def _assemble(rgb, ft, nc, mesh, grid_h: int, grid_w: int, rpd: int,
              interleave: bool, render_cfg: cfg.RenderConfig, height: int,
              width: int) -> tuple:
    """The whole image from every rank's tiles: one all_gather over the
    tile axis of (rgb, final_t, n_contrib as float, exact below 2^24
    positions), the rows reordered to
    the global tile order, untiled. Returns (image (H, W, 3), final_t,
    n_contrib), which every rank holds: `comm.replicated_output`, so a loss
    of them that every rank computes gets its gradient once, not once per
    rank."""
    n_dev = axis_size(mesh, TILE_AXIS)
    tiles = torch.cat([rgb, ft[:, None], nc.to(rgb.dtype)[:, None]], dim=1)
    tiles = comm.replicated_output(comm.all_gather(tiles, mesh, TILE_AXIS),
                                   mesh)
    perm = _tile_perm(grid_h, grid_w, n_dev, rpd, interleave, rgb.device)
    tiles = (tiles[:grid_h * grid_w] if perm is None
             else tiles.index_select(0, perm))
    image = untile_cf(tiles[:, 0:3], grid_h, grid_w, render_cfg, height,
                      width).permute(1, 2, 0)
    final_t = untile(tiles[:, 3], grid_h, grid_w, render_cfg, height, width)
    n_contrib = untile(tiles[:, 4].detach().to(torch.int32), grid_h, grid_w,
                       render_cfg, height, width)
    return image, final_t, n_contrib


def _stats(values, names, mesh) -> dict:
    """Per-rank counts summed over the tile axis, as 0-d int64 tensors."""
    local = torch.stack([torch.as_tensor(v).to(torch.int64).reshape(())
                         .to(values[0].device) for v in values])
    total = comm.all_reduce_sum(local, mesh, TILE_AXIS)
    return {k: total[i] for i, k in enumerate(names)}


def render_tile_sharded(gaussians: ActivatedGaussians, camera: Camera,
                        render_cfg: cfg.RenderConfig, mesh,
                        interleave: bool = True,
                        backend: Optional[str] = None,
                        prep_exchange: bool = True,
                        prep_send_capacity: Optional[int] = None
                        ) -> RenderOutput:
    """Tile-sharded render, differentiable; every rank passes the same
    `gaussians` and gets the whole image.

    `interleave=True` assigns tile ROWS round-robin (rank d of D owns
    {d, d+D, ...}); screen-space locality would pile the heavy rows on few
    ranks under contiguous blocks. `backend` ('cuda' or 'torch') overrides
    render_cfg.backend. `prep_exchange`: route each Gaussian's screen state
    only to the ranks whose rows its rect touches (`_relevance_exchange`)
    instead of all_gathering all of it (`_sharded_prep`);
    `prep_send_capacity` overrides the exchange's per-(source,
    destination) budget (`exchange_budget`). Stats, summed over the ranks:
    num_intersections, overflow_capacity (the exchange's send overflow),
    overflow_tile_cap, overflow_per_tile (the oracle's cap; 0 on the
    blends, which walk true ranges).

    With `tiers=()`, the legacy branch: every rank preprocesses all the
    Gaussians and bins its rows (`build_binning`, capacity
    `render_cfg.capacity(N // max(D // 2, 1))`, the reference's); the
    exchange options do not apply, and overflow_capacity counts the
    binning's capacity drops."""
    backend = _blend_backend(backend or render_cfg.backend)
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    n_dev, d = axis_size(mesh, TILE_AXIS), mesh.get_local_rank(TILE_AXIS)
    rpd = _rows_per_device(grid_h, n_dev)
    row_stride = n_dev if interleave else 1
    row0 = d if interleave else d * rpd
    size = (mesh, grid_h, grid_w, rpd, interleave, render_cfg, camera.height,
            camera.width)
    names = ("num_intersections", "overflow_capacity", "overflow_tile_cap",
             "overflow_per_tile")
    if not render_cfg.tiers:
        capacity = render_cfg.capacity(
            gaussians.means.shape[0] // max(n_dev // 2, 1))
        prep, bins = _legacy_local_binning(
            _replicated(gaussians, mesh), camera, render_cfg, grid_h, grid_w,
            rpd, row0, row_stride, capacity)
        rgb, ft, nc, ovf = _blend_local(prep, bins, grid_h, grid_w,
                                        render_cfg, rpd, row0, row_stride,
                                        backend)
        image, final_t, n_contrib = _assemble(rgb, ft, nc, *size)
        stats = _stats([bins.num_intersections, bins.overflow_capacity,
                        bins.overflow_tile_cap, ovf], names, mesh)
        return RenderOutput(image=image, final_t=final_t,
                            n_contrib=n_contrib, stats=stats)
    g_local, c_send, cfg_d = _tile_inputs(gaussians, render_cfg, mesh,
                                          interleave, prep_exchange,
                                          prep_send_capacity)
    prep, ovf_x = _tile_prep(g_local, camera, render_cfg, mesh, rpd,
                             interleave, c_send)
    rgb, ft, nc, ovf, plan = _local_tiles(prep, render_cfg, cfg_d, grid_h,
                                          grid_w, rpd, row0, row_stride,
                                          backend)
    image, final_t, n_contrib = _assemble(rgb, ft, nc, *size)
    stats = _stats([plan.total, ovf_x, plan.overflow_tile_cap, ovf], names,
                   mesh)
    return RenderOutput(image=image, final_t=final_t, n_contrib=n_contrib,
                        stats=stats)


class _PermuteRows(torch.autograd.Function):
    """x[perm] whose backward gathers the cotangent through the inverse
    permutation (a bijection on range(len(x))) instead of scattering."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g.index_select(0, inv_perm), None, None


def _permute_rows(x, perm, inv_perm):
    return _PermuteRows.apply(x, perm, inv_perm)


def default_send_capacity(n_total: int, n_dev: int,
                          render_cfg: cfg.RenderConfig) -> int:
    """The primitive-sharded send buffer's default rows per (source,
    destination): the expected volume int(N * intersect_capacity_factor) /
    D^2, 4x skew headroom, rounded up to 128, at least 256 (the
    reference's expression, so overflow counts match)."""
    return max(256, -(-int(n_total * render_cfg.intersect_capacity_factor)
                      // (n_dev * n_dev) * 4 // 128) * 128)


def _expanded_routes(prep: Preprocessed, grid_w: int, rpd: int,
                     ltile_bits: int, capacity: int) -> tuple:
    """The legacy primitive-sharded path's slots, the reference's: the
    exact expansion (`expand_intersections`) of each visible Gaussian's
    whole rect, `capacity` slots, slot (i, k) on the k-th tile of the rect
    row-major, keyed by the route `dest << ltile_bits | local tile` of
    contiguous ownership (rpd rows a rank) and the full depth bits; dead
    slots route IMAX. Returns (route, depth key, Gaussian (-1 dead), total,
    the intersections past the capacity)."""
    rect = prep.rect
    rw = torch.clamp(rect.x_max - rect.x_min, min=0)
    touched = torch.where(prep.radius > 0, rw * torch.clamp(
        rect.y_max - rect.y_min, min=0), 0)
    gi, k, _, total = binning.expand_intersections(touched, capacity)
    valid = torch.arange(capacity, device=gi.device) < total
    gil = gi.long()
    rw_g = torch.clamp(rw, min=1)[gil]
    ry = k // rw_g
    y = rect.y_min[gil] + ry
    x = rect.x_min[gil] + (k - ry * rw_g)
    dest = y // rpd
    route = torch.where(
        valid, (dest << ltile_bits) | ((y - dest * rpd) * grid_w + x), IMAX)
    dkey = torch.where(valid, depth_order_key(prep.depth)[gil], 0)
    return (route.to(torch.int32), dkey, torch.where(valid, gi, -1), total,
            torch.clamp(total - capacity, min=0))


def render_primitive_sharded(gaussians: ActivatedGaussians, camera: Camera,
                             render_cfg: cfg.RenderConfig, mesh,
                             backend: Optional[str] = None,
                             send_capacity: Optional[int] = None
                             ) -> RenderOutput:
    """Primitive-sharded render, differentiable: `gaussians` is this rank's
    shard, rows [d nl, (d+1) nl) of a scene padded to a multiple of D
    (`pad_gaussians`), every shard nl rows; every rank gets the whole
    image, and each shard's gradient stays on its rank.

    Per rank d of D (contiguous tile-row ownership, rpd rows each):
      1. preprocess the shard;
      2. the routed tier plan, or with `tiers=()` the exact expansion of
         every rect (`_expanded_routes`, `render_cfg.capacity(nl)` slots):
         each slot keyed by (destination | local tile, depth);
      3. one stable sort groups the slots by destination; fixed (D, c_send)
         send buffers take them by gather (overflow counted, never silent);
      4. one all_to_all exchanges keys, depths, global ids and the 9
         feature rows, so no rank holds the whole Gaussian set;
      5. a stable (tile, depth, global id) sort restores the exact global
         blend order; the rank blends its rows.
    `send_capacity` defaults to `default_send_capacity`, rounded up to 128.
    Stats, summed over the ranks: num_intersections (min(total, D c_send)
    a rank), overflow_send, overflow_capacity (tiles past the plan's
    k_last or a budget, or past the expansion's capacity),
    overflow_per_tile (the oracle's cap; 0 on the blends)."""
    backend = _blend_backend(backend or render_cfg.backend)
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    n_dev, d = axis_size(mesh, TILE_AXIS), mesh.get_local_rank(TILE_AXIS)
    rpd = _rows_per_device(grid_h, n_dev)  # contiguous row ownership
    tpd = rpd * grid_w
    nl = gaussians.means.shape[0]
    n_total = nl * n_dev
    if send_capacity is None:
        send_capacity = default_send_capacity(n_total, n_dev, render_cfg)
    c_send = -(-send_capacity // 128) * 128
    c_recv = n_dev * c_send
    dev = gaussians.means.device
    ltile_bits = binning.route_bits(rpd, grid_w, n_dev)

    prep = preprocess(gaussians, camera, render_cfg)
    if render_cfg.tiers:
        plan = binning.plan_tiers(prep.detach(), grid_h, grid_w, render_cfg,
                                  dest_rows=rpd, n_dest=n_dev)
        route, dkey, gauss, total, ovf_expand = (
            plan.tile_key, plan.depth_key, plan.gauss, plan.total,
            plan.overflow_tile_cap)
    else:
        route, dkey, gauss, total, ovf_expand = _expanded_routes(
            prep.detach(), grid_w, rpd, ltile_bits,
            render_cfg.capacity(nl))
    by_route = torch.sort(sort_key(route, dkey), stable=True).indices
    sroute = route[by_route].long()
    sdkey = dkey[by_route]
    sgauss = gauss[by_route].long()
    sdest = torch.clamp(sroute >> ltile_bits, max=n_dev)
    dest_starts = torch.searchsorted(
        sdest, torch.arange(n_dev + 1, device=dev), side="left")
    ovf_send = torch.clamp(dest_starts[1:] - dest_starts[:-1] - c_send,
                           min=0).sum()

    idx = dest_starts[:-1, None] + torch.arange(c_send, device=dev)[None, :]
    ok = idx < dest_starts[1:, None]
    idx_c = torch.clamp(idx, max=sroute.shape[0] - 1)
    src_gauss = sgauss[idx_c]  # (D, Cs) local Gaussian; -1 dead
    ok = ok & (src_gauss >= 0)
    src_gauss = torch.clamp(src_gauss, min=0)
    send_key = torch.where(ok, sroute[idx_c] & ((1 << ltile_bits) - 1), IMAX)
    send_depth = torch.where(ok, sdkey[idx_c], 0)
    send_gid = torch.where(ok, d * nl + src_gauss, -1)
    feat_n = feature_rows(prep).T  # (nl, 9), differentiable
    send_feat = feat_n.index_select(0, src_gauss.reshape(-1)) * ok.reshape(
        -1, 1).to(feat_n.dtype)

    recv_key, recv_depth, recv_gid = (
        comm.all_to_all(x.reshape(-1).to(torch.int32), mesh, TILE_AXIS)
        for x in (send_key, send_depth, send_gid))
    recv_feat = comm.all_to_all(send_feat, mesh, TILE_AXIS)  # (c_recv, 9)

    # The global blend order: (tile, full depth, global id), then position.
    by_gid = torch.sort(recv_gid, stable=True).indices
    perm = by_gid[torch.sort(sort_key(recv_key, recv_depth)[by_gid],
                             stable=True).indices]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(c_recv, device=dev)
    sorted_ltile = torch.clamp(recv_key[perm], max=tpd)
    tile_starts = torch.searchsorted(
        sorted_ltile, torch.arange(tpd + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True)
    s_feat = _permute_rows(recv_feat, perm, inv_perm)
    live = (sorted_ltile < tpd).to(s_feat.dtype)
    if backend == "autograd":
        rgb, ft, nc, ovf_tile = blend_sorted_xla(
            s_feat[:, 0:2], s_feat[:, 2:5], s_feat[:, 6:9],
            s_feat[:, 5] * live, tile_starts, grid_h, grid_w, render_cfg,
            num_local_rows=rpd, row0=d * rpd)
        rgb = rgb.transpose(1, 2)
    else:
        feat = pack_sorted_features((s_feat * live[:, None]).T, sorted_ltile)
        rgb, ft, nc = BlendFunction.apply(
            feat, tile_starts, grid_h, grid_w, render_cfg.tile_h,
            render_cfg.tile_w, backend, tpd, (d * rpd, 1))
        rgb, ovf_tile = _over_background(rgb, ft, render_cfg), 0
    image, final_t, n_contrib = _assemble(
        rgb, ft, nc, mesh, grid_h, grid_w, rpd, False, render_cfg,
        camera.height, camera.width)
    stats = _stats([torch.clamp(total, max=c_recv), ovf_send, ovf_expand,
                    ovf_tile],
                   ("num_intersections", "overflow_send",
                    "overflow_capacity", "overflow_per_tile"), mesh)
    return RenderOutput(image=image, final_t=final_t, n_contrib=n_contrib,
                        stats=stats)


def make_sharded_train_step(render_cfg: cfg.RenderConfig, mesh, height: int,
                            width: int, cameras_per_device: int = 1,
                            ssim_weight: float = 0.2, optimizer=None,
                            interleave: bool = True,
                            backend: Optional[str] = None):
    """The data x tile parallel training step.

      * the camera batch, B = n_data * cameras_per_device, is split over
        the data axis: data rank a renders cameras [a c, (a + 1) c);
      * each camera renders the rank's tile rows (interleaved over the
        tile axis, the relevance exchange where the axis has more than one
        rank), an all_gather over the tile axis assembles the whole image
        for the L1 + D-SSIM loss (SSIM crosses tile borders), and its
        transpose reduce-scatters the pixel cotangents;
      * the loss is the mean over the rank's cameras, then `pmean` over
        the data axis; every rank holds it, and the image assembly divides
        the cotangents as `shard_map` does for a replicated output;
      * the parameters are replicated: their gradient is summed over the
        mesh explicitly (`comm.shard_replicated`'s backward), which
        `shard_map` does implicitly, so every rank holds the gradient of
        the reference's step;
      * with `tiers=()`, the legacy branch: every rank preprocesses all the
        Gaussians and bins its rows (`build_binning`, capacity
        `render_cfg.capacity(max(N // max(D // 2, 1), 1024))`, the
        reference's), the gradient summed by `comm.replicated_input`.

    Returns train_step(scene, cameras, targets) -> (loss, grads): `scene` a
    `GaussianScene` (the same on every rank), `cameras` a batched `Camera`
    of B (`scene.dataset.batch_cameras`), `targets` (B, H, W, 3); grads by
    parameter field. With an `optimizer` over the scene's parameters (the
    port's Adam, `train.trainer.make_optimizer`), it then takes one step.
    """
    from ..scene.dataset import camera_at
    from ..train.loss import rgb_loss

    backend = _blend_backend(backend or render_cfg.backend)
    n_tile = axis_size(mesh, TILE_AXIS)
    grid_h, grid_w = render_cfg.grid_shape(height, width)
    rpd = _rows_per_device(grid_h, n_tile)
    row_stride = n_tile if interleave else 1
    d_tile = mesh.get_local_rank(TILE_AXIS)
    row0 = d_tile if interleave else d_tile * rpd
    first = mesh.get_local_rank(DATA_AXIS) * cameras_per_device

    def tier_tiles(scene):
        """The tier path: this rank's shard of the Gaussians through the
        exchange and the row-local plan. Returns camera -> this rank's
        (rgb, final_t, n_contrib)."""
        g_local, c_send, cfg_d = _tile_inputs(scene.activated(), render_cfg,
                                              mesh, interleave)

        def tiles(cam):
            prep, _ = _tile_prep(g_local, cam, render_cfg, mesh, rpd,
                                 interleave, c_send)
            return _local_tiles(prep, render_cfg, cfg_d, grid_h, grid_w, rpd,
                                row0, row_stride, backend)[:3]
        return tiles

    def legacy_tiles(scene):
        """The legacy branch: all the Gaussians on every rank, its rows
        binned. Returns camera -> (rgb, final_t, n_contrib)."""
        act = _replicated(scene.activated(), mesh)
        capacity = render_cfg.capacity(
            max(act.means.shape[0] // max(n_tile // 2, 1), 1024))

        def tiles(cam):
            prep, bins = _legacy_local_binning(act, cam, render_cfg, grid_h,
                                               grid_w, rpd, row0, row_stride,
                                               capacity)
            return _blend_local(prep, bins, grid_h, grid_w, render_cfg, rpd,
                                row0, row_stride, backend)[:3]
        return tiles

    def train_step(scene, cameras: Camera, targets: torch.Tensor):
        params = scene.param_groups()
        for p in params.values():
            p.grad = None
        tiles = (tier_tiles if render_cfg.tiers else legacy_tiles)(scene)
        losses = []
        for i in range(first, first + cameras_per_device):
            image, _, _ = _assemble(*tiles(camera_at(cameras, i)), mesh,
                                    grid_h, grid_w, rpd, interleave,
                                    render_cfg, height, width)
            losses.append(rgb_loss(image, targets[i], ssim_weight))
        loss = comm.pmean(torch.stack(losses).mean(), mesh, DATA_AXIS)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        if optimizer is not None:
            optimizer.step()
        return loss.detach(), grads

    return train_step
