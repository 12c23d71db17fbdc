"""The tile-sorted forward render: preprocess -> tile plan -> (tile, depth)
sort and per-intersection features -> blend -> image assembly.

Counterpart of the reference's `render_tiled_pallas`
(`gsrast_tpu/render/pallas_pipeline.py`), both of its plans:
  * a non-empty `tiers`: the multi-tier plan, whose one stable sort of a
    64-bit (tile, depth) key yields the permutation by which the feature
    rows are gathered (`sort_pack`; the reference lets nine feature rows
    ride its sort as payloads because a gather is slow on the TPU);
  * `tiers=()`, the reference's default: the legacy two-tier binning
    (`ops.binning.build_binning`) and its sorted Gaussian ids, by which the
    feature rows are gathered (`pack_features`, the reference's
    `_gather_sorted`).
Both feed the same `BlendFunction`, so both run the blend kernels.

Differentiable end to end: the tile plan is integer structure built from
detached preprocess outputs (the reference's `stop_gradient(prep)`), the
blend is `BlendFunction`, and autograd turns the gather (`index_select`)
into an index-add of per-intersection gradients by Gaussian id
(`index_add_`, atomic adds on the card), which replaces the reference's
routing sorts (`pallas_pipeline.py:78-118, 218-244`). The gather is not
written `feat_nt[:, gauss]`: that differentiates into `index_put_` with
accumulation, whose CUDA kernel sorts the indices and sums each run of
equal ones serially, 38 ms of a 64 ms 1M/1080p fwd+bwd on an H100. Dead
slots gather Gaussian `slot mod N` (`sort_pack`, `render.tiled.
gather_sorted`), so that the index-add spreads their (exactly zero)
cotangents over distinct addresses instead of queueing atomics on one.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.binning import sort_key
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians
from .blend import BlendFunction
from .tiled import (RenderOutput, background_rgb, gather_sorted, untile,
                    untile_cf)


def feature_rows(prep: Preprocessed) -> torch.Tensor:
    """Per-Gaussian screen features as (9, N) rows, in the blend's row order:
    mx, my, conic A, B, C, opacity, r, g, b."""
    return torch.cat([prep.mean2d.T, prep.conic.T, prep.opacity[None],
                      prep.color.T], dim=0)


def sort_pack(feat_nt: torch.Tensor, plan: binning.TierPlan,
              num_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order the plan's slots by (tile, depth) and pack the blend's input.

    Returns feat (10, S) float32, rows 0:9 the features of each slot's
    Gaussian and row 9 its tile id, and tile_starts (T+1,) int32. Live slots
    come first, in exactly the order of the reference's stable two-key sort
    of (tile, depth); the dead slots after `tile_starts[-1]` are in no
    defined order and carry no defined features: slot s gathers Gaussian
    s mod N (module docstring; the blend backward writes nothing outside
    the tiles' segments)."""
    perm = torch.sort(sort_key(plan.tile_key, plan.depth_key),
                      stable=True).indices
    tile = plan.tile_key[perm]
    gauss = plan.gauss[perm].long()
    slot = torch.arange(gauss.shape[0], device=gauss.device)
    gauss = torch.where(gauss >= 0, gauss, slot % feat_nt.shape[1])
    feat = torch.cat([feat_nt.index_select(1, gauss), tile[None].float()],
                     dim=0)
    queries = torch.arange(num_tiles + 1, dtype=torch.int32,
                           device=tile.device)
    tile_starts = torch.searchsorted(tile, queries, side="left",
                                     out_int32=True)
    return feat, tile_starts


def pack_features(prep: Preprocessed,
                  binning_: binning.Binning) -> torch.Tensor:
    """The legacy binning's blend input, the reference's `pack_features`:
    the (9, N) feature rows gathered by `sorted_gauss` (`gather_sorted`:
    dead slots zero), and row 9 the sorted tile ids
    (`pack_sorted_features`). Returns (10, C)."""
    return pack_sorted_features(
        gather_sorted(feature_rows(prep), binning_.sorted_gauss, dim=1),
        binning_.sorted_tile)


def pack_sorted_features(feat_t: torch.Tensor,
                         sorted_tile: torch.Tensor) -> torch.Tensor:
    """(9, C) per-intersection feature rows already in (tile, depth) order
    and their (C,) local tile ids -> the blend's (10, C) input: row 9 the
    tile id as float (structure, no gradient). The counterpart of the
    reference's `pack_sorted_features` (`pallas_pipeline.py:267-280`)
    without its zero padding rows; the primitive-sharded path packs the
    features it receives through the exchange with it."""
    return torch.cat([feat_t, sorted_tile.detach().to(feat_t.dtype)[None]],
                     dim=0)


# The forward's stages as named profiler ranges, `render.<stage>` (what
# `diag/profile_step.py` splits a step's kernels by, the backward's through
# the autograd nodes made inside each range): the stages of
# `benchmark.stage_table`.
STAGES = ("prep", "binning", "pack", "blend")


def span(stage: str, layer: str = "render"):
    """The profiler range `<layer>.<stage>` while a profiler runs; else
    nothing, so that an unprofiled step pays no dispatcher calls."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"{layer}.{stage}")
    return contextlib.nullcontext()


def render_tiled(gaussians: ActivatedGaussians, camera: Camera,
                 render_cfg: cfg.RenderConfig,
                 mean2d_delta: torch.Tensor | None = None) -> RenderOutput:
    """The 'cuda' and 'torch' backends' render. Stats, on both plans:
    num_visible, num_intersections, overflow_capacity (the legacy
    capacity's drops; 0 under tiers), overflow_tile_cap, overflow_per_tile
    (0: the blend walks true ranges), radii."""
    tile_h, tile_w = render_cfg.tile_h, render_cfg.tile_w
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w

    with span("prep"):
        prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
    zero = torch.zeros((), dtype=torch.int32, device=prep.depth.device)
    if render_cfg.tiers:
        with span("binning"):
            plan = binning.plan_tiers(prep.detach(), grid_h, grid_w,
                                      render_cfg)
        with span("pack"):
            feat, tile_starts = sort_pack(feature_rows(prep), plan,
                                          num_tiles)
        bin_stats = {"num_intersections": plan.total,
                     "overflow_capacity": zero,
                     "overflow_tile_cap": plan.overflow_tile_cap}
    else:
        with span("binning"):
            bins = binning.build_binning(
                prep.detach(), grid_h, grid_w, render_cfg,
                render_cfg.capacity(gaussians.means.shape[0]))
        with span("pack"):
            feat, tile_starts = pack_features(prep, bins), bins.tile_starts
        bin_stats = {"num_intersections": bins.num_intersections,
                     "overflow_capacity": bins.overflow_capacity,
                     "overflow_tile_cap": bins.overflow_tile_cap}
    with span("blend"):
        rgb_tiles, ft_tiles, nc_tiles = BlendFunction.apply(
            feat, tile_starts, grid_h, grid_w, tile_h, tile_w,
            render_cfg.backend)

    background = background_rgb(render_cfg, feat.device)
    image_cf = untile_cf(rgb_tiles, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)  # (3, H, W)
    final_t = untile(ft_tiles, grid_h, grid_w, render_cfg, camera.height,
                     camera.width)
    n_contrib = untile(nc_tiles, grid_h, grid_w, render_cfg, camera.height,
                       camera.width)
    image_cf = image_cf + final_t[None] * background[:, None, None]
    stats = {"num_visible": torch.sum(prep.radius > 0),
             "overflow_per_tile": zero, "radii": prep.radius, **bin_stats}
    return RenderOutput(image=image_cf.permute(1, 2, 0), final_t=final_t,
                        n_contrib=n_contrib, stats=stats)
