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

import dataclasses
from typing import Tuple

import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.binning import sort_key
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians
from ..utils import profiling
from ..utils.profiling import span
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


# The forward's stages, each the span `render.<stage>`
# (`utils/profiling.py`; `diag/profile_step.py` splits a step's kernels by
# their host ranges, the backward's through the autograd nodes made inside
# each range): the stages of `benchmark.stage_table`. The render's last
# span, `render.untile`, assembles the image.
STAGES = ("prep", "binning", "pack", "blend")
# The preprocess outputs the pack reads (`feature_rows`).
FEATURE_FIELDS = ("mean2d", "conic", "opacity", "color")


def render_tiled(gaussians: ActivatedGaussians, camera: Camera,
                 render_cfg: cfg.RenderConfig,
                 mean2d_delta: torch.Tensor | None = None) -> RenderOutput:
    """The 'cuda' and 'torch' backends' render. Stats, on both plans:
    num_visible, num_intersections, overflow_capacity (the legacy
    capacity's drops; 0 under tiers), overflow_tile_cap, overflow_per_tile
    (0: the blend walks true ranges), radii.

    Its stages are the spans `render.prep`, `render.binning` (which counts
    the plan, `profiling.count_plan`), `render.pack`, `render.blend` and
    `render.untile`; with tracing on, each differentiable stage's backward
    is the span `<stage>.bwd` between nodes at its inputs and outputs
    (`profiling.backward_end` / `backward_start`)."""
    tile_h, tile_w = render_cfg.tile_h, render_cfg.tile_w
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w
    dev = gaussians.means.device

    if profiling.tracing():
        gaussians, mean2d_delta = _bound_inputs(gaussians, mean2d_delta)
    with span("prep", device=dev):
        prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
        num_visible = torch.sum(prep.radius > 0)
    prep = _bound_features(prep, profiling.backward_start, "render.prep")
    prep = _bound_features(prep, profiling.backward_end, "render.pack")
    if render_cfg.tiers:
        with span("binning", device=dev):
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            plan = binning.plan_tiers(prep.detach(), grid_h, grid_w,
                                      render_cfg)
            profiling.count_plan(plan.total, plan.gauss.shape[0],
                                 plan.overflow_tile_cap)
        with span("pack", device=dev):
            feat, tile_starts = sort_pack(feature_rows(prep), plan,
                                          num_tiles)
        bin_stats = {"num_intersections": plan.total,
                     "overflow_capacity": zero,
                     "overflow_tile_cap": plan.overflow_tile_cap}
    else:
        with span("binning", device=dev):
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            capacity = render_cfg.capacity(gaussians.means.shape[0])
            bins = binning.build_binning(prep.detach(), grid_h, grid_w,
                                         render_cfg, capacity)
            profiling.count_plan(bins.num_intersections, capacity,
                                 bins.overflow_tile_cap,
                                 bins.overflow_capacity)
        with span("pack", device=dev):
            feat, tile_starts = pack_features(prep, bins), bins.tile_starts
        bin_stats = {"num_intersections": bins.num_intersections,
                     "overflow_capacity": bins.overflow_capacity,
                     "overflow_tile_cap": bins.overflow_tile_cap}
    feat = profiling.backward_start("render.pack", feat)
    feat = profiling.backward_end("render.blend", feat)
    with span("blend", device=dev):
        rgb_tiles, ft_tiles, nc_tiles = BlendFunction.apply(
            feat, tile_starts, grid_h, grid_w, tile_h, tile_w,
            render_cfg.backend)
    rgb_tiles, ft_tiles = profiling.backward_start("render.blend", rgb_tiles,
                                                   ft_tiles)
    rgb_tiles, ft_tiles = profiling.backward_end("render.untile", rgb_tiles,
                                                 ft_tiles)
    with span("untile", device=dev):
        background = background_rgb(render_cfg, dev)
        image_cf = untile_cf(rgb_tiles, grid_h, grid_w, render_cfg,
                             camera.height, camera.width)  # (3, H, W)
        final_t = untile(ft_tiles, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)
        n_contrib = untile(nc_tiles, grid_h, grid_w, render_cfg,
                           camera.height, camera.width)
        image_cf = image_cf + final_t[None] * background[:, None, None]
    image = profiling.backward_start("render.untile",
                                     image_cf.permute(1, 2, 0))
    stats = {"num_visible": num_visible, "overflow_per_tile": zero,
             "radii": prep.radius, **bin_stats}
    return RenderOutput(image=image, final_t=final_t, n_contrib=n_contrib,
                        stats=stats)


def _bound_inputs(gaussians: ActivatedGaussians,
                  mean2d_delta: torch.Tensor | None) -> tuple:
    """The preprocess's differentiable inputs through the node that ends
    the span `render.prep.bwd` (with tracing on)."""
    fields = ("means", "scales", "quats", "opacities", "sh")
    inputs = [getattr(gaussians, f) for f in fields]
    if mean2d_delta is not None:
        inputs.append(mean2d_delta)
    inputs = profiling.backward_end("render.prep", *inputs)
    return (dataclasses.replace(gaussians, **dict(zip(fields, inputs))),
            None if mean2d_delta is None else inputs[-1])


def _bound_features(prep: Preprocessed, bound, layer: str) -> Preprocessed:
    """prep with the outputs the pack reads through `bound`
    (`profiling.backward_start` or `backward_end`) of `layer`; prep itself
    with tracing off."""
    if not profiling.tracing():
        return prep
    fields = bound(layer, *(getattr(prep, f) for f in FEATURE_FIELDS))
    return prep._replace(**dict(zip(FEATURE_FIELDS, fields)))
