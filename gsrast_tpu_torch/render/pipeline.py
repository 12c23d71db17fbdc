"""The tile-sorted forward render: preprocess -> tile plan -> (tile, depth)
sort that packs per-intersection features -> blend -> image assembly.

Counterpart of the reference's `render_tiled_pallas`
(`gsrast_tpu/render/pallas_pipeline.py`). The reference lets nine feature
rows ride its sort as payloads because a gather is slow on the TPU; here one
stable sort of a 64-bit (tile, depth) key yields the permutation, and the
feature rows are gathered by it.

Differentiable end to end: the tile plan is integer structure built from
detached preprocess outputs (the reference's `stop_gradient(prep)`), the
blend is `BlendFunction`, and autograd turns the sort-pack gather
(`index_select`) into an index-add of per-intersection gradients by
Gaussian id (`index_add_`, atomic adds on the card), which replaces the
reference's routing sorts (`pallas_pipeline.py:218-244`). The gather is
not written `feat_nt[:, gauss]`: that differentiates into `index_put_`
with accumulation, whose CUDA kernel sorts the indices and sums each run
of equal ones serially, 38 ms of a 64 ms 1M/1080p fwd+bwd on an H100.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians
from .blend import BlendFunction
from .tiled import RenderOutput, untile, untile_cf


def feature_rows(prep: Preprocessed) -> torch.Tensor:
    """Per-Gaussian screen features as (9, N) rows, in the blend's row order:
    mx, my, conic A, B, C, opacity, r, g, b."""
    return torch.cat([prep.mean2d.T, prep.conic.T, prep.opacity[None],
                      prep.color.T], dim=0)


def sort_key(high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (high, low) int32 pairs lexicographically as
    signed values: (tile, depth bits) for the (tile, depth) sort, whose
    depth bits order positive depths as the depths."""
    return (high.long() << 32) | (low.long() + 2**31)


def sort_pack(feat_nt: torch.Tensor, plan: binning.TierPlan,
              num_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order the plan's slots by (tile, depth) and pack the blend's input.

    Returns feat (10, S) float32, rows 0:9 the features of each slot's
    Gaussian and row 9 its tile id, and tile_starts (T+1,) int32. Live slots
    come first, in exactly the order of the reference's stable two-key sort
    of (tile, depth); the dead slots after `tile_starts[-1]` are in no
    defined order and carry no defined features: slot s gathers Gaussian
    s mod N, so that the backward's index-add spreads their cotangents
    (exactly zero: the blend backward writes nothing outside the tiles'
    segments) over distinct addresses instead of queueing atomics on
    one."""
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


def render_tiled(gaussians: ActivatedGaussians, camera: Camera,
                 render_cfg: cfg.RenderConfig,
                 mean2d_delta: torch.Tensor | None = None) -> RenderOutput:
    tile_h, tile_w = render_cfg.tile_h, render_cfg.tile_w
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w

    prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
    plan = binning.plan_tiers(
        Preprocessed(*(x.detach() if isinstance(x, torch.Tensor) else x
                       for x in prep)), grid_h, grid_w, render_cfg)
    feat, tile_starts = sort_pack(feature_rows(prep), plan, num_tiles)
    rgb_tiles, ft_tiles, nc_tiles = BlendFunction.apply(
        feat, tile_starts, grid_h, grid_w, tile_h, tile_w, render_cfg.backend)

    background = torch.tensor(render_cfg.background, dtype=torch.float32,
                              device=feat.device)
    image_cf = untile_cf(rgb_tiles, grid_h, grid_w, render_cfg,
                         camera.height, camera.width)  # (3, H, W)
    final_t = untile(ft_tiles, grid_h, grid_w, render_cfg, camera.height,
                     camera.width)
    n_contrib = untile(nc_tiles, grid_h, grid_w, render_cfg, camera.height,
                       camera.width)
    image_cf = image_cf + final_t[None] * background[:, None, None]
    stats = {
        "num_visible": torch.sum(prep.radius > 0),
        "num_intersections": plan.total,
        "overflow_tile_cap": plan.overflow_tile_cap,
        "radii": prep.radius,
    }
    return RenderOutput(image=image_cf.permute(1, 2, 0), final_t=final_t,
                        n_contrib=n_contrib, stats=stats)
