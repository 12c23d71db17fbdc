"""The tile-sorted forward render: preprocess -> tile plan -> (tile, depth)
sort that packs per-intersection features -> blend -> image assembly.

Counterpart of the reference's `render_tiled_pallas`
(`gsrast_tpu/render/pallas_pipeline.py`). The reference lets nine feature
rows ride its sort as payloads because a gather is slow on the TPU; here one
stable sort of a 64-bit (tile, depth) key yields the permutation, and the
feature rows are gathered by it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians
from .blend import blend_forward
from .tiled import RenderOutput, untile, untile_cf


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
    defined order and carry no defined features."""
    # The depth bits of culled Gaussians can be negative int32, which would
    # sign-extend over the tile bits; padded slots carry depth 0. Masking to
    # the low 32 bits keeps the tile in the high word. Live slots have
    # depth > 0, where unsigned and signed orders agree.
    key = (plan.tile_key.long() << 32) | (plan.depth_key.long() & 0xFFFFFFFF)
    perm = torch.sort(key, stable=True).indices
    tile = plan.tile_key[perm]
    gauss = plan.gauss[perm].long().clamp(min=0)
    feat = torch.cat([feat_nt[:, gauss], tile[None].float()], dim=0)
    queries = torch.arange(num_tiles + 1, dtype=torch.int32,
                           device=tile.device)
    tile_starts = torch.searchsorted(tile, queries, side="left",
                                     out_int32=True)
    return feat, tile_starts


def render_tiled(gaussians: ActivatedGaussians, camera: Camera,
                 render_cfg: cfg.RenderConfig) -> RenderOutput:
    tile_h, tile_w = render_cfg.tile_h, render_cfg.tile_w
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w

    prep = preprocess(gaussians, camera, render_cfg)
    plan = binning.plan_tiers(prep, grid_h, grid_w, render_cfg)
    feat, tile_starts = sort_pack(feature_rows(prep), plan, num_tiles)
    rgb_tiles, ft_tiles, nc_tiles = blend_forward(
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
