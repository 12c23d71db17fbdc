"""Top-level render entry point and the product-default render config."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .. import config as cfg
from ..camera import Camera
from ..ops import binning
from ..ops.preprocess import preprocess
from ..scene.gaussians import ActivatedGaussians, GaussianScene
from .dense import render_dense
from .pipeline import render_tiled
from .tiled import RenderOutput


def _activated(scene) -> ActivatedGaussians:
    return scene.activated() if isinstance(scene, GaussianScene) else scene


def scene_tile_counts(scene, camera: Camera,
                      render_cfg: cfg.RenderConfig) -> np.ndarray:
    """Per-Gaussian owned-tile counts from one preprocess pass (numpy)."""
    with torch.inference_mode():
        prep = preprocess(_activated(scene), camera, render_cfg)
        grid_h, _ = render_cfg.grid_shape(camera.height, camera.width)
        return binning.tile_counts(prep, grid_h)[0].cpu().numpy()


def auto_render_config(scene, camera: Camera,
                       margin: float = 1.12) -> cfg.RenderConfig:
    """The product-default RenderConfig for (scene, camera): the tier plan
    derived from the scene's own tile-count distribution, and the tile shape
    of the reference's big-splat rule: start from 16x32 and double the tile
    area, up to P = 2048, while the mean tiles per Gaussian is above 8. The
    backend follows the camera's device: 'cuda' on a CUDA device, else
    'torch'. `margin` is the tier budgets' headroom (`auto_tiers`); training
    passes a larger one, since densification reshapes the count
    distribution.

    The 16x32 base and the P <= 2048 cap were tuned on the TPU and are kept
    for parity with the reference; they are still to be tuned on the GPU."""
    backend = "cuda" if camera.device.type == "cuda" else "torch"
    rcfg = cfg.RenderConfig(tile_h=16, tile_w=32, backend=backend)
    counts = scene_tile_counts(scene, camera, rcfg)
    mean_c = float(counts.mean()) if counts.size else 0.0
    while mean_c > 8.0 and rcfg.tile_h * rcfg.tile_w < 2048:
        if rcfg.tile_w <= rcfg.tile_h * 2:
            rcfg = rcfg.replace(tile_w=rcfg.tile_w * 2)
        else:
            rcfg = rcfg.replace(tile_h=rcfg.tile_h * 2)
        counts = scene_tile_counts(scene, camera, rcfg)
        mean_c = float(counts.mean()) if counts.size else 0.0
    return rcfg.replace(tiers=binning.auto_tiers(counts, margin=margin))


def render(scene: Union[GaussianScene, ActivatedGaussians], camera: Camera,
           render_cfg: cfg.RenderConfig,
           mean2d_delta: torch.Tensor | None = None) -> RenderOutput:
    """Render `scene` from `camera`, differentiably. The tiled backends
    need `render_cfg.tiers` (see `auto_render_config`); 'dense' renders by
    brute force and takes no `mean2d_delta`. `mean2d_delta`: see
    `ops.preprocess.preprocess`."""
    if render_cfg.backend not in cfg.BACKENDS:
        raise ValueError(f"unknown backend {render_cfg.backend!r}; expected "
                         f"one of {cfg.BACKENDS}")
    if render_cfg.backend == "dense":
        if mean2d_delta is not None:
            raise ValueError("the dense backend takes no mean2d_delta")
        return render_dense(_activated(scene), camera, render_cfg)
    return render_tiled(_activated(scene), camera, render_cfg, mean2d_delta)
