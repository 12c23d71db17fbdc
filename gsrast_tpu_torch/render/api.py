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
from .tiled import RenderOutput, render_tiled_xla


def _activated(scene) -> ActivatedGaussians:
    return scene.activated() if isinstance(scene, GaussianScene) else scene


def _on_card(scene, camera: Camera, off_card: str) -> str:
    """'cuda' where the scene or the camera lies on a CUDA device, else
    `off_card`."""
    on_card = "cuda" in (scene.means.device.type, camera.device.type)
    return "cuda" if on_card else off_card


def default_render_config(scene, camera: Camera) -> cfg.RenderConfig:
    """The reference's default, `RenderConfig()`: 8x128 tiles and the legacy
    binning (`tiers=()`), on the blend kernels ('cuda') where the scene or
    the camera lies on the card and elsewhere on the reference's own
    default backend, the 'autograd' oracle (its 'xla')."""
    return cfg.RenderConfig(backend=_on_card(scene, camera, "autograd"))


def scene_tile_counts(scene, camera: Camera,
                      render_cfg: cfg.RenderConfig) -> np.ndarray:
    """Per-Gaussian owned-tile counts from one preprocess pass (numpy)."""
    with torch.inference_mode():
        prep = preprocess(_activated(scene), camera, render_cfg)
        grid_h, _ = render_cfg.grid_shape(camera.height, camera.width)
        return binning.tile_counts(prep, grid_h)[0].cpu().numpy()


def auto_render_config(scene, camera: Camera,
                       base: cfg.RenderConfig | None = None,
                       margin: float = 1.12,
                       auto_tile_w: bool = True) -> cfg.RenderConfig:
    """The product-default RenderConfig for (scene, camera): the tier plan
    derived from the scene's own tile-count distribution, and the tile shape
    of the reference's big-splat rule: start from `base`'s tile and, where
    `auto_tile_w`, double the tile area, up to P = 2048, while the mean
    tiles per Gaussian is above 8. `base` defaults to 16x32 with backend
    'cuda' where the scene or the camera lies on a CUDA device, else
    'torch' (so make the config from the tensors it will render). A given
    `base` keeps its backend and every other field but the legacy
    binning's fallback knobs, which are set as the reference sets them on
    every config it returns (`gsrast_tpu/render/api.py:76-78`):
    `max_tiles_per_gaussian` 512 and `heavy_fraction` 0.5, for a caller
    that puts the config back on the legacy path (`tiers=()`); neither
    changes the tier plan. `margin` is the tier budgets' headroom
    (`auto_tiers`); training passes a larger one, since densification
    reshapes the count distribution.

    The 16x32 base and the P <= 2048 cap were tuned on the TPU and are kept
    for parity with the reference; `diag/tile_sweep.py` times the tile
    shapes on the card."""
    if base is None:
        base = cfg.RenderConfig(tile_h=16, tile_w=32,
                                backend=_on_card(scene, camera, "torch"))
    rcfg = base.replace(max_tiles_per_gaussian=512, heavy_fraction=0.5)
    counts = scene_tile_counts(scene, camera, rcfg)
    mean_c = float(counts.mean()) if counts.size else 0.0
    while (auto_tile_w and mean_c > 8.0
           and rcfg.tile_h * rcfg.tile_w < 2048):
        if rcfg.tile_w <= rcfg.tile_h * 2:
            rcfg = rcfg.replace(tile_w=rcfg.tile_w * 2)
        else:
            rcfg = rcfg.replace(tile_h=rcfg.tile_h * 2)
        counts = scene_tile_counts(scene, camera, rcfg)
        mean_c = float(counts.mean()) if counts.size else 0.0
    return rcfg.replace(tiers=binning.auto_tiers(counts, margin=margin))


def render(scene: Union[GaussianScene, ActivatedGaussians], camera: Camera,
           render_cfg: cfg.RenderConfig | None = None,
           mean2d_delta: torch.Tensor | None = None) -> RenderOutput:
    """Render `scene` from `camera`, differentiably. `render_cfg` defaults
    to the reference's `RenderConfig()` (`default_render_config`: the
    legacy binning); `auto_render_config` gives the product's tier plan.
    'cuda' and 'torch' blend with the kernels or their plain versions
    (`render.pipeline`), 'autograd' is the capped oracle (`render.tiled`),
    'dense' renders by brute force and takes no `mean2d_delta`.
    `mean2d_delta`: see `ops.preprocess.preprocess`."""
    if render_cfg is None:
        render_cfg = default_render_config(scene, camera)
    if render_cfg.backend not in cfg.BACKENDS:
        raise ValueError(f"unknown backend {render_cfg.backend!r}; expected "
                         f"one of {cfg.BACKENDS}")
    if render_cfg.backend == "dense":
        if mean2d_delta is not None:
            raise ValueError("the dense backend takes no mean2d_delta")
        return render_dense(_activated(scene), camera, render_cfg)
    if render_cfg.backend == "autograd":
        return render_tiled_xla(_activated(scene), camera, render_cfg,
                                mean2d_delta)
    return render_tiled(_activated(scene), camera, render_cfg, mean2d_delta)
