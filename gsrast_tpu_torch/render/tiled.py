"""Image assembly from per-tile blend outputs, and the render result."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as cfg


class RenderOutput(NamedTuple):
    image: torch.Tensor      # (H, W, 3)
    final_t: torch.Tensor    # (H, W) residual transmittance
    n_contrib: torch.Tensor  # (H, W) int32 positions blended before saturation
    stats: dict


def untile(tiles: torch.Tensor, grid_h: int, grid_w: int,
           render_cfg: cfg.RenderConfig, height: int,
           width: int) -> torch.Tensor:
    """(T, P, ...) tile-major -> (height, width, ...) image, cropped."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    trailing = tuple(tiles.shape[2:])
    img = tiles.reshape((grid_h, grid_w, th, tw) + trailing)
    img = img.transpose(1, 2)  # (gh, th, gw, tw, ...)
    img = img.reshape((grid_h * th, grid_w * tw) + trailing)
    return img[:height, :width]


def untile_cf(tiles: torch.Tensor, grid_h: int, grid_w: int,
              render_cfg: cfg.RenderConfig, height: int,
              width: int) -> torch.Tensor:
    """(T, ch, P) channel-first tiles -> (ch, height, width)."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    ch = tiles.shape[1]
    img = tiles.reshape(grid_h, grid_w, ch, th, tw).permute(2, 0, 3, 1, 4)
    img = img.reshape(ch, grid_h * th, grid_w * tw)
    return img[:, :height, :width]
