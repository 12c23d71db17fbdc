"""Point projection, frustum culling and the covered-tile rectangle."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import config as cfg
from ..camera import matmul_f32


def to_camera(means: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points -> (N, 3) camera space (z = depth)."""
    return matmul_f32(means, view[:3, :3].T) + view[:3, 3]


def project(means: torch.Tensor, full_proj: torch.Tensor, width: int,
            height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> (pixel xy (N, 2), ndc (N, 3)), with the pixel mapping
    ((ndc + 1) * size - 1) / 2."""
    ones = torch.ones_like(means[..., :1])
    hom = matmul_f32(torch.cat([means, ones], dim=-1), full_proj.T)  # (N, 4)
    w = 1.0 / (hom[..., 3:4] + 1e-7)
    ndc = hom[..., :3] * w
    px = ((ndc[..., 0] + 1.0) * width - 1.0) * 0.5
    py = ((ndc[..., 1] + 1.0) * height - 1.0) * 0.5
    return torch.stack([px, py], dim=-1), ndc


def in_frustum(depth: torch.Tensor, ndc: torch.Tensor) -> torch.Tensor:
    """Near-plane and margin-expanded NDC cull."""
    m = cfg.NDC_CULL_MARGIN
    return ((depth > cfg.NEAR_CULL_DEPTH)
            & (ndc[..., 0] > -m) & (ndc[..., 0] < m)
            & (ndc[..., 1] > -m) & (ndc[..., 1] < m))


class TileRect(NamedTuple):
    x_min: torch.Tensor  # inclusive, int32
    y_min: torch.Tensor
    x_max: torch.Tensor  # exclusive
    y_max: torch.Tensor


def tile_rect(mean2d: torch.Tensor, radius_x: torch.Tensor,
              radius_y: torch.Tensor, grid_h: int, grid_w: int, tile_h: int,
              tile_w: int) -> TileRect:
    """Tile rectangle covered by a splat extending `radius_x` pixels in x and
    `radius_y` in y around mean2d."""
    px, py = mean2d[..., 0], mean2d[..., 1]

    def i32(x, hi):
        # Clamp before the conversion: culled splats can sit at huge or
        # non-finite pixel coordinates, where a float->int32 cast is
        # undefined. This matches a saturating cast (NaN -> 0) then clamp.
        x = torch.nan_to_num(x, nan=0.0, posinf=hi, neginf=0.0)
        return torch.clamp(x, 0, hi).to(torch.int32)

    return TileRect(
        i32((px - radius_x) / tile_w, grid_w),
        i32((py - radius_y) / tile_h, grid_h),
        i32(torch.ceil((px + radius_x + 1.0) / tile_w), grid_w),
        i32(torch.ceil((py + radius_y + 1.0) / tile_h), grid_h),
    )


def depth_order_key(depth: torch.Tensor) -> torch.Tensor:
    """float32 depth -> its int32 bit pattern, which orders positive floats
    exactly as their values."""
    return depth.contiguous().view(torch.int32)
