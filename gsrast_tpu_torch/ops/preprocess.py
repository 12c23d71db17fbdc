"""Batched Gaussian preprocessing: cull, project, shade, and bound each
splat's support by a per-axis tile rectangle."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config as cfg
from ..camera import Camera
from ..scene.gaussians import ActivatedGaussians
from . import covariance, projection, sh as sh_ops


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space state."""

    mean2d: torch.Tensor   # (N, 2) pixel coords
    depth: torch.Tensor    # (N,) camera-space z
    conic: torch.Tensor    # (N, 3) inverse 2D covariance [A, B, C]
    color: torch.Tensor    # (N, 3) RGB from SH
    opacity: torch.Tensor  # (N,) 0 where culled
    radius: torch.Tensor   # (N,) int32 pixel extent (0 = culled)
    rect: projection.TileRect  # covered tile rectangle

    def detach(self) -> "Preprocessed":
        """The same state cut from the graph: the integer structure the
        tile plans are built from (the reference's `stop_gradient(prep)`)."""
        return Preprocessed(*(x.detach() if isinstance(x, torch.Tensor)
                              else x for x in self))


def preprocess(gaussians: ActivatedGaussians, camera: Camera,
               render_cfg: cfg.RenderConfig,
               mean2d_delta: torch.Tensor | None = None) -> Preprocessed:
    """`mean2d_delta`: optional (N, 2) zero perturbation added to the screen
    positions; its gradient is the per-Gaussian screen-space positional
    gradient that drives densification."""
    view = camera.view
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)

    mean_view = projection.to_camera(gaussians.means, view)
    depth = mean_view[..., 2]
    mean2d, ndc = projection.project(
        gaussians.means, camera.full_projection(), camera.width,
        camera.height)
    if mean2d_delta is not None:
        mean2d = mean2d + mean2d_delta
    visible = projection.in_frustum(depth, ndc) & gaussians.mask

    cov6 = covariance.compute_cov3d(gaussians.scales, gaussians.quats)
    # Guard the EWA division by z for culled points.
    safe_view = torch.cat(
        [mean_view[..., :2], torch.where(visible, depth, 1.0)[..., None]],
        dim=-1)
    cov2d = covariance.compute_cov2d(
        safe_view, cov6, view[:3, :3], camera.focal_x, camera.focal_y,
        camera.tan_fov_x, camera.tan_fov_y)
    conic, cov_valid = covariance.conic(cov2d)
    visible = visible & cov_valid

    direction = gaussians.means - camera.position
    norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    direction = direction / (norm + 1e-12)
    degree = min(render_cfg.sh_degree, gaussians.sh_degree)
    color = sh_ops.eval_sh(gaussians.sh, direction, degree)

    # Opacity-aware per-axis extent: the blend skips alpha < ALPHA_MIN, so
    # the support is the ellipse d^T Sigma^-1 d <= c with
    # c = 2 ln(opacity / ALPHA_MIN), capped at (3 sigma)^2, whose tight
    # axis-aligned bound is +-sqrt(c Sigma_xx) by +-sqrt(c Sigma_yy). The 2%
    # margin on the threshold keeps the dropped pixels provably below
    # ALPHA_MIN under float32 rounding. The extents reach only int32 values
    # (radius, rect): ceil(sqrt(0)) would give a NaN gradient in autograd.
    cfac = torch.clamp(
        2.0 * torch.log(gaussians.opacities / (0.98 * cfg.ALPHA_MIN)),
        0.0, cfg.GAUSSIAN_EXTENT_SIGMA ** 2)
    ext_x = torch.ceil(torch.sqrt(cfac * torch.clamp(cov2d[..., 0], min=0.0)))
    ext_y = torch.ceil(torch.sqrt(cfac * torch.clamp(cov2d[..., 2], min=0.0)))
    radius = torch.where(visible, torch.maximum(ext_x, ext_y),
                         0.0).to(torch.int32)
    rect = projection.tile_rect(
        mean2d, torch.where(visible, ext_x, 0.0),
        torch.where(visible, ext_y, 0.0), grid_h, grid_w,
        render_cfg.tile_h, render_cfg.tile_w)
    opacity = torch.where(visible, gaussians.opacities, 0.0)
    return Preprocessed(mean2d=mean2d, depth=depth, conic=conic, color=color,
                        opacity=opacity, radius=radius, rect=rect)
