"""Dense (tile-free) renderer: the correctness oracle.

Blends every Gaussian into every pixel front to back with the blend's
semantics (`gsrast_tpu/render/dense.py`): power = -1/2 (A dx^2 + C dy^2)
- B dx dy, skip power > 0, alpha = min(0.99, opacity e^power), skip
alpha < 1/255, stop once T (1 - alpha) < 1e-4, background behind the
residual transmittance. O(N * pixels), plain PyTorch on any device, and
differentiable by autograd.

The sequential early-stop recurrence in closed form:
  P_i = prod_{j<=i} (1 - a_j),  T_i = P_{i-1},
  include_i = (P_i >= T_MIN)           (monotone: the exact early-stop mask)
  C = sum include_i * valid_i * c_i a_i T_i,  T_final = min included P_i.
The cumulative product rounds differently from a per-pixel loop, so a pixel
whose transmittance lands within rounding of T_MIN may stop one position
earlier or later than in the tiled renderers.
"""

from __future__ import annotations

import torch

from .. import config as cfg
from ..camera import Camera, matmul_f32
from ..ops.preprocess import preprocess
from ..scene.gaussians import ActivatedGaussians
from .tiled import RenderOutput, background_rgb


def blend_pixels(pix_x: torch.Tensor, pix_y: torch.Tensor,
                 mean2d: torch.Tensor, conic: torch.Tensor,
                 color: torch.Tensor, opacity: torch.Tensor,
                 active: torch.Tensor, background: torch.Tensor):
    """Blend depth-sorted Gaussians into a batch of pixels.

    pix_x, pix_y: (P,) pixel centres; mean2d/conic/color/opacity: (G, ...)
    per-Gaussian screen state sorted front to back; active: (G, P) or
    (G, 1) bool, whether Gaussian g may touch pixel p; background: (3,).
    Returns (color (P, 3), final_t (P,), n_contrib (P,) int32)."""
    dx = mean2d[:, 0:1] - pix_x[None, :]  # (G, P)
    dy = mean2d[:, 1:2] - pix_y[None, :]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(opacity[:, None] * torch.exp(power),
                        max=cfg.ALPHA_MAX)
    valid = active & (power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
    alpha_eff = torch.where(valid, alpha, 0.0)

    p_cum = torch.cumprod(1.0 - alpha_eff, dim=0)  # P_i
    t_before = torch.cat([torch.ones_like(p_cum[:1]), p_cum[:-1]])  # T_i
    include = p_cum >= cfg.TRANSMITTANCE_MIN
    w = torch.where(include & valid, alpha_eff * t_before, 0.0)  # (G, P)
    out = matmul_f32(w.T, color)

    final_t = torch.clamp(torch.cat([
        torch.ones_like(p_cum[:1]),
        torch.where(include, p_cum, float("inf"))]).amin(0), max=1.0)
    out = out + final_t[:, None] * background[None, :]
    # The blend length before saturation; `active` stands in for the tiled
    # path's segment membership.
    n_contrib = torch.sum(include & active, dim=0, dtype=torch.int32)
    return out, final_t, n_contrib


def render_dense(gaussians: ActivatedGaussians, camera: Camera,
                 render_cfg: cfg.RenderConfig = cfg.RenderConfig(),
                 row_chunk: int = 64,
                 match_tiled_rects: bool = False) -> RenderOutput:
    """Render by brute force, `row_chunk` image rows at a time.
    `match_tiled_rects=True` also restricts each Gaussian to the pixels of
    its covered tile rectangle (`render_cfg`'s tiles), the inclusion set of
    the tiled renderers."""
    prep = preprocess(gaussians, camera, render_cfg)
    h, w, dev = camera.height, camera.width, camera.device

    # Stable, so depth ties keep the tiled path's stable (tile | depth) order.
    order = torch.argsort(prep.depth, stable=True)
    mean2d, conic, color, opacity, radius = (
        x[order] for x in (prep.mean2d, prep.conic, prep.color,
                           prep.opacity, prep.radius))
    rect = [r[order][:, None] for r in prep.rect]
    visible = (radius > 0)[:, None]
    background = background_rgb(render_cfg, dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)

    rows = []
    for row0 in range(0, h, row_chunk):
        ys = torch.arange(row0, min(row0 + row_chunk, h),
                          dtype=torch.float32, device=dev)
        py, px = (g.reshape(-1) for g in torch.meshgrid(ys, xs,
                                                        indexing="ij"))
        active = visible
        if match_tiled_rects:
            tx = (px // render_cfg.tile_w).to(torch.int32)[None, :]
            ty = (py // render_cfg.tile_h).to(torch.int32)[None, :]
            x_min, y_min, x_max, y_max = rect
            active = (visible & (tx >= x_min) & (tx < x_max)
                      & (ty >= y_min) & (ty < y_max))
        out = blend_pixels(px, py, mean2d, conic, color, opacity, active,
                           background)
        rows.append([x.reshape(len(ys), w, *x.shape[1:]) for x in out])
    img, final_t, n_contrib = (torch.cat(parts) for parts in zip(*rows))
    return RenderOutput(image=img, final_t=final_t, n_contrib=n_contrib,
                        stats={"num_visible": torch.sum(prep.radius > 0)})
