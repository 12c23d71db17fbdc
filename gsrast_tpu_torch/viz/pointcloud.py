"""Point-cloud debug renderer: splat centres as fixed-size points coloured
0.2 * SH-DC + 0.5.

As in the reference (`gsrast_tpu/viz/pointcloud.py`) this is not a z-buffer:
each of the point_size^2 offset passes writes every visible point in
far-to-near order, so within one pass the nearest point wins a pixel, and a
later pass overwrites an earlier one whatever the depth. The reference's
scatter keeps the last of several writes to one pixel; a CUDA scatter keeps
any, so each pass here takes the winner explicitly: the largest far-to-near
rank (`scatter_reduce` "amax") among the points that reach the pixel.

Every shape here is static and nothing is read on the host, so a CUDA graph
captures the frame (`render/frame.py::FrameGraph`).
"""

from __future__ import annotations

import functools

import torch

from ..camera import Camera
from ..ops import projection
from ..scene.gaussians import ActivatedGaussians


@functools.lru_cache()
def background_row(background: tuple, device: torch.device) -> torch.Tensor:
    """(3,) float32 `background` on `device`, copied there once: a copy
    from host memory inside a CUDA graph's capture is refused."""
    with torch.inference_mode(False):
        return torch.tensor(background, dtype=torch.float32, device=device)


def render_pointcloud(gaussians: ActivatedGaussians, camera: Camera,
                      point_size: int = 2,
                      background=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Returns the (H, W, 3) image. `point_size` is the side of each
    point's square in pixels."""
    h, w, dev = camera.height, camera.width, camera.device
    depth = projection.to_camera(gaussians.means, camera.view)[..., 2]
    mean2d, ndc = projection.project(gaussians.means,
                                     camera.full_projection(), w, h)
    visible = projection.in_frustum(depth, ndc) & gaussians.mask
    color = 0.2 * gaussians.sh[:, 0, :] + 0.5

    # Culled points may sit at non-finite pixels: zero them before the cast.
    pix = torch.round(torch.where(visible[:, None], mean2d, 0.0)).long()
    order = torch.argsort(-depth, stable=True)  # far first
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev)

    bg = background_row(tuple(float(v) for v in background), dev)
    ranked = torch.cat([color[order], bg[None]])  # far to near, background
    img = bg.expand(h * w, 3)
    n = order.numel()
    half = point_size // 2
    for dy in range(-half, point_size - half):
        for dx in range(-half, point_size - half):
            xx, yy = pix[:, 0] + dx, pix[:, 1] + dy
            ok = visible & (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            flat = torch.where(ok, yy * w + xx, h * w)  # h * w: a dump slot
            winner = torch.full((h * w + 1,), -1, dtype=torch.long,
                                device=dev)
            winner.scatter_reduce_(0, flat, rank, "amax")
            hit = winner[:h * w] >= 0
            img = torch.where(hit[:, None],
                              ranked[torch.where(hit, winner[:h * w], n)],
                              img)
    return torch.clamp(img.reshape(h, w, 3), 0.0, 1.0)
