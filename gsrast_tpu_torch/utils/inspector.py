"""Inspector: scene, camera and per-Gaussian render-state reports, and a
rolling frame-time window (`gsrast_tpu/utils/inspector.py`'s reports).

  * scene_report: counts and byte sizes of the parameter arrays, bbox, centre
  * camera_report: position, forward, field of view, clip planes, size
  * peek_gaussian: one Gaussian's screen-space state from `preprocess`
  * goto_gaussian: a camera looking at one Gaussian
  * FrameStats: fps and frame-time percentiles over a time window
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

import numpy as np
import torch

from .. import config as cfg
from ..camera import Camera, look_at
from ..ops.preprocess import preprocess
from ..scene.gaussians import PARAM_FIELDS, GaussianScene


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def scene_report(scene: GaussianScene) -> Dict:
    """Counts and byte sizes per array, bbox and centre of the live
    Gaussians."""
    def size(x: torch.Tensor) -> int:
        return x.numel() * x.element_size()

    mn, mx = scene.bbox()
    sizes = {f: size(getattr(scene, f)) for f in PARAM_FIELDS}
    return {
        "num_active": int(scene.num_active()),
        "capacity": int(scene.capacity),
        "sh_degree": scene.sh_degree,
        "bytes": {**sizes, "total": sum(sizes.values())},
        "bbox_min": _host(mn).tolist(),
        "bbox_max": _host(mx).tolist(),
        "center": _host(scene.center()).tolist(),
    }


def camera_report(camera: Camera) -> Dict:
    return {
        "position": _host(camera.position).tolist(),
        "front": _host(camera.front).tolist(),
        "fov_deg": [float(torch.rad2deg(camera.fov_x)),
                    float(torch.rad2deg(camera.fov_y))],
        "near_far": [float(camera.znear), float(camera.zfar)],
        "width": camera.width,
        "height": camera.height,
    }


def peek_gaussian(scene: GaussianScene, camera: Camera, index: int,
                  render_cfg: cfg.RenderConfig = cfg.RenderConfig()) -> Dict:
    """One Gaussian's screen-space state, gathered once to the host: depth,
    radius, mean2d, conic, colour, tiles touched, tile rectangle, and its
    raw position, scale and opacity."""
    with torch.no_grad():
        prep = preprocess(scene.activated(), camera, render_cfg)
        rect = [int(r[index]) for r in prep.rect]
        radius = int(prep.radius[index])
        area = max(rect[2] - rect[0], 0) * max(rect[3] - rect[1], 0)
        return {
            "index": index,
            "raw": {
                "mean": _host(scene.means[index]).tolist(),
                "scale": _host(torch.exp(scene.log_scales[index])).tolist(),
                "opacity": float(torch.sigmoid(scene.opacity_logits[index])),
            },
            "depth": float(prep.depth[index]),
            "mean2d": _host(prep.mean2d[index]).tolist(),
            "conic": _host(prep.conic[index]).tolist(),
            "color": _host(prep.color[index]).tolist(),
            "radius": radius,
            "tiles_touched": area if radius > 0 else 0,
            "rect": rect,
        }


def goto_gaussian(scene: GaussianScene, camera: Camera, index: int,
                  distance: float = 1.0) -> Camera:
    """The camera moved to look at Gaussian `index` from `distance` along
    -z."""
    target = scene.means.detach()[index]
    eye = target - torch.tensor([0.0, 0.0, distance], device=target.device)
    return camera.replace(view=look_at(eye, target, device=target.device))


class FrameStats:
    """Rolling frame-time window: fps, mean and percentile frame times and
    Mpixels/s over the last `window_seconds`."""

    def __init__(self, window_seconds: float = 10.0):
        self.window = window_seconds
        self._frames = deque()  # (timestamp, dt_seconds, pixels)

    def record(self, dt_seconds: float, pixels: int = 0) -> None:
        now = time.monotonic()
        self._frames.append((now, dt_seconds, pixels))
        while self._frames and now - self._frames[0][0] > self.window:
            self._frames.popleft()

    def clear(self) -> None:
        self._frames.clear()

    def report(self) -> Dict:
        if not self._frames:
            return {"frames": 0, "fps": 0.0, "mean_dt_ms": 0.0,
                    "mpixels_per_s": 0.0}
        dts = np.array([f[1] for f in self._frames])
        pixels = np.array([f[2] for f in self._frames])
        return {
            "frames": len(dts),
            "fps": float(1.0 / max(dts.mean(), 1e-9)),
            "mean_dt_ms": float(dts.mean() * 1e3),
            "p50_dt_ms": float(np.percentile(dts, 50) * 1e3),
            "p99_dt_ms": float(np.percentile(dts, 99) * 1e3),
            "mpixels_per_s": float(pixels.sum() / max(dts.sum(), 1e-9) / 1e6),
        }
