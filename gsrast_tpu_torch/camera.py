"""Cameras: a world->camera view matrix plus pinhole intrinsics.

Conventions are the reference renderer's (`gsrast_tpu/camera.py`):
  * view @ [p, 1] gives camera space with +z pointing INTO the screen, so a
    visible point has depth = p_cam.z > 0; pixel x grows right, y DOWN.
  * the projection maps z to [0, 1] over [znear, zfar] and does not flip y.
  * focal_y = height / (2 tan(fov_y / 2)).

The small matrix products here are written as elementwise products and sums
(`matmul_f32`): they stay exact float32 on every device and never take the
TF32 path a CUDA matmul may take.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as cfg


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a (..., K) or (..., M, K) and b (K, J), in float32 without
    the tensor cores."""
    return (a.unsqueeze(-1) * b).sum(-2)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


@dataclasses.dataclass(frozen=True)
class Camera:
    """An immutable camera. Tensors are float32 and live on one device."""

    view: torch.Tensor   # (4, 4) world -> camera (z forward, y down)
    fov_x: torch.Tensor  # () radians
    fov_y: torch.Tensor  # () radians
    znear: torch.Tensor  # ()
    zfar: torch.Tensor   # ()
    width: int = cfg.DEFAULT_WIDTH
    height: int = cfg.DEFAULT_HEIGHT

    @property
    def device(self) -> torch.device:
        return self.view.device

    @property
    def tan_fov_x(self) -> torch.Tensor:
        return torch.tan(self.fov_x * 0.5)

    @property
    def tan_fov_y(self) -> torch.Tensor:
        return torch.tan(self.fov_y * 0.5)

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fov_x)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fov_y)

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world space (inverse of the view transform)."""
        rot = self.view[:3, :3]
        t = self.view[:3, 3]
        return -matmul_f32(t, rot)  # rot.T @ t

    def projection(self) -> torch.Tensor:
        return perspective(self.fov_x, self.fov_y, self.znear, self.zfar)

    def full_projection(self) -> torch.Tensor:
        """world -> clip: proj @ view."""
        return matmul_f32(self.projection(), self.view)

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(view=self.view.to(device),
                            fov_x=self.fov_x.to(device),
                            fov_y=self.fov_y.to(device),
                            znear=self.znear.to(device),
                            zfar=self.zfar.to(device))


def make_camera(view, fov_x, fov_y, width: int, height: int,
                znear: float = cfg.DEFAULT_NEAR, zfar: float = cfg.DEFAULT_FAR,
                device="cpu") -> Camera:
    """Camera from array-likes and floats, as float32 tensors on `device`."""
    return Camera(view=_f32(view, device), fov_x=_f32(fov_x, device),
                  fov_y=_f32(fov_y, device), znear=_f32(znear, device),
                  zfar=_f32(zfar, device), width=int(width),
                  height=int(height))


def perspective(fov_x, fov_y, znear, zfar) -> torch.Tensor:
    """GS-style perspective matrix: z mapped to [0, 1], +z forward."""
    tx = torch.tan(fov_x * 0.5)
    ty = torch.tan(fov_y * 0.5)
    p = torch.zeros((4, 4), dtype=torch.float32, device=fov_x.device)
    p[0, 0] = 1.0 / tx
    p[1, 1] = 1.0 / ty
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def look_at(eye, target, up=(0.0, -1.0, 0.0), device="cpu") -> torch.Tensor:
    """World->camera view matrix looking from `eye` to `target`. The default
    `up` is -Y: trained GS scenes are Y-down."""
    eye, target, up = (_f32(v, device) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / (_norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (_norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)  # camera +y (image down)
    rot = torch.stack([right, down, fwd])  # rows: camera axes in world space
    view = torch.eye(4, dtype=torch.float32, device=device)
    view[:3, :3] = rot
    view[:3, 3] = -matmul_f32(eye, rot.T)  # rot @ eye
    return view


def auto_frame(bbox_min, bbox_max, width: int, height: int,
               fov_deg: float = cfg.DEFAULT_FOV_DEG, device="cpu") -> Camera:
    """Frame a scene bbox: step back from its center by the bbox span along
    -z and look at the center."""
    bbox_min, bbox_max = (np.asarray(torch.as_tensor(b).detach().cpu(),
                                     np.float32) for b in (bbox_min, bbox_max))
    center = 0.5 * (bbox_min + bbox_max)
    span = float(np.linalg.norm(bbox_max - bbox_min))
    eye = center + np.array([0.0, 0.0, -max(span, 1e-3)], np.float32)
    aspect = width / height
    fov_y = np.deg2rad(fov_deg)
    fov_x = 2.0 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2.0) * aspect)
    return make_camera(look_at(eye, center, device=device), fov_x, fov_y,
                       width, height, zfar=max(cfg.DEFAULT_FAR, 4.0 * span),
                       device=device)
