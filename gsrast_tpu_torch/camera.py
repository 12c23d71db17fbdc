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

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import config as cfg


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a (..., K) or (..., M, K) and b (K, J), in float32 without
    the tensor cores."""
    return (a.unsqueeze(-1) * b).sum(-2)


@contextlib.contextmanager
def no_tf32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS float32 products
    inside the block, and restore the flags afterwards: in TF32 a CUDA
    float32 product keeps about three decimal digits."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _true_div(n: int, d: torch.Tensor) -> torch.Tensor:
    """n / d as a float32 division on every device, as the reference
    divides (an int or float divided by a tensor is PyTorch's reciprocal of
    the tensor times the scalar, an ulp off at some d)."""
    return torch.full_like(d, float(n)) / d


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
        return _true_div(self.width, 2.0 * self.tan_fov_x)

    @property
    def focal_y(self) -> torch.Tensor:
        return _true_div(self.height, 2.0 * self.tan_fov_y)

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world space (inverse of the view transform)."""
        rot = self.view[:3, :3]
        t = self.view[:3, 3]
        return -matmul_f32(t, rot)  # rot.T @ t

    @property
    def front(self) -> torch.Tensor:
        """World-space forward (the +z camera row)."""
        return self.view[2, :3]

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


# A Camera's tensor fields.
CAMERA_TENSORS = ("view", "fov_x", "fov_y", "znear", "zfar")

# The floats of a camera block (`device_camera`), in order: view (4x4,
# row-major), full projection (4x4), position (3), focal_x, focal_y,
# tan_fov_x, tan_fov_y; csrc/preprocess.cu reads them at these offsets.
CAMERA_FLOATS = 39


class DeviceCamera(NamedTuple):
    """A camera as the preprocess kernels read it: its floats in one device
    tensor, and the image size, which a launch takes as host ints."""

    block: torch.Tensor  # (CAMERA_FLOATS,) float32
    width: int
    height: int


def device_camera(camera: Camera) -> DeviceCamera:
    """The camera's block, built by torch ops from its device tensors, each
    float as `Camera`'s properties round it (focal = size / (2 tan), a
    true division). A CUDA graph that captures this call rebuilds the block
    from the camera's tensors at each replay: the kernels never take the
    camera as host scalars."""
    block = torch.cat([camera.view.reshape(16),
                       camera.full_projection().reshape(16), camera.position,
                       camera.focal_x.reshape(1), camera.focal_y.reshape(1),
                       camera.tan_fov_x.reshape(1),
                       camera.tan_fov_y.reshape(1)])
    return DeviceCamera(block, camera.width, camera.height)


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
    p[3, 2].fill_(1.0)  # a fill kernel, not a host copy: capturable
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


def _yaw_pitch_front(yaw: torch.Tensor, pitch: torch.Tensor) -> torch.Tensor:
    """Unit forward vector; yaw = 0 looks down +x."""
    return torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
                        torch.sin(yaw) * torch.cos(pitch)])


_PITCH_LIMIT = cfg.PI / 2.0 - 0.05


def from_yaw_pitch(eye, yaw, pitch, up=(0.0, -1.0, 0.0),
                   device="cpu") -> torch.Tensor:
    """First-person view matrix from yaw/pitch, pitch clamped to
    +-(pi/2 - 0.05)."""
    yaw, pitch = _f32(yaw, device), _f32(pitch, device)
    pitch = torch.clamp(pitch, -_PITCH_LIMIT, _PITCH_LIMIT)
    eye = _f32(eye, device)
    return look_at(eye, eye + _yaw_pitch_front(yaw, pitch), up, device=device)


@dataclasses.dataclass(frozen=True)
class FirstPersonState:
    """The first-person controller's state: WASD motion scaled by speed *
    dt, mouse-look yaw/pitch with the pitch clamp, speed doubling and
    halving, and the invert-up flip for Y-down trained scenes."""

    eye: torch.Tensor    # (3,) world position
    yaw: torch.Tensor    # ()
    pitch: torch.Tensor  # ()
    speed: torch.Tensor  # () units per second
    invert_up: bool = True

    @property
    def up(self) -> tuple:
        return (0.0, -1.0, 0.0) if self.invert_up else (0.0, 1.0, 0.0)

    def replace(self, **kw) -> "FirstPersonState":
        return dataclasses.replace(self, **kw)


def fp_init(eye, yaw=0.0, pitch=0.0, speed=1.0, invert_up: bool = True,
            device="cpu") -> FirstPersonState:
    return FirstPersonState(eye=_f32(eye, device), yaw=_f32(yaw, device),
                            pitch=_f32(pitch, device),
                            speed=_f32(speed, device), invert_up=invert_up)


def _fp_basis(state: FirstPersonState):
    """(front, right, up) of the controller."""
    front = _yaw_pitch_front(state.yaw, state.pitch)
    up = _f32(state.up, state.eye.device)
    right = torch.linalg.cross(front, up)
    right = right / (_norm(right) + 1e-12)
    return front, right, up


def fp_move(state: FirstPersonState, forward: float = 0.0,
            strafe: float = 0.0, dt: float = 1.0 / 60.0) -> FirstPersonState:
    """WASD step: forward/strafe in {-1, 0, 1}, speed * dt along front and
    right."""
    front, right, _ = _fp_basis(state)
    delta = (front * forward + right * strafe) * state.speed * dt
    return state.replace(eye=state.eye + delta)


def fp_look(state: FirstPersonState, dyaw: float, dpitch: float,
            sensitivity: float = 0.005) -> FirstPersonState:
    """Mouse-look: yaw/pitch deltas with the +-(pi/2 - 0.05) pitch clamp."""
    dev = state.eye.device
    return state.replace(
        yaw=state.yaw + _f32(dyaw, dev) * sensitivity,
        pitch=torch.clamp(state.pitch + _f32(dpitch, dev) * sensitivity,
                          -_PITCH_LIMIT, _PITCH_LIMIT))


def fp_speed(state: FirstPersonState, factor: float) -> FirstPersonState:
    """Speed times `factor` (x2 / /2 on the up/down keys)."""
    return state.replace(speed=state.speed * _f32(factor, state.eye.device))


def fp_camera(state: FirstPersonState, width: int, height: int,
              fov_deg: float = cfg.DEFAULT_FOV_DEG) -> Camera:
    """The camera of the controller state, rebuilt each frame."""
    dev = state.eye.device
    view = from_yaw_pitch(state.eye, state.yaw, state.pitch, state.up,
                          device=dev)
    fov = _f32(fov_deg * cfg.PI / 180.0, dev)
    return Camera(view=view, fov_x=fov * (width / height), fov_y=fov,
                  znear=_f32(cfg.DEFAULT_NEAR, dev),
                  zfar=_f32(cfg.DEFAULT_FAR, dev), width=width,
                  height=height)


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


def _recip_f32(n: int) -> float:
    """1 / n rounded to float32 (a float32 division), as a Python float."""
    return float(np.float32(1.0) / np.float32(n))


def camera_rays(camera: Camera):
    """Per-pixel world-space ray origins and unit directions, each
    (H, W, 3), for the ellipsoid ray trace. Each operation is rounded alone
    and the same on every device (the ellipsoid kernel repeats it bit for
    bit): the pixel centre times 1 / n in float32, (px, py, 1) V[:3, :3]
    summed left to right, the norm's square root correctly rounded."""
    h, w, dev = camera.height, camera.width, camera.device
    xs, ys = ((torch.arange(n, dtype=torch.float32, device=dev) + 0.5)
              * _recip_f32(n) * 2.0 - 1.0 for n in (w, h))
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (h, w)
    rot = camera.view[:3, :3]  # R^T on each direction: (px, py, 1) rot
    dir_world = ((px * camera.tan_fov_x)[..., None] * rot[0]
                 + (py * camera.tan_fov_y)[..., None] * rot[1] + rot[2])
    x, y, z = dir_world.unbind(-1)
    norm = torch.sqrt((x * x + y * y + z * z).double()).float()
    return camera.position.expand(h, w, 3), dir_world / norm[..., None]


def debug_camera(width: int = 979, height: int = 546, device="cpu") -> Camera:
    """A frozen pose for numerical A/B comparisons: every run sees the
    identical camera."""
    return make_camera(look_at([1.25, -0.75, -2.0], [0.0, 0.0, 0.0],
                               device=device), 1.222, 0.733, width, height,
                       device=device)


# Pose (de)serialization: the pose store's JSON record of a camera.

def pose_to_dict(camera: Camera) -> dict:
    return {
        "view": camera.view.detach().cpu().numpy().tolist(),
        "fov_x": float(camera.fov_x),
        "fov_y": float(camera.fov_y),
        "znear": float(camera.znear),
        "zfar": float(camera.zfar),
        "width": camera.width,
        "height": camera.height,
    }


def pose_from_dict(d: dict, device="cpu") -> Camera:
    return make_camera(d["view"], d["fov_x"], d["fov_y"], int(d["width"]),
                       int(d["height"]),
                       znear=d.get("znear", cfg.DEFAULT_NEAR),
                       zfar=d.get("zfar", cfg.DEFAULT_FAR), device=device)
