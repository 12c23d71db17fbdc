"""Multi-view training dataset: cameras.json + PNG images in a directory.
Port of the reference's `gsrast_tpu/scene/dataset.py`; the format is the
same, so a directory written by either package loads in the other:

  data_dir/
    cameras.json   {"width": W, "height": H, "frames": [
                      {"file": "00000.png", "view": [16 floats row-major],
                       "fov_x": f, "fov_y": f}, ...]}
    00000.png ...  8-bit RGB targets

`view` is the world->camera matrix in the renderer's convention
(`camera.look_at`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np
import torch

from ..camera import Camera, look_at, make_camera
from ..utils.image import load_png, save_png


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Cameras and their target images, on one device."""

    cameras: List[Camera]
    images: torch.Tensor  # (F, H, W, 3) float32 in [0, 1]

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]


def save_dataset(path: str, cameras: List[Camera], images) -> str:
    """Write a dataset directory. `images`: iterable of (H, W, 3) images
    (tensors or arrays) with values in [0, 1]."""
    os.makedirs(path, exist_ok=True)
    frames = []
    for i, (cam, img) in enumerate(zip(cameras, images)):
        name = f"{i:05d}.png"
        save_png(img, os.path.join(path, name))
        frames.append({
            "file": name,
            "view": cam.view.detach().cpu().numpy().astype(
                np.float64).reshape(-1).tolist(),
            "fov_x": float(cam.fov_x),
            "fov_y": float(cam.fov_y),
        })
    meta = {"width": int(cameras[0].width), "height": int(cameras[0].height),
            "frames": frames}
    with open(os.path.join(path, "cameras.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_dataset(path: str, device="cpu") -> Dataset:
    """Read a dataset directory onto `device`."""
    with open(os.path.join(path, "cameras.json")) as f:
        meta = json.load(f)
    width, height = int(meta["width"]), int(meta["height"])
    cameras, images = [], []
    for fr in meta["frames"]:
        view = np.asarray(fr["view"], np.float32).reshape(4, 4)
        cameras.append(make_camera(view, fr["fov_x"], fr["fov_y"], width,
                                   height, device=device))
        img = load_png(os.path.join(path, fr["file"]))
        if img.shape[:2] != (height, width):
            raise ValueError(
                f"{fr['file']}: image {img.shape[:2]} != cameras.json "
                f"({height}, {width})")
        images.append(img)
    if not cameras:
        raise ValueError(f"{path}: no frames in cameras.json")
    return Dataset(cameras=cameras,
                   images=torch.from_numpy(np.stack(images)).to(device))


def orbit_cameras(center, radius: float, width: int, height: int, n: int,
                  fov_x: float = 1.2, fov_y: float = 1.0,
                  elevation: float = 0.35, device="cpu") -> List[Camera]:
    """N cameras on an orbit around `center`, looking at it: the synthetic
    multi-view rig."""
    center = np.asarray(torch.as_tensor(center).detach().cpu(), np.float32)
    cams = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        eye = center + np.float32(radius) * np.asarray(
            [np.cos(ang) * np.cos(elevation), np.sin(elevation),
             np.sin(ang) * np.cos(elevation)], np.float32)
        cams.append(make_camera(look_at(eye, center, device=device), fov_x,
                                fov_y, width, height, device=device))
    return cams


def render_synthetic_dataset(scene, path: str, n_views: int = 16,
                             width: int = 256, height: int = 256,
                             render_cfg=None, radius_scale: float = 2.2
                             ) -> Tuple[str, List[Camera]]:
    """Render `scene` from an orbit rig around its bbox and save the views
    as a dataset: the ground truth for multi-view training. `render_cfg`
    defaults to `auto_render_config` on the first view."""
    from ..render.api import auto_render_config, render

    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    center = (mn + mx) / 2.0
    radius = max(float(np.linalg.norm(mx - mn)) * radius_scale / 2.0, 1e-3)
    cams = orbit_cameras(center, radius, width, height, n_views,
                         device=scene.means.device)
    render_cfg = render_cfg or auto_render_config(scene, cams[0])
    with torch.no_grad():
        images = [render(scene, cam, render_cfg).image for cam in cams]
    save_dataset(path, cams, images)
    return path, cams
