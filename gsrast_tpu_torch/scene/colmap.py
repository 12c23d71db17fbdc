"""COLMAP dataset reader and writer: cameras.bin / images.bin / points3D.bin.
Port of the reference's `gsrast_tpu/scene/colmap.py`.

Real Gaussian-splatting datasets ship as a COLMAP sparse reconstruction
plus the photographs:

  scene_dir/
    sparse/0/cameras.bin   intrinsics  (camera_id -> model, W, H, params)
    sparse/0/images.bin    extrinsics  (qvec, tvec, camera_id, file name)
    sparse/0/points3D.bin  SfM points  (xyz, rgb): the scene initializer
    images/                the photographs (JPEG, PNG, ...: `utils.image.load_png`)

The binary layout is COLMAP's (little-endian; counts are uint64; qvec is
(w, x, y, z)); the world->camera transform is X_cam = R(qvec) X_world + tvec
with camera axes x right, y down, z forward, which is the renderer's camera
convention, so the view matrix is [[R, t], [0, 1]] with no flip.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# model_id -> (name, number of params). Distortion parameters beyond the
# pinhole set are read and ignored: the renderer's camera is an ideal
# pinhole (real pipelines undistort first).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_TWO_FOCAL = ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
              "THIN_PRISM_FISHEYE")

# Points per chunk of the nearest-neighbour search in
# `init_scene_from_points`: a chunk's (points, anchors, 3) differences take
# 1024 * 4096 * 3 float32, 48 MiB.
KNN_CHUNK = 1024


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class ColmapImage(NamedTuple):
    name: str
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            cam_id, model_id = _read(f, "ii")
            width, height = _read(f, "QQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = _read(f, "d" * nparams)
            if name in _TWO_FOCAL:
                fx, fy, cx, cy = params[:4]
            else:  # single-focal models
                fx = fy = params[0]
                cx, cy = params[1], params[2]
            out[cam_id] = ColmapCamera(name, int(width), int(height), fx, fy,
                                       cx, cy)
    return out


def read_images_bin(path: str) -> List[ColmapImage]:
    """The images' poses, sorted by file name."""
    out = []
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            _read(f, "i")  # image id
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            (camera_id,) = _read(f, "i")
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (npts,) = _read(f, "Q")
            f.seek(npts * 24, os.SEEK_CUR)  # (x, y double) + point3D_id int64
            out.append(ColmapImage(name.decode("utf-8"), qvec, tvec,
                                   camera_id))
    out.sort(key=lambda im: im.name)
    return out


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N, 3) float32, rgb (N, 3) float32 in [0, 1])."""
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    pos = 8
    for i in range(num):
        # point id, xyz, rgb, reprojection error, track length
        rec = struct.unpack_from("<QdddBBBdQ", data, pos)
        xyz[i], rgb[i] = rec[1:4], rec[4:7]
        pos += 51 + rec[8] * 8  # (image_id, point2D_idx) int32 per track
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(rot: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation matrix: the
    inverse of `qvec_to_rotmat`, for writing poses (Shepperd's method, from
    the largest of the four diagonal combinations)."""
    m = np.asarray(rot, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    i = int(np.argmax([tr, m[0, 0], m[1, 1], m[2, 2]]))
    if i == 0:
        s = 2.0 * np.sqrt(1.0 + tr)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif i == 1:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif i == 2:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q) / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _sparse_dir(scene_dir: str) -> str:
    for cand in ("sparse/0", "sparse", "."):
        p = os.path.join(scene_dir, cand)
        if os.path.exists(os.path.join(p, "cameras.bin")):
            return p
    raise FileNotFoundError(
        f"no cameras.bin under {scene_dir}/sparse[/0]: not a COLMAP scene")


def is_colmap_dir(scene_dir: str) -> bool:
    try:
        _sparse_dir(scene_dir)
        return True
    except FileNotFoundError:
        return False


def load_colmap(scene_dir: str, images_subdir: str = "images",
                downscale: int = 1, device="cpu"):
    """Read a COLMAP scene directory into a `Dataset` on `device` (what
    `train --data` consumes) plus the SfM point cloud.

    Returns (Dataset, xyz (N, 3), rgb (N, 3)), numpy point arrays that are
    None when points3D.bin is absent. `downscale` averages the images over
    integer blocks and divides the intrinsics: real captures are 4-8K."""
    from ..camera import make_camera
    from ..utils.image import load_png
    from .dataset import Dataset

    sp = _sparse_dir(scene_dir)
    cams = read_cameras_bin(os.path.join(sp, "cameras.bin"))
    images = read_images_bin(os.path.join(sp, "images.bin"))
    pts_path = os.path.join(sp, "points3D.bin")
    xyz = rgbp = None
    if os.path.exists(pts_path):
        xyz, rgbp = read_points3d_bin(pts_path)

    img_dir = os.path.join(scene_dir, images_subdir)
    cameras, frames = [], []
    for im in images:
        ic = cams[im.camera_id]
        w, h = ic.width // downscale, ic.height // downscale
        fx, fy = ic.fx / downscale, ic.fy / downscale
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = qvec_to_rotmat(im.qvec)
        view[:3, 3] = im.tvec
        cameras.append(make_camera(view, 2.0 * np.arctan(w / (2.0 * fx)),
                                   2.0 * np.arctan(h / (2.0 * fy)), w, h,
                                   device=device))
        img = load_png(os.path.join(img_dir, im.name))
        if downscale > 1:
            img = img[: h * downscale, : w * downscale]
            img = img.reshape(h, downscale, w, downscale, 3).mean((1, 3))
        frames.append(np.asarray(img, np.float32))
    ds = Dataset(cameras=cameras,
                 images=torch.from_numpy(np.stack(frames)).to(device))
    return ds, xyz, rgbp


def _mean_3nn(xyz: np.ndarray, device) -> np.ndarray:
    """Mean distance to the 3 nearest of up to 4096 anchors (the reference's
    random subset when there are more points), taken on `device` in chunks
    of points: the distances to all anchors of one chunk at a time, never
    the (N, 4096, 3) temporary. The squares sum in the reference's order."""
    n = xyz.shape[0]
    n_anchor = min(n, 4096)
    if n_anchor < n:
        sel = np.random.default_rng(0).choice(n, n_anchor, replace=False)
        anchors = xyz[sel]
    else:
        anchors = xyz
    k = min(3, max(1, n_anchor - 1))
    pts = torch.as_tensor(np.ascontiguousarray(xyz, np.float32),
                          device=device)
    anc = torch.as_tensor(np.ascontiguousarray(anchors, np.float32),
                          device=device)
    nearest = []
    for c0 in range(0, n, KNN_CHUNK):
        d = pts[c0:c0 + KNN_CHUNK, None, :] - anc[None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + (
            d[..., 2] * d[..., 2])
        d2 = torch.where(d2 <= 1e-12, torch.inf, d2)  # drop self-distance
        nearest.append(torch.topk(d2, k, dim=1, largest=False).values.cpu())
    d2k = torch.cat(nearest).numpy()
    return np.clip(np.sqrt(d2k).mean(axis=1), 1e-4, None)


def init_scene_from_points(xyz: np.ndarray, rgb: np.ndarray,
                           capacity: Optional[int] = None,
                           sh_degree: int = 3, device="cpu"):
    """The standard 3DGS initialization from SfM points: one Gaussian per
    point, isotropic log-scale from the mean 3-NN distance, opacity logit
    for alpha = 0.1, SH DC from the point colour; dead slots up to
    `capacity`."""
    from ..ops.sh import SH_C0
    from .gaussians import from_numpy, pad_to_capacity

    n = xyz.shape[0]
    nn = _mean_3nn(xyz, device)
    ksh = (sh_degree + 1) ** 2
    sh = np.zeros((n, ksh, 3), np.float32)
    sh[:, 0, :] = (rgb - 0.5) / SH_C0
    scene = from_numpy(dict(
        means=xyz,
        log_scales=np.log(nn)[:, None].repeat(3, 1),
        quats=np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        opacity_logits=np.full((n,), float(np.log(0.1 / 0.9)), np.float32),
        sh=sh), device=device)
    if capacity is not None and capacity > n:
        scene = pad_to_capacity(scene, capacity)
    return scene


_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                          ("error", "<f8"), ("track", "<u8")])  # packed


def write_colmap_bin(scene_dir: str, cams: Dict[int, ColmapCamera],
                     images: List[ColmapImage],
                     xyz: Optional[np.ndarray] = None,
                     rgb: Optional[np.ndarray] = None) -> str:
    """Write a minimal COLMAP sparse/0, byte for byte as the reference's
    writer: PINHOLE cameras, images without 2D points, points with
    reprojection error 1 and empty tracks."""
    sp = os.path.join(scene_dir, "sparse", "0")
    os.makedirs(sp, exist_ok=True)
    with open(os.path.join(sp, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            f.write(struct.pack("<ii", cid, 1))  # PINHOLE
            f.write(struct.pack("<QQ", c.width, c.height))
            f.write(struct.pack("<dddd", c.fx, c.fy, c.cx, c.cy))
    with open(os.path.join(sp, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for i, im in enumerate(images):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points
    if xyz is not None:
        rec = np.zeros(xyz.shape[0], _POINT_RECORD)
        rec["id"] = np.arange(1, xyz.shape[0] + 1)
        rec["xyz"] = np.asarray(xyz).astype(np.float64)
        rec["rgb"] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        rec["error"] = 1.0
        with open(os.path.join(sp, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", xyz.shape[0]))
            f.write(rec.tobytes())
    return sp
