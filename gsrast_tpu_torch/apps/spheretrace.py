"""One movable, rotatable, scalable ellipsoid, ray-traced, with the
projection diagnostics for checking the rasterizer's math by hand:
camera-space position, 3D covariance, EWA 2D covariance, its eigenvalues
and the projected 3-sigma axes.

    python -m gsrast_tpu_torch.apps.spheretrace [--pos x y z]
        [--scale sx sy sz] [--rot-axis x y z --rot-deg d] [--out png]
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import cli
from ..camera import look_at, make_camera
from ..ops.covariance import compute_cov2d, compute_cov3d, quat_to_rotmat
from ..ops.projection import to_camera
from ..scene.gaussians import from_numpy
from ..utils.image import save_png
from ..viz.ellipsoids import render_ellipsoids


def axis_angle_quat(axis, deg) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    half = np.deg2rad(deg) / 2.0
    return np.concatenate([[np.cos(half)],
                           np.sin(half) * axis]).astype(np.float32)


def main(argv=None) -> dict:
    """Returns the diagnostics."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch.apps.spheretrace")
    ap.add_argument("--pos", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    ap.add_argument("--scale", type=float, nargs=3, default=[0.6, 0.3, 0.15])
    ap.add_argument("--rot-axis", type=float, nargs=3,
                    default=[0.0, 1.0, 0.0])
    ap.add_argument("--rot-deg", type=float, default=30.0)
    ap.add_argument("--out", default="spheretrace.png")
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)

    scene = from_numpy(dict(
        means=np.asarray([args.pos], np.float32),
        log_scales=np.log(np.asarray([args.scale], np.float32)),
        quats=axis_angle_quat(args.rot_axis, args.rot_deg)[None],
        opacity_logits=np.asarray([3.0], np.float32),  # sigmoid(3) ~ 0.95
        sh=np.asarray([1.0, 0.2, 0.2], np.float32).reshape(1, 1, 3)),
        device=device)
    camera = make_camera(look_at([0.0, 0.0, -3.0], args.pos, device=device),
                         1.2, 1.0, 512, 512, device=device)
    with torch.no_grad():
        act = scene.activated()
        img = render_ellipsoids(act, camera, background=(0.05, 0.05, 0.08))
        path = save_png(img, args.out)

        mean_cam = to_camera(act.means, camera.view)
        cov6 = compute_cov3d(act.scales, act.quats)
        cov2d = compute_cov2d(mean_cam, cov6, camera.view[:3, :3],
                              camera.focal_x, camera.focal_y,
                              camera.tan_fov_x, camera.tan_fov_y)[0]
        rot = quat_to_rotmat(act.quats)[0]
    a, b, c = (float(v) for v in cov2d)
    mid = 0.5 * (a + c)
    det = a * c - b * b
    disc = max(mid * mid - det, 0.0) ** 0.5
    lam1, lam2 = mid + disc, mid - disc
    theta = 0.5 * np.arctan2(2 * b, a - c)
    host = {"world_pos": act.means[0], "camera_pos": mean_cam[0],
            "rotation": rot, "cov3d": cov6[0]}
    host = {k: v.detach().cpu().numpy() for k, v in host.items()}
    print(f"spheretrace: wrote {path}")
    print(f"  world pos        : {host['world_pos']}")
    print(f"  camera-space pos : {host['camera_pos']} "
          f"(depth={float(host['camera_pos'][2]):.4f})")
    print(f"  rot matrix       :\n{host['rotation']}")
    print(f"  cov3d (upper6)   : {host['cov3d']}")
    print(f"  cov2d [a b c]    : [{a:.5f} {b:.5f} {c:.5f}] det={det:.6f}")
    print(f"  eigenvalues      : {lam1:.5f}, {lam2:.5f}")
    print(f"  projected axes   : major={3 * lam1 ** 0.5:.2f}px "
          f"minor={3 * lam2 ** 0.5:.2f}px angle={np.rad2deg(theta):.2f}deg"
          "  (3-sigma extents)")
    return {**host, "cov2d": (a, b, c), "eigenvalues": (lam1, lam2),
            "angle_deg": float(np.rad2deg(theta)), "image": img, "path": path}


if __name__ == "__main__":
    main()
