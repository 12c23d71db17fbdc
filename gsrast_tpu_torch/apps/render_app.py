"""The viewer, offline: load a scene, frame its bbox, render frames along
an orbit (or a scripted first-person walk, `--flythrough`) in any of the
three modes, record frame statistics, write each frame as a PNG and print
the inspector's scene and camera reports. On a card every frame goes
through `render.frame.FrameGraph` (captured once per image shape and
replayed, as the reference jits its frame); on the CPU frames are drawn
eagerly.

    python -m gsrast_tpu_torch.apps.render_app scene.ply
        [--mode gaussians|ellipsoids|pointcloud] [--frames 8]
        [--outdir frames] [--width W --height H] [--flythrough]
        [--save-pose NAME [--store PATH]] [--device cpu]

Without the scene file a random 50k-Gaussian scene is drawn instead.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import cli
from ..camera import (auto_frame, fp_camera, fp_init, fp_look, fp_move,
                      fp_speed, look_at)
from ..render.api import auto_render_config, render
from ..render.frame import FrameGraph
from ..scene.gaussians import random_scene
from ..scene.ply import load_ply
from ..utils.image import save_png
from ..utils.inspector import FrameStats, camera_report, scene_report
from ..utils.posedb import PoseDB
from ..viz.ellipsoids import render_ellipsoids
from ..viz.pointcloud import render_pointcloud


def orbit_view(center, radius, angle, height=0.3, device="cpu"):
    eye = center + np.array([radius * np.sin(angle), -height * radius,
                             -radius * np.cos(angle)], np.float32)
    return look_at(eye, center, device=device)


def flythrough_views(center, radius, frames, width, height, device="cpu"):
    """The view matrices of a scripted first-person session: walk forward
    for half the frames, double the speed, look around, strafe."""
    st = fp_init(center + np.array([0.0, 0.0, -max(radius, 1e-3)]),
                 yaw=np.pi / 2, speed=radius, device=device)
    script = ([("move", 1.0, 0.0)] * (frames // 2) + [("speed", 2.0)]
              + [("look", 40.0, -10.0), ("move", 0.0, 1.0)])
    views = []
    for op in script:
        if op[0] == "move":
            st = fp_move(st, forward=op[1], strafe=op[2], dt=1 / 30)
        elif op[0] == "look":
            st = fp_look(st, op[1], op[2])
        else:
            st = fp_speed(st, op[1])
        views.append(fp_camera(st, width, height).view)
    return views[:frames]


def main(argv=None) -> dict:
    """Returns the frame statistics' report."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch.apps.render_app")
    ap.add_argument("scene", nargs="?", default="data.ply")
    ap.add_argument("--mode", default="gaussians", choices=cli.MODES)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--save-pose", default=None)
    ap.add_argument("--store", default="gsrast_store.json")
    ap.add_argument("--flythrough", action="store_true",
                    help="drive the first-person controller instead of the "
                         "orbit")
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)

    if os.path.exists(args.scene):
        scene = load_ply(args.scene, device=device)
    else:
        print(f"{args.scene} not found; using a 50k random scene")
        scene = random_scene(50_000, np.random.default_rng(0),
                             scale_range=(0.005, 0.03), device=device)
    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    base = auto_frame(mn, mx, args.width, args.height, device=device)
    center = 0.5 * (mn + mx)
    radius = float(np.linalg.norm(mx - mn))
    print("scene:", scene_report(scene))
    print("camera:", camera_report(base))
    if args.save_pose:
        PoseDB(path=args.store).save(args.save_pose, base)

    with torch.inference_mode():
        act = scene.activated()
        rcfg = (auto_render_config(scene, base) if args.mode == "gaussians"
                else None)

        def draw(cam):
            if args.mode == "gaussians":
                return render(act, cam, rcfg).image
            if args.mode == "ellipsoids":
                return render_ellipsoids(act, cam)
            return render_pointcloud(act, cam)

        frame = FrameGraph(draw, args.mode,
                           rcfg.backend if rcfg is not None else "cuda")

        if args.flythrough:
            views = flythrough_views(center, radius, args.frames, args.width,
                                     args.height, device)
        else:
            views = [orbit_view(center, max(radius, 1e-3),
                                2.0 * np.pi * i / max(args.frames, 1),
                                device=device)
                     for i in range(args.frames)]
        stats = FrameStats()
        os.makedirs(args.outdir, exist_ok=True)
        for i, view in enumerate(views):
            t0 = time.perf_counter()
            img = frame(base.replace(view=view))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats.record(time.perf_counter() - t0,
                         pixels=args.width * args.height)
            save_png(img, os.path.join(args.outdir, f"frame_{i:03d}.png"))
    report = stats.report()
    print("frames:", report)
    return report


if __name__ == "__main__":
    main()
