"""Command-line entry points: `python -m gsrast_tpu_torch render scene.ply`,
`python -m gsrast_tpu_torch train --scene scene.ply [--data DIR | --target
PNG]` and `python -m gsrast_tpu_torch make-dataset scene.ply --out DIR`.

`render --mode gaussians`, `train` (on a COLMAP or cameras.json dataset, a
target image, or the scene's own render) and `make-dataset` are ported; the
other commands, modes and `train` options of the reference CLI
(`python -m gsrast_tpu`) exit with an error. Every command runs on
`--device cuda` unless `--device cpu` is passed; without a card, cuda
exits with an error rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import config as cfg

PORTED = ("render", "train", "make-dataset")
NOT_PORTED = ("info", "pose", "bench")
# Reference `train` options this port does not serve yet: named poses from
# the pose store, multi-host runs.
TRAIN_NOT_PORTED = ("--pose", "--store", "--dist")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {name}: no CUDA device is available "
                 "(torch.cuda.is_available() is false); pass --device cpu "
                 "to run the plain PyTorch versions on the CPU")
    return device


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")


def _load_scene(spec: str, device):
    """A .ply path, or 'random:N' (the port's seeded random scene)."""
    import numpy as np

    from .scene.gaussians import random_scene
    from .scene.ply import load_ply

    if spec.startswith("random:"):
        return random_scene(int(spec.split(":")[1]),
                            np.random.default_rng(0), device=device)
    return load_ply(spec, device=device)


def cmd_render(argv) -> torch.Tensor:
    """Render a .ply to PNG; returns the (H, W, 3) image."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch render")
    ap.add_argument("scene")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--mode", default="gaussians",
                    choices=["gaussians", "ellipsoids", "pointcloud"])
    ap.add_argument("--width", type=int, default=cfg.DEFAULT_WIDTH)
    ap.add_argument("--height", type=int, default=cfg.DEFAULT_HEIGHT)
    ap.add_argument("--sh-degree", type=int, default=3)
    _add_device(ap)
    args = ap.parse_args(argv)
    if args.mode != "gaussians":
        sys.exit(f"render --mode {args.mode} is not ported yet; "
                 "use --mode gaussians")
    device = _device(args.device)

    from .camera import auto_frame
    from .render.api import auto_render_config, render
    from .scene.ply import load_ply
    from .utils.image import save_png

    with torch.inference_mode():
        scene = load_ply(args.scene, device=device)
        camera = auto_frame(*scene.bbox(), args.width, args.height,
                            device=device)
        t0 = time.perf_counter()
        rcfg = auto_render_config(scene, camera)
        rcfg = rcfg.replace(sh_degree=min(args.sh_degree, scene.sh_degree))
        img = render(scene, camera, rcfg).image
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    path = save_png(img, args.out)
    n_pix = camera.width * camera.height
    print(f"{args.mode}: {camera.width}x{camera.height} on {device} in "
          f"{dt:.3f}s ({n_pix / dt / 1e6:.2f} Mpix/s incl. config and "
          f"kernel build) -> {path}")
    return img


def _train_frames(args, scene, device):
    """(scene, frames, render config) of a `train` run: frames are
    (camera, target image) pairs, visited round robin."""
    from .camera import auto_frame
    from .render.api import auto_render_config, render
    from .utils.image import load_png

    def auto_cfg(camera):
        # The wide margin covers densification reshaping the tile counts;
        # a view that still overflows a tier counts it in overflow_tile_cap.
        rcfg = auto_render_config(scene, camera, margin=1.5)
        return rcfg.replace(sh_degree=min(args.sh_degree, scene.sh_degree))

    if args.data:
        from .scene.colmap import (init_scene_from_points, is_colmap_dir,
                                   load_colmap)
        from .scene.dataset import load_dataset

        if is_colmap_dir(args.data):
            ds, xyz, rgb = load_colmap(args.data, downscale=args.downscale,
                                       device=device)
            if scene is None:
                if xyz is None:
                    sys.exit("--scene colmap needs points3D.bin in --data")
                scene = init_scene_from_points(xyz, rgb, device=device)
                print(f"initialized {xyz.shape[0]} gaussians from COLMAP "
                      "SfM points")
        elif scene is None:
            sys.exit("--scene colmap requires a COLMAP --data directory")
        else:
            ds = load_dataset(args.data, device=device)
        frames = [(ds.cameras[i], ds.images[i]) for i in range(ds.num_frames)]
        print(f"dataset: {ds.num_frames} views {ds.cameras[0].width}x"
              f"{ds.cameras[0].height} from {args.data}")
        return scene, frames, auto_cfg(frames[0][0])
    camera = auto_frame(*scene.bbox(), args.width or cfg.DEFAULT_WIDTH,
                        args.height or cfg.DEFAULT_HEIGHT, device=device)
    if args.target:
        target = torch.from_numpy(load_png(args.target)).to(device)
        camera = camera.replace(width=target.shape[1], height=target.shape[0])
        return scene, [(camera, target)], auto_cfg(camera)
    rcfg = auto_cfg(camera)
    with torch.no_grad():  # self-distillation: fit the scene's own render
        target = render(scene, camera, rcfg).image
    return scene, [(camera, target)], rcfg


def cmd_train(argv):
    """Train a scene: on a multi-view dataset (`--data`: COLMAP, with
    `--scene colmap` initializing from its SfM points, or a cameras.json
    directory), on one target image (`--target`), or on its own render.
    Render config from the first view with margin 1.5, L1 + D-SSIM,
    per-group Adam, the densify schedule, views round robin; the loop runs
    under `run_resilient` (a checkpoint at the start, every `--ckpt-every`
    steps and at the end; NaN rollback; SIGTERM checkpoint; heartbeat
    `<ckpt-dir>/heartbeat.json`). `--steps` counts from 0, so a resumed run
    stops at the same step. Returns the final `TrainState`."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch train")
    ap.add_argument("--scene", required=True,
                    help=".ply initialization, 'random:N', or 'colmap' "
                         "(initialize from --data's SfM points3D.bin)")
    ap.add_argument("--data", default=None,
                    help="multi-view dataset directory: COLMAP "
                         "(sparse[/0]/cameras.bin + images/) or cameras.json "
                         "+ PNGs; one view per step, round robin")
    ap.add_argument("--downscale", type=int, default=1,
                    help="integer image downscale for COLMAP datasets")
    ap.add_argument("--target", default=None,
                    help="target image PNG for single-view fitting")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-ply", default=None,
                    help="write the trained scene as .ply when done")
    ap.add_argument("--capacity", type=int, default=None,
                    help="scene capacity (free slots for densification)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--sh-degree", type=int, default=3)
    _add_device(ap)
    for flag in TRAIN_NOT_PORTED:
        ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in TRAIN_NOT_PORTED:
        if getattr(args, flag[2:]) is not None:
            sys.exit(f"train {flag} is not ported yet")
    if args.scene == "colmap" and not args.data:
        sys.exit("--scene colmap requires a COLMAP --data directory")
    device = _device(args.device)

    import numpy as np

    from .scene.gaussians import pad_to_capacity
    from .scene.ply import save_ply
    from .train import checkpoint as ckpt
    from .train.resilience import ResilienceConfig, run_resilient
    from .train.trainer import (TrainConfig, init_train_state,
                                make_train_step, maybe_densify,
                                step_generator)

    scene = None if args.scene == "colmap" else _load_scene(args.scene,
                                                            device)
    scene, frames, rcfg = _train_frames(args, scene, device)
    if args.capacity:
        scene = pad_to_capacity(scene, args.capacity)
    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    extent = float(np.linalg.norm(mx - mn)) or 1.0
    tc = TrainConfig()
    state = init_train_state(scene, tc, extent)
    if args.resume and ckpt.restore(args.ckpt_dir, state) is not None:
        print(f"resumed from step {state.step}")
    step_fn = make_train_step(rcfg, tc, extent)

    def one_step(st, i):
        camera, target = frames[i % len(frames)]
        metrics = step_fn(st, camera, target)
        maybe_densify(st, tc, step_generator(device, i), extent)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.5f} "
                  f"psnr={float(metrics['psnr']):.2f} "
                  f"active={int(metrics['num_active'])}")
        return metrics

    rc = ResilienceConfig(ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every or 500,
                          heartbeat_path=f"{args.ckpt_dir}/heartbeat.json")
    state, stopped = run_resilient(state, args.steps, one_step, rc)
    if stopped:
        print("stopped early on preemption signal (checkpoint saved)")
    if args.save_ply:
        save_ply(state.scene, args.save_ply)
        print(f"saved trained scene -> {args.save_ply}")
    print(f"done; checkpoints in {args.ckpt_dir}")
    return state


def cmd_make_dataset(argv):
    """Render a scene from an orbit rig into a cameras.json dataset (the
    synthetic ground truth for `train --data`). Returns the cameras."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch make-dataset")
    ap.add_argument("scene", help=".ply scene (or 'random:N')")
    ap.add_argument("--out", required=True, help="dataset directory")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--sh-degree", type=int, default=3)
    _add_device(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)

    from .camera import auto_frame
    from .render.api import auto_render_config
    from .scene.dataset import render_synthetic_dataset

    scene = _load_scene(args.scene, device)
    width, height = args.width or 256, args.height or 256
    rcfg = auto_render_config(scene, auto_frame(*scene.bbox(), width, height,
                                                device=device), margin=1.5)
    rcfg = rcfg.replace(sh_degree=min(args.sh_degree, scene.sh_degree))
    path, cams = render_synthetic_dataset(scene, args.out,
                                          n_views=args.views, width=width,
                                          height=height, render_cfg=rcfg)
    print(f"wrote {len(cams)} views to {path}")
    return cams


COMMANDS = {"render": cmd_render, "train": cmd_train,
            "make-dataset": cmd_make_dataset}


def main(argv=None):
    """Run one command; returns what it returns (`render`: the image;
    `train`: the final TrainState; `make-dataset`: the cameras)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gsrast_tpu_torch render scene.ply "
              "[--out PNG] [--width W] [--height H] [--device DEV]\n"
              "       python -m gsrast_tpu_torch train --scene "
              "{scene.ply|random:N|colmap} [--data DIR [--downscale K] | "
              "--target PNG] [--steps N] [--ckpt-dir DIR] [--resume] "
              "[--save-ply PLY] [--device DEV]\n"
              "       python -m gsrast_tpu_torch make-dataset scene.ply "
              "--out DIR [--views N] [--width W] [--height H] "
              "[--device DEV]")
        return
    cmd = argv[0]
    if cmd in NOT_PORTED:
        sys.exit(f"command {cmd!r} is not ported yet; ported: {list(PORTED)}")
    if cmd not in COMMANDS:
        sys.exit(f"unknown command {cmd!r}; expected one of {list(PORTED)}")
    return COMMANDS[cmd](argv[1:])
