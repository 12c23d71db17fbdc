"""Command-line entry points: `python -m gsrast_tpu_torch render scene.ply`
and `python -m gsrast_tpu_torch train --scene scene.ply`.

`render --mode gaussians` and `train` (with the reference's self-distillation
demo as its target) are ported; the other commands, modes and `train`
inputs of the reference CLI (`python -m gsrast_tpu`) exit with an error.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import config as cfg

PORTED = ("render", "train")
NOT_PORTED = ("info", "pose", "make-dataset", "bench")
# Reference `train` options this port does not serve yet: a target image
# or a multi-view dataset, named poses, multi-host runs.
TRAIN_NOT_PORTED = ("--target", "--data", "--downscale", "--pose", "--store",
                    "--dist")


def _device(name) -> torch.device:
    return torch.device(name or ("cuda" if torch.cuda.is_available()
                                 else "cpu"))


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when available, "
                         "else cpu)")
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


def cmd_train(argv):
    """Train a scene on its own render (the reference's self-distillation
    demo): auto-framed camera, auto render config with margin 1.5, L1 +
    D-SSIM, per-group Adam, densify schedule, checkpoints every
    `--ckpt-every` steps and at the end. `--steps` counts from 0, so a
    resumed run stops at the same step. Returns the final `TrainState`."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch train")
    ap.add_argument("--scene", required=True,
                    help=".ply initialization or 'random:N'")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when available, "
                         "else cpu)")
    for flag in TRAIN_NOT_PORTED:
        ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in TRAIN_NOT_PORTED:
        if getattr(args, flag[2:]) is not None:
            sys.exit(f"train {flag} is not ported yet; without it, train "
                     "fits the scene to its own render")
    device = _device(args.device)

    import numpy as np

    from .camera import auto_frame
    from .render.api import auto_render_config, render
    from .scene.gaussians import pad_to_capacity, random_scene
    from .scene.ply import load_ply, save_ply
    from .train import checkpoint as ckpt
    from .train.trainer import (TrainConfig, init_train_state,
                                make_train_step, maybe_densify,
                                step_generator)

    if args.scene.startswith("random:"):
        scene = random_scene(int(args.scene.split(":")[1]),
                             np.random.default_rng(0), device=device)
    else:
        scene = load_ply(args.scene, device=device)
    camera = auto_frame(*scene.bbox(), args.width or cfg.DEFAULT_WIDTH,
                        args.height or cfg.DEFAULT_HEIGHT, device=device)
    rcfg = auto_render_config(scene, camera, margin=1.5)
    rcfg = rcfg.replace(sh_degree=min(args.sh_degree, scene.sh_degree))
    with torch.no_grad():
        target = render(scene, camera, rcfg).image
    if args.capacity:
        scene = pad_to_capacity(scene, args.capacity)
    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    extent = float(np.linalg.norm(mx - mn)) or 1.0
    tc = TrainConfig()
    state = init_train_state(scene, tc, extent)
    if args.resume and ckpt.restore(args.ckpt_dir, state) is not None:
        print(f"resumed from step {state.step}")
    step_fn = make_train_step(rcfg, tc, extent)

    while state.step < args.steps:
        i = state.step
        metrics = step_fn(state, camera, target)
        maybe_densify(state, tc, step_generator(device, i), extent)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.5f} "
                  f"psnr={float(metrics['psnr']):.2f} "
                  f"active={int(metrics['num_active'])}")
        if args.ckpt_every and state.step % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, state)
    ckpt.save(args.ckpt_dir, state)
    if args.save_ply:
        save_ply(state.scene, args.save_ply)
        print(f"saved trained scene -> {args.save_ply}")
    print(f"done; checkpoints in {args.ckpt_dir}")
    return state


COMMANDS = {"render": cmd_render, "train": cmd_train}


def main(argv=None):
    """Run one command; returns what it returns (`render`: the image;
    `train`: the final TrainState)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gsrast_tpu_torch render scene.ply "
              "[--out PNG] [--width W] [--height H] [--device DEV]\n"
              "       python -m gsrast_tpu_torch train --scene scene.ply "
              "[--steps N] [--ckpt-dir DIR] [--resume] [--save-ply PLY] "
              "[--device DEV]")
        return
    cmd = argv[0]
    if cmd in NOT_PORTED:
        sys.exit(f"command {cmd!r} is not ported yet; ported: {list(PORTED)}")
    if cmd not in COMMANDS:
        sys.exit(f"unknown command {cmd!r}; expected one of {list(PORTED)}")
    return COMMANDS[cmd](argv[1:])
