"""Command-line entry point: `python -m gsrast_tpu_torch render scene.ply`.

Only `render --mode gaussians` is ported so far; the other commands and
modes of the reference CLI (`python -m gsrast_tpu`) exit with an error.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import config as cfg

PORTED = ("render",)
NOT_PORTED = ("info", "pose", "train", "make-dataset", "bench")


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
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))

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


def main(argv=None):
    """Run one command; returns what it returns (`render`: the image)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gsrast_tpu_torch render scene.ply "
              "[--out PNG] [--width W] [--height H] [--device DEV]")
        return
    cmd = argv[0]
    if cmd in NOT_PORTED:
        sys.exit(f"command {cmd!r} is not ported yet; ported: {list(PORTED)}")
    if cmd != "render":
        sys.exit(f"unknown command {cmd!r}; expected one of {list(PORTED)}")
    return cmd_render(argv[1:])
