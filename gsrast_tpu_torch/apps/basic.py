"""The smallest end-to-end program: a 256-Gaussian random scene rendered
over an orange background to a PNG.

    python -m gsrast_tpu_torch.apps.basic [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import cli
from ..camera import look_at, make_camera
from ..render.api import auto_render_config, render
from ..scene.gaussians import random_scene
from ..utils.image import save_png


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch.apps.basic")
    ap.add_argument("out", nargs="?", default="basic.png")
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)
    scene = random_scene(256, np.random.default_rng(0), sh_degree=0,
                         scale_range=(0.02, 0.08), device=device)
    camera = make_camera(look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                                 device=device), 1.2, 1.0, 256, 256,
                         device=device)
    with torch.inference_mode():
        rcfg = auto_render_config(scene, camera).replace(
            background=(1.0, 0.5, 0.0))  # the orange clear colour
        img = render(scene, camera, rcfg).image
    path = save_png(img, args.out)
    print(f"basic: wrote {path}")
    return path


if __name__ == "__main__":
    main()
