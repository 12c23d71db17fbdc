"""Nested render targets: a small scene rendered into a 200x100 inner
target, composited into a 640x480 outer target through a `RenderStack`,
then blitted again scaled to 400x200.

    python -m gsrast_tpu_torch.apps.fbtest [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import cli
from ..camera import look_at, make_camera
from ..render.api import auto_render_config, render
from ..scene.gaussians import random_scene
from ..utils.compositor import RenderStack, blit
from ..utils.image import save_png


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch.apps.fbtest")
    ap.add_argument("out", nargs="?", default="fbtest.png")
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)
    scene = random_scene(128, np.random.default_rng(2), sh_degree=0,
                         scale_range=(0.03, 0.1), device=device)
    inner_cam = make_camera(look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                                    device=device), 1.4, 0.8, 200, 100,
                            device=device)
    with torch.inference_mode():
        inner = render(scene, inner_cam,
                       auto_render_config(scene, inner_cam)).image

    stack = RenderStack(480, 640, clear=(0.1, 0.1, 0.15), device=device)
    stack.push(100, 200, y=40, x=40)  # bind the offscreen target
    stack.draw(inner)                 # draw the scene into it
    stack.pop()                       # composite it into the outer target
    # and once more, scaled by nearest-neighbour resampling:
    stack.draw(lambda img: blit(img, inner, y=200, x=40,
                                scale_to=(200, 400)))
    path = save_png(stack.image, args.out)
    print(f"fbtest: wrote {path}")
    return path


if __name__ == "__main__":
    main()
