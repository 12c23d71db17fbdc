"""Intersection statistics of the bench scene's tile plan.

    python -m gsrast_tpu_torch.diag.scene_stats [--n 1000000] [--width 1920]
        [--height 1080] [--tile-h H --tile-w W] [--device cpu]

Counterpart of the reference's `scripts/scene_stats.py` over the port's
tier plan (`benchmark.scene_stats`): visible Gaussians, intersections,
tiles per Gaussian, tile segments and `overflow_tile_cap`. The tile shape
is the bench's (`benchmark.bench_render_config`) unless `--tile-h` or
`--tile-w` fixes it. For a .ply, `bench --scene PLY --no-stages` prints the
same statistics.
"""

from __future__ import annotations

import argparse
from typing import Optional

from .. import benchmark, cli


def main(argv: Optional[list] = None) -> dict:
    """Print the statistics, one per line, under the tile shape, grid and
    tiers; returns them."""
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "scene_stats")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--tile-h", type=int, default=None)
    ap.add_argument("--tile-w", type=int, default=None)
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)

    scene, camera = benchmark.bench_scene_camera(args.n, args.width,
                                                 args.height, device=device)
    shape = {k: v for k, v in (("tile_h", args.tile_h),
                               ("tile_w", args.tile_w)) if v is not None}
    backend = "cuda" if device.type == "cuda" else "torch"
    rcfg = benchmark.bench_render_config(scene, camera, backend, **shape)
    stats = benchmark.scene_stats(scene, camera, rcfg)
    gh, gw = rcfg.grid_shape(camera.height, camera.width)
    print(f"tile {rcfg.tile_h}x{rcfg.tile_w} grid {gh}x{gw} ({gh * gw} "
          f"tiles) tiers={rcfg.tiers}")
    for k, v in stats.items():
        print(f"  {k:28s} {v}")
    return stats


if __name__ == "__main__":
    main()
