"""Tile-shape sweep of the benchmark step on the bench scene.

    python -m gsrast_tpu_torch.diag.tile_sweep [--n 1000000] [--iters 4]
        [--fwd-only] [--shapes 8x32,16x32,...] [--device cpu]

Counterpart of the reference's `scripts/tile_sweep.py`: `benchmark.
run_bench` at each tile shape, its tier plan derived from the scene at that
shape (the tile does not grow: `auto_tile_w` off). The default shapes are
every tile of 256-2048 pixels that both blend kernels take
(`render.blend.kernel_footprint`); a shape they do not take is skipped, a
shape that fails prints FAILED and the sweep goes on, and the command then
exits 1. The 16x32 base of `auto_render_config` was picked on the TPU; this
sweep is how the card's own best shape is found.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from .. import benchmark, cli
from ..render.blend import TILE_PIXELS, kernel_footprint


def kernels_take(tile_h: int, tile_w: int) -> bool:
    """Whether both blend kernels take tiles of tile_h x tile_w."""
    try:
        for kernel in ("forward", "backward"):
            kernel_footprint(kernel, tile_h, tile_w)
    except ValueError:
        return False
    return True


# Every tile both kernels take (heights are multiples of 8), by pixels.
SHAPES = tuple(f"{h}x{p // h}" for p in TILE_PIXELS for h in range(8, p, 8)
               if p % h == 0 and kernels_take(h, p // h))


def main(argv: Optional[list] = None) -> dict:
    """Time each shape and print one line a shape; returns {shape: row},
    a row {"status": "ok", "best_ms", "median_ms", "mpix_s"}, {"status":
    "skipped"} or {"status": "failed", "error"}."""
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "tile_sweep")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    cli._add_device(ap)
    args = ap.parse_args(argv)
    device = cli._device(args.device)

    backend = "cuda" if device.type == "cuda" else "torch"
    scene, camera = benchmark.bench_scene_camera(args.n, args.width,
                                                 args.height, device=device)
    rows = {}
    for shape in args.shapes.split(","):
        th, tw = (int(x) for x in shape.split("x"))
        if not kernels_take(th, tw):
            rows[shape] = {"status": "skipped"}
            print(f"{shape:>6}: skipped (kernel footprint)", flush=True)
            continue
        try:
            rcfg = benchmark.bench_render_config(scene, camera, backend,
                                                 tile_h=th, tile_w=tw)
            best, median, mpix = benchmark.run_bench(
                scene, camera, rcfg, fwd_only=args.fwd_only, iters=args.iters)
        except Exception as e:  # report the shape, go on with the next
            rows[shape] = {"status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
            print(f"{shape:>6}: FAILED {rows[shape]['error']}", flush=True)
            continue
        rows[shape] = {"status": "ok", "best_ms": best, "median_ms": median,
                       "mpix_s": mpix}
        print(f"{shape:>6}: {best:9.3f} ms best, {median:9.3f} ms median, "
              f"{mpix:8.2f} Mpix/s ({'fwd' if args.fwd_only else 'fwd+bwd'}"
              f")", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(1 if any(row["status"] == "failed"
                      for row in main().values()) else 0)
