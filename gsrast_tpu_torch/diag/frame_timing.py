"""Time the viewer's frames of several checkouts in turns on one card, and
compare their images.

    python -m gsrast_tpu_torch.diag.frame_timing [--tree DIR ...]
        [--rounds R] [--reps K] [--kernel] [--no-frames]

Builds every tree's kernels at once (`diag/turns.py`), then runs the trees
in turns (in the order given and back, R times), each in a process of its
own that imports that tree's package: on trained_116k and the 1M SH-3
bench scene at 1920x1080, each framed by its bbox with an orbit of 8 views
as `apps/render_app.py` makes them, each mode's frame (render_app's draw:
the splats on the scene's tier plan, the ellipsoids, the point cloud) is
timed by CUDA events around each call (`benchmark.timeit`, a view a call,
K passes over the orbit after a warm-up call): drawn eagerly,
and, where the tree has `render/frame.py`, through its `FrameGraph` (after
its warm-up and capture). Each run prints one JSON line of best and median
ms per cell and kind; the first view's image of each cell is saved on the
tree's first run. With `--kernel`, each run also times the ellipsoid
kernel alone on each scene's base view (`ellipsoids_<scene>_kernel`: its
launches as its wrapper makes them ready, no torch op between; a tree from
before the kernel took the prologue gets `ellipsoid_terms` and
`camera_rays` computed first, outside the timing), cold (the tree's
`chip_smoke.cold_ms`: the L2 flushed before each launch, median of 10) and
warm (best and median of 10 after a warm-up); `--no-frames` times that
alone. Last, one JSON line a cell: per tree its runs' best and
median, and the pixels of its first view that differ from the first
tree's. A tree must lie inside this checkout (the parent: `git archive
HEAD chip_smoke.py gsrast_tpu_torch native tests/fixtures | tar -x -C
_archive/parent`). Default tree: this checkout.
"""

from __future__ import annotations

import argparse
import itertools
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
OUT = HERE / "gsrast_tpu_torch" / "_build" / "frame_timing"
FIXTURE_116K = HERE / "tests" / "fixtures" / "trained_116k.ply"
WIDTH, HEIGHT, VIEWS, N_1M = 1920, 1080, 8, 1_000_000


def tag(tree: Path) -> str:
    """The file name stem of a tree's outputs and readings under OUT."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def frame_scenes(dev, width: int = WIDTH, height: int = HEIGHT) -> dict:
    """name -> (scene, base camera, the orbit's cameras) as render_app
    makes them: trained_116k and the 1M SH-3 bench scene, each framed by
    its bbox, orbited in VIEWS views."""
    import numpy as np

    from gsrast_tpu_torch.apps.render_app import orbit_view
    from gsrast_tpu_torch.benchmark import bench_scene_camera
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.scene.ply import load_ply

    out = {}
    for name in ("trained_116k", "1M"):
        scene = (load_ply(str(FIXTURE_116K), device=dev)
                 if name == "trained_116k" else
                 bench_scene_camera(N_1M, width, height, device=dev)[0])
        mn, mx = (x.cpu().numpy() for x in scene.bbox())
        base = auto_frame(mn, mx, width, height, device=dev)
        center, radius = 0.5 * (mn + mx), float(np.linalg.norm(mx - mn))
        views = [base.replace(view=orbit_view(
            center, max(radius, 1e-3), 2.0 * np.pi * i / VIEWS,
            device=dev)) for i in range(VIEWS)]
        out[name] = (scene, base, views)
    return out


def frame_draws(scene, base) -> dict:
    """mode -> (draw, backend): render_app's draw of each mode, the
    splats on the scene's tier plan from the base view."""
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids
    from gsrast_tpu_torch.viz.pointcloud import render_pointcloud

    act = scene.activated()
    rcfg = auto_render_config(scene, base)
    return {"gaussians": (lambda cam: render(act, cam, rcfg).image,
                          rcfg.backend),
            "ellipsoids": (lambda cam: render_ellipsoids(act, cam), "cuda"),
            "pointcloud": (lambda cam: render_pointcloud(act, cam), "cuda")}


def kernel_launch(act, cam, dev):
    """The tree's ellipsoid kernel made ready on the base view: fn() runs
    its launches, out is the image they write."""
    from gsrast_tpu_torch.camera import camera_rays
    from gsrast_tpu_torch.viz import ellipsoids as E
    from gsrast_tpu_torch.viz.pointcloud import background_row

    bg = background_row((0.0, 0.0, 0.0), dev)
    try:
        launch = E.ellipsoids_launch(act, cam, bg)
    except TypeError:  # a tree whose kernel takes the torch prologue's terms
        pre = E.ellipsoid_terms(act, cam)
        _, dirs = camera_rays(cam)
        launch = E.ellipsoids_launch(pre, dirs, bg, cam.height, cam.width)
    return (lambda: launch.fn(*launch.args)), launch.out


def run_tree(tree: Path, reps: int, kernel: bool = False,
             frames: bool = True) -> None:
    """Time one tree's frames and kernel (run as a script, in a process of
    its own, so that the tree's package is the one imported)."""
    sys.path[0] = str(tree)
    import torch

    from gsrast_tpu_torch import _kernels, benchmark

    try:
        from gsrast_tpu_torch.render.frame import FrameGraph
    except ImportError:  # a tree from before the frame was captured
        FrameGraph = None
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    saved = OUT / f"{tag(tree)}.pt"
    keep = {} if not saved.exists() else None
    ms = {}
    with torch.inference_mode():
        for name, (scene, base, views) in frame_scenes(dev).items():
            if kernel:
                import chip_smoke

                fn, out = kernel_launch(scene.activated(), base, dev)
                key = f"ellipsoids_{name}_kernel"
                if keep is not None:
                    fn()
                    keep[key] = out.cpu()
                ms[key] = {"cold": chip_smoke.cold_ms(fn, dev),
                           "warm": benchmark.timeit(fn, 10, dev)}
            for mode, (draw, backend) in frame_draws(scene, base).items():
                if not frames:
                    continue
                key = f"{name}_{mode}"
                kinds = {"eager": draw}
                if FrameGraph is not None:
                    graph = FrameGraph(draw, mode, backend)
                    for cam in views[:2]:  # the warm-up and the capture
                        graph(cam)
                    kinds["graphed"] = graph
                if keep is not None:
                    keep[key] = draw(views[0]).cpu()
                ms[key] = {}
                for kind, fn in kinds.items():
                    cams = itertools.cycle(views)
                    ms[key][kind] = benchmark.timeit(
                        lambda: fn(next(cams)), reps * len(views), dev)
            del scene
            torch.cuda.empty_cache()
    if keep is not None:
        torch.save(keep, saved)
    line = json.dumps({"tree": str(tree), "reps": reps, "ms": ms})
    with open(OUT / f"{tag(tree)}.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


def summarise(trees) -> None:
    """One JSON line a cell: per tree its runs' best and median ms by kind
    and its first view's pixels that differ from the first tree's."""
    import torch

    first = torch.load(OUT / f"{tag(trees[0])}.pt")
    for key in first:
        res = {"cell": key, "trees": {}}
        for tree in trees:
            img = torch.load(OUT / f"{tag(tree)}.pt")[key]
            runs = [json.loads(line)["ms"][key] for line in
                    (OUT / f"{tag(tree)}.jsonl").read_text().splitlines()]
            res["trees"][str(tree.relative_to(HERE))] = {
                **{kind: [run[kind] for run in runs] for kind in runs[0]},
                "pixels_differ": int((img != first[key]).any(-1).sum())}
        print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "frame_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one; images compared with the "
                         "first's)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=2,
                    help="timed passes over the orbit a kind")
    ap.add_argument("--kernel", action="store_true",
                    help="also time the ellipsoid kernel alone")
    ap.add_argument("--no-frames", action="store_true",
                    help="time the ellipsoid kernel alone (with --kernel)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_tree(Path(args.worker), args.reps, args.kernel,
                 not args.no_frames)
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("frame_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("frame_timing: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    print(json.dumps({"card": turns.card(), "trees": [
        str(tree.relative_to(HERE)) for tree in turns.build(trees)]}),
        flush=True)
    flags = ["--reps", str(args.reps)] + ["--kernel"] * args.kernel + [
        "--no-frames"] * args.no_frames
    code = turns.in_turns(Path(__file__).resolve(), trees, flags,
                          rounds=args.rounds)
    if code == 0:
        summarise(trees)
    return code


if __name__ == "__main__":
    sys.exit(main())
