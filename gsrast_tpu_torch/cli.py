"""Command-line entry points: `python -m gsrast_tpu_torch <command>` with
the commands `render`, `info`, `pose`, `train`, `make-dataset` and `bench`
of the reference CLI (`python -m gsrast_tpu`).

`render` draws a .ply in the three modes (`--mode gaussians|ellipsoids|
pointcloud`, and `--backend dense` for the tile-free oracle), `info` prints
the scene and camera reports (and one Gaussian's render state), `pose`
keeps named cameras in the pose store, which `render`, `info` and `train`
read with `--pose NAME [--store PATH]`. `bench` times the benchmark step
(`benchmark.py`) and prints its scene statistics, its stage table and one
JSON line. Every command runs on `--device cuda` unless `--device cpu` is
passed; without a card, cuda exits with an error rather than running on the
CPU. `--dist COORD:PORT,NPROCS,RANK` on every command joins a multi-process
run before anything else (`parallel.mesh.initialize_distributed`); as in
the reference it only bootstraps: the commands do not shard by themselves
(`parallel.sharded` does, and `diag/multihost_smoke.py` drives it).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import config as cfg

PORTED = ("render", "info", "pose", "train", "make-dataset", "bench")
MODES = ("gaussians", "ellipsoids", "pointcloud")
# The backends of `train` and `bench`, whose steps differentiate the render.
TILED_BACKENDS = ("cuda", "torch", "autograd")
TILED_HELP = ("'cuda' the blend kernels, 'torch' their plain versions, "
              "'autograd' the capped closed-form oracle (the reference's "
              "'xla'); default: 'cuda' on a CUDA device, else 'torch'")


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


def _add_dist(ap: argparse.ArgumentParser) -> None:
    """--dist, the multi-process bootstrap of every command."""
    ap.add_argument("--dist", default=None, metavar="COORD:PORT,NPROCS,RANK",
                    help="join a multi-process run (torch.distributed): "
                         "rank 0's address, the process count, this rank")


def _maybe_distributed(args, backend=None):
    """The multi-process bootstrap of `--dist`, before the first use of the
    device: the process-group backend is `backend`, or where None the one
    `initialize_distributed` chooses for `--device`. Returns it (None
    without --dist or for one process)."""
    if not getattr(args, "dist", None):
        return None
    from .parallel.mesh import initialize_distributed

    try:
        coord, nprocs, rank = args.dist.rsplit(",", 2)
        nprocs, rank = int(nprocs), int(rank)
    except ValueError:
        sys.exit(f"--dist {args.dist!r}: expected COORD:PORT,NPROCS,RANK")
    return initialize_distributed(coord, nprocs, rank, backend=backend,
                                  device=args.device)


def _add_view(ap: argparse.ArgumentParser, width=None, height=None) -> None:
    """The camera options: image size, a named pose, the store."""
    ap.add_argument("--width", type=int, default=width)
    ap.add_argument("--height", type=int, default=height)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--pose", default=None,
                    help="named pose from the pose store (default: frame "
                         "the scene's bbox)")
    ap.add_argument("--store", default="gsrast_store.json",
                    help="pose-store path")


def _load_scene(spec: str, device):
    """A .ply path, or 'random:N' (the port's seeded random scene)."""
    import numpy as np

    from .scene.gaussians import random_scene
    from .scene.ply import load_ply

    if spec.startswith("random:"):
        return random_scene(int(spec.split(":")[1]),
                            np.random.default_rng(0), device=device)
    return load_ply(spec, device=device)


def _camera(args, scene, device):
    """The pose `--pose` from the store at `--width` x `--height` (exits if
    it is not there), else the scene's bbox framed at that size."""
    from .camera import auto_frame
    from .utils.posedb import PoseDB

    width = args.width or cfg.DEFAULT_WIDTH
    height = args.height or cfg.DEFAULT_HEIGHT
    if args.pose:
        cam = PoseDB(path=args.store).load(args.pose, device=device)
        if cam is None:
            sys.exit(f"pose {args.pose!r} not found in {args.store}")
        return cam.replace(width=width, height=height)
    return auto_frame(*scene.bbox(), width, height, device=device)


def _render_cfg(args, scene, camera) -> cfg.RenderConfig:
    """`--backend dense`: the oracle's config; otherwise the product
    default (`auto_render_config`), whose backend follows the device unless
    `--backend` names one."""
    from .render.api import auto_render_config

    sh_degree = min(args.sh_degree, scene.sh_degree)
    if args.backend == "dense":
        return cfg.RenderConfig(backend="dense", sh_degree=sh_degree)
    rcfg = auto_render_config(scene, camera, backend=args.backend)
    return rcfg.replace(sh_degree=sh_degree)


def cmd_render(argv) -> torch.Tensor:
    """Render a .ply (or 'random:N') to PNG in one of the three modes;
    returns the (H, W, 3) image."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch render")
    ap.add_argument("scene")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--mode", default="gaussians", choices=MODES)
    ap.add_argument("--backend", default=None, choices=cfg.BACKENDS,
                    help="gaussians mode: 'cuda' the blend kernels (CUDA "
                         "devices only), 'torch' their plain PyTorch "
                         "versions on any device, 'autograd' the capped "
                         "closed-form oracle (the reference's 'xla'), "
                         "'dense' brute force; default: 'cuda' on a CUDA "
                         "device, else 'torch'")
    _add_view(ap, cfg.DEFAULT_WIDTH, cfg.DEFAULT_HEIGHT)
    _add_device(ap)
    _add_dist(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)
    _maybe_distributed(args)

    from .render.api import render
    from .utils.image import save_png
    from .viz.ellipsoids import render_ellipsoids
    from .viz.pointcloud import render_pointcloud

    with torch.inference_mode():
        scene = _load_scene(args.scene, device)
        camera = _camera(args, scene, device)
        t0 = time.perf_counter()
        if args.mode == "gaussians":
            img = render(scene, camera, _render_cfg(args, scene,
                                                    camera)).image
        elif args.mode == "ellipsoids":
            img = render_ellipsoids(scene.activated(), camera)
        else:
            img = render_pointcloud(scene.activated(), camera)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    path = save_png(img, args.out)
    n_pix = camera.width * camera.height
    print(f"{args.mode}: {camera.width}x{camera.height} on {device} in "
          f"{dt:.3f}s ({n_pix / dt / 1e6:.2f} Mpix/s incl. config and "
          f"kernel build) -> {path}")
    return img


def cmd_info(argv) -> dict:
    """Print the scene and camera reports as JSON, with `--gaussian i` also
    that Gaussian's render state; returns the report."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch info")
    ap.add_argument("scene")
    ap.add_argument("--gaussian", type=int, default=None,
                    help="one Gaussian's screen-space render state")
    _add_view(ap)
    _add_device(ap)
    _add_dist(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)
    _maybe_distributed(args)

    from .utils.inspector import camera_report, peek_gaussian, scene_report

    scene = _load_scene(args.scene, device)
    camera = _camera(args, scene, device)
    report = {"scene": scene_report(scene), "camera": camera_report(camera)}
    if args.gaussian is not None:
        report["gaussian"] = peek_gaussian(scene, camera, args.gaussian)
    print(json.dumps(report, indent=2, default=str))
    return report


def cmd_pose(argv):
    """Pose store: `list` (returns the names), `show NAME` (the pose's
    record, or None), `delete NAME` (whether it was there), `save NAME
    --scene PLY` (the scene framed, or `--pose`, at `--width` x `--height`;
    returns the camera)."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch pose")
    ap.add_argument("action", choices=["list", "save", "delete", "show"])
    ap.add_argument("name", nargs="?")
    ap.add_argument("--scene", default=None,
                    help="scene to frame when saving")
    _add_view(ap)
    _add_device(ap)
    _add_dist(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)
    _maybe_distributed(args)
    if args.action != "list" and not args.name:
        sys.exit(f"pose {args.action} requires a NAME")

    from .camera import pose_to_dict
    from .utils.posedb import PoseDB

    db = PoseDB(path=args.store)
    if args.action == "list":
        out = db.names()
        print(json.dumps(out))
    elif args.action == "show":
        cam = db.load(args.name, device=device)
        out = pose_to_dict(cam) if cam else None
        print(json.dumps(out, indent=2))
    elif args.action == "delete":
        out = db.delete(args.name)
        print(out)
    else:
        if not args.scene:
            sys.exit("pose save requires --scene to derive the framing")
        out = _camera(args, _load_scene(args.scene, device), device)
        db.save(args.name, out)
        print(f"saved {args.name!r}")
    return out


def _train_frames(args, scene, device):
    """(scene, frames, render config) of a `train` run: frames are
    (camera, target image) pairs, visited round robin."""
    from .render.api import auto_render_config, render
    from .utils.image import load_png

    def auto_cfg(camera):
        # The wide margin covers densification reshaping the tile counts;
        # a view that still overflows a tier counts it in overflow_tile_cap.
        rcfg = auto_render_config(scene, camera, margin=1.5,
                                  backend=args.backend)
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
    camera = _camera(args, scene, device)
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
    directory), on one target image (`--target`), or on its own render
    (from the bbox framing, or from `--pose` in the store). Render config
    from the first view with margin 1.5, L1 + D-SSIM, per-group Adam, the
    densify schedule, views round robin; the loop runs
    under `run_resilient` (a checkpoint at the start, every `--ckpt-every`
    steps and at the end; NaN rollback; SIGTERM checkpoint; heartbeat
    `<ckpt-dir>/heartbeat.json`). On a card with backend 'cuda' the step is
    captured once per image shape into a CUDA graph and replayed
    (`train.trainer.TrainGraph`, the reference's jitted step), with
    densify, checkpoints and rollbacks written into its tensors between
    replays; the other backends step eagerly and say why. `--steps` counts
    from 0, so a resumed run stops at the same step. Returns the final
    `TrainState`."""
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
    ap.add_argument("--backend", default=None, choices=TILED_BACKENDS,
                    help=TILED_HELP)
    _add_view(ap)
    _add_device(ap)
    _add_dist(ap)
    args = ap.parse_args(argv)
    if args.scene == "colmap" and not args.data:
        sys.exit("--scene colmap requires a COLMAP --data directory")
    device = _device(args.device)
    _maybe_distributed(args)

    import numpy as np

    from .benchmark import capture_refusal
    from .scene.gaussians import pad_to_capacity
    from .scene.ply import save_ply
    from .train import checkpoint as ckpt
    from .train.resilience import ResilienceConfig, run_resilient
    from .train.trainer import (TrainConfig, TrainGraph, init_train_state,
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
    graph = None
    if device.type == "cuda":
        refusal = capture_refusal(rcfg.backend)
        if refusal is None:
            step_fn = graph = TrainGraph(step_fn)
        else:
            print(f"train: backend {rcfg.backend!r} steps eagerly, not in "
                  f"a CUDA graph: {refusal}")

    def one_step(st, i):
        camera, target = frames[i % len(frames)]
        captures = graph.captures if graph else 0
        metrics = step_fn(st, camera, target)
        if graph is not None and graph.captures > captures:
            print(f"train: step captured in a CUDA graph ({camera.height} x "
                  f"{camera.width})")
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
    _add_dist(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)
    _maybe_distributed(args)

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


def bench_inputs(n: int, width: int, height: int, scene_spec, backend: str,
                 device) -> tuple:
    """`bench`'s (scene, camera, config): the bench scene of n Gaussians,
    or `scene_spec` (a .ply or 'random:N') framed by its bbox, at width x
    height, with `benchmark.bench_render_config` on `backend`."""
    from . import benchmark
    from .camera import auto_frame

    overrides = {}
    if scene_spec:
        scene = _load_scene(scene_spec, device)
        camera = auto_frame(*scene.bbox(), width, height, device=device)
        # The reference's legacy capacity for trained scenes' skew
        # (`gsrast_tpu/benchmark.py:128-129`); the tier plan ignores it.
        overrides["intersect_capacity_factor"] = max(
            64.0, 8e6 / scene.capacity)
    else:
        scene, camera = benchmark.bench_scene_camera(n, width, height,
                                                     device=device)
    rcfg = benchmark.bench_render_config(scene, camera, backend, **overrides)
    return scene, camera, rcfg


def cmd_bench(argv) -> dict:
    """The benchmark (`benchmark.py`, the one definition of the step that
    `chip_smoke.py` and the diag scripts time too): on the bench scene, or
    `--scene` framed by its bbox, print the scene statistics of its tile
    plan, the stage table unless `--no-stages`, and as the last line one
    JSON object, which it returns.

    `--chain K` > 1 times K data-dependent steps a call (the reference's
    `bench --chain`; `benchmark.StepChain`: on a card one CUDA graph
    replay, on the CPU an eager chain), prints the kernel launches per
    step that the capture recorded, and adds the root `bench.py`'s keys:
    `chained_ms` (the chained best per step; `best_ms`, `median_ms` and
    `value` are the chained ones too) and `per_dispatch_ms` /
    `per_dispatch_mpix_s` from one step a call over max(3, iters // 2)
    calls. Every JSON carries `chain`."""
    ap = argparse.ArgumentParser(prog="gsrast_tpu_torch bench")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scene", default=None,
                    help="bench a .ply (or 'random:N') framed by its bbox "
                         "instead of the bench scene; n is its capacity")
    ap.add_argument("--backend", default=None, choices=TILED_BACKENDS,
                    help=TILED_HELP)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chain", type=int, default=1,
                    help="steps chained per timed call (steady-state "
                         "timing: on a card K steps in one CUDA graph, one "
                         "replay a call; 1 = one step a call, its host "
                         "launches included)")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage table (headline only)")
    ap.add_argument("--small", action="store_true",
                    help="100k Gaussians at 800x800 (BASELINE config 2)")
    ap.add_argument("--fwd-only", action="store_true",
                    help="time the forward render alone")
    _add_device(ap)
    _add_dist(ap)
    args = ap.parse_args(argv)
    device = _device(args.device)
    _maybe_distributed(args)

    from . import benchmark

    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")
    if args.small:
        args.n, args.width, args.height = 100_000, 800, 800
    scene, camera, rcfg = bench_inputs(args.n, args.width, args.height,
                                       args.scene, backend, device)
    args.n = scene.capacity
    gh, gw = rcfg.grid_shape(args.height, args.width)
    stats = benchmark.scene_stats(scene, camera, rcfg)
    print(f"scene stats: tile {rcfg.tile_h}x{rcfg.tile_w} grid {gh}x{gw} "
          f"tiers={rcfg.tiers} {json.dumps(stats)}")
    if not args.no_stages:
        stages = benchmark.stage_table(scene, camera, rcfg, iters=args.iters)
        print(benchmark.format_stage_table(stages, args.width, args.height))
    steps = benchmark.StepChain(scene, camera, rcfg, args.fwd_only,
                                args.chain)
    best_ms, median_ms, mpix_s = benchmark.time_steps(steps, args.iters)
    mode = "fwd" if args.fwd_only else "fwd+bwd"
    result = {
        "metric": ("mpixels_per_s_per_chip_fwd" if args.fwd_only
                   else "mpixels_per_s_per_chip_fwd_bwd"),
        "n": args.n, "width": args.width, "height": args.height,
        "scene": args.scene, "backend": backend, "best_ms": best_ms,
        "value": mpix_s, "unit": "Mpixels/s/chip", "median_ms": median_ms,
        "iters": args.iters, "mode": mode,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "chain": steps.chain,
    }
    if steps.chain > 1:
        if steps.captures:
            per_step = {k: v / steps.chain for k, v in steps.captured.items()
                        if v}
            print(f"chain: {steps.chain} steps in one CUDA graph; kernel "
                  f"launches per step in the capture {json.dumps(per_step)}")
        else:
            print(f"chain: {steps.chain} steps a call, eagerly on {device}")
        pd_ms, _, pd_mpix = benchmark.run_bench(
            scene, camera, rcfg, fwd_only=args.fwd_only,
            iters=max(3, args.iters // 2))
        result.update(chained_ms=best_ms, per_dispatch_ms=pd_ms,
                      per_dispatch_mpix_s=pd_mpix)
    print(json.dumps(result))
    return result


COMMANDS = {"render": cmd_render, "info": cmd_info, "pose": cmd_pose,
            "train": cmd_train, "make-dataset": cmd_make_dataset,
            "bench": cmd_bench}


def main(argv=None):
    """Run one command; returns what it returns (`render`: the image;
    `info`: the report; `pose`: see `cmd_pose`; `train`: the final
    TrainState; `make-dataset`: the cameras; `bench`: its JSON object)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        view = "[--width W] [--height H] [--pose NAME [--store PATH]]"
        print("usage: python -m gsrast_tpu_torch render scene.ply "
              f"[--out PNG] [--mode {{{','.join(MODES)}}}] [--backend "
              f"{{{','.join(cfg.BACKENDS)}}}] {view} [--device DEV]\n"
              "       python -m gsrast_tpu_torch info scene.ply "
              f"[--gaussian I] {view} [--device DEV]\n"
              "       python -m gsrast_tpu_torch pose "
              "{list|save|delete|show} [NAME] [--scene PLY] [--store PATH] "
              "[--width W] [--height H] [--device DEV]\n"
              "       python -m gsrast_tpu_torch train --scene "
              "{scene.ply|random:N|colmap} [--data DIR [--downscale K] | "
              f"--target PNG] [--steps N] [--ckpt-dir DIR] [--resume] "
              f"[--save-ply PLY] [--backend {{{','.join(TILED_BACKENDS)}}}] "
              f"{view} [--device DEV]\n"
              "       python -m gsrast_tpu_torch make-dataset scene.ply "
              "--out DIR [--views N] [--width W] [--height H] "
              "[--device DEV]\n"
              "       python -m gsrast_tpu_torch bench [--n N] [--width W] "
              "[--height H] [--scene PLY|random:N] [--backend "
              f"{{{','.join(TILED_BACKENDS)}}}] "
              "[--iters K] [--chain K] [--no-stages] [--small] [--fwd-only] "
              "[--device DEV]\n"
              "every command also takes [--dist COORD:PORT,NPROCS,RANK]")
        return
    cmd = argv[0]
    if cmd not in COMMANDS:
        sys.exit(f"unknown command {cmd!r}; expected one of {list(PORTED)}")
    return COMMANDS[cmd](argv[1:])
