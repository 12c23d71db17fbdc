"""Where the ellipsoid ray trace's time goes: counters from a build of its
kernel that counts, and the frame's device time by kernel name.

    python -m gsrast_tpu_torch.diag.ellipsoid_probe [--profile]
        [--width W --height H]

Builds `csrc/ellipsoids.cu` with `-DELLIPSOID_PROBE` alone by nvcc into
`_build/` (seconds: a plain C interface). On each cell of `chip_smoke.py`'s
phase 23 (trained_116k and the 1M SH-3 scene framed by their bboxes, a
camera inside trained_116k, a 1901x1061 image, both scenes with no
Gaussian above the cull) it runs the counting build once and prints one
JSON line: the pixel solves inside the image, the discriminants >= 0 and
the hits kept as keys, the share of lanes idle in the solve loop, per
block the busiest warp's cycles and solves against the block's mean (the
mean over blocks and the worst), the blocks' cycles (the busiest against
the mean), and the share of the trace's block cycles in each of its
phases (PHASES: the walk over the packed regions, staging, the units'
solves, the merge of keys, the rest). The counting build's image is held
to the plain version's. With `--profile` it then traces the ellipsoid
mode's frame of both scenes, eager and replayed through
`render.frame.FrameGraph`, with `torch.profiler`, and prints the device
time a frame by kernel name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

KERNEL_SRC = Path(__file__).parents[1] / "csrc" / "ellipsoids.cu"
PHASES = ("walk", "stage", "units", "merge", "rest")
WARP_FIELDS = ("cycles", "iterations", "active_lanes", "pixel_solves",
               "disc_hits", "key_hits")


def build():
    """The kernel's counting build, loaded with ctypes."""
    from gsrast_tpu_torch import _kernels

    path = _kernels.BUILD_DIR / "libgsrast_ellipsoid_probe.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                    "-DELLIPSOID_PROBE", "-shared", "-o", str(path),
                    str(KERNEL_SRC)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gsrast_ellipsoid_probe_shape.argtypes = [i32, i32, vp, vp]
    lib.gsrast_ellipsoid_probe_shape.restype = i32
    _kernels.set_ellipsoid_argtypes(lib)
    lib.gsrast_ellipsoid_probe.argtypes = [
        *_kernels.ELLIPSOID_INPUT_ARGTYPES, *[vp] * 5]
    lib.gsrast_ellipsoid_probe.restype = i32
    return lib


def run_counted(lib, act, cam, background) -> tuple:
    """(image, counters (blocks, record) int64) of one counted frame."""
    from gsrast_tpu_torch.viz import ellipsoids as E
    from gsrast_tpu_torch.viz.pointcloud import background_row

    dev = cam.device
    blocks, record = ctypes.c_int(), ctypes.c_int()
    assert lib.gsrast_ellipsoid_probe_shape(
        cam.height, cam.width, ctypes.byref(blocks),
        ctypes.byref(record)) == 0
    probe = torch.zeros((blocks.value, record.value), dtype=torch.int64,
                        device=dev)
    bg = background_row(tuple(float(v) for v in background), dev)
    launch = E.ellipsoids_launch(act, cam, bg)
    code = lib.gsrast_ellipsoid_probe(*launch.args, probe.data_ptr())
    assert code == 0, code
    torch.cuda.synchronize(dev)
    return launch.out, probe


def summarise(probe: torch.Tensor) -> dict:
    """The counters of module's docstring from the (blocks, record)
    records: per block [cycles, warps, PHASES' cycles, then WARP_FIELDS a
    warp]."""
    rec = probe.cpu().double()
    warps, first = int(rec[0, 1]), 2 + len(PHASES)
    w = rec[:, first:first + warps * len(WARP_FIELDS)].reshape(
        -1, warps, len(WARP_FIELDS))
    field = {name: w[:, :, i] for i, name in enumerate(WARP_FIELDS)}
    total = {name: float(v.sum()) for name, v in field.items()}
    busy = field["cycles"].sum(1) > 0  # blocks with any solve
    res = {"blocks": rec.shape[0], "warps_a_block": warps,
           "busy_blocks": int(busy.sum()),
           "pixel_solves": int(total["pixel_solves"]),
           "disc_hits": int(total["disc_hits"]),
           "key_hits": int(total["key_hits"]),
           "hit_share": (total["disc_hits"] / total["pixel_solves"]
                         if total["pixel_solves"] else 0.0),
           "idle_lane_share": (1.0 - total["active_lanes"]
                               / (32.0 * total["iterations"])
                               if total["iterations"] else 0.0)}
    for name in ("cycles", "pixel_solves"):
        v = field[name][busy]
        if len(v):
            ratio = v.max(1).values / v.mean(1).clamp(min=1e-9)
            res[f"busiest_warp_{name}_over_mean"] = [
                float(ratio.mean()), float(ratio.max())]
    cycles = rec[:, 0]
    res["phase_share"] = {name: float(rec[:, 2 + i].sum() / cycles.sum())
                          for i, name in enumerate(PHASES)}
    res["block_cycles_max_over_mean"] = float(cycles.max() / cycles.mean())
    res["block_cycles_mean"] = float(cycles.mean())
    res["block_cycles_max"] = float(cycles.max())
    return res


def cells(dev, width: int, height: int):
    """(name, activated scene, camera, background) of phase 23's cells."""
    import dataclasses as dc

    import numpy as np

    from gsrast_tpu_torch.camera import auto_frame, look_at
    from gsrast_tpu_torch.diag.frame_timing import frame_scenes

    scenes = frame_scenes(dev, width, height)
    bg = (0.1, 0.2, 0.3)
    act116 = scenes["trained_116k"][0].activated()
    act1m = scenes["1M"][0].activated()
    base116, base1m = scenes["trained_116k"][1], scenes["1M"][1]
    mn, mx = (x.cpu().numpy() for x in scenes["trained_116k"][0].bbox())
    center = 0.5 * (mn + mx)
    inside = base116.replace(view=look_at(center, center + np.array(
        [0.3, 0.1, 1.0], np.float32), device=dev))

    def culled(act):
        return dc.replace(act, opacities=torch.full_like(act.opacities,
                                                         0.29))

    return scenes, [
        ("trained_116k", act116, base116, (0.0, 0.0, 0.0)),
        ("1M", act1m, base1m, (0.0, 0.0, 0.0)),
        ("inside", act116, inside, (0.0, 0.0, 0.0)),
        ("edge", act116, auto_frame(mn, mx, 1901, 1061, device=dev), bg),
        ("culled", culled(act116), base116, bg),
        ("culled_1M", culled(act1m), base1m, bg)]


def counts(lib, act, cam, background, ref=None) -> dict:
    """One counted frame's summary, its image held to the plain version's
    (`ref`, else rendered here)."""
    from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids_torch

    img, probe = run_counted(lib, act, cam, background)
    if ref is None:
        ref = render_ellipsoids_torch(act, cam, background)
    res = summarise(probe)
    res["pixels_differ"] = int((img != ref).any(-1).sum())
    return res


def profile_frames(scenes) -> dict:
    """Device ms a frame by kernel name of the ellipsoid mode's frame,
    eager and replayed through FrameGraph, on each scene's orbit."""
    from torch.profiler import ProfilerActivity, profile

    from gsrast_tpu_torch.render.frame import FrameGraph
    from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids

    out = {}
    for name, (scene, _, views) in scenes.items():
        act = scene.activated()
        draw = lambda cam: render_ellipsoids(act, cam)  # noqa: E731
        graph = FrameGraph(draw, "ellipsoids", "cuda")
        for cam in views[:2]:  # the warm-up and the capture
            graph(cam)
        for kind, fn in (("eager", draw), ("graphed", graph)):
            fn(views[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for cam in views:
                    fn(cam)
                torch.cuda.synchronize()
            rows = []
            for ev in prof.key_averages():
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                if dev_us and ev.device_type.name == "CUDA":
                    rows.append([ev.key[:90], ev.count // len(views),
                                 dev_us / 1e3 / len(views)])
            rows.sort(key=lambda r: -r[2])
            out[f"{name}_{kind}"] = {
                "device_ms_a_frame": sum(r[2] for r in rows),
                "kernels_a_frame": sum(r[1] for r in rows),
                "by_name": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "ellipsoid_probe")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ellipsoid_probe: no CUDA device", file=sys.stderr)
        return 1
    from gsrast_tpu_torch.diag import turns

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(json.dumps({"card": turns.card()}), flush=True)
    lib = build()
    with torch.inference_mode():
        scenes, todo = cells(dev, args.width, args.height)
        for name, act, cam, bg in todo:
            res = counts(lib, act, cam, bg)
            print(json.dumps({"cell": name, **res}), flush=True)
        if args.profile:
            for key, res in profile_frames(scenes).items():
                print(json.dumps({"profile": key, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
