"""Where a step's device time goes: one eager step and one chained
replay of `bench`'s cells, and one eager and one graphed train step of the
train cells, profiled by `utils.profiling.trace` (`torch.profiler`).

    python -m gsrast_tpu_torch.diag.profile_step [--cells default,small,
        trained_116k,train_trained_116k,train_default,train_colmap]
        [--out DIR]
        [--device cuda|cpu]

For each bench cell (`bench`'s default 1M SH-3 scene at 1920x1080
fwd+bwd, `--small` and `--scene tests/fixtures/trained_116k.ply` at
1920x1080, each with `cli.bench_inputs`' config), after two warm-up steps
and the capture of a `benchmark.StepChain` of CHAIN steps and one replay,
it times TIMED unprofiled calls of each (`benchmark.timeit`), traces one
`bench_step` and then one replay, and prints one JSON line:
  * `eager`: the device kernels the step launched, the device-busy ms (the
    union of its kernels', copies' and fills' intervals), the unprofiled
    step's best and median ms, and the idle share against each (1 - busy
    / ms: the profiler's own host cost per op lengthens a traced eager
    step, so the traced window, from the step's start on the host to the
    end of its last device work, and its idle share are kept beside them
    as `traced_window_ms` and `traced_idle_share`); and per forward stage
    of `render.pipeline.STAGES` its kernels and busy ms, the backward's
    kernels counted to the stage whose forward made the autograd node that
    launched them (by the trace's sequence numbers), the rest (activation,
    image assembly, the bench's mean(img^2) and glue) as `other`, whose
    device work `other_by_name` lists by name ([name, count, busy ms] a
    step, the OTHER_TOP busiest);
  * `chained`: the same numbers of a replay divided by the chain. A replay
    has no host ops, so it has no stage split.
A train cell (`train_cell`: trained_116k at 1920x1080 from the perturbed
start of chip_smoke.py's phase 8, the 1M SH-3 scene of its phase 10, and
the COLMAP scene of its phase 12 made in memory)
is profiled the same way with the train step (`trainer.make_train_step`:
render, L1 + D-SSIM, backward, Adam, densify statistics) as `eager`, its
split adding a `loss` stage (the `train.loss` range around `rgb_loss`,
its backward counted as the render stages' are; `other` is then Adam,
image assembly and glue), and as `graphed` one replay of its
`trainer.TrainGraph`, after the graph's
warm-up and capture and two eager steps; `kernel_diff` holds each kernel
name whose count differs between the two traces, as [eager, graphed].
On a CPU run no device events exist and every device number is 0: the
script is meant for the card, and `--device cpu` only checks its control
flow. The traces go to `<out>/<cell>_{eager,chained,graphed}/trace.json`.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
from typing import Optional

import torch

from .. import config as cfg
from ..render.pipeline import STAGES
from ..scene.gaussians import GaussianScene
from ..train.trainer import (TrainConfig, TrainGraph, TrainState,
                             init_train_state, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# name: (n, width, height, scene), as `bench` takes them.
CELLS = {
    "default": (1_000_000, 1920, 1080, None),
    "small": (100_000, 800, 800, None),
    "trained_116k": (0, 1920, 1080, os.path.join(
        ROOT, "tests", "fixtures", "trained_116k.ply")),
}
CHAIN = 8  # steps of the chained replay, as phase 15 of chip_smoke.py
TIMED = 10  # unprofiled calls timed of each part, as `bench --iters`
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The host ranges a step's kernels are split by, range name -> stage: the
# forward's stages (`render.pipeline.span`) and, in a train step, the loss
# (`train.loss`, `trainer.make_train_step`).
RENDER_RANGES = {f"render.{s}": s for s in STAGES}
TRAIN_RANGES = {**RENDER_RANGES, "train.loss": "loss"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# `other`'s device work by name: the OTHER_TOP names of most busy ms, each
# without "void " and "at::native::" and cut to NAME_CHARS characters.
OTHER_TOP = 12
NAME_CHARS = 160


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _ranges(events, pred) -> list:
    return [(e["tid"], e["ts"], e["ts"] + e["dur"], e) for e in events
            if e.get("ph") == "X" and pred(e)]


def _inside(ranges, tid, ts):
    for rtid, a, b, e in ranges:
        if rtid == tid and a <= ts <= b:
            return e
    return None


def _device_events(events: list, marker: str) -> tuple:
    """(the host range `marker`, the device events traced after it
    began)."""
    (mark,) = [e for e in events if e.get("name") == marker
               and e.get("cat") == "user_annotation"]
    return mark, [e for e in events if e.get("cat") in DEVICE_CATS
                  and e["ts"] >= mark["ts"]]


def kernel_names(events: list, marker: str) -> collections.Counter:
    """The kernels traced after the host range `marker` began, counted by
    name."""
    return collections.Counter(e["name"] for e in
                               _device_events(events, marker)[1]
                               if e["cat"] == "kernel")


def summarize(events: list, marker: str, steps: int = 1,
              split: bool = True, ranges: dict = RENDER_RANGES) -> dict:
    """The device work traced after the host range `marker` began (see the
    module docstring), per step of `steps`."""
    mark, device = _device_events(events, marker)
    start = mark["ts"]
    kernels = [e for e in device if e["cat"] == "kernel"]
    end = max([e["ts"] + e["dur"] for e in device]
              + [mark["ts"] + mark["dur"]])
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in device)
    window = (end - start) / 1e3
    out = {"kernels": len(kernels) / steps, "busy_ms": busy / steps,
           "traced_window_ms": window / steps,
           "traced_idle_share": 1.0 - busy / window if window > 0 else 0.0}
    if not split:
        return out
    # The stage ranges of `ranges`; the autograd nodes made inside each (by
    # sequence number), whose backward ranges launch that stage's kernels.
    # A forward op ("Fwd thread id" 0) that makes no node carries the
    # number the next node will take, so a number's node is made by the
    # last forward op that carries it.
    stage_of = ranges
    stage_ranges = _ranges(events, lambda e: e.get("name") in stage_of)
    seq_stage = {}
    for e in sorted(events, key=lambda e: e.get("ts", 0.0)):
        args = e.get("args", {})
        seq = args.get("Sequence number")
        if e.get("cat") == "cpu_op" and seq is not None and (
                args.get("Fwd thread id", 0) == 0):
            owner = _inside(stage_ranges, e["tid"], e["ts"])
            seq_stage[seq] = ("other" if owner is None
                              else stage_of[owner["name"]])
    backward = _ranges(events, lambda e: "evaluate_function" in e["name"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    stages = {s: [] for s in (*stage_of.values(), "other")}
    for k in device:
        launch = launches.get(k.get("args", {}).get("correlation"))
        stage = "other"
        if launch is not None:
            owner = _inside(stage_ranges, launch["tid"], launch["ts"])
            if owner is not None:
                stage = stage_of[owner["name"]]
            else:
                node = _inside(backward, launch["tid"], launch["ts"])
                if node is not None:
                    stage = seq_stage.get(
                        node["args"].get("Sequence number"), "other")
        stages[stage].append(k)
    out["stages"] = {s: {"kernels": sum(e["cat"] == "kernel" for e in ks),
                         "busy_ms": _union_ms((e["ts"], e["ts"] + e["dur"])
                                              for e in ks)}
                     for s, ks in stages.items()}
    by_name = collections.defaultdict(list)
    for e in stages["other"]:
        by_name[e["name"]].append(e)
    out["other_by_name"] = sorted(
        ([name.removeprefix("void ").replace("at::native::", "")[
            :NAME_CHARS], len(es) / steps, _union_ms(
            (e["ts"], e["ts"] + e["dur"]) for e in es) / steps]
         for name, es in by_name.items()), key=lambda x: -x[2])[:OTHER_TOP]
    return out


def _profile_parts(name: str, parts: tuple, out_dir: str, device,
                   ranges: dict = RENDER_RANGES) -> dict:
    """Time and trace each (label, fn, steps a call, split) of `parts`
    (see the module docstring), split by `ranges`; returns {label:
    numbers}."""
    from .. import benchmark
    from ..utils.profiling import trace

    res = {}
    for label, fn, per, split in parts:
        best, median = (t / per for t in benchmark.timeit(fn, TIMED, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logdir = os.path.join(out_dir, f"{name}_{label}")
        with trace(logdir):
            with torch.profiler.record_function(f"profile.{label}"):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        part = summarize(events, f"profile.{label}", per, split, ranges)
        part.update(ms=[best, median], idle_share=[
            1.0 - part["busy_ms"] / t for t in (best, median)])
        res[label] = part
    return res


def profile_cell(name: str, out_dir: str, device) -> dict:
    from .. import benchmark
    from ..cli import bench_inputs

    n, width, height, scene_path = CELLS[name]
    backend = "cuda" if device.type == "cuda" else "torch"
    scene, camera, rcfg = bench_inputs(n, width, height, scene_path,
                                       backend, device)
    steps = benchmark.StepChain(scene, camera, rcfg, chain=CHAIN)
    steps()
    for _ in range(2):
        benchmark.bench_step(scene, camera, rcfg)
    res = {"cell": name, "gaussians": scene.capacity, "width": width,
           "height": height, "tile": [rcfg.tile_h, rcfg.tile_w],
           "chain": steps.chain, "captured": steps.captures == 1}
    res.update(_profile_parts(name, (
        ("eager", lambda: benchmark.bench_step(scene, camera, rcfg), 1,
         True),
        ("chained", steps, steps.chain, False)), out_dir, device))
    return res


# The train step's cells: name -> (n, width, height, scene), n = 0 for the
# scene's own count; `train_colmap` makes its COLMAP scene from the scene.
TRAIN_CELLS = {
    "train_trained_116k": CELLS["trained_116k"],
    "train_default": CELLS["default"],
    "train_colmap": CELLS["trained_116k"],
}
COLMAP_VIEWS = 8  # the orbit views of `train_colmap`, as chip_smoke.py's
#                   phase 12 writes them


@dataclasses.dataclass
class TrainCell:
    """A train cell's start and inputs: `scene` stays as it was made, and
    each `state()` trains a copy of it."""

    scene: GaussianScene
    views: list
    targets: list
    rcfg: cfg.RenderConfig
    tc: TrainConfig
    extent: float

    def state(self) -> TrainState:
        """A fresh TrainState on a copy of the start."""
        copy = GaussianScene(*(p.detach().clone() for p in
                               self.scene.param_groups().values()),
                             self.scene.mask.clone())
        return init_train_state(copy, self.tc, self.extent)


def train_cell(name: str, device) -> TrainCell:
    """The train cell `name` of TRAIN_CELLS on `device`:
      * `train_trained_116k`: trained_116k framed by its bbox, the target
        its own render, the start its means moved by N(0, (0.015 d)^2) (d
        its bbox diagonal: the reference's 0.03 on a scene in [-1, 1]^3)
        and its opacity logits - 0.5, in 4,096 more slots; config from the
        scene with margin 1.5; densify at step 10 (chip_smoke.py phase 8);
      * `train_default`: the bench's 1M SH-3 scene and camera, the target
        0.25 grey, config from the scene, the reference's TrainConfig
        (chip_smoke.py phase 10);
      * `train_colmap`: chip_smoke.py phase 12's COLMAP scene made in
        memory (no files, so no 8-bit photos): the SfM init of the scene's
        points with their DC colours, COLMAP_VIEWS orbit views at fov_y 1
        around its bbox, the scene's renders from them the photos, config
        from the init at view 0 with margin 1.5, the reference's
        TrainConfig; the profile steps on view 0."""
    import numpy as np

    from .. import benchmark
    from ..camera import auto_frame
    from ..render.api import auto_render_config, render
    from ..scene.gaussians import from_numpy, pad_to_capacity
    from ..scene.ply import load_ply

    n, width, height, scene_path = TRAIN_CELLS[name]
    if name == "train_colmap":
        return _colmap_cell(scene_path, width, height, device)
    if scene_path is None:
        scene, camera = benchmark.bench_scene_camera(
            n, width, height, device=device)
        rcfg = auto_render_config(scene, camera)
        target = torch.full((height, width, 3), 0.25, device=device)
        tc = TrainConfig()
        extent = scene_extent(scene)
    else:
        base = load_ply(scene_path, device=device)
        camera = auto_frame(*base.bbox(), width, height, device=device)
        rcfg = auto_render_config(base, camera, margin=1.5)
        with torch.no_grad():
            target = render(base, camera, rcfg).image
        extent = scene_extent(base)
        arrays = {f: p.detach().cpu().numpy()
                  for f, p in base.param_groups().items()}
        arrays["means"] = arrays["means"] + 0.03 * 0.5 * extent * (
            np.random.default_rng(2).standard_normal(arrays["means"].shape))
        arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
        scene = pad_to_capacity(from_numpy(arrays, device=device),
                                base.capacity + 4096)
        tc = TrainConfig(densify_from=10, densify_until=10, densify_every=10)
    return TrainCell(scene, [camera], [target], rcfg, tc, extent)


def colmap_views(base: GaussianScene, width: int, height: int, n: int,
                 device) -> tuple:
    """The COLMAP scene's cameras of `base` (chip_smoke.py phase 12):
    (n orbit cameras at fov_y 1 around its bbox, 1.1 diagonals out,
    fov_x, fov_y)."""
    import numpy as np

    from ..scene.dataset import orbit_cameras

    mn, mx = (x.cpu().numpy() for x in base.bbox())
    fov_y = 1.0
    fov_x = float(2.0 * np.arctan(np.tan(fov_y / 2) * width / height))
    views = orbit_cameras((mn + mx) / 2, float(np.linalg.norm(mx - mn)) * 1.1,
                          width, height, n, fov_x=fov_x, fov_y=fov_y,
                          device=device)
    return views, fov_x, fov_y


def _colmap_cell(scene_path: str, width: int, height: int,
                 device) -> TrainCell:
    """`train_colmap` of `train_cell`."""
    import numpy as np

    from ..ops.sh import SH_C0
    from ..render.api import auto_render_config, render
    from ..scene import colmap
    from ..scene.ply import load_ply

    base = load_ply(scene_path, device=device)
    views = colmap_views(base, width, height, COLMAP_VIEWS, device)[0]
    with torch.no_grad():
        rcfg_gt = auto_render_config(base, views[0])
        photos = [render(base, v, rcfg_gt).image for v in views]
    sh0 = base.sh.detach()[:, 0].cpu().numpy()
    init = colmap.init_scene_from_points(
        base.means.detach().cpu().numpy(),
        np.clip(sh0 * SH_C0 + 0.5, 0.0, 1.0), device=device)
    return TrainCell(init, views, photos,
                     auto_render_config(init, views[0], margin=1.5),
                     TrainConfig(), scene_extent(init))


def scene_extent(scene) -> float:
    """The length of the scene's bbox diagonal: the scene extent, as the
    CLI's `train` takes it."""
    import numpy as np

    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    return float(np.linalg.norm(mx - mn))


def profile_train_cell(name: str, out_dir: str, device) -> dict:
    cell = train_cell(name, device)
    state = cell.state()
    step = make_train_step(cell.rcfg, cell.tc, cell.extent)
    graph = TrainGraph(step)
    camera, target = cell.views[0], cell.targets[0]

    def eager():
        return step(state, camera, target)

    def graphed():
        return graph(state, camera, target)

    for fn in (graphed, graphed, eager, eager):  # warm-up, capture
        fn()
    res = {"cell": name, "gaussians": state.scene.capacity,
           "width": camera.width, "height": camera.height,
           "tile": [cell.rcfg.tile_h, cell.rcfg.tile_w],
           "captured": graph.captures == 1,
           "captured_launches": dict(graph.captured)}
    res.update(_profile_parts(name, (("eager", eager, 1, True),
                                     ("graphed", graphed, 1, False)),
                              out_dir, device, TRAIN_RANGES))
    names = {}
    for label in ("eager", "graphed"):
        with open(os.path.join(out_dir, f"{name}_{label}",
                               "trace.json")) as f:
            names[label] = kernel_names(json.load(f)["traceEvents"],
                                        f"profile.{label}")
    res["kernel_diff"] = {k: [names["eager"][k], names["graphed"][k]]
                          for k in sorted(names["eager"] | names["graphed"])
                          if names["eager"][k] != names["graphed"][k]}
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m gsrast_tpu_torch.diag.profile_step")
    names = (*CELLS, *TRAIN_CELLS)
    ap.add_argument("--cells", default=",".join(names),
                    help=f"comma-separated, of {', '.join(names)}")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "gsrast_tpu_torch", "_build", "profile"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..cli import _device

    device = _device(args.device)
    results = {}
    for name in args.cells.split(","):
        profile = profile_train_cell if name in TRAIN_CELLS else profile_cell
        results[name] = profile(name, args.out, device)
        print(json.dumps(results[name]), flush=True)
    return results


if __name__ == "__main__":
    main()
