"""Where a bench step's device time goes: one eager step and one chained
replay of `bench`'s cells, profiled by `utils.profiling.trace`
(`torch.profiler`).

    python -m gsrast_tpu_torch.diag.profile_step [--cells default,small,
        trained_116k] [--out DIR] [--device cuda|cpu]

For each cell (`bench`'s default 1M SH-3 scene at 1920x1080 fwd+bwd,
`--small` and `--scene tests/fixtures/trained_116k.ply` at 1920x1080, each
with `cli.bench_inputs`' config), after two warm-up steps and the capture
of a `benchmark.StepChain` of CHAIN steps and one replay, it times TIMED
unprofiled calls of each (`benchmark.timeit`), traces one `bench_step` and
then one replay, and prints one JSON line:
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
    image assembly, loss, optimizer-free glue) as `other`;
  * `chained`: the same numbers of a replay divided by the chain. A replay
    has no host ops, so it has no stage split.
On a CPU run no device events exist and every device number is 0: the
script is meant for the card, and `--device cpu` only checks its control
flow. The traces go to `<out>/<cell>_{eager,chained}/trace.json`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..render.pipeline import STAGES

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
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


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


def summarize(events: list, marker: str, steps: int = 1,
              split: bool = True) -> dict:
    """The device work traced after the host range `marker` began (see the
    module docstring), per step of `steps`."""
    (mark,) = [e for e in events if e.get("name") == marker
               and e.get("cat") == "user_annotation"]
    start = mark["ts"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] >= start]
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
    # The forward's stage ranges; the autograd nodes made inside each (by
    # sequence number), whose backward ranges launch that stage's kernels.
    # A forward op ("Fwd thread id" 0) that makes no node carries the
    # number the next node will take, so a number's node is made by the
    # last forward op that carries it.
    stage_of = {f"render.{s}": s for s in STAGES}
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
    stages = {s: [] for s in (*STAGES, "other")}
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
    return out


def profile_cell(name: str, out_dir: str, device) -> dict:
    from .. import benchmark
    from ..cli import bench_inputs
    from ..utils.profiling import trace

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
    for label, fn, split in (
            ("eager", lambda: benchmark.bench_step(scene, camera, rcfg),
             True),
            ("chained", steps, False)):
        per = 1 if label == "eager" else steps.chain
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
        part = summarize(events, f"profile.{label}", per, split)
        part.update(ms=[best, median], idle_share=[
            1.0 - part["busy_ms"] / t for t in (best, median)])
        res[label] = part
    return res


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m gsrast_tpu_torch.diag.profile_step")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help=f"comma-separated, of {', '.join(CELLS)}")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "gsrast_tpu_torch", "_build", "profile"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..cli import _device

    device = _device(args.device)
    results = {}
    for name in args.cells.split(","):
        results[name] = profile_cell(name, args.out, device)
        print(json.dumps(results[name]), flush=True)
    return results


if __name__ == "__main__":
    main()
