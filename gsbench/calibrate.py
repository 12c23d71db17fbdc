"""The readings that a cell's limits are set from (`gsbench/cells/<cell>.json`,
`limits`), on the card at the cell's own size:

  * the program's: its numbers on each of `--seeds`, set up and checked as a
    run does (a view cell's frames from a window of `--seconds`, keeping
    every `--keep-every`-th frame);
  * the control's, on each of `--control-seeds`: the reference in bfloat16,
    the precision below the configuration's float32, put in the program's
    place and compared with the float32 reference;
  * the planted faults', on the same seeds, in the reference put in the
    program's place: a train step whose loss leaves out half of the image's
    rows (the mean over the rest), and a viewer frame that is the one of
    the pose before (a stale frame). A step that leaves its state
    unchanged reads 1 by the change's measure and needs no run.

    python3 gsbench/calibrate.py --workload <cell> --seeds 1 2 ...
        --control-seeds 1 2 3 [--seconds 3] [--keep-every 150]

Prints one JSON line a seed and a last line with, per number, the largest
program reading and the smallest control and fault readings.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def _bf16(params: dict) -> dict:
    import torch

    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
            for k, v in params.items()}


def _f32(params: dict) -> dict:
    import torch

    return {k: v.to(torch.float32) for k, v in params.items()}


def train_readings(loop, control: bool) -> dict:
    import torch

    from gsbench.loops import common, train
    from gsbench.reference import train as ref_train

    out = {"program": loop.check()["compared"]}
    if not control:
        return out
    views, ref = loop.first, loop.ref
    targets = [loop.targets[k] for k in views]
    with common.exact_float32():
        low = ref_train.steps(
            _bf16(loop.start), [loop.ref_cam(k, torch.bfloat16)
                                for k in views],
            [t.to(torch.bfloat16) for t in targets], loop.plan,
            loop.sh_degree, loop.extent, loop.settings)
        low = {"losses": low["losses"], "first_grad": _f32(low["first_grad"]),
               "params": _f32(low["params"])}
        h = targets[0].shape[0] // 2

        def half(pred, target, weight):
            return ref_train.loss(pred[:h], target[:h], weight)

        half_batch = ref_train.steps(loop.start,
                                     [loop.ref_cams[k] for k in views],
                                     targets, loop.plan, loop.sh_degree,
                                     loop.extent, loop.settings,
                                     loss_fn=half)
    out["control"] = train.compare_steps(low, ref, loop.start)
    out["half_batch"] = train.compare_steps(half_batch, ref, loop.start)
    return out


def view_readings(loop, control: bool) -> dict:
    import torch

    from gsbench.loops import common
    from gsbench.reference import splat

    out = {"program": loop.check()["compared"]}
    if not control:
        return out
    low, stale = [], []
    with common.exact_float32():
        for k, ref in loop.ref_images.items():
            img = splat.render(_bf16(loop.params), loop.ref_cam(
                k, torch.bfloat16), loop.sh_degree, *loop.plan)[0].image
            low.append(float((img.float() - ref).abs().mean()))
            before = (k - 1) % len(loop.views)
            img = splat.render(loop.params, loop.ref_cams[before],
                               loop.sh_degree, *loop.plan)[0].image
            stale.append(float((img - ref).abs().mean()))
    out["control"] = {"frame_gap": max(low)}
    out["stale_frame"] = {"frame_gap": max(stale)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(prog="gsbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--keep-every", type=int, default=150)
    args = ap.parse_args()

    from gsbench import harness

    harness.set_caches()
    import torch

    cell = harness.load(args.workload)
    cell.traffic["keep_every"] = args.keep_every
    torch.cuda.set_device(0)
    readings = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        loop = harness.loop_class(cell)(cell, seed, "cuda")
        loop.setup()
        if loop.kind == "view":
            loop.window(args.seconds)
        loop.release()
        control = seed in args.control_seeds
        got = (train_readings if loop.kind == "train" else view_readings)(
            loop, control)
        got = {kind: {k: (v["value"] if isinstance(v, dict) else v)
                      for k, v in nums.items() if not k.startswith("_")}
               for kind, nums in got.items()}
        got["seed"], got["seconds"] = seed, time.perf_counter() - t0
        print(json.dumps(got), flush=True)
        readings.append(got)
        del loop
        torch.cuda.empty_cache()
    summary = {}
    for name in cell.settings["limits"]:
        summary[name] = {"program_max": max(r["program"][name]
                                            for r in readings)}
        for kind in ("control", "half_batch", "stale_frame"):
            vals = [r[kind][name] for r in readings
                    if name in r.get(kind, {})]
            if vals:
                summary[name][f"{kind}_min"] = min(vals)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
