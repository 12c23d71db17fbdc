"""The tile plan on the card: its kernel (`csrc/plan.cu`) held to its plain
version, timed and bounded on the plan's cells, and several checkouts'
plans timed in turns.

    python -m gsrast_tpu_torch.diag.plan_timing [--tree DIR ...]
        [--rounds R] [--train]

The cells (`CELLS`, 1920x1080 unless stated): the 1M SH-3 bench scene
('1M', `bench`), trained_116k ('trained_116k', `bench --scene`), the
COLMAP SfM init at its first view ('colmap', `profile_step`'s
train_colmap) and `bench --small` ('small': 100,000 Gaussians at 800x800),
each with its own render config and one preprocess pass.

Builds every tree's kernels at once (`diag/turns.py`), then runs the trees
in turns (in the order given and back, R times), each in a process of its
own that imports that tree's package and times `binning.plan_tiers` as
that tree has it (a tree from before the kernel: its plain torch ops) on
each cell, cold (`cold_ms`: the L2 flushed before each call, median of
10) and warm (`warm_ms`: best and median of 20), both with the host's
launches hidden behind a spin kernel, eager (back to back, the host
included), and split into its device operations (`split`: each one's
device time and the gaps between them, by the profiler), with the binning
stage of one eager bench step at 1M and trained_116k (`binning_stage`:
kernels and busy ms by `profile_step`'s `render.binning` range). Each run prints one
JSON line; its plans are saved on the tree's first run, and at the end one
JSON line a cell gives each tree's runs and the plan's slots that differ
from the first tree's. With `--train`, each run also takes TRAIN_STEPS
graphed train steps on TRAIN_CELL (`train_params`), as torch runs them and
under its deterministic algorithms, and a last line gives, per tree, mode
and run, each parameter group's largest difference from the first tree's
first run (the first tree's other runs: its own spread). A tree must lie
inside this checkout (the parent: `git archive HEAD chip_smoke.py
gsrast_tpu_torch native tests/fixtures | tar -x -C _archive/parent`).
Default tree: this checkout.

`chip_smoke.py` phase 24 takes its cells, comparisons and timings from
here (`cell_inputs`, `compare`, `time_cell`, `launch_split`,
`binning_stage`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
OUT = HERE / "gsrast_tpu_torch" / "_build" / "plan_timing"
FIXTURE_116K = HERE / "tests" / "fixtures" / "trained_116k.ply"
CELLS = ("1M", "trained_116k", "colmap", "small")
STAGE_CELLS = ("1M", "trained_116k")  # binning_stage's cells
FIELDS = ("tile_key", "depth_key", "gauss", "order", "total",
          "overflow_tile_cap")
# The byte bound: a Gaussian's preprocess fields read once (rect 16 bytes,
# radius 4, depth 4, conic 12, opacity 4, mean2d 8), its `order` entry
# written once, a slot's three int32 written once, the two counts; at the
# H100 SXM's published HBM3 rate.
INPUT_BYTES = 48
ORDER_BYTES = 4
SLOT_BYTES = 12
COUNT_BYTES = 8
HBM_BPS = 3.35e12
L2_FLUSH_BYTES = 256 << 20  # written before each cold call: 5x the L2
# The spin before a timed call (about 2 ms at the H100's 1.98 GHz boost):
# longer than the host takes to enqueue the kernel's plan.
HIDE_CYCLES = 4_000_000
COLD_REPS = 10
WARM_REPS = 20
PLAIN_REPS = 5
SPLIT_REPS = 5
TRAIN_CELL = "train_trained_116k"  # `train_params`' cell (profile_step's)
TRAIN_STEPS = 10
TRAIN_MODES = ("atomic", "deterministic")  # `train_params` without and with
#                                             torch's deterministic algorithms
SPLIT_HIDE = 20_000_000  # about 10 ms: the profiler slows the host's launches
SPIN = "spin_kernel"  # torch.cuda._sleep's kernel
SPLIT_NAME = 60  # characters of a device operation's name kept


def cell_inputs(name: str, dev) -> tuple:
    """(scene, camera, render config) of the cell `name` of CELLS."""
    from gsrast_tpu_torch.cli import bench_inputs

    if name == "colmap":
        from gsrast_tpu_torch.diag import profile_step

        cell = profile_step.train_cell("train_colmap", dev)
        return cell.scene, cell.views[0], cell.rcfg
    n, width, height, scene = {
        "1M": (1_000_000, 1920, 1080, None),
        "trained_116k": (0, 1920, 1080, str(FIXTURE_116K)),
        "small": (100_000, 800, 800, None)}[name]
    return bench_inputs(n, width, height, scene, "cuda", dev)


def cell_prep(scene, camera, rcfg):
    """One preprocess pass, cut from the graph (what the plan takes)."""
    import torch

    from gsrast_tpu_torch.ops.preprocess import preprocess

    with torch.no_grad():
        return preprocess(scene.activated(), camera, rcfg).detach()


def differing(got, want) -> dict:
    """Per TierPlan field, the elements that differ (shapes must agree)."""
    out = {}
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)} "
                                 f"against {b.dtype} {tuple(b.shape)}")
        out[name] = int((a != b).sum())
    return out


def cull_differ(prep, cull) -> list:
    """[lam_min, cull_thresh]: the Gaussians whose value in the kernel's
    `cull` ((N, 2), `binning.plan_cull`) differs from `cull_bounds`' (NaN
    equal to NaN)."""
    import torch

    from gsrast_tpu_torch.ops import binning

    out = []
    for got, want in zip(cull.unbind(1), binning.cull_bounds(prep)):
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        out.append(int((~same).sum()))
    return out


def compare(prep, grid_h: int, grid_w: int, rcfg, **mode) -> dict:
    """The kernel's plan (two calls) against the plain version's on the
    same inputs, field by field, in the plan's `mode` (row-local or routed
    keywords of `plan_tiers`), and its cull values against `cull_bounds`
    (`cull_differ`)."""
    import torch

    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.ops import binning

    first = binning.plan_tiers_cuda(prep, grid_h, grid_w, rcfg, **mode)
    again = binning.plan_tiers_cuda(prep, grid_h, grid_w, rcfg, **mode)
    plain = binning.plan_tiers_torch(prep, grid_h, grid_w, rcfg, **mode)
    cull = binning.plan_cull(_kernels.load().lib, prep,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return {"differ": differing(first, plain),
            "repeat_differ": differing(first, again),
            "cull_differ": cull_differ(prep, cull),
            "max_abs_err": max(int((getattr(first, f).long() - getattr(
                plain, f).long()).abs().max()) if getattr(first, f).numel()
                else 0 for f in FIELDS),
            "slots": first.tile_key.numel(), "total": int(first.total),
            "overflow_tile_cap": int(first.overflow_tile_cap),
            "tiers": len(rcfg.tiers), "k_last": rcfg.tiers[-1][0]}


def plan_bytes(n: int, slots: int) -> int:
    return (INPUT_BYTES + ORDER_BYTES) * n + SLOT_BYTES * slots + COUNT_BYTES


def _timed(fn, before, reps: int, hide: bool) -> list:
    """Device ms of fn() by CUDA events around each of `reps` calls, each
    after before(); with `hide`, a spin kernel first holds the stream
    while the host enqueues fn's launches, so that the events time the
    device's work and not the host's (the plan's launches sit between torch
    calls on the host, as they do in a CUDA graph's capture)."""
    import torch

    fn()
    events = []
    for _ in range(reps):
        before()
        if hide:
            torch.cuda._sleep(HIDE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def cold_ms(fn, dev, reps: int = COLD_REPS, hide: bool = True) -> float:
    """Median device ms of fn(), each call after L2_FLUSH_BYTES written
    (the L2 holds none of its inputs) and, with `hide`, the host's
    launches hidden (`_timed`)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    return statistics.median(_timed(fn, flush.zero_, reps, hide))


def warm_ms(fn, reps: int = WARM_REPS, hide: bool = True) -> list:
    """[best, median] device ms of fn() back to back, each call timed
    alone, with `hide` the host's launches hidden (`_timed`); without it,
    what an eager caller waits for."""
    ms = _timed(fn, lambda: None, reps, hide)
    return [min(ms), statistics.median(ms)]


def time_cell(prep, grid_h: int, grid_w: int, rcfg, dev,
              plain: bool = True) -> dict:
    """The kernel's plan cold and warm (device ms, the host hidden) beside
    its byte bound, eager (best and median of back-to-back calls, the
    host's launches included), its device operations (`split`), its
    launches (`launch_split`), the rank launch's shape, and (with `plain`)
    the plain version's eager median (its cost is its launches)."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.ops import binning

    def fn():
        return binning.plan_tiers_cuda(prep, grid_h, grid_w, rcfg)

    plan = fn()
    n, slots = prep.depth.shape[0], plan.tile_key.numel()
    k_last = rcfg.tiers[-1][0]
    bound = plan_bytes(n, slots) / HBM_BPS * 1e3
    cold = cold_ms(fn, dev)
    res = {
        "n": n, "slots": slots, "total": int(plan.total),
        "tiers": len(rcfg.tiers), "k_last": k_last,
        "shape": binning.plan_shape(_kernels.load().lib, n, k_last)._asdict(),
        "cold_ms": cold, "warm_ms": warm_ms(fn),
        "eager_ms": warm_ms(fn, hide=False), "split": split(fn),
        "launches": launch_split(prep, grid_h, grid_w, rcfg),
        "bytes": plan_bytes(n, slots), "bound_ms": bound,
        "bound_by": "bytes", "share": bound / cold}
    if plain:
        res["plain_ms"] = warm_ms(lambda: binning.plan_tiers_torch(
            prep, grid_h, grid_w, rcfg), PLAIN_REPS, hide=False)[1]
    return res


def launch_split(prep, grid_h: int, grid_w: int, rcfg,
                 reps: int = SPLIT_REPS) -> dict:
    """The kernel's launches as `binning.plan_tiers_launch` makes them,
    each timed by a CUDA event recorded as its entry point returns (the
    host's launches hidden behind a spin kernel, so each interval holds
    one launch and the gap before it): their names in order and each one's
    device us (median of `reps` plans). It needs no profiler, which in a
    long process has missed a launch of the plan."""
    import torch

    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.ops import binning

    lib = _kernels.load().lib

    def plan():
        start = torch.cuda.Event(enable_timing=True)
        marks = [("start", start)]

        def check(code, launch):
            if code != 0:
                raise RuntimeError(f"plan {launch} launch failed: {code}")
            marks.append((launch, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        torch.cuda._sleep(HIDE_CYCLES)
        start.record()
        binning.plan_tiers_launch(
            lib, prep, grid_h, grid_w, rcfg,
            stream=torch.cuda.current_stream().cuda_stream, check=check)
        return marks

    plan()
    runs = [plan() for _ in range(reps)]
    torch.cuda.synchronize()
    return {"names": [name for name, _ in runs[0][1:]],
            "us": [statistics.median(
                1e3 * r[i - 1][1].elapsed_time(r[i][1]) for r in runs)
                for i in range(1, len(runs[0]))]}


def split(fn, reps: int = SPLIT_REPS) -> dict:
    """The device operations of one call of fn() by the profiler's device
    events, the host's launches hidden behind a spin kernel (SPLIT_HIDE
    cycles; its events, SPIN, dropped): the count of operations, each one's
    name and device us, the gaps between them and the span from the first
    one's start to the last one's end. Medians over those of the `reps`
    calls whose trace holds the most operations (`kept`: a trace can miss
    a device event, never add one), after one call traced and dropped.
    The host's events are traced too: traced alone, the device's missed
    the first launch of a plan in every call of a long process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = []
    for rep in range(reps + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPLIT_HIDE)
            fn()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and SPIN not in e.name),
                     key=lambda e: e.time_range.start)
        if rep:
            runs.append([(e.name, e.time_range.start, e.time_range.end)
                         for e in ops])
    count = max(len(r) for r in runs)
    runs = [r for r in runs if len(r) == count]

    def med(values):
        return statistics.median(values)

    return {
        "ops": count, "kept": len(runs),
        "names": [name[:SPLIT_NAME] for name, _, _ in runs[0]],
        "us": [med([r[i][2] - r[i][1] for r in runs]) for i in range(count)],
        "gaps_us": [med([r[i + 1][1] - r[i][2] for r in runs])
                    for i in range(count - 1)],
        "span_us": med([r[-1][2] - r[0][1] for r in runs])}


def binning_stage(scene, camera, rcfg, dev, label: str) -> dict:
    """The `render.binning` stage of one eager bench step (fwd+bwd): its
    device kernels and busy ms, split by `profile_step`."""
    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch.diag import profile_step

    res = profile_step._profile_parts(
        f"plan_{label}", (("eager", lambda: benchmark.bench_step(
            scene, camera, rcfg), 1, True),), str(OUT / "profile"), dev)
    stage = res["eager"]["stages"]["binning"]
    return {"kernels": stage["kernels"], "busy_ms": stage["busy_ms"]}


def train_params(dev, deterministic: bool) -> dict:
    """The five parameter groups after TRAIN_STEPS graphed train steps
    (`trainer.TrainGraph`) of `profile_step`'s TRAIN_CELL from its start,
    on its first view; with `deterministic`, under torch's deterministic
    algorithms (the gradients' `index_add_` without atomics)."""
    import torch

    from gsrast_tpu_torch.diag import profile_step
    from gsrast_tpu_torch.train.trainer import TrainGraph, make_train_step

    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        cell = profile_step.train_cell(TRAIN_CELL, dev)
        state = cell.state()
        graph = TrainGraph(make_train_step(cell.rcfg, cell.tc, cell.extent))
        for _ in range(TRAIN_STEPS):
            graph(state, cell.views[0], cell.targets[0])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return {k: p.detach().cpu().clone()
            for k, p in state.scene.param_groups().items()}


def tag(tree: Path) -> str:
    """The file name stem of a tree's outputs and readings under OUT."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def run_tree(tree: Path, train: bool = False) -> None:
    """Time one tree's plan on every cell (run as a script, in a process
    of its own, so that the tree's package is the one imported); with
    `train`, also save its `train_params` of this run."""
    sys.path[0] = str(tree)
    import torch

    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.ops import binning

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    saved = OUT / f"{tag(tree)}.pt"
    keep = {} if not saved.exists() else None
    ms = {}
    for name in CELLS:
        scene, camera, rcfg = cell_inputs(name, dev)
        prep = cell_prep(scene, camera, rcfg)
        gh, gw = rcfg.grid_shape(camera.height, camera.width)

        def fn():
            return binning.plan_tiers(prep, gh, gw, rcfg)

        if keep is not None:
            keep[name] = {f: getattr(fn(), f).cpu() for f in FIELDS}
        ms[name] = {"cold": cold_ms(fn, dev), "warm": warm_ms(fn),
                    "eager": warm_ms(fn, hide=False), "split": split(fn)}
        if name in STAGE_CELLS:
            ms[name]["binning_stage"] = binning_stage(scene, camera, rcfg,
                                                      dev, name)
        del scene, prep
        torch.cuda.empty_cache()
    if keep is not None:
        torch.save(keep, saved)
    if train:
        runs = len(list(OUT.glob(f"{tag(tree)}_train_*.pt")))
        torch.save({mode: train_params(dev, mode == "deterministic")
                    for mode in TRAIN_MODES},
                   OUT / f"{tag(tree)}_train_{runs}.pt")
    line = json.dumps({"tree": str(tree), "ms": ms})
    with open(OUT / f"{tag(tree)}.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


def summarise(trees) -> None:
    """One JSON line a cell: per tree its runs and the plan's elements
    that differ from the first tree's, per field."""
    import torch

    first = torch.load(OUT / f"{tag(trees[0])}.pt")
    for name in first:
        res = {"cell": name, "trees": {}}
        for tree in trees:
            plan = torch.load(OUT / f"{tag(tree)}.pt")[name]
            runs = [json.loads(line)["ms"][name] for line in
                    (OUT / f"{tag(tree)}.jsonl").read_text().splitlines()]
            res["trees"][str(tree.relative_to(HERE))] = {
                "runs": runs, "differ": {
                    f: int((plan[f] != first[name][f]).sum()) for f in FIELDS}}
        print(json.dumps(res), flush=True)
    base = OUT / f"{tag(trees[0])}_train_0.pt"
    if base.exists():
        want = torch.load(base)
        res = {"train": TRAIN_CELL, "steps": TRAIN_STEPS, "trees": {}}
        for tree in trees:
            runs = [torch.load(run) for run in
                    sorted(OUT.glob(f"{tag(tree)}_train_*.pt"))]
            res["trees"][str(tree.relative_to(HERE))] = {
                mode: [{k: float((p - want[mode][k]).abs().max())
                        for k, p in run[mode].items()} for run in runs]
                for mode in TRAIN_MODES}
        print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "plan_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one; plans compared with the "
                         "first's)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--train", action="store_true",
                    help="also train TRAIN_STEPS graphed steps a run and "
                         "compare the parameters with the first tree's "
                         "first run")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_tree(Path(args.worker), args.train)
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("plan_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("plan_timing: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    print(json.dumps({"card": turns.card(), "trees": [
        str(tree.relative_to(HERE)) for tree in turns.build(trees)]}),
        flush=True)
    code = turns.in_turns(Path(__file__).resolve(), trees,
                          ("--train",) if args.train else (),
                          rounds=args.rounds)
    if code == 0:
        summarise(trees)
    return code


if __name__ == "__main__":
    sys.exit(main())
