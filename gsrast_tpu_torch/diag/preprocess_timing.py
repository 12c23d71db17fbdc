"""Time the preprocess kernels of several checkouts in turns on one card,
and compare their outputs bit for bit.

    python -m gsrast_tpu_torch.diag.preprocess_timing [--tree DIR ...]
        [--cells 1M,trained_116k,colmap,edge] [--rounds R]

Makes phase 20's cells once with this checkout (`chip_smoke.preprocess_cells`,
the COLMAP cell made without files), with seeded cotangents on every output
of every Gaussian, and saves them under `_build/`. It builds every tree's
kernels at once and prints one JSON line: the card's name and power limit,
and per tree the `cuobjdump -res-usage` line of each preprocess kernel
(registers, local and static shared bytes). Then it runs the trees
in turns (`diag/turns.py`: in the order given and back, R times), each in a
process of its own that imports that tree's package and `chip_smoke.py`:
on each cell the tree's forward and backward launches
(`ops.preprocess.forward_launch`, `backward_launch`) run once, their
outputs are saved on the tree's first run, and each is timed as phase 20
times it (`chip_smoke.cuda_ms`: the median of 10 intervals of RAW_REPS raw
launches, warm), the forward also cold (`chip_smoke.cold_ms`: one launch
after an L2 flush) beside the launch floor (`chip_smoke.launch_floor`),
and alone on the device (`diag/plan_timing.py`'s cold and warm times, a
spin holding the stream while the host enqueues the launch), and the
forward's launch where the tree reports it (`chip_smoke.forward_occupancy`:
registers, spills, shared bytes, resident warps, grid); each run prints
one JSON line of its readings. Last, one JSON line a cell: per kernel its
bound (`chip_smoke.preprocess_bound`) and per tree the ms of each run, the
share of the bound at the best, the forward's cold ms, device times,
launch floors and launch, and each output against the first tree's
(elements that differ, largest difference). A tree must lie inside this
checkout (the parent: `git archive` unpacked under `_archive/`, which git
ignores; a variant: such a copy with an edited `csrc/preprocess.cu`).
Default tree: this checkout.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
OUT = HERE / "gsrast_tpu_torch" / "_build" / "preprocess_timing"
INPUTS = OUT / "inputs.pt"
KINDS = ("forward", "backward")


def tag(tree: Path) -> str:
    """The file name stem of a tree's outputs and readings under OUT."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def make_inputs(smoke, wanted) -> dict:
    """Save the wanted cells of `chip_smoke.preprocess_cells` with their
    cotangents to INPUTS; per cell its label, sizes and bounds."""
    import torch

    from gsrast_tpu_torch.ops import preprocess as pp

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    cells, info = {}, {}
    for key, label, act, cam, rcfg in smoke.preprocess_cells(dev):
        if key not in wanted:
            continue
        n, k = act.sh.shape[:2]
        used = (pp.sh_degree(act, rcfg) + 1) ** 2
        cells[key] = (act, cam, rcfg, pp.Cotangents(*(
            torch.randn((n, *shape), generator=gen, device=dev)
            for shape in ((2,), (), (3,), (3,), ()))))
        info[key] = {"label": label, "gaussians": n, "sh_rows": k,
                     "sh_used": used,
                     "sh_offset_bytes": act.sh.data_ptr() % 16,
                     "bounds": {kind: smoke.preprocess_bound(kind, n, used, k)
                                for kind in KINDS}}
    torch.save(cells, INPUTS)  # the SH rows' views keep their offsets
    del cells
    torch.cuda.empty_cache()
    return info


def outputs(launch) -> dict:
    """A launch's outputs by name: the gradients, or the forward's fields
    with the rect's four rows stacked."""
    import torch

    from gsrast_tpu_torch.ops import preprocess as pp

    out = launch.out
    if isinstance(out, dict):
        return dict(out)
    return {**{f: getattr(out, f) for f in pp.Preprocessed._fields[:6]},
            "rect": torch.stack(list(out.rect))}


def run_tree(tree: Path) -> None:
    """Run and time one tree's kernels on the saved cells (run as a script,
    in a process of its own, so that the tree's package and smoke script are
    the ones imported)."""
    sys.path[0] = str(tree)
    import torch

    import chip_smoke as smoke
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.camera import device_camera
    from gsrast_tpu_torch.ops import preprocess as pp

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    saved = OUT / f"{tag(tree)}.pt"
    keep = {} if not saved.exists() else None
    from gsrast_tpu_torch.diag import plan_timing

    occupancy = getattr(smoke, "forward_occupancy", None)
    ms, cold, device, launch_of = {}, {}, {}, {}
    for key, (act, cam, rcfg, cot) in torch.load(
            INPUTS, weights_only=False).items():
        dcam = device_camera(cam)
        launches = {"forward": pp.forward_launch(act, dcam, rcfg),
                    "backward": pp.backward_launch(act, dcam, rcfg, cot)}
        ms[key] = {}
        for kind, launch in launches.items():
            assert launch.fn(*launch.args) == 0, (key, kind)
            torch.cuda.synchronize()
            if keep is not None:
                keep.setdefault(key, {})[kind] = {
                    f: x.cpu() for f, x in outputs(launch).items()}
            ms[key][kind] = smoke.cuda_ms(lambda: [
                launch.fn(*launch.args) for _ in range(smoke.RAW_REPS)]
            ) / smoke.RAW_REPS
        fwd = launches["forward"]
        cold[key] = smoke.cold_ms(lambda: fwd.fn(*fwd.args), dev)
        device[key] = {
            "cold_ms": plan_timing.cold_ms(lambda: fwd.fn(*fwd.args), dev),
            "warm_ms": plan_timing.warm_ms(lambda: fwd.fn(*fwd.args))}
        if occupancy is not None:
            n, k = act.sh.shape[:2]
            launch_of[key] = occupancy(n, k, pp.sh_degree(act, rcfg))
        del launches, fwd
    if keep is not None:
        torch.save(keep, saved)
    line = json.dumps({"tree": str(tree), "raw_reps": smoke.RAW_REPS,
                       "ms": ms, "cold_ms": cold, "device": device,
                       "launch_floor": smoke.launch_floor(dev),
                       "launch": launch_of or None})
    with open(OUT / f"{tag(tree)}.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


def compare(a, b) -> dict:
    """Elements of float or int tensors a and b that differ (NaN equal to
    NaN) and their largest difference."""
    import torch

    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    diff = (a.double() - b.double()).abs()
    diff = torch.where(same | ~torch.isfinite(diff), 0.0, diff)
    return {"differ": int((~same).sum()), "max_abs_diff": float(diff.max())}


def summarise(trees, info: dict) -> None:
    """One JSON line a cell: per kernel the bound, and per tree its ms, its
    share of the bound at the best and its outputs against the first
    tree's; the forward's also its cold ms and cold share at the best, the
    launch floor of each run and its launch, where the runs hold them."""
    import torch

    first = torch.load(OUT / f"{tag(trees[0])}.pt")
    res = {key: {"cell": key, **{k: v for k, v in cell.items()
                                 if k != "bounds"}}
           for key, cell in info.items()}
    for key, cell in info.items():
        for kind, (bound_ms, by) in cell["bounds"].items():
            res[key][kind] = {"bound_ms": bound_ms, "bound_by": by,
                              "trees": {}}
    for tree in trees:
        out = torch.load(OUT / f"{tag(tree)}.pt")
        runs = [json.loads(line) for line in
                (OUT / f"{tag(tree)}.jsonl").read_text().splitlines()]
        for key in info:
            for kind in KINDS:
                ms = [run["ms"][key][kind] for run in runs]
                entry = res[key][kind]
                got = entry["trees"][str(tree.relative_to(HERE))] = {
                    "ms": ms, "share": entry["bound_ms"] / min(ms),
                    "against_first": {f: compare(x, first[key][kind][f])
                                      for f, x in out[key][kind].items()}}
                if kind == "forward" and "cold_ms" in runs[0]:
                    cold = [run["cold_ms"][key] for run in runs]
                    got.update(cold_ms=cold,
                               cold_share=entry["bound_ms"] / min(cold),
                               launch_floor=[run["launch_floor"]
                                             for run in runs],
                               launch=(runs[-1]["launch"] or {}).get(key))
                if kind == "forward" and "device" in runs[0]:
                    got["device"] = [run["device"][key] for run in runs]
        del out
    for line in res.values():
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "preprocess_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one; outputs compared with the "
                         "first)")
    ap.add_argument("--cells", default="1M,trained_116k,colmap,edge")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_tree(Path(args.worker))
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("preprocess_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("preprocess_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    info = make_inputs(smoke, args.cells.split(","))
    names = ("preprocess_forward", "preprocess_backward")
    print(json.dumps({"card": turns.card(), "res_usage": {
        str(tree.relative_to(HERE)): turns.resource_usage(path, names)
        for tree, path in turns.build(trees).items()}}), flush=True)
    code = turns.in_turns(Path(__file__).resolve(), trees,
                          rounds=args.rounds)
    if code == 0:
        summarise(trees, info)
    return code


if __name__ == "__main__":
    sys.exit(main())
