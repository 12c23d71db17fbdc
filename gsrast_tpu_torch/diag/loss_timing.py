"""Time the loss kernels of several checkouts in turns on one card, and
compare their outputs bit for bit.

    python -m gsrast_tpu_torch.diag.loss_timing [--tree DIR ...]
        [--cells trained_116k,colmap,512,edge_5x7,edge] [--rounds R]

Makes phase 21's cells once with this checkout (`chip_smoke.loss_cells`,
the COLMAP cell made without files), keeping each pred's strides, and saves
them under `_build/`. It builds every tree's kernels at once and prints one
JSON line: the card's name and power limit, and per tree the `cuobjdump
-res-usage` line of each loss kernel (registers, local and static shared
bytes). Then it runs the trees in turns (`diag/turns.py`: in the order given
and back, R times), each in a process of its own that imports that tree's
package and `chip_smoke.py`: on each cell the tree's forward and backward
launches (`train.loss.forward_launch`, `backward_launch`, cotangent 1) run
once, their outputs (the loss, d_pred) are saved on the tree's first run,
and each is timed as phase 21 times it (`chip_smoke.cuda_ms`: the median of
10 intervals of RAW_REPS raw launches); each run prints one JSON line of its
ms. Last, one JSON line a cell: per kernel its bound
(`chip_smoke.loss_work`) and per tree the ms of each run, the share of the
bound at the best, and each output against the first tree's (elements that
differ, largest difference). A tree must lie inside this checkout (the
parent: `git archive` unpacked under `_archive/`, which git ignores; a
variant: such a copy with an edited `csrc/loss.cu`). Default tree: this
checkout.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
OUT = HERE / "gsrast_tpu_torch" / "_build" / "loss_timing"
INPUTS = OUT / "inputs.pt"
KINDS = ("forward", "backward")
WEIGHT = 0.2  # TrainConfig().ssim_weight, as phase 21


def tag(tree: Path) -> str:
    """The file name stem of a tree's outputs and readings under OUT."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def make_inputs(smoke, wanted) -> dict:
    """Save the wanted cells of `chip_smoke.loss_cells` to INPUTS; per cell
    its label, shape, pred's strides and the kernels' bounds."""
    import torch

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cells, info = {}, {}
    for key, label, pred, target in smoke.loss_cells(dev):
        if key not in wanted:
            continue
        cells[key] = (pred, target)
        h, w, c = pred.shape
        work = smoke.loss_work(h, w, c)
        info[key] = {"label": label, "shape": [h, w, c],
                     "pred_strides": list(pred.stride()),
                     "target_strides": list(target.stride()),
                     "bounds": {kind: (work[kind]["bound_ms"],
                                       work[kind]["bound_by"])
                                for kind in KINDS}}
    torch.save(cells, INPUTS)  # views keep their strides and offsets
    del cells
    torch.cuda.empty_cache()
    return info


def run_tree(tree: Path) -> None:
    """Run and time one tree's kernels on the saved cells (run as a script,
    in a process of its own, so that the tree's package and smoke script are
    the ones imported)."""
    sys.path[0] = str(tree)
    import torch

    import chip_smoke as smoke
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.train import loss as L

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    saved = OUT / f"{tag(tree)}.pt"
    keep = {} if not saved.exists() else None
    ones = torch.ones((), device=dev)
    ms = {}
    for key, (pred, target) in torch.load(INPUTS,
                                          weights_only=False).items():
        launches = {"forward": L.forward_launch(pred, target, WEIGHT),
                    "backward": L.backward_launch(pred, target, WEIGHT,
                                                  ones)}
        ms[key] = {}
        for kind, launch in launches.items():
            assert launch.fn(*launch.args) == 0, (key, kind)
            torch.cuda.synchronize()
            if keep is not None:
                keep.setdefault(key, {})[kind] = launch.out.cpu()
            ms[key][kind] = smoke.cuda_ms(lambda: [
                launch.fn(*launch.args) for _ in range(smoke.RAW_REPS)]
            ) / smoke.RAW_REPS
        del launches
    if keep is not None:
        torch.save(keep, saved)
    line = json.dumps({"tree": str(tree), "raw_reps": smoke.RAW_REPS,
                       "ms": ms})
    with open(OUT / f"{tag(tree)}.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


def compare(a, b) -> dict:
    """Elements of float tensors a and b that differ and their largest
    difference."""
    diff = (a.double() - b.double()).abs()
    return {"differ": int((a != b).sum()), "max_abs_diff": float(diff.max())}


def summarise(trees, info: dict) -> None:
    """One JSON line a cell: per kernel the bound, and per tree its ms, its
    share of the bound at the best and its output against the first
    tree's."""
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
        runs = [json.loads(line)["ms"] for line in
                (OUT / f"{tag(tree)}.jsonl").read_text().splitlines()]
        for key in info:
            for kind in KINDS:
                ms = [run[key][kind] for run in runs]
                entry = res[key][kind]
                entry["trees"][str(tree.relative_to(HERE))] = {
                    "ms": ms, "share": entry["bound_ms"] / min(ms),
                    "against_first": compare(out[key][kind],
                                             first[key][kind])}
    for line in res.values():
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "loss_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one; outputs compared with the "
                         "first)")
    ap.add_argument("--cells", default="trained_116k,colmap,512,edge_5x7,"
                                       "edge")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_tree(Path(args.worker))
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("loss_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("loss_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    info = make_inputs(smoke, args.cells.split(","))
    names = ("loss_forward_kernel", "loss_backward_kernel", "loss_sum_kernel")
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
