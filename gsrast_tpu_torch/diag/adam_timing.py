"""Time the optimizer kernel of several checkouts in turns on one card, and
compare their outputs bit for bit.

    python -m gsrast_tpu_torch.diag.adam_timing [--tree DIR ...]
        [--cells 1M,trained_116k,colmap] [--rounds R]

Makes phase 22's train cells once with this checkout
(`chip_smoke.adam_train_groups`: each cell's five groups after two eager
steps, with the gradients of a third backward; the values matter, since
Gaussians that no pixel reached have zero moments; the COLMAP cell made
without files) and saves them under `_build/`. It builds every tree's kernels
at once and prints one JSON line: the card's name and power limit, and per
tree the `cuobjdump -res-usage` line of each optimizer kernel. Then it runs
the trees in turns (`diag/turns.py`: in the order given and back, R times),
each in a process of its own that imports that tree's package and
`chip_smoke.py`: on each cell, from a fresh copy of the saved state, the
tree's launch (`train.adam.update_launch`) runs once, its outputs are saved
on the tree's first run, and it is timed as phase 22 times it: cold
(`chip_smoke.cold_ms`, the L2 flushed before each launch) and warm
(`chip_smoke.cuda_ms` of RAW_REPS raw launches back to back), and its
device operations an update are counted as the nodes of a CUDA graph that
captures one launch; each run prints one JSON line of its ms and nodes.
Last, one JSON line a cell: its bound (`chip_smoke.adam_work`) and per
tree the ms of each run, the share of the bound at the best cold run, its
graph's nodes, and its outputs against the first tree's. A tree must lie
inside this checkout and hold `train/adam.py` (a variant: a copy under
`_archive/`, which git ignores, with an edited `csrc/adam.cu`). Default
tree: this checkout.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
OUT = HERE / "gsrast_tpu_torch" / "_build" / "adam_timing"
INPUTS = OUT / "inputs.pt"
# cell -> its `diag.profile_step` train cell: phase 22's.
CELLS = {"1M": "train_default", "trained_116k": "train_trained_116k",
         "colmap": "train_colmap"}
OUTPUTS = ("param", "exp_avg", "exp_avg_sq", "step")


def tag(tree: Path) -> str:
    """The file name stem of a tree's outputs and readings under OUT."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def make_inputs(smoke, wanted) -> dict:
    """Save the wanted cells' groups and masks to INPUTS; per cell its
    bound and the shares of its values that are zero or subnormal."""
    import torch

    from gsrast_tpu_torch.diag.profile_step import train_cell

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cells, info = {}, {}
    for key in wanted:
        state, groups, _ = smoke.adam_train_groups(
            train_cell(CELLS[key], dev), dev)
        live = state.scene.mask
        cells[key] = ([{**g._asdict(), "param": g.param.detach(),
                        "grad": g.grad.detach()} for g in groups], live)
        info[key] = {**smoke.adam_work(groups, live),
                     **smoke.adam_values(groups)}
        del state, groups
        torch.cuda.empty_cache()
    torch.save(cells, INPUTS)
    del cells
    torch.cuda.empty_cache()
    return info


def graph_nodes(graph) -> int:
    """The nodes of a captured CUDA graph (made with keep_graph=True, not
    yet instantiated): the device operations one replay runs."""
    import ctypes

    count = ctypes.c_size_t(0)
    code = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert code == 0, f"cuGraphGetNodes: CUDA error {code}"
    return count.value


def update_nodes(make_launch) -> int:
    """The device operations of one update: the nodes of a CUDA graph that
    captures the launch make_launch() makes on the capture's stream."""
    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        launch = make_launch()
        assert launch.fn(*launch.args) == 0
    return graph_nodes(graph)


def run_tree(tree: Path) -> None:
    """Run and time one tree's kernel on the saved cells (run as a script,
    in a process of its own, so that the tree's package and smoke script are
    the ones imported)."""
    sys.path[0] = str(tree)
    import torch

    import chip_smoke as smoke
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.train import adam

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    saved = OUT / f"{tag(tree)}.pt"
    keep = {} if not saved.exists() else None
    ms = {}
    for key, (fields, live) in torch.load(INPUTS,
                                          weights_only=False).items():
        groups = [adam.Group(**f) for f in fields]
        launch = adam.update_launch(smoke.adam_clone(groups), live,
                                    smoke.ADAM_REST_SCALE)
        assert launch.fn(*launch.args) == 0, key
        torch.cuda.synchronize()
        if keep is not None:
            keep[key] = [getattr(g, f).cpu() for g in launch.held["groups"]
                         for f in OUTPUTS]
        ms[key] = {
            "cold": smoke.cold_ms(lambda: launch.fn(*launch.args), dev),
            "warm": smoke.cuda_ms(lambda: [
                launch.fn(*launch.args) for _ in range(smoke.RAW_REPS)]
            ) / smoke.RAW_REPS,
            "graph_nodes": update_nodes(
                lambda: adam.update_launch(launch.held["groups"], live,
                                           smoke.ADAM_REST_SCALE))}
        del launch, groups
    if keep is not None:
        torch.save(keep, saved)
    line = json.dumps({"tree": str(tree), "raw_reps": smoke.RAW_REPS,
                       "ms": ms})
    with open(OUT / f"{tag(tree)}.jsonl", "a") as f:
        f.write(line + "\n")
    print(line, flush=True)


def summarise(trees, info: dict) -> None:
    """One JSON line a cell: its bound, and per tree its ms, its share of
    the bound at the best cold run and its outputs against the first
    tree's (elements that differ)."""
    import torch

    first = torch.load(OUT / f"{tag(trees[0])}.pt")
    for key, work in info.items():
        res = {"cell": key, **work, "trees": {}}
        for tree in trees:
            out = torch.load(OUT / f"{tag(tree)}.pt")
            runs = [json.loads(line)["ms"][key] for line in
                    (OUT / f"{tag(tree)}.jsonl").read_text().splitlines()]
            cold = [run["cold"] for run in runs]
            res["trees"][str(tree.relative_to(HERE))] = {
                "cold_ms": cold, "warm_ms": [run["warm"] for run in runs],
                "graph_nodes": sorted({run["graph_nodes"] for run in runs}),
                "share": work["bound_ms"] / min(cold),
                "differ": sum(int((a != b).sum())
                              for a, b in zip(out[key], first[key]))}
        print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "adam_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one; outputs compared with the "
                         "first)")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run_tree(Path(args.worker))
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("adam_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("adam_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    info = make_inputs(smoke, args.cells.split(","))
    names = ("adam_update_kernel", "adam_count_kernel")
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
