"""Time the bisection kernels of several checkouts in turns, on one card.

    python -m gsrast_tpu_torch.diag.bisect_timing [--tree DIR ...]
        [--rounds R] [--order | --probe]

Makes phase 11's inputs once with this checkout (`chip_smoke.bisect_sizes`:
trained_116k's 1080p plan, 2,040 tiles, and its longest tile alone) and
saves them under `_build/`. It builds every tree's kernels at once and
prints one JSON line a tree: the card's name and power limit, and per
bisection kernel of its library the `cuobjdump -res-usage` line and the
SASS instruction count and a hash of its SASS with addresses and parameter
offsets left out (where `cuobjdump` runs). Then it runs the trees in turns
(`diag/turns.py`: in the order given and back, A, B, B, A for two), each
in a process of its own that imports that tree's package and its
`chip_smoke.py` and times each kernel as that tree's phase 11 does:
`bisect_launch` (C and D in the tree's own tile order), `RAW_REPS` raw
launches per interval, the median of `cuda_ms`; and the tile order kernel
alone on the full plan. Each run prints one JSON line: the tree and per
kernel the ms at both sizes. A tree must lie inside this checkout (for the
parent, `git archive` unpacked under `_archive/`, which git ignores).
Default tree: this checkout.

With `--order`, it times the tile order kernel alone instead, on phase
25's order cells (`chip_smoke.order_cells`, made once with this checkout:
the first views' plans of the trained_116k, 1M and COLMAP train cells and
the 1M bench scene's plan at 3840x2160, 16,200 tiles): each run prints
per cell the kernel's raw launch (`order_launch`) cold (`cold_ms`, the L2 flushed) and
warm (RAW_REPS back to back), whether its order equals the tree's plain
`tile_order` element for element, and the launch floor (a one-element
fill) timed alike; then one JSON line a cell with its bound and per tree
its runs and its share of the bound at the best cold run.

With `--probe`, it then builds `diag/bisect_probe.cu` and prints one more
JSON line: the L2 fetch-granularity limit, and the ms of a streaming read
of every float, of one float every 8, 16 and 32 (32, 64 and 128 bytes
apart) and of a streaming write, over the full input's feat (55 MB) and
over 8 times as much (440 MB, far past the 50 MB L2).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
INPUTS = HERE / "gsrast_tpu_torch" / "_build" / "bisect_timing_inputs.pt"
ORDER_INPUTS = INPUTS.with_name("order_timing_inputs.pt")
ORDER_RUNS = INPUTS.with_name("order_timing")  # one .jsonl a tree
SIZES = ("full", "longest_tile")
PROBE_SRC = Path(__file__).with_name("bisect_probe.cu")
PROBE_STRIDES = (1, 8, 16, 32)  # floats between the reads


def make_inputs() -> None:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke

    with torch.inference_mode():
        sizes = chip_smoke.bisect_sizes(torch.device("cuda:0"))
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: {n: x.cpu() for n, x in sizes[k].items()} for k in SIZES},
               INPUTS)


def sass_digest(sass: str) -> dict:
    """Per bisection kernel in `sass` (`cuobjdump -sass` of a library): its
    SASS instruction count and a hash of the instructions without
    addresses, encodings and constant-bank parameter offsets."""
    out = {}
    for body in sass.split("Function : ")[1:]:
        m = re.search(r"(bisect|carry)_kernelILi(\d)E|lanes_kernelE",
                      body.split("\n", 1)[0])
        if not m:
            continue
        instrs = [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]",
                         ln.split("*/", 1)[1].split(";")[0].strip())
                  for ln in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
        out[f"{m.group(1)}_kernel<{m.group(2)}>" if m.group(1)
            else "lanes_kernel"] = [
            len(instrs), hashlib.sha256("\n".join(instrs).encode()).hexdigest()[:12]]
    return out


def run_tree(tree: Path) -> dict:
    """Time one tree's kernels (run as a script, in a process of its own,
    so that the tree's package and smoke script are the ones imported)."""
    sys.path[0] = str(tree)
    import torch

    import chip_smoke as smoke
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.diag import bisect_bwd as bb

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()
    inputs = {k: {n: x.to(dev) for n, x in v.items()}
              for k, v in torch.load(INPUTS).items()}

    def raw_ms(launch) -> float:
        assert launch() == 0
        return smoke.cuda_ms(lambda: [launch() for _ in range(
            smoke.RAW_REPS)]) / smoke.RAW_REPS

    res = {name: {size: raw_ms(smoke.bisect_launch(
        name, bb.kernel_args(name, inputs[size]))) for size in SIZES}
        for name in "abcd"}
    res["tile_order"] = {"full": raw_ms(smoke.order_launch(
        inputs["full"]["starts"]))}
    return {"tree": str(tree), "raw_reps": smoke.RAW_REPS, "ms": res}


def make_order_inputs() -> dict:
    """Save the order cells' tile_starts to ORDER_INPUTS; per cell its
    tile count and bound (`chip_smoke.order_bound`)."""
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke

    cells = chip_smoke.order_cells(torch.device("cuda:0"))
    ORDER_INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in cells.items()}, ORDER_INPUTS)
    return {k: dict(zip(("bound_ms", "bound_by"), chip_smoke.order_bound(
        len(v) - 1)), tiles=len(v) - 1) for k, v in cells.items()}


def run_order_tree(tree: Path) -> dict:
    """Time one tree's order kernel on the saved cells, and the launch
    floor (run as a script, in a process of its own)."""
    sys.path[0] = str(tree)
    import torch

    import chip_smoke as smoke
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.render.blend import tile_order, tile_order_cuda

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _kernels.load()

    def times(launch) -> dict:
        launch()
        return {"cold": smoke.cold_ms(launch, dev),
                "warm": smoke.cuda_ms(lambda: [launch() for _ in range(
                    smoke.RAW_REPS)]) / smoke.RAW_REPS}

    fill = torch.empty(1, device=dev)
    res = {"floor": times(fill.zero_)}
    for key, starts in torch.load(ORDER_INPUTS).items():
        starts = starts.to(dev)
        launch = smoke.order_launch(starts)
        assert launch() == 0, key
        res[key] = {**times(launch), "equal_to_plain": bool(torch.equal(
            tile_order_cuda(starts), tile_order(starts)))}
    line = {"tree": str(tree), "raw_reps": smoke.RAW_REPS, "ms": res}
    with open(ORDER_RUNS / f"{tree_tag(tree)}.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")
    return line


def tree_tag(tree: Path) -> str:
    """The file name stem of a tree's readings under ORDER_RUNS."""
    return "_".join(tree.relative_to(HERE).parts) or "here"


def summarise_order(trees, info: dict) -> None:
    """One JSON line a cell (and one for the floor): its bound and per
    tree the runs' cold and warm ms and the share of the bound at the best
    cold run."""
    runs = {tree: [json.loads(line)["ms"] for line in (
        ORDER_RUNS / f"{tree_tag(tree)}.jsonl").read_text().splitlines()]
        for tree in trees}
    for key, work in {"floor": {}, **info}.items():
        res = {"cell": key, **work, "trees": {}}
        for tree, ms in runs.items():
            cold = [run[key]["cold"] for run in ms]
            res["trees"][str(tree.relative_to(HERE))] = {
                "cold_ms": cold, "warm_ms": [run[key]["warm"] for run in ms],
                **({"share": work["bound_ms"] / min(cold),
                    "equal_to_plain": [run[key]["equal_to_plain"]
                                       for run in ms]} if work else {})}
        print(json.dumps(res), flush=True)


@functools.cache
def build_probe():
    """nvcc of `bisect_probe.cu` into `_build/`, loaded with ctypes."""
    import ctypes

    from gsrast_tpu_torch import _kernels

    path = _kernels.BUILD_DIR / "libgsrast_bisect_probe.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    str(path), str(PROBE_SRC)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gsrast_probe_fetch_granularity.argtypes = [vp]
    lib.gsrast_probe_read.argtypes = [vp, i64, i32, vp, vp]
    lib.gsrast_probe_write.argtypes = [vp, i64, vp]
    return lib


def probe_memory(x, raw_ms) -> dict:
    """The L2 fetch-granularity limit, and the ms of the streaming reads
    (every PROBE_STRIDES floats) and write of `x` (a float32 CUDA tensor,
    its size a multiple of 32), each timed by raw_ms(launcher)."""
    import ctypes

    import torch

    lib = build_probe()
    limit = ctypes.c_ulonglong(0)
    assert lib.gsrast_probe_fetch_granularity(ctypes.byref(limit)) == 0
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, device=x.device)
    n = x.numel()
    res = {"l2_fetch_granularity_limit_bytes": limit.value, "bytes": 4 * n}
    for s in PROBE_STRIDES:
        res[f"read_stride{s}_ms"] = raw_ms(lambda s=s: lib.gsrast_probe_read(
            x.data_ptr(), n, s, sink.data_ptr(), stream))
    y = torch.empty_like(x)
    res["write_ms"] = raw_ms(lambda: lib.gsrast_probe_write(
        y.data_ptr(), n, stream))
    for s in PROBE_STRIDES[1:]:
        res[f"stride{s}_over_all"] = (res[f"read_stride{s}_ms"]
                                      / res["read_stride1_ms"])
    return res


def run_probe() -> dict:
    """The memory probes of the module docstring."""
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
    from gsrast_tpu_torch.diag import turns

    def raw_ms(launch) -> float:
        assert launch() == 0
        return smoke.cuda_ms(lambda: [launch() for _ in range(
            smoke.RAW_REPS)]) / smoke.RAW_REPS

    feat = torch.load(INPUTS)["full"]["feat"].to("cuda:0")
    return {"probe": {"card": turns.card(), "raw_reps": smoke.RAW_REPS,
                      "feat_55MB": probe_memory(feat, raw_ms),
                      "x8_440MB": probe_memory(feat.repeat(8, 1), raw_ms)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "bisect_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one)")
    ap.add_argument("--probe", action="store_true",
                    help="then run the memory probes of bisect_probe.cu")
    ap.add_argument("--order", action="store_true",
                    help="time the tile order kernel on the order cells "
                         "instead of the bisection kernels")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        run = run_order_tree if args.order else run_tree
        print(json.dumps(run(Path(args.worker))), flush=True)
        return 0
    sys.path.insert(0, str(HERE))
    from gsrast_tpu_torch.diag import turns

    trees = turns.resolve("bisect_timing", args.tree)
    if trees is None:
        return 2
    import torch

    if not torch.cuda.is_available():
        print("bisect_timing: no CUDA device", file=sys.stderr)
        return 1
    if args.order:
        shutil.rmtree(ORDER_RUNS, ignore_errors=True)
        ORDER_RUNS.mkdir(parents=True)
        info = make_order_inputs()
        for tree, path in turns.build(trees).items():
            print(json.dumps({"tree": str(tree), "card": turns.card(),
                              "res_usage": turns.resource_usage(
                                  path, ("tile_order_kernel",))}),
                  flush=True)
        code = turns.in_turns(Path(__file__).resolve(), trees, ("--order",),
                              rounds=args.rounds)
        if code == 0:
            summarise_order(trees, info)
        return code
    make_inputs()
    names = ("bisect", "carry", "lanes")
    for tree, path in turns.build(trees).items():
        sass = sass_digest(turns.cuobjdump(path, "-sass"))
        print(json.dumps({"tree": str(tree), "card": turns.card(),
                          "res_usage": turns.resource_usage(path, names),
                          "sass": sass}), flush=True)
    code = turns.in_turns(Path(__file__).resolve(), trees,
                          rounds=args.rounds)
    if code != 0:
        return code
    if args.probe:
        print(json.dumps(run_probe()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
