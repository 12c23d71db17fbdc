"""Time the bisection kernels of several checkouts in turns, on one card.

    python -m gsrast_tpu_torch.diag.bisect_timing [--tree DIR ...]

Makes phase 11's inputs once with this checkout (`chip_smoke.bisect_sizes`:
trained_116k's 1080p plan, 2,040 tiles, and its longest tile alone) and
saves them under `_build/`. Then it runs the trees in the order given and
back (A, B, B, A for two), each in a process of its own that imports that
tree's package and its `chip_smoke.py`, builds its kernels and times each
kernel as that tree's phase 11 does: `bisect_launch` (C and D in the
tree's own tile order), `RAW_REPS` raw launches per interval, the median
of `cuda_ms`; and the tile order kernel alone on the full plan. Each run
prints one JSON line: the tree, the card's name and power limit, per
kernel the ms at both sizes, and per kernel of the library its SASS
instruction count and a hash of its SASS with addresses and parameter
offsets left out (where `cuobjdump` runs). A tree must lie inside this
checkout (for the parent, `git archive` unpacked under `_archive/`, which
git ignores). Default tree: this checkout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
INPUTS = HERE / "gsrast_tpu_torch" / "_build" / "bisect_timing_inputs.pt"
SIZES = ("full", "longest_tile")


def make_inputs() -> None:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke

    with torch.inference_mode():
        sizes = chip_smoke.bisect_sizes(torch.device("cuda:0"))
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: {n: x.cpu() for n, x in sizes[k].items()} for k in SIZES},
               INPUTS)


def sass_digest(path: Path) -> dict:
    """Per bisection kernel of the library at `path`: its SASS instruction
    count and a hash of the instructions without addresses, encodings and
    constant-bank parameter offsets; {} where cuobjdump does not run."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    out = {}
    for body in sass.split("Function : ")[1:]:
        m = re.search(r"(bisect|carry)_kernelILi(\d)E", body.split("\n", 1)[0])
        if not m:
            continue
        instrs = [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]",
                         ln.split("*/", 1)[1].split(";")[0].strip())
                  for ln in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
        out[f"{m.group(1)}_kernel<{m.group(2)}>"] = [
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
    built = _kernels.load()
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"tree": str(tree), "card": smi, "raw_reps": smoke.RAW_REPS,
            "ptxas": [ln.strip() for ln in built.build_log.splitlines()
                      if "bisect" in ln or "carry" in ln or "registers" in ln],
            "ms": res, "sass": sass_digest(built.path)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "bisect_timing")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout inside this one to time (repeatable; "
                         "default: this one)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(run_tree(Path(args.worker))), flush=True)
        return 0
    trees = [Path(t).resolve() for t in (args.tree or [HERE])]
    outside = [str(t) for t in trees if not t.is_relative_to(HERE)]
    if outside:
        print(f"bisect_timing: trees outside {HERE}: {outside}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("bisect_timing: no CUDA device", file=sys.stderr)
        return 1
    make_inputs()
    for tree in trees + trees[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(tree)], cwd=tree, timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
