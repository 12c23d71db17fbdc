"""Run a timing tool's worker in several checkouts in turns, on one card.

The tools (`bisect_timing`, `preprocess_timing`) time the kernels of
checkouts of this repository ("trees") against each other. A tree lies
inside this checkout: for the parent, `git archive` unpacked under
`_archive/` (which git ignores); for a variant, such a copy with an edited
kernel source. `build` builds every tree's kernel library at once, each by
its own `_kernels.load()`; `in_turns` then runs the tool's script once per
tree, in a process of its own whose `sys.path[0]` is the tree (so that the
tree's package and `chip_smoke.py` are the ones imported), in the order
given and back (A, B, B, A), as many rounds as asked.

Only the tools' parent processes import this module: a worker runs in a
tree that may not hold it.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
TIMEOUT_S = 900  # a tree's build, or one worker run
_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from gsrast_tpu_torch import _kernels; print(_kernels.load().path)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def resolve(tool: str, paths) -> list | None:
    """The trees `paths` (default: this checkout) as absolute paths, or
    None, with the reason on stderr, where one lies outside this checkout
    (a tree builds and runs in place, and a chip call copies only this
    checkout)."""
    trees = [Path(t).resolve() for t in (paths or [HERE])]
    outside = [str(t) for t in trees if not t.is_relative_to(HERE)]
    if outside:
        print(f"{tool}: trees outside {HERE}: {outside}", file=sys.stderr)
        return None
    return trees


def build(trees) -> dict:
    """Each tree's kernel library path, built by the tree's own
    `_kernels.load()` in a process of its own, all trees at once."""
    procs = {tree: subprocess.Popen([sys.executable, "-c", _BUILD], cwd=tree,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for tree in dict.fromkeys(trees)}
    paths = {}
    for tree, proc in procs.items():
        out = proc.communicate(timeout=TIMEOUT_S)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"building the kernels of {tree} failed:\n"
                               f"{out}")
        paths[tree] = Path(out.strip().splitlines()[-1])
    return paths


def in_turns(script: Path, trees, args=(), rounds: int = 1) -> int:
    """Run `python script --worker TREE *args` from each tree, the trees in
    order and back, `rounds` times; the first nonzero exit code, else 0."""
    for tree in (list(trees) + list(trees)[::-1]) * rounds:
        proc = subprocess.run([sys.executable, str(script), "--worker",
                               str(tree), *args], cwd=tree,
                              timeout=TIMEOUT_S)
        if proc.returncode != 0:
            return proc.returncode
    return 0


def cuobjdump(path: Path, *flags: str) -> str:
    """cuobjdump's output for the library at `path`; "" where it does not
    run."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        return subprocess.run([tool, *flags, str(path)], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def resource_usage(path: Path, names) -> dict:
    """Per kernel of the library at `path` whose mangled name holds one of
    `names`: its line of `cuobjdump -res-usage` (registers, stack, static
    shared and local bytes, ...); {} where cuobjdump does not run."""
    lines = cuobjdump(path, "-res-usage").splitlines()
    return {ln.strip()[len("Function "):-1]: usage.strip()
            for ln, usage in zip(lines, lines[1:])
            if ln.strip().startswith("Function ")
            and any(name in ln for name in names)}
