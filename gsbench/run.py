"""Run one cell of the benchmark once and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA cards.
Set-up (the kernel library's build on a checkout's first run, the scene,
the views, the targets, the capture and a warm-up) is timed from the
process's start; then the window runs for `--seconds`; with `--trace 1` a
traced window and the per-layer readings follow; last, the program's
outputs are checked against the plain reference. The last line of the
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and `compared` (each
number compared with its limit), which the standard error's last lines
repeat. The run exits with another code than 0, printing no result, where
no card or too few cards are found, or where the process has loaded JAX or
the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the package, not this directory's modules, by name


def main() -> int:
    ap = argparse.ArgumentParser(prog="gsbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from gsbench import harness

    harness.set_caches()
    cell = harness.load(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gsbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    t_import = time.perf_counter() - T0
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    t_context = time.perf_counter() - T0
    from gsrast_tpu_torch import _kernels

    built = _kernels.load().build_seconds
    print(f"gsbench: torch imported at {t_import:.3f} s, CUDA context at "
          f"{t_context:.3f} s, kernel library loaded at "
          f"{time.perf_counter() - T0:.3f} s (built in {built:.3f} s; 0: "
          f"reused)", file=sys.stderr)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                         chips=chips)
    for name, c in result["compared"].items():
        print(f"gsbench: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"gsbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
