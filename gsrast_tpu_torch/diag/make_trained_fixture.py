"""Make the trained bench fixtures from a random scene, with no download.

    python -m gsrast_tpu_torch.diag.make_trained_fixture [--out DIR]
        [--steps 700] [--small] [--skip-5m] [--device cpu]

Counterpart of the reference's `scripts/make_trained_fixture.py`, through
the port's own commands:
  1. `make-dataset`: render an orbit of a random scene (1M Gaussians, 16
     views at 800x800; `--small`: 120k, 24 views at 512x512);
  2. `train`: fit a fresh random scene (1.1M, capacity 1.3M; `--small`:
     130k, capacity 170k) to those views, densify and prune on;
  3. save the trained .ply, and unless `--skip-5m` a variant of five
     copies, each with its means jittered by N(0, 0.02^2)
     (`numpy.random.default_rng(0)`): ~5.5M Gaussians with trained
     statistics (the scale of BASELINE.json's config 3).
The output goes to `--out` (default `gsrast_tpu_torch/_build/fixtures`,
which git ignores).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from .. import cli
from ..scene.gaussians import PARAM_FIELDS, from_numpy
from ..scene.ply import load_ply, save_ply

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "fixtures")
# (dataset Gaussians, trained Gaussians, capacity, views, image side).
SIZES = {"full": (1_000_000, 1_100_000, 1_300_000, 16, 800),
         "small": (120_000, 130_000, 170_000, 24, 512)}
COPIES, JITTER = 5, 0.02


def main(argv: Optional[list] = None) -> dict:
    """Make the fixtures; returns the paths written ({"trained": ply} and,
    unless `--skip-5m`, "stats_5m")."""
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "make_trained_fixture")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--small", action="store_true",
                    help="the 120k-scale variant (fast)")
    ap.add_argument("--skip-5m", action="store_true",
                    help="skip the 5x replicated-statistics variant")
    cli._add_device(ap)
    args = ap.parse_args(argv)
    cli._device(args.device)

    n_data, n_train, cap, views, size = SIZES["small" if args.small
                                              else "full"]
    os.makedirs(args.out, exist_ok=True)
    data_dir = os.path.join(args.out, "dataset")
    ply = os.path.join(args.out, f"trained_{n_train // 1000}k.ply")
    device = ["--device", args.device]
    t0 = time.perf_counter()
    cli.cmd_make_dataset([f"random:{n_data}", "--out", data_dir, "--views",
                          str(views), "--width", str(size), "--height",
                          str(size), *device])
    t1 = time.perf_counter()
    cli.cmd_train(["--scene", f"random:{n_train}", "--capacity", str(cap),
                   "--data", data_dir, "--steps", str(args.steps),
                   "--ckpt-dir", os.path.join(args.out, "ckpts"),
                   "--save-ply", ply, *device])
    t2 = time.perf_counter()
    print(f"trained fixture: {ply} (dataset {t1 - t0:.1f} s, train and "
          f"save {t2 - t1:.1f} s, host clock)")
    written = {"trained": ply}
    if not args.skip_5m:
        scene = load_ply(ply)
        arrays = {f: getattr(scene, f).detach().numpy() for f in PARAM_FIELDS}
        rng = np.random.default_rng(0)
        means = [arrays["means"] + rng.normal(
            0.0, JITTER, size=arrays["means"].shape).astype(np.float32)
            for _ in range(COPIES)]
        big = {f: np.concatenate([a] * COPIES) for f, a in arrays.items()}
        big["means"] = np.concatenate(means)
        written["stats_5m"] = os.path.join(args.out, "trained_stats_5m.ply")
        save_ply(from_numpy(big), written["stats_5m"])
        print(f"{COPIES}x trained-statistics fixture: {written['stats_5m']} "
              f"({time.perf_counter() - t2:.1f} s)")
    return written


if __name__ == "__main__":
    main()
