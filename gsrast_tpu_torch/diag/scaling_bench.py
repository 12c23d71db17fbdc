"""Scaling harness: pixels/s against the number of ranks, the port's
counterpart of the reference's `scripts/scaling_bench.py`.

    python -m gsrast_tpu_torch.diag.scaling_bench --out PATH [--quick]
        [--n 200000 --width 1024 --height 512] [--iters 3] [--ranks 8]
        [--device cuda|cpu]

For each D of (1, 2, 4, 8) no larger than --ranks it spawns D ranks of one
process group (`diag.dryrun.spawn_ranks`: gloo on the CPU; on the card NCCL
where every rank has a card of its own, else gloo ranks sharing the cards)
and times the gradient of mean(image) with respect to the means:
  * tile mode: `render_tile_sharded` on the (1, D) mesh, interleaved rows,
    the relevance exchange; and its forward split into prep (the sharded
    preprocess and the exchange), binning (the row-local tier plan) and
    blend (sort-pack and the blend of the rank's rows), timed as growing
    prefixes, each entry the difference (`stages_tile_fwd_ms`);
  * primitive mode: `render_primitive_sharded`, each rank its shard of the
    scene padded by `pad_gaussians`;
and one rank alone times the share control (`share_loss`) for every D:
one rank's exact share of the work with no communication (the preprocess of N/D Gaussians
and rank 0's interleaved rows' plan, pack and blend over the whole set,
each forward and backward), so that efficiency_vs_share_control = control /
measured is at most about 1. The exchange budgets come from
`sharded.exchange_budget`.

Scene: N SH-1 anisotropic Gaussians, scales in [0.004, 0.015], from
`numpy.random.default_rng(0)`, seen from (0, 0, -2.5); the config is
`auto_render_config`'s with the reference's cap 4,096, tile_chunk 4 and
capacity factor 8. Default 200k at 1024x512; --quick 20k at 512x256. Each
time is the best of --iters after a warm-up, per iteration the slowest
rank's: on the card by CUDA events, on the CPU by the host clock between
barriers; the group of one takes its tile step and the share controls
in turns (`timed_turns`), each the best of at least ONE_RANK_ITERS, so
that the control at D = 1 lands within a band of the step (`chip_smoke.py`
phase 18). The JSON at
--out has the reference's keys (`SCALING_r05.json`) and, per D, the
transport and the distinct cards the ranks used, with the card's name
and power limit (nvidia-smi). Ranks that share one card measure the
curve's shape and its overheads, not scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

COUNTS = (1, 2, 4, 8)
STAGES = ("prep", "binning", "blend")
# The group of one times its tile step and the share controls as the best
# of at least this many calls: both are host-bound, and on an H100 a best
# of 2 spread by half. A call takes 10-20 ms there at --quick's size.
ONE_RANK_ITERS = 30


def scene_camera(n: int, width: int, height: int, device):
    """The harness's scene and camera (module docstring)."""
    from ..scene.gaussians import random_scene
    from .dryrun import front_camera

    scene = random_scene(n, np.random.default_rng(0), sh_degree=1,
                         isotropic=False, scale_range=(0.004, 0.015),
                         device=device)
    return scene, front_camera(width, height, 2.5, device)


def bench_config(scene, camera):
    """`auto_render_config` with the reference's cap, chunk and capacity."""
    from ..render.api import auto_render_config

    return auto_render_config(scene, camera).replace(
        max_per_tile=4096, tile_chunk=4, intersect_capacity_factor=8.0)


def timed(fn, iters: int, device) -> float:
    """Best of `iters` runs of fn() after one warm-up, in ms; per run the
    slowest rank's time (a collective: every rank calls it)."""
    return timed_turns([fn], iters, device)[0]


def timed_turns(fns, iters: int, device) -> list:
    """`timed` of each of fns, taken in turns: every round runs each once,
    so that a drift of the host's speed falls on all of them alike."""
    import torch.distributed as dist

    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, runs in zip(fns, times):
            dist.barrier()
            if device.type == "cuda":
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                dist.barrier()
                runs.append((time.perf_counter() - t0) * 1e3)
    slowest = torch.tensor(times, dtype=torch.float64, device=(
        device if dist.get_backend() == "nccl" else "cpu"))
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return slowest.min(dim=1).values.tolist()


def tile_step(act, camera, cfg, mesh):
    """(step, means): step() runs render_tile_sharded and the backward of
    mean(image) into means.grad, on every rank of the mesh."""
    from ..parallel.sharded import render_tile_sharded

    means = act.means.detach().clone().requires_grad_(True)

    def step():
        means.grad = None
        out = render_tile_sharded(dataclasses.replace(act, means=means),
                                  camera, cfg, mesh)
        torch.mean(out.image).backward()
    return step, means


def primitive_step(act, camera, cfg, mesh):
    """(step, means): as `tile_step` through render_primitive_sharded on
    this rank's shard of the padded scene."""
    from ..parallel.mesh import TILE_AXIS, axis_size
    from ..parallel.sharded import pad_gaussians, render_primitive_sharded

    d, n_dev = mesh.get_local_rank(TILE_AXIS), axis_size(mesh, TILE_AXIS)
    padded = pad_gaussians(act, n_dev)
    nl = padded.means.shape[0] // n_dev
    shard = {k: v[d * nl:(d + 1) * nl].detach()
             for k, v in vars(padded).items()}
    means = shard.pop("means").clone().requires_grad_(True)

    def step():
        means.grad = None
        out = render_primitive_sharded(
            type(act)(means=means, **shard), camera, cfg, mesh)
        torch.mean(out.image).backward()
    return step, means


def tile_prefix(act, camera, cfg, mesh):
    """prefix(stage) -> the tile mode's forward up to `stage` of STAGES on
    this rank of the (1, D) mesh, through the helpers that
    `render_tile_sharded` runs, in its order: prep (`_tile_prep`: the
    sharded preprocess and the exchange), binning (the row-local tier plan)
    and blend (`_local_tiles`: the plan again, sort-pack and the blend;
    its (rgb, final_t, n_contrib) are the rank's tiles of the image). The
    shard and the budgets (`_tile_inputs`) are made once, outside."""
    from ..ops import binning
    from ..parallel import sharded as ps
    from ..parallel.mesh import TILE_AXIS, axis_size

    n_dev, rank = axis_size(mesh, TILE_AXIS), mesh.get_local_rank(TILE_AXIS)
    grid_h, grid_w = cfg.grid_shape(camera.height, camera.width)
    rpd = ps._rows_per_device(grid_h, n_dev)
    g_local, c_send, cfg_d = ps._tile_inputs(act, cfg, mesh, True)

    def prefix(stage):
        prep, _ = ps._tile_prep(g_local, camera, cfg, mesh, rpd, True, c_send)
        if stage == "binning":
            return binning.plan_tiers(prep.detach(), grid_h, grid_w, cfg_d,
                                      num_local_rows=rpd, row0=rank,
                                      row_stride=n_dev)
        if stage == "blend":
            return ps._local_tiles(prep, cfg, cfg_d, grid_h, grid_w, rpd,
                                   rank, n_dev, cfg.backend)
        return prep
    return prefix


def stage_ms(act, camera, cfg, mesh, iters: int, device) -> dict:
    """The tile mode's forward by stage on the (1, D) mesh: prep, binning,
    blend, each the time of the `tile_prefix` ending with it less the one
    before."""
    prefix = tile_prefix(act, camera, cfg, mesh)
    out, before = {}, 0.0
    with torch.no_grad():
        for stage in STAGES:
            t = timed(lambda: prefix(stage), iters, device)
            out[stage] = t - before
            before = t
    return out


def share_loss(act, camera, cfg, n_dev: int):
    """loss() of the share control: one rank's exact share at D = n_dev,
    with no communication: the preprocess of N/D Gaussians and rank 0's
    interleaved rows' plan, pack and blend over all N, as one graph, as the
    step is; it sets its leaves' grads to None first, as the step does.
    Like the step, it differentiates with respect to the means alone: the
    reference's control takes the gradient of all five activated fields,
    which jit fuses but which eagerly costs launches that the step does not
    pay. The reference sums two timed jits; eagerly, each part's own
    backward would pay the host's launch latency again."""
    from ..ops.preprocess import preprocess
    from ..parallel import sharded as ps

    grid_h, grid_w = cfg.grid_shape(camera.height, camera.width)
    rpd = ps._rows_per_device(grid_h, n_dev)
    padded = ps.pad_gaussians(act, n_dev)
    _, tiers_d = ps.exchange_budget(cfg.tiers, padded.means.shape[0], n_dev,
                                    True)
    cfg_d = cfg.replace(tiers=tiers_d)
    nl = padded.means.shape[0] // n_dev
    part = {k: v[:nl].detach().clone() for k, v in vars(padded).items()}
    part["means"].requires_grad_(True)
    with torch.no_grad():
        full = preprocess(act, camera, cfg)
    floats = {k: getattr(full, k).detach().clone().requires_grad_(True)
              for k in ("mean2d", "conic", "color", "opacity")}
    leaves = [part["means"], *floats.values()]

    def loss():
        for leaf in leaves:
            leaf.grad = None
        p = preprocess(type(act)(**part), camera, cfg)
        rgb, ft, _, _, _ = ps._local_tiles(
            full._replace(**floats), cfg, cfg_d, grid_h, grid_w, rpd, 0,
            n_dev, cfg.backend)
        return (p.mean2d.sum() + p.conic.sum() + p.color.sum()
                + p.opacity.sum() + rgb.sum() + ft.sum())
    return loss


def _rank(world: int, device, cfg: dict, n: int, width: int, height: int,
          iters: int, controls=()) -> dict:
    """One rank of a group of D = world: both modes' step times, the tile
    stages, and (on a group of one) the share control (`share_loss`
    forward and backward) for each D of `controls`; there the tile step and
    the controls are timed in turns (`timed_turns`), the best of at least
    ONE_RANK_ITERS calls each."""
    import torch.distributed as dist

    from ..config import RenderConfig
    from ..parallel import make_mesh

    scene, camera = scene_camera(n, width, height, device)
    with torch.no_grad():
        act = scene.activated()
    cfg = RenderConfig(**cfg)
    step_iters = max(iters, ONE_RANK_ITERS) if world == 1 else iters
    mesh = make_mesh((1, world))
    res = {"device": str(device), "transport": dist.get_backend()}
    losses = [share_loss(act, camera, cfg, d) for d in controls]
    res["tile_ms"], *control_ms = timed_turns(
        [tile_step(act, camera, cfg, mesh)[0],
         *[lambda loss=loss: loss().backward() for loss in losses]],
        step_iters, device)
    res["stages"] = stage_ms(act, camera, cfg, mesh, iters, device)
    res["primitive_ms"] = timed(primitive_step(act, camera, cfg, mesh)[0],
                                iters, device)
    res["controls"] = {str(d): t for d, t in zip(controls, control_ms)}
    return res


def card_name_and_limit() -> tuple:
    """(name, power limit) of the first card, as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, limit


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "scaling_bench")
    ap.add_argument("--out", required=True, help="the JSON file to write")
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=8,
                    help="the most ranks to spawn (D of 1, 2, 4, 8 up to it)")
    ap.add_argument("--quick", action="store_true",
                    help="20k at 512x256, for fast checks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.width, args.height = 20_000, 512, 256
    from ..cli import _device
    from .dryrun import spawn_ranks

    device = _device(args.device)
    counts = [d for d in COUNTS if d <= args.ranks]
    with torch.no_grad():
        cfg = dataclasses.asdict(bench_config(*scene_camera(
            args.n, args.width, args.height, device)))
    on_card = device.type == "cuda"
    name, limit = card_name_and_limit() if on_card else (None, None)
    pixels = args.width * args.height
    result = {"device_counts": counts, "pixels": pixels,
              "n_gaussians": args.n, "backend": f"{cfg['backend']}+fused",
              "host_cores": os.cpu_count(), "modes": {},
              "stages_tile_fwd_ms": {}, "share_control_ms": {},
              "device": device.type, "name": name, "power_limit": limit,
              "transport": [], "cards": []}
    times = {"tile": [], "primitive": []}
    for d in counts:
        ranks = spawn_ranks(_rank, d, device, cfg=cfg,
                            n=args.n, width=args.width, height=args.height,
                            iters=args.iters,
                            controls=counts if d == 1 else ())
        head = ranks[0]
        result["share_control_ms"].update(head["controls"])
        result["stages_tile_fwd_ms"][str(d)] = head["stages"]
        result["transport"].append(head["transport"])
        result["cards"].append(len({r["device"] for r in ranks})
                               if on_card else 0)
        for mode in times:
            times[mode].append(head[f"{mode}_ms"])
        print(f"D={d}: tile {head['tile_ms']:.2f} ms, primitive "
              f"{head['primitive_ms']:.2f} ms, stages {head['stages']} "
              f"({head['transport']})", flush=True)
    for mode, ms in times.items():
        mpix = [pixels / t / 1e3 for t in ms]
        eff = [m / (mpix[0] * d) for m, d in zip(mpix, counts)]
        result["modes"][mode] = {
            "step_ms": ms, "mpix_s": mpix, "efficiency_vs_1dev": eff,
            "vs_ideal_flat": [e * d for e, d in zip(eff, counts)],
            "efficiency_vs_share_control": [
                result["share_control_ms"][str(d)] / t
                for d, t in zip(counts, ms)]}
    one_card = on_card and max(result["cards"]) <= 1
    result["notes"] = (
        f"{'one card' if one_card else device.type} ranks ({', '.join(sorted(set(result['transport'])))}), spawned per "
        "D; fwd+bwd of mean(image) in both modes, the fused multi-tier "
        "binning, the relevance exchange (tile mode) and the tier-grid "
        "routing (primitive mode). Ranks that share one card, or one host's "
        "cores, measure the curve's shape and its overheads, not scaling. "
        "efficiency_vs_share_control: one rank's exact share with no "
        "communication over the measured step. stages_tile_fwd_ms: the tile "
        "mode's forward, prefix-timed, entries the stage deltas.")
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
