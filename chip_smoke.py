"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of `gsrast_tpu_torch` from the sources
in this checkout, holds each against its plain PyTorch version at the shapes
the render and training paths give it (the backward also against a second
launch, bit for bit), prints each blend kernel's work, bound and share of
the bound beside its time and times it with its blocks taking the tiles in
index order and longest first (the tile order kernel's), drives the
forward render path
through its user entry points (the CLI on the trained 116k-Gaussian fixture
at 1920x1080, and `render` on the 1M-Gaussian SH-degree-3 scene of the
reference benchmark) and the training path (whole-render gradients against
the CPU, 30 steps at 1080p through the `train.trainer` API, the CLI `train`
with a checkpoint resume, and the fwd+bwd and train-step times at the
north-star size), the fault-bisection kernels through their entry point
and against their plain versions at the script's shapes and at the size of
trained_116k's 1080p plan, training from data through the CLI (a COLMAP
scene of eight 1080p views of trained_116k with its means as SfM points,
whose 32x64 tiles the blend kernels are also held at, a cameras.json
directory, a target PNG), a NaN rollback at 1080p, and the viewer (the
CLI's point-cloud and ellipsoid modes on trained_116k at 1080p, the point
cloud at 1M, the three new renderers on the card against the CPU, a saved
pose rendered back bit for bit, `info`, the four apps, the native .ply
reader against numpy), and the benchmark through `bench` (the 1M scene
fwd+bwd with its stage table and forward only, `--small`, trained_116k,
`--backend torch` on the card, the scene statistics, the tile sweep, and a
trained fixture made from a random scene), and the sharded path (phase 16:
both blend kernels on a rank's local tile rows against their plain
versions; 2 and 4 gloo ranks sharing the card, spawned by
torch.multiprocessing, rendering the 1M scene tile- and primitive-sharded
against `render`; the data x tile train step on a (2, 2) mesh; one NCCL
rank; the multihost smoke through --dist), and the reference's default
path (phase 17: the legacy two-tier binning, tiers=(), through the blend
kernels at 1M/1080p timed by the benchmark and on trained_116k with its
counted drops; both kernels against their plain versions on its inputs;
the autograd oracle against the kernels, forward at 1080p and gradients at
--small; build_binning on the card against the CPU; its sharded renders
and train step on 2 gloo ranks); and
checks that each path went through the kernels. Each phase prints its
lines before the next begins; the line before the last is the per-kernel
JSON record, and the last is {"ok": true, "device": {...}}. Any failure
raises and exits nonzero, as does a run without a card or without the
package beside the script. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_116K = os.path.join(ROOT, "tests", "fixtures", "trained_116k.ply")
FIXTURE_SMALL = os.path.join(ROOT, "tests", "fixtures", "trained_small.ply")
OUT_DIR = os.path.join(ROOT, "gsrast_tpu_torch", "_build")  # git-ignored
WIDTH, HEIGHT = 1920, 1080
DEVICE = "cuda:0"
N_NORTH_STAR = 1_000_000

# Kernel against plain version: rgb/final_t where n_contrib agrees, and the
# share of pixels whose n_contrib may differ at the saturation boundary.
ATOL = 1e-5
MAX_NC_MISMATCH = 1e-4
# Backward kernel against plain backward on the same inputs (same gate):
# per gradient row, max |kernel - plain| <= BWD_RTOL * max |plain| of the
# row; they differ in summation order (atomics) and in how T is replayed.
BWD_RTOL = 1e-4
# Whole-render gradients, card against CPU: per parameter group.
GRAD_RTOL = 1e-4
# Bisection kernels against their plain versions: max |kernel - plain| over
# the output's largest magnitude. C and D sum 1,024 elements per step in
# another order (a tree of warp shuffles against torch.sum).
BISECT_RTOL = 1e-5
RAW_REPS = 20  # back-to-back raw launches per timed interval
N_VIEWS = 8  # views of the COLMAP scene of phase 12
PATH_KERNELS = ("tile_order", "blend_forward", "blend_backward")
# Bounds: NVIDIA's H100 SXM figures at 700 W (FP32 outside the tensor
# cores, HBM3), and the flops of one needed (pixel, position) pair at which
# the splat blends, read off the kernels: the forward's alpha and blend
# (blend_forward.cu), the backward's replay and gradient terms plus the 9
# sums over pixels (blend_backward.cu). A needed pair at which it does not
# blend costs at least the box test of blend_common.cuh: four comparisons.
FP32_FLOPS = 67e12
HBM_BPS = 3.35e12
FWD_FLOPS = 21
BWD_FLOPS = 46
SKIP_FLOPS = 4
ORDER_AB_ROUNDS = 2  # rounds of the tile-order A/B, each order timed once
BACKGROUND = (0.1, 0.2, 0.3)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_blend(kernel_out, plain_out, t_min: float) -> dict:
    """Kernel against plain blend outputs. The kernel multiplies the
    transmittance sequentially and the plain version by cumulative product,
    so a pixel whose transmittance lands within rounding of t_min may stop
    at another position: such pixels must be rare, and at each one the
    version that counted more must end just above t_min. Elsewhere rgb and
    final_t agree within ATOL."""
    rgb, ft, nc = kernel_out
    rgb_p, ft_p, nc_p = plain_out
    for a in (rgb, ft, rgb_p, ft_p):
        assert bool(torch.isfinite(a).all()), "non-finite blend output"
    agree = nc == nc_p
    err_rgb = float(torch.where(agree[:, None], rgb - rgb_p, 0.0).abs().max())
    err_ft = float(torch.where(agree, ft - ft_p, 0.0).abs().max())
    bad = ~agree
    n_bad = int(bad.sum())
    dnc = (nc - nc_p)[bad]
    longer_ft = torch.where(nc > nc_p, ft, ft_p)[bad]
    at_boundary = bool(((longer_ft >= t_min)
                        & (longer_ft <= t_min * (1 + 1e-3))).all())
    return {"max_abs_err": max(err_rgb, err_ft), "err_rgb": err_rgb,
            "err_final_t": err_ft, "nc_mismatch": n_bad,
            "nc_mismatch_share": n_bad / nc.numel(),
            "nc_mismatch_by_one": int((dnc.abs() == 1).sum()),
            "nc_mismatch_max": int(dnc.abs().max()) if n_bad else 0,
            "mismatch_at_boundary": at_boundary}


def compare_backward(kernel, plain, live: int) -> dict:
    """Backward kernel against plain backward, per gradient row scaled by
    the plain row's largest magnitude; row 9 and the dead columns past
    tile_starts[-1] must be exactly 0 in the kernel's output."""
    assert bool(torch.isfinite(kernel).all()), "non-finite kernel gradient"
    assert bool(torch.isfinite(plain).all()), "non-finite plain gradient"
    errs = (kernel[:9] - plain[:9]).abs().amax(dim=1)
    scales = plain[:9].abs().amax(dim=1)
    dead = float(kernel[9].abs().max()) + (
        float(kernel[:, live:].abs().max()) if live < kernel.shape[1]
        else 0.0)
    return {"max_abs_err": float(errs.max()),
            "row_rel_err": [float(e / max(float(sc), 1e-30))
                            for e, sc in zip(errs, scales)],
            "row_scale": [float(sc) for sc in scales],
            "dead_abs_sum": dead}


def blended_pairs(feat, tile_starts, n_contrib, grid_w: int, tile_h: int,
                  tile_w: int, budget: int = 1 << 24,
                  tile_map=(0, 1)) -> tuple:
    """(forward, backward): the needed (pixel, position) pairs at which the
    splat blends, power <= 0 and alpha >= ALPHA_MIN as the plain version
    computes them, among the positions below min(n_contrib + 1, segment)
    and below n_contrib. Runs of tiles of at most `budget` (tile, position,
    pixel) elements, on the inputs' device; local tiles placed by
    `tile_map` (row0, row step) as the blend places them."""
    from gsrast_tpu_torch import config as cfg

    dev = feat.device
    starts = tile_starts.long()
    nc = n_contrib.long()
    stop = torch.minimum(nc + 1, (starts[1:] - starts[:-1])[:, None])
    num_tiles, p = nc.shape
    pix = torch.arange(p, device=dev)
    need = stop.amax(1).tolist()
    fwd = bwd = t0 = 0
    while t0 < num_tiles:
        t1, kmax = t0 + 1, need[t0]
        while t1 < num_tiles and (t1 - t0 + 1) * max(kmax, need[t1]) * p <= (
                budget):
            kmax, t1 = max(kmax, need[t1]), t1 + 1
        if kmax > 0:
            tid = torch.arange(t0, t1, device=dev)[:, None, None]
            pos = torch.arange(kmax, device=dev)[:, None]
            take = (starts[t0:t1, None, None] + pos).clamp(
                max=feat.shape[1] - 1)
            f = feat[:, take]  # (10, tiles, kmax, 1)
            dx = f[0] - ((tid % grid_w) * tile_w + pix % tile_w).float()
            dy = f[1] - ((tile_map[0] + (tid // grid_w) * tile_map[1])
                         * tile_h + pix // tile_w).float()
            power = (-0.5 * (f[2] * (dx * dx) + f[4] * (dy * dy))
                     - f[3] * (dx * dy))
            alpha = torch.clamp(f[5] * torch.exp(power), max=cfg.ALPHA_MAX)
            blends = (power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
            fwd += int((blends & (pos < stop[t0:t1, None, :])).sum())
            bwd += int((blends & (pos < nc[t0:t1, None, :])).sum())
        t0 = t1
    return fwd, bwd


def blend_work(feat, tile_starts, n_contrib, grid_w: int, tile_h: int,
               tile_w: int, tile_map=(0, 1)) -> dict:
    """The blend kernels' work on these inputs, counted from the features,
    tile_starts, n_contrib and the tile shape.

    Pairs are (pixel, position) pairs. Needed: what the function needs,
    min(n_contrib + 1, segment) per pixel for the forward (a pixel
    evaluates the position where it saturates) and n_contrib for the
    backward; of those, blended: the pairs at which the splat blends
    (`blended_pairs`). Evaluated: what the kernels issue before their box
    test, 32 x the largest need of each 32-pixel sub-patch of a warp
    (`footprint_pixels`), summed; the backward's warps also sum over their
    lanes at each position up to the warp's largest n_contrib
    (`bwd_warp_steps`); `fwd_strips` counts 1x32 strips (one warp a row of
    32 pixels) for comparison. The bound is the larger of bytes (each input
    read once, each output written once) over HBM_BPS and flops over
    FP32_FLOPS: FWD_FLOPS / BWD_FLOPS per blended pair, SKIP_FLOPS per other
    needed pair; the expf is not counted."""
    from gsrast_tpu_torch.render.blend import (footprint_pixels,
                                               kernel_footprint)

    starts = tile_starts.long()
    seg = starts[1:] - starts[:-1]
    nc = n_contrib.long()
    num_tiles, p = nc.shape
    stop = torch.minimum(nc + 1, seg[:, None])

    def patches(x, kernel):  # (T, P) -> (T, warps, k, 32)
        fpx = footprint_pixels(kernel_footprint(kernel, tile_h, tile_w),
                               tile_w).to(x.device)
        return x[:, fpx.reshape(-1)].reshape(num_tiles, *fpx.shape)

    live = int(starts[-1])
    fwd_blended, bwd_blended = blended_pairs(feat, tile_starts, n_contrib,
                                             grid_w, tile_h, tile_w,
                                             tile_map=tile_map)
    work = {
        "fwd_pairs": int(stop.sum()), "bwd_pairs": int(nc.sum()),
        "fwd_blended": fwd_blended, "bwd_blended": bwd_blended,
        "fwd_evaluated": 32 * int(patches(stop, "forward").amax(-1).sum()),
        "bwd_evaluated": 32 * int(patches(nc, "backward").amax(-1).sum()),
        "bwd_warp_steps": int(patches(nc, "backward").amax(-1).amax(-1)
                              .sum()),
        "fwd_strips": 32 * int(stop.reshape(num_tiles, -1, 32).amax(-1)
                               .sum()),
        "fwd_bytes": 4 * (9 * live + 5 * num_tiles * p + num_tiles + 1),
        "bwd_bytes": 4 * (9 * live + 10 * feat.shape[1] + 6 * num_tiles * p
                          + num_tiles + 1),
    }
    for d, flops in (("fwd", FWD_FLOPS), ("bwd", BWD_FLOPS)):
        blended = work[f"{d}_blended"]
        work[f"{d}_bound_ms"], work[f"{d}_bound_by"] = bound(
            work[f"{d}_bytes"], blended * flops
            + (work[f"{d}_pairs"] - blended) * SKIP_FLOPS)
    return work


def work_line(work: dict, d: str, ms: float) -> str:
    """The `d` ('fwd' or 'bwd') half of blend_work() beside the kernel's
    time: pairs, bytes, bound and the share of the bound."""
    keys = [f"{d}_pairs", f"{d}_blended", f"{d}_evaluated", f"{d}_bytes",
            f"{d}_bound_ms", f"{d}_bound_by"] + (["fwd_strips"] if d == "fwd" else
                                ["bwd_warp_steps"])
    return (f"work {json.dumps({k: work[k] for k in keys})}, share of the "
            f"bound {work[f'{d}_bound_ms'] / ms:.3f}")


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and flops over
    FP32_FLOPS."""
    by_bytes, by_flops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return max(by_bytes, by_flops), ("bytes" if by_bytes > by_flops
                                     else "operations")


def bisect_bound(name: str, rows: int, tiles: int) -> tuple:
    """bound() of bisection kernel `name` on `rows` rows of 128 lanes in
    `tiles` tiles (diag/bisect_bwd.py): A reads and writes every element
    (one multiply each); B, C and D read the 8 elements at lanes 16 j of a
    row and write whole rows; C and D take 8 steps a row over the 1,024
    carry elements, 3 flops an element a step (C: a division, a product,
    a sum) or 5 (D, with the gate's product and sum), and D reads its
    tiles' ft, nc and drgb channel-0 blocks."""
    row = rows * 128 * 4
    nbytes = row + (row if name == "a" else rows * 8 * 4)
    if name == "d":
        nbytes += 3 * tiles * 1024 * 4
    flops = {"a": rows * 128, "b": rows * 8, "c": rows * 8 * 1024 * 3,
             "d": rows * 8 * 1024 * 5}[name]
    return bound(nbytes, flops)


def order_bound(num_tiles: int) -> tuple:
    """bound() of the order kernel on `num_tiles` tiles: tile_starts read
    once, the order written once, a bucket (a difference, a division, a
    minimum) and two counts a tile."""
    return bound(4 * (2 * num_tiles + 1), 5 * num_tiles)


def order_err(order, tile_starts) -> float:
    """The order kernel's output against the plain `tile_order`: the
    largest difference of the two sequences of buckets, which is 0 where
    they match (the kernel leaves the tiles of one bucket in no fixed
    order), or inf where the output is not a permutation of the tiles."""
    from gsrast_tpu_torch.render.blend import (ORDER_BUCKET_POSITIONS,
                                               ORDER_BUCKETS, tile_order)

    lengths = tile_starts[1:] - tile_starts[:-1]

    def buckets(o):
        return torch.clamp(lengths[o.long()] // ORDER_BUCKET_POSITIONS,
                           max=ORDER_BUCKETS - 1)

    every_tile = torch.arange(len(order), device=order.device)
    if not torch.equal(torch.sort(order.long()).values, every_tile):
        return float("inf")
    diff = buckets(order) - buckets(tile_order(tile_starts))
    return float(diff.abs().max()) if len(diff) else 0.0


def order_launch(tile_starts):
    """The order kernel alone, for timing: one launch into an output
    allocated here, not counted. Returns the launcher, which returns the
    launch's CUDA error code."""
    from gsrast_tpu_torch import _kernels

    num_tiles = len(tile_starts) - 1
    out = torch.empty((num_tiles,), dtype=torch.int32,
                      device=tile_starts.device)
    fn = _kernels.load().lib.gsrast_tile_order
    ptrs = (tile_starts.data_ptr(), num_tiles, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*ptrs)


def order_ab(run, tile_starts) -> dict:
    """The blend kernel run(order) with its blocks taking the tiles in
    index order and longest first (`tile_order_cuda`): whether both give
    the same bits, and the ms of each, timed in turns, ORDER_AB_ROUNDS
    rounds of CUDA-event medians of 10."""
    from gsrast_tpu_torch.render.blend import tile_order_cuda

    orders = {"index_order": torch.arange(
        len(tile_starts) - 1, dtype=torch.int32, device=tile_starts.device),
        "longest_first": tile_order_cuda(tile_starts)}
    outs = [run(o) for o in orders.values()]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    res = {"same_bits": all(torch.equal(a, b) for a, b in zip(*outs))}
    res.update({k: [] for k in orders})
    for _ in range(ORDER_AB_ROUNDS):
        for k, o in orders.items():
            res[k].append(cuda_ms(lambda: run(o)))
    return res


def bisect_launch(name: str, args: tuple):
    """The bisection kernel `name` alone, for timing: one launch on `args`
    into an output allocated here, without the wrapper's bounds check (a
    host sync) and zero fill, and not counted. Returns the launcher, which
    returns the launch's CUDA error code."""
    from gsrast_tpu_torch import _kernels

    starts, feat, *blocks = args
    out = torch.zeros_like(feat)
    fn = getattr(_kernels.load().lib, f"gsrast_bisect_{name}")
    ptrs = (starts.data_ptr(), len(starts) - 1, feat.data_ptr(),
            *(b.data_ptr() for b in blocks), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*ptrs)


def event_ms(fn) -> float:
    """Device time of one fn() in ms, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def image_stats(img, background=(0.0, 0.0, 0.0)) -> dict:
    """Mean per channel, range, and the share of pixels not equal to the
    background, of an (H, W, 3) image; asserts it is finite."""
    assert bool(torch.isfinite(img).all()), "non-finite image"
    bg = torch.tensor(background, device=img.device)
    return {"mean_rgb": [round(float(v), 5) for v in img.mean((0, 1))],
            "min": float(img.min()), "max": float(img.max()),
            "drawn_share": float((img != bg).any(-1).float().mean())}


def run_main(main, argv) -> tuple:
    """(CUDA-event ms of the whole call main(argv), its return value, its
    stdout)."""
    held, log = {}, io.StringIO()
    with contextlib.redirect_stdout(log):
        ms = event_ms(lambda: held.setdefault("out", main(argv)))
    return ms, held["out"], log.getvalue().strip()


def phase_viewer(dev) -> dict:
    """Phase 14: the viewer on the card. The CLI's point-cloud and ellipsoid
    modes on trained_116k at 1080p and the point cloud at 1M; the three new
    renderers on the card against the CPU on trained_small at 128x128; a
    pose saved and rendered back bit for bit; `info`; the four apps; the
    native .ply reader against numpy. Returns the checks."""
    from gsrast_tpu_torch import _kernels, cli
    from gsrast_tpu_torch.apps import basic, fbtest, render_app, spheretrace
    from gsrast_tpu_torch.camera import auto_frame, look_at, make_camera
    from gsrast_tpu_torch.config import RenderConfig
    from gsrast_tpu_torch.render.api import render
    from gsrast_tpu_torch.scene import native
    from gsrast_tpu_torch.scene.gaussians import random_scene
    from gsrast_tpu_torch.scene.ply import load_ply, read_ply_raw
    from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids
    from gsrast_tpu_torch.viz.pointcloud import render_pointcloud
    import numpy as np

    res = {}
    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    for mode in ("pointcloud", "ellipsoids"):
        png = os.path.join(OUT_DIR, f"chip_smoke_116k_{mode}.png")
        ms, img, out = run_main(cli.main, ["render", FIXTURE_116K, "--mode",
                                           mode, *size, "--out", png])
        stats = image_stats(img)
        render_s = float(re.search(r" in (\S+)s ", out).group(1))
        res[mode] = {"cli_ms": ms, "render_ms": 1e3 * render_s, **stats}
        print(f"phase 14 cli render --mode {mode} trained_116k {WIDTH}x"
              f"{HEIGHT}: {ms:.1f} ms for the call (CUDA events: load, "
              f"frame, render, PNG), render {1e3 * render_s:.1f} ms; "
              f"{json.dumps(stats)}", flush=True)
        assert img.device == dev and img.shape == (HEIGHT, WIDTH, 3)
        assert stats["drawn_share"] > 0.05, stats
    with torch.inference_mode():
        scene = load_ply(FIXTURE_116K, device=dev)
        cam = auto_frame(*scene.bbox(), WIDTH, HEIGHT, device=dev)
        act = scene.activated()
        res["pointcloud"]["ms"] = cuda_ms(lambda: render_pointcloud(act,
                                                                    cam))
        res["ellipsoids"]["ms"] = cuda_ms(
            lambda: render_ellipsoids(act, cam), iters=3, warmup=1)
        big = random_scene(N_NORTH_STAR, np.random.default_rng(0),
                           sh_degree=3, scale_range=(0.002, 0.008),
                           device=dev)
        cam1m = make_camera(look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0],
                                    device=dev), 1.2, 1.0, WIDTH, HEIGHT,
                            device=dev)
        act1m = big.activated()
        img = render_pointcloud(act1m, cam1m)
        res["pointcloud_1m"] = {"ms": cuda_ms(lambda: render_pointcloud(
            act1m, cam1m)), **image_stats(img)}
        del big, act1m, img
    print(f"phase 14 renderers alone (CUDA events): pointcloud "
          f"trained_116k {res['pointcloud']['ms']:.3f} ms (median of 10), "
          f"ellipsoids trained_116k {res['ellipsoids']['ms']:.3f} ms "
          f"(median of 3), pointcloud 1M SH3 (median of 10) "
          f"{json.dumps(res['pointcloud_1m'])}", flush=True)
    assert res["pointcloud_1m"]["drawn_share"] > 0.05

    # The card against the CPU on the same small input.
    small = load_ply(FIXTURE_SMALL)
    cam_s = auto_frame(*small.bbox(), 128, 128)
    small_dev, cam_sd = load_ply(FIXTURE_SMALL, device=dev), cam_s.to(dev)
    dense_cfg = RenderConfig(backend="dense", background=BACKGROUND)
    draws = {
        "pointcloud": lambda s, c: render_pointcloud(s.activated(), c),
        "ellipsoids": lambda s, c: render_ellipsoids(s.activated(), c),
        "dense": lambda s, c: render(s, c, dense_cfg).image}
    vs_cpu = {}
    with torch.inference_mode():
        for name, draw in draws.items():
            ref, got = draw(small, cam_s), draw(small_dev, cam_sd)
            err = (got.cpu() - ref).abs()
            vs_cpu[name] = {"pixels_differ": int((err > 0).any(-1).sum()),
                            "pixels_differ_1e-5": int((err > 1e-5).any(-1)
                                                      .sum()),
                            "max_abs_err": float(err.max()),
                            "ms": cuda_ms(lambda: draw(small_dev, cam_sd))}
    res["vs_cpu"] = vs_cpu
    print(f"phase 14 card vs CPU, trained_small 128x128 (ms: the card, "
          f"CUDA events): {json.dumps(vs_cpu)}", flush=True)
    for name in ("pointcloud", "ellipsoids"):
        assert vs_cpu[name]["pixels_differ"] <= 16, vs_cpu
    assert vs_cpu["dense"]["max_abs_err"] <= 1e-5, vs_cpu

    # A saved pose renders the auto-framed image bit for bit.
    store = os.path.join(OUT_DIR, "poses.json")
    if os.path.exists(store):
        os.remove(store)
    run_main(cli.main, ["pose", "save", "home", "--scene", FIXTURE_116K,
                        *size, "--store", store])
    names = run_main(cli.main, ["pose", "list", "--store", store])[1]
    _, framed, _ = run_main(cli.main, [
        "render", FIXTURE_116K, *size, "--out",
        os.path.join(OUT_DIR, "framed.png")])
    _kernels.reset_launch_counts()
    ms, posed, _ = run_main(cli.main, [
        "render", FIXTURE_116K, *size, "--pose", "home", "--store", store,
        "--out", os.path.join(OUT_DIR, "posed.png")])
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    res["pose_bits_equal"] = bool(torch.equal(framed, posed))
    _, report, _ = run_main(cli.main, ["info", FIXTURE_116K, "--gaussian",
                                       "0", *size])
    peek = report["gaussian"]
    print(f"phase 14 pose save/list {names}, render --pose home: {ms:.1f} "
          f"ms, bitwise equal to the auto-framed render "
          f"{res['pose_bits_equal']}, launches={launches}; info --gaussian "
          f"0: num_active {report['scene']['num_active']}, bytes "
          f"{report['scene']['bytes']['total']}, depth {peek['depth']:.4f}, "
          f"radius {peek['radius']}, tiles {peek['tiles_touched']}",
          flush=True)
    assert names == ["home"] and min(launches[k] for k in PATH_KERNELS[:2])
    assert report["scene"]["num_active"] == scene.capacity

    # The four apps, in this process.
    apps = {}
    for name, fn, argv in (
            ("render_app", render_app.main,
             [FIXTURE_116K, "--frames", "4", *size, "--outdir",
              os.path.join(OUT_DIR, "frames")]),
            ("spheretrace", spheretrace.main,
             ["--out", os.path.join(OUT_DIR, "spheretrace.png")]),
            ("fbtest", fbtest.main, [os.path.join(OUT_DIR, "fbtest.png")]),
            ("basic", basic.main, [os.path.join(OUT_DIR, "basic.png")])):
        _kernels.reset_launch_counts()
        ms, out, log = run_main(fn, argv)
        torch.cuda.synchronize()
        apps[name] = {"ms": ms, "launches": dict(_kernels.launch_counts),
                      "last_line": log.splitlines()[-1]}
        if name != "spheretrace":
            assert apps[name]["launches"]["blend_forward"] > 0, apps[name]
    print(f"phase 14 apps (CUDA events per call): {json.dumps(apps)}",
          flush=True)
    assert apps["render_app"]["last_line"].startswith("frames: {'frames': 4")

    # The native .ply reader against numpy's, on trained_116k.
    t0 = time.perf_counter()
    cols = native.read_ply_columns(FIXTURE_116K)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with open(FIXTURE_116K, "rb") as f:
        ref_cols = read_ply_raw(f.read())
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    same = list(cols) == list(ref_cols) and all(
        cols[k].tobytes() == v.tobytes() for k, v in ref_cols.items())
    print(f"phase 14 native .ply reader trained_116k ({len(cols)} columns "
          f"of {len(cols['x'])}): {native_ms:.1f} ms, numpy "
          f"{numpy_ms:.1f} ms (host), columns byte-equal {same}", flush=True)
    assert same
    res.update(apps=apps, native_ms=native_ms, numpy_ms=numpy_ms)
    return res


def captured(fn, argv) -> tuple:
    """(fn(argv), its stdout lines, host seconds); on a failure the
    captured lines go to stderr before the exception."""
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            out = fn(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(log.getvalue(), file=sys.stderr)
        raise
    return out, log.getvalue().strip().splitlines(), time.perf_counter() - t0


def phase_bench(dev) -> dict:
    """Phase 15: the benchmark on the card through `cli.main(["bench",
    ...])` at 1920x1080: the 1M SH-3 scene fwd+bwd with the stage table and
    forward only, `--small`, trained_116k, the plain versions on the card
    (`--backend torch`) on trained_small at 128x128 with their image held
    against the kernels', the scene statistics and the tile sweep at 1M,
    and a trained fixture made from a random scene, benched with its 5x
    copy. Each bench prints its JSON line after a `phase 15` prefix.
    Returns the results by label."""
    from gsrast_tpu_torch import _kernels, benchmark, cli
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.config import TRANSMITTANCE_MIN
    from gsrast_tpu_torch.diag import (make_trained_fixture, scene_stats,
                                       tile_sweep)
    from gsrast_tpu_torch.render.api import render
    from gsrast_tpu_torch.scene.ply import load_ply

    size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
    res = {}

    def bench(label, argv, kernels=True):
        _kernels.reset_launch_counts()
        out, lines, sec = captured(cli.main, ["bench", *argv])
        launches = {k: _kernels.launch_counts[k] for k in PATH_KERNELS}
        print(f"phase 15 bench {label} ({sec:.1f} s, launches "
              f"{json.dumps(launches)}): {' | '.join(lines[:-1])}",
              flush=True)
        print(f"phase 15 {lines[-1]}", flush=True)
        assert json.loads(lines[-1]) == out
        assert math.isfinite(out["value"]) and out["value"] > 0, out
        if kernels:
            need = PATH_KERNELS if out["mode"] == "fwd+bwd" else (
                PATH_KERNELS[:2])
            assert min(launches[k] for k in need) > 0, launches
        else:
            assert not any(_kernels.launch_counts.values()), launches
        res[label] = dict(out, launches=launches, seconds=sec)

    bench("1M fwd+bwd", size)
    bench("1M fwd", ["--fwd-only", "--no-stages", *size])
    bench("--small", ["--small"])
    bench("trained_116k", ["--scene", FIXTURE_116K, *size])
    small = ["--scene", FIXTURE_SMALL, "--width", "128", "--height", "128"]
    bench("torch backend trained_small",
          ["--backend", "torch", "--no-stages", "--iters", "1", *small],
          kernels=False)
    # The plain versions' image on the card against the kernels'.
    scene = load_ply(FIXTURE_SMALL, device=dev)
    cam = auto_frame(*scene.bbox(), 128, 128, device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "torch")
    with torch.no_grad():
        outs = [render(scene, cam, rcfg.replace(backend=b))
                for b in ("torch", "cuda")]
    tiles = [(o.image.permute(2, 0, 1).reshape(1, 3, -1),
              o.final_t.reshape(1, -1), o.n_contrib.reshape(1, -1))
             for o in outs]
    cmp_torch = compare_blend(tiles[1], tiles[0], TRANSMITTANCE_MIN)
    print(f"phase 15 --backend torch image against --backend cuda, "
          f"trained_small 128x128 on the card: {json.dumps(cmp_torch)}",
          flush=True)
    assert cmp_torch["err_rgb"] <= ATOL and cmp_torch["err_final_t"] <= ATOL
    assert cmp_torch["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp_torch["mismatch_at_boundary"], cmp_torch
    res["torch_vs_cuda"] = cmp_torch

    stats, lines, sec = captured(scene_stats.main, size)
    print(f"phase 15 scene_stats 1M SH3 {WIDTH}x{HEIGHT} ({sec:.1f} s): "
          f"{' | '.join(lines)}", flush=True)
    assert stats["overflow_tile_cap"] == 0 and stats["total_isect"] > 0
    _kernels.reset_launch_counts()
    rows, lines, sec = captured(tile_sweep.main, [*size, "--iters", "3"])
    print(f"phase 15 tile_sweep 1M SH3 {WIDTH}x{HEIGHT} fwd+bwd, best and "
          f"median of 3 ({sec:.1f} s, launches "
          f"{json.dumps(dict(_kernels.launch_counts))}): "
          f"{json.dumps(rows)}", flush=True)
    assert all(row["status"] == "ok" for shape, row in rows.items()
               if tile_sweep.kernels_take(*map(int, shape.split("x")))), rows
    res.update(scene_stats=stats, tile_sweep=rows)

    out_dir = os.path.join(OUT_DIR, "fixtures")
    shutil.rmtree(out_dir, ignore_errors=True)
    made, lines, sec = captured(make_trained_fixture.main, [
        "--small", "--steps", "30", "--out", out_dir])
    sizes = {k: load_ply(v).capacity for k, v in made.items()}
    print(f"phase 15 make_trained_fixture --small --steps 30 ({sec:.1f} s): "
          f"Gaussians {json.dumps(sizes)}; {' | '.join(lines)}", flush=True)
    assert sizes["stats_5m"] == 5 * sizes["trained"] > 0
    res["fixture"] = {"seconds": sec, "gaussians": sizes}
    bench("trained fixture", ["--scene", made["trained"], "--no-stages",
                              *size])
    bench("trained fixture 5x", ["--scene", made["stats_5m"], "--no-stages",
                                 *size])
    return res


# -- phase 16: the sharded path -------------------------------------------
# The ranks are processes of torch.multiprocessing (spawn), all on cuda:0:
# NCCL takes one rank per GPU, so ranks that share the card take gloo and
# one rank alone takes NCCL. Each rank writes its results as JSON under
# SHARD_DIR; the first failure of any rank fails the phase.
SHARD_DIR = os.path.join(OUT_DIR, "phase16")
RANK_TIMEOUT = 240.0  # seconds a group of ranks may take
# Sharded against single-device results on the card: images as the
# reference's sharded tests hold them (2e-5). Gradients of sum(image): the
# reference tests' elementwise 2e-4 + 1e-4 |g| is counted and printed, but
# at 1M/1080p the gradients reach ~1e4 and each is a float32 sum of
# thousands of atomically added terms, so where they cancel the order of
# the adds alone moves a gradient by ~1e-3 (`render` against itself shows
# it, printed beside); the bound held is 1e-6 of each gradient's largest
# magnitude.
SHARD_IMAGE_ATOL = 2e-5
SHARD_GRAD_TOL = dict(atol=2e-4, rtol=1e-4)
SHARD_GRAD_SCALE_RTOL = 1e-6
# The tier spec of the reference's sharded tests (test_sharded_fused.py).
# The bench's auto-derived tiers are not kept for the sharded renders:
# `shard_tiers` divides their widths by D, but on this scene most rects
# span one tile row, so an interleaved rank owns all of a rect's tiles and
# the scaled budgets drop tiles (counted; phase 16 prints how many).
SHARD_TIERS = ((2, 1.0), (4, 1.0), (8, 0.5), (32, 0.25))
TRAIN_VIEWS, TRAIN_STEPS = 4, 10


def tie_free_bench_scene(device):
    """The bench scene and camera with every Gaussian at its own depth.

    Two splats at the same float32 depth in one tile blend in slot order,
    which depends on the tile plan (the reference's too), so a sharded
    render may take them in the other order than a single-device one; on
    the 1M bench scene, whose depths z + 2.5 round to 2^-22 steps, many
    do. Here z is a shuffled uniform grid over [-1, 1] (steps of 2e-6,
    some 8 ulps of the depth), the scene otherwise the bench scene."""
    import numpy as np
    from gsrast_tpu_torch import benchmark

    scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH, HEIGHT,
                                              device=device)
    grid = (np.arange(N_NORTH_STAR) + 0.5) / N_NORTH_STAR * 2.0 - 1.0
    z = np.random.default_rng(16).permutation(grid).astype(np.float32)
    from gsrast_tpu_torch.ops.projection import to_camera

    with torch.no_grad():
        scene.means[:, 2] = torch.from_numpy(z).to(device)
        depth = to_camera(scene.means, cam.view)[:, 2]
    assert len(torch.unique(depth)) == N_NORTH_STAR, "depth ties"
    return scene, cam


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(fn, world: int, *args, out_dir: str = SHARD_DIR) -> list:
    """fn(rank, world, port, *args) on `world` spawned processes; returns
    the JSON each wrote to out_dir/<fn>_<rank>.json. Raises if a rank
    fails, or kills them all past RANK_TIMEOUT."""
    import torch.multiprocessing as mp

    port = free_port()
    ctx = mp.start_processes(fn, args=(world, port, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"{fn.__name__}: ranks past {RANK_TIMEOUT} s")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{fn.__name__}_{r}.json")) as f:
            out.append(json.load(f))
    return out


def _rank_setup(rank: int, world: int, port: int, backend=None):
    """The rank's bootstrap: the port's `initialize_distributed` (gloo for
    ranks that share the card), or an explicit backend for one rank."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from gsrast_tpu_torch.parallel.mesh import initialize_distributed

    torch.cuda.set_device(0)
    if world > 1:
        initialize_distributed(f"localhost:{port}", world, rank,
                               backend=backend, device="cuda")
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    return torch.device("cuda", 0), dist.get_backend()


def _rank_write(name: str, rank: int, result: dict,
                out_dir: str = SHARD_DIR) -> None:
    """The rank's results, then the process group's end."""
    import torch.distributed as dist

    with open(os.path.join(out_dir, f"{name}_{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


class _PlainCounts:
    """Counts calls of the blend's plain versions (torch backend), which
    a run on the kernels must not make."""

    def __init__(self):
        from gsrast_tpu_torch.render import blend

        self.counts = {"blend_forward_torch": 0, "blend_backward_torch": 0}
        for name in self.counts:
            setattr(blend, name, self._wrap(name, getattr(blend, name)))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            self.counts[name] += 1
            return fn(*args, **kw)
        return counted

    def reset(self):
        for name in self.counts:
            self.counts[name] = 0


def _grad_compare(got, ref) -> dict:
    """Gradients against the single-device ones: the largest error, the
    elements outside the elementwise tolerance, and whether the largest
    error is within SHARD_GRAD_SCALE_RTOL of the largest magnitude."""
    err = (got - ref).abs()
    outside = int((err > SHARD_GRAD_TOL["atol"]
                   + SHARD_GRAD_TOL["rtol"] * ref.abs()).sum())
    scale = float(ref.abs().max())
    return {"max_abs_err": float(err.max()), "scale": scale,
            "outside_elementwise_tol": outside,
            "within_tol": float(err.max()) <= SHARD_GRAD_SCALE_RTOL * scale}


def _sharded_case(run, act, ref_image, ref_grad, plain, rows=None) -> dict:
    """One sharded fwd+bwd on this rank, 1 warm-up and 3 timed: its image
    and gradient of sum(image) against the single-device ones, its stats,
    its kernel launches and plain-version calls (of the last call). `run`
    maps Gaussians to a RenderOutput; `rows` the rank's shard of them
    (primitive sharding) or None (all)."""
    import dataclasses

    from gsrast_tpu_torch import _kernels

    if rows is not None:
        act = dataclasses.replace(act, **{
            f.name: getattr(act, f.name)[rows]
            for f in dataclasses.fields(act)})
        ref_grad = ref_grad[rows]
    ms = []
    for _ in range(4):
        means = act.means.detach().clone().requires_grad_(True)
        _kernels.reset_launch_counts()
        plain.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(dataclasses.replace(act, means=means))
        out.image.sum().backward()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "step_ms": ms[1:],
        "image_err": float((out.image.detach() - ref_image).abs().max()),
        "grad": _grad_compare(means.grad, ref_grad),
        "stats": {k: int(v) for k, v in out.stats.items()},
        "launches": dict(_kernels.launch_counts),
        "plain_calls": dict(plain.counts)}


def _single_device_reference(scene, cam, rcfg):
    """(the detached activated Gaussians, the means leaf, render's output)
    with sum(image)'s gradient in the leaf's .grad, and `render`'s second
    gradient against it (the atomic adds' own spread)."""
    import dataclasses

    from gsrast_tpu_torch.render.api import render

    act = scene.activated()
    act = dataclasses.replace(act, **{f.name: getattr(act, f.name).detach()
                                      for f in dataclasses.fields(act)})
    grads = []
    for _ in range(2):
        means = act.means.clone().requires_grad_(True)
        ref = render(dataclasses.replace(act, means=means), cam, rcfg)
        ref.image.sum().backward()
        grads.append(means.grad)
    return act, means, ref, _grad_compare(grads[0], grads[1])


def phase16_sharded_rank(rank: int, world: int, port: int) -> None:
    """D gloo ranks on the card: the tile-sharded render, interleaved and
    contiguous, and the primitive-sharded render of the 1M SH-3 scene at
    1080p (`tie_free_bench_scene`), fwd+bwd, each against `render` on the
    same card; the bench scene's ties, printed; with 4 ranks then the
    data x tile train step on a (2, 2) mesh."""
    dev, backend = _rank_setup(rank, world, port)
    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch.parallel import (comm, make_mesh,
                                           render_primitive_sharded,
                                           render_tile_sharded)

    plain = _PlainCounts()
    mesh = make_mesh((1, world))
    res = {"backend": backend}
    # The bench scene itself, interleaved: depth ties taken in another
    # order than `render` takes them (printed, not held to a tolerance).
    scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH, HEIGHT,
                                              device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda").replace(
        tiers=SHARD_TIERS)
    act, means, ref, _ = _single_device_reference(scene, cam, rcfg)
    case = _sharded_case(lambda g: render_tile_sharded(g, cam, rcfg, mesh),
                         act, ref.image.detach(), means.grad, plain)
    res["bench_scene_ties"] = {k: case[k] for k in ("image_err", "grad")}
    del scene, act, means, ref

    scene, cam = tie_free_bench_scene(dev)
    act, means, ref, res["render_vs_render"] = _single_device_reference(
        scene, cam, rcfg)
    ref_image, ref_grad = ref.image.detach(), means.grad
    total = int(ref.stats["num_intersections"])
    nl = N_NORTH_STAR // world
    # Primitive sharding: a source's intersections to one destination are
    # at most its shard's, ~total / D.
    send_capacity = int(1.05 * total / world)
    runs = {
        "tile_interleaved": lambda g: render_tile_sharded(g, cam, rcfg, mesh),
        "tile_contiguous": lambda g: render_tile_sharded(
            g, cam, rcfg, mesh, interleave=False),
        "primitive": lambda g: render_primitive_sharded(
            g, cam, rcfg, mesh, send_capacity=send_capacity)}
    res.update(tiles=f"{rcfg.tile_h}x{rcfg.tile_w}",
               single_device_isect=total, send_capacity=send_capacity)
    for name, run in runs.items():
        rows = slice(rank * nl, (rank + 1) * nl) if name == "primitive" \
            else None
        res[name] = _sharded_case(run, act, ref_image, ref_grad, plain, rows)
    res["transports"] = dict(comm.transports)
    del ref, ref_image, ref_grad, scene, act, means
    torch.cuda.empty_cache()
    if world == 4:
        res["train"] = _train_2x2(rank, dev, plain)
    _rank_write("phase16_sharded_rank", rank, res)


def _train_2x2(rank: int, dev, plain) -> dict:
    """The data x tile train step on a (2, 2) mesh of the 4 ranks:
    trained_116k perturbed as in phase 8, its renders from TRAIN_VIEWS orbit
    views at 1080p as targets, 2 views a data rank, TRAIN_STEPS steps of the
    port's Adam. Returns the losses and step times."""
    import numpy as np
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.scene.dataset import Dataset, orbit_cameras
    from gsrast_tpu_torch.scene.gaussians import from_numpy
    from gsrast_tpu_torch.scene.ply import load_ply
    from gsrast_tpu_torch.train.trainer import TrainConfig, make_optimizer

    base = load_ply(FIXTURE_116K, device=dev)
    mn, mx = (x.cpu().numpy() for x in base.bbox())
    extent = float(np.linalg.norm(mx - mn))
    fov_y = 1.0
    fov_x = float(2.0 * np.arctan(np.tan(fov_y / 2) * WIDTH / HEIGHT))
    views = orbit_cameras((mn + mx) / 2, extent * 1.1, WIDTH, HEIGHT,
                          TRAIN_VIEWS, fov_x=fov_x, fov_y=fov_y, device=dev)
    with torch.no_grad():
        rcfg_gt = auto_render_config(base, views[0])
        data = Dataset(cameras=views, images=torch.stack(
            [render(base, c, rcfg_gt).image for c in views]))
    arrays = {f: p.detach().cpu().numpy()
              for f, p in base.param_groups().items()}
    arrays["means"] = arrays["means"] + 0.03 * 0.5 * extent * (
        np.random.default_rng(2).standard_normal(arrays["means"].shape))
    arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
    scene = from_numpy(arrays, device=dev)
    rcfg = auto_render_config(scene, views[0], margin=1.5)
    mesh = make_mesh((2, 2))
    step = make_sharded_train_step(
        rcfg, mesh, HEIGHT, WIDTH, cameras_per_device=TRAIN_VIEWS // 2,
        optimizer=make_optimizer(scene, TrainConfig(), extent))
    idx = list(range(TRAIN_VIEWS))
    cams, targets = data.batch_cameras(idx), data.batch_images(idx)
    losses, ms = [], []
    _kernels.reset_launch_counts()
    plain.reset()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(scene, cams, targets)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": ms,
            "tiles": f"{rcfg.tile_h}x{rcfg.tile_w}",
            "launches": dict(_kernels.launch_counts),
            "plain_calls": dict(plain.counts)}


def phase16_nccl_rank(rank: int, world: int, port: int) -> None:
    """One rank over NCCL on the card: the tile-sharded render of the 1M
    scene at 1080p against `render` (the same launches: bit for bit) with
    its gradient, an all_reduce over NCCL, and the train step against the
    single-device step."""
    dev, backend = _rank_setup(rank, world, port, backend="nccl")
    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch.parallel import (comm, make_mesh,
                                           make_sharded_train_step,
                                           render_tile_sharded)
    from gsrast_tpu_torch.render.api import render
    from gsrast_tpu_torch.scene.dataset import Dataset
    from gsrast_tpu_torch.train.loss import rgb_loss

    plain = _PlainCounts()
    scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH, HEIGHT,
                                              device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda").replace(
        tiers=SHARD_TIERS)
    mesh = make_mesh((1, 1))
    one = comm._all_reduce_raw(torch.ones(4, device=dev),
                               mesh.get_group("tiles"))
    assert float(one.sum()) == 4.0
    act, means, ref, spread = _single_device_reference(scene, cam, rcfg)
    res = {"backend": backend, "transports": dict(comm.transports),
           "render_vs_render": spread}
    res["tile"] = _sharded_case(
        lambda g: render_tile_sharded(g, cam, rcfg, mesh), act,
        ref.image.detach(), means.grad, plain)
    with torch.no_grad():
        out = render_tile_sharded(act, cam, rcfg, mesh)
        res["image_bit_equal"] = bool(torch.equal(out.image, ref.image))

    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    data = Dataset(cameras=[cam], images=target[None])
    step = make_sharded_train_step(rcfg, mesh, HEIGHT, WIDTH)
    t0 = time.perf_counter()
    loss, grads = step(scene, data.batch_cameras([0]), data.batch_images([0]))
    torch.cuda.synchronize()
    res["train_step_ms"] = (time.perf_counter() - t0) * 1e3
    grads = {k: v.clone() for k, v in grads.items()}
    for p in scene.param_groups().values():
        p.grad = None
    ref_loss = rgb_loss(render(scene, cam, rcfg).image, target)
    ref_loss.backward()
    res["train_loss"] = [float(loss), float(ref_loss.detach())]
    res["train_grads"] = {k: _grad_compare(grads[k], p.grad)
                          for k, p in scene.param_groups().items()}
    _rank_write("phase16_nccl_rank", rank, res)


def phase_sharded(dev) -> dict:
    """Phase 16: the sharded path. The blend kernels alone on local tiles
    (`phase_sharded_kernels`), then its ranks (`phase_sharded_ranks`).
    Returns both's results."""
    return {"local_tiles": phase_sharded_kernels(dev),
            **phase_sharded_ranks()}


def phase_sharded_kernels(dev) -> dict:
    """Both blend kernels on local tiles, the 1M plan's rows {1, 5, ...}
    (D = 4) at 1080p, against their plain versions by phases 3 and 6's
    rules, the backward twice bit for bit, with their work and bound.
    Returns their numbers by kernel."""
    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch import config as cfg
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.blend import (blend_backward_cuda,
                                               blend_backward_torch,
                                               blend_forward_cuda,
                                               blend_forward_torch,
                                               tile_order_cuda)
    from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack

    n_dev, row0 = 4, 1
    with torch.inference_mode():
        scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH,
                                                  HEIGHT, device=dev)
        rcfg = benchmark.bench_render_config(scene, cam, "cuda")
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        th, tw = rcfg.tile_h, rcfg.tile_w
        prep = preprocess(scene.activated(), cam, rcfg)
        # The bench's own tiers under shard_tiers, interleaved: the tiles
        # the ranks' plans drop.
        dropped = {}
        for d_count in (2, 4):
            rows = -(-gh // d_count)
            cfg_d = rcfg.replace(tiers=binning.shard_tiers(rcfg.tiers,
                                                           d_count))
            dropped[f"D={d_count}"] = sum(int(binning.plan_tiers(
                prep, gh, gw, cfg_d, num_local_rows=rows, row0=d,
                row_stride=d_count).overflow_tile_cap)
                for d in range(d_count))
        whole = int(binning.plan_tiers(prep, gh, gw, rcfg).overflow_tile_cap)
        depths = len(torch.unique(prep.depth))
        print(f"phase 16 the bench's tiers {rcfg.tiers} under shard_tiers, "
              f"interleaved rows: tiles dropped over the ranks "
              f"{json.dumps(dropped)} (the whole grid's plan: {whole}); the "
              f"sharded renders take {SHARD_TIERS}; the bench scene's "
              f"{N_NORTH_STAR} Gaussians lie at {depths} distinct depths",
              flush=True)
        rpd = -(-gh // n_dev)
        tmap = (row0, n_dev)
        cfg_d = rcfg.replace(tiers=binning.shard_tiers(SHARD_TIERS, n_dev))
        plan = binning.plan_tiers(prep, gh, gw, cfg_d, num_local_rows=rpd,
                                  row0=row0, row_stride=n_dev)
        assert int(plan.overflow_tile_cap) == 0
        feat, starts = sort_pack(feature_rows(prep), plan, rpd * gw)
        local = dict(num_tiles=rpd * gw, tile_map=tmap)
        order = tile_order_cuda(starts)
        fwd = blend_forward_cuda(feat, starts, gh, gw, th, tw, order, **local)
        cmp_f = compare_blend(fwd, blend_forward_torch(feat, starts, gh, gw,
                                                       th, tw, **local),
                              cfg.TRANSMITTANCE_MIN)
        gen = torch.Generator(device=dev).manual_seed(16)
        d_rgb = torch.randn((rpd * gw, 3, th * tw), generator=gen, device=dev)
        d_ft = torch.randn((rpd * gw, th * tw), generator=gen, device=dev)
        bargs = (feat, starts, d_rgb, d_ft, fwd[1], fwd[2], gh, gw, th, tw)
        bwd = blend_backward_cuda(*bargs, order, **local)
        same = bool(torch.equal(bwd, blend_backward_cuda(*bargs, order,
                                                         **local)))
        cmp_b = compare_backward(bwd, blend_backward_torch(*bargs, **local),
                                 int(starts[-1]))
        work = blend_work(feat, starts, fwd[2], gw, th, tw, tile_map=tmap)
        ms_f = cuda_ms(lambda: blend_forward_cuda(feat, starts, gh, gw, th,
                                                  tw, order, **local))
        ms_b = cuda_ms(lambda: blend_backward_cuda(*bargs, order, **local))
        ms_fp = cuda_ms(lambda: blend_forward_torch(feat, starts, gh, gw, th,
                                                    tw, **local), iters=3)
        ms_bp = cuda_ms(lambda: blend_backward_torch(*bargs, **local),
                        iters=3)
    print(f"phase 16 blend kernels on local tiles: 1M SH3 {WIDTH}x{HEIGHT} "
          f"tiles {th}x{tw}, rows {row0} + {n_dev} r of {gh} ({rpd * gw} "
          f"tiles, isect={int(starts[-1])}): forward {ms_f:.3f} ms (plain "
          f"{ms_fp:.3f} ms) {json.dumps(cmp_f)}; {work_line(work, 'fwd', ms_f)}"
          f"; backward {ms_b:.3f} ms (plain {ms_bp:.3f} ms), rows "
          f"{json.dumps(cmp_b['row_rel_err'])} of their scale, bitwise equal "
          f"over two launches {same}; {work_line(work, 'bwd', ms_b)}",
          flush=True)
    assert cmp_f["err_rgb"] <= ATOL and cmp_f["err_final_t"] <= ATOL
    assert cmp_f["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp_f["mismatch_at_boundary"] and same
    assert max(cmp_b["row_rel_err"]) <= BWD_RTOL and (
        cmp_b["dead_abs_sum"] == 0.0), cmp_b
    res = {
        "blend_forward": {"ms": ms_f, "plain_ms": ms_fp,
                          "max_abs_err": cmp_f["max_abs_err"],
                          "bound_ms": work["fwd_bound_ms"],
                          "bound_by": work["fwd_bound_by"],
                          "tile_map": list(tmap), "num_tiles": rpd * gw},
        "blend_backward": {"ms": ms_b, "plain_ms": ms_bp,
                           "max_abs_err": cmp_b["max_abs_err"],
                           "bound_ms": work["bwd_bound_ms"],
                           "bound_by": work["bwd_bound_by"],
                           "bitwise_equal_over_two_launches": same,
                           "tile_map": list(tmap), "num_tiles": rpd * gw}}
    del scene, prep, plan, feat, starts, fwd, bwd, bargs, d_rgb, d_ft, order
    torch.cuda.empty_cache()
    return res


def phase_sharded_ranks() -> dict:
    """2 and 4 gloo ranks on the card (`phase16_sharded_rank`), with the
    (2, 2) train step on the 4; one NCCL rank (`phase16_nccl_rank`); the
    multihost smoke as 2 processes through --dist. Returns the ranks'
    results."""
    os.makedirs(SHARD_DIR, exist_ok=True)
    res = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn_ranks(phase16_sharded_rank, world)
        sec = time.perf_counter() - t0
        for r, out in enumerate(ranks):
            shown = {k: v for k, v in out.items() if k != "train"}
            print(f"phase 16 D={world} rank {r} ({sec:.1f} s for the "
                  f"group): {json.dumps(shown)}", flush=True)
            assert out["backend"] == "gloo", out["backend"]
            for name in ("tile_interleaved", "tile_contiguous", "primitive"):
                case = out[name]
                assert not any(v for k, v in case["stats"].items()
                               if k.startswith("overflow")), (name, case)
                assert case["image_err"] <= SHARD_IMAGE_ATOL, (name, case)
                assert case["grad"]["within_tol"], (name, case)
                assert min(case["launches"][k] for k in PATH_KERNELS) > 0, (
                    name, case)
                assert not any(case["plain_calls"].values()), (name, case)
        res[f"D{world}"] = ranks
    train = [out["train"] for out in res["D4"]]
    for r, out in enumerate(train):
        print(f"phase 16 (2, 2) train step trained_116k {WIDTH}x{HEIGHT}, "
              f"{TRAIN_VIEWS} orbit views, 2 a data rank, rank {r}: "
              f"{json.dumps(out)}", flush=True)
        assert out["losses"] == train[0]["losses"], "ranks disagree"
        assert out["losses"][-1] < out["losses"][0], out["losses"]
        assert min(out["launches"][k] for k in PATH_KERNELS) > 0, out
        assert not any(out["plain_calls"].values()), out

    t0 = time.perf_counter()
    (nccl,) = spawn_ranks(phase16_nccl_rank, 1)
    print(f"phase 16 one NCCL rank ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(nccl)}", flush=True)
    assert nccl["backend"] == "nccl" and nccl["image_bit_equal"]
    assert nccl["tile"]["grad"]["within_tol"], nccl["tile"]
    assert min(nccl["tile"]["launches"][k] for k in PATH_KERNELS) > 0
    assert math.isclose(*nccl["train_loss"], rel_tol=1e-6), nccl
    assert all(g["within_tol"] for g in nccl["train_grads"].values()), nccl
    res["nccl"] = nccl

    coord = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gsrast_tpu_torch.diag.multihost_smoke",
         "--coord", coord, "--nprocs", "2", "--rank", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    sums = [line for out in outs for line in out.splitlines()
            if line.startswith("MULTIHOST_OK")]
    print(f"phase 16 multihost_smoke, 2 processes through --dist "
          f"({time.perf_counter() - t0:.1f} s): "
          f"{' | '.join(ln for out in outs for ln in out.splitlines())}",
          flush=True)
    assert all(p.returncode == 0 for p in procs), outs
    assert len(sums) == 2 and sums[0] == sums[1], sums
    return res


# -- phase 17: the reference's default path ------------------------------
# `render(scene, camera)` with the reference's RenderConfig(): the legacy
# two-tier binning (tiers=()) through the blend kernels, and the capped
# autograd oracle (the reference's 'xla' backend) that holds them.
LEGACY_DIR = os.path.join(OUT_DIR, "phase17")
# Oracle against the kernels: image and final_t where n_contrib agrees, as
# the reference holds its kernels to its oracle (tests/test_pallas_blend.py
# :104-147); gradients per parameter group, relative to the group's largest
# magnitude (:118-119).
ORACLE_ATOL = 3e-6
ORACLE_GRAD_RTOL = 2e-5
N_SMALL, SMALL_SIZE = 100_000, 800  # the bench's --small
# Saved (tiles, positions, pixels) float tensors of one oracle chunk under
# autograd: a reckoning for its memory, printed before the run.
ORACLE_SAVED_TENSORS = 12


def quantized_depth_scene(n: int, size: int, device):
    """The bench scene and camera at n Gaussians and size x size, z snapped
    to multiples of 2^-11. The legacy key keeps depth_bits = 31 -
    bit_length(local tiles + 1) of the depth's float bits, so a rank's key,
    over fewer local tiles, orders depths more finely than the
    single-device key, and two depths equal in the one and unequal in the
    other blend in another order (slot order against depth order). With
    every depth z + 2.5 a multiple of 2^-11 in [1.5, 3.5] the coarsest key
    here drops no depth bit, so every key orders the depths alike and exact
    ties fall back to Gaussian order in every plan."""
    from gsrast_tpu_torch import benchmark

    scene, cam = benchmark.bench_scene_camera(n, size, size, device=device)
    with torch.no_grad():
        scene.means[:, 2] = torch.round(scene.means[:, 2] * 2048.0) / 2048.0
    return scene, cam


def legacy_depth_lossless(scene, cam, rcfg) -> bool:
    """Whether the whole grid's legacy key drops no bit of any visible
    Gaussian's depth."""
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.ops.projection import depth_order_key

    gh, gw = rcfg.grid_shape(cam.height, cam.width)
    dshift = (gh * gw + 1).bit_length()
    with torch.no_grad():
        prep = preprocess(scene.activated(), cam, rcfg)
    bits = depth_order_key(prep.depth)[prep.radius > 0]
    return bool(((bits & ((1 << dshift) - 1)) == 0).all())


def phase17_sharded_rank(rank: int, world: int, port: int) -> None:
    """2 gloo ranks on the card: the legacy tile-sharded render,
    interleaved and contiguous, and the legacy primitive-sharded render of
    `quantized_depth_scene` at --small, each against the single-device
    legacy `render` (2e-5, the reference's tests/test_sharded.py:77-78); the
    same tile-interleaved render of the bench scene itself, whose gap is
    printed, not held; one legacy train step on a (2, 1) mesh."""
    dev, backend = _rank_setup(rank, world, port)
    res = legacy_sharded_cases(rank, world, dev)
    res["backend"] = backend
    _rank_write("phase17_sharded_rank", rank, res, out_dir=LEGACY_DIR)


def legacy_sharded_cases(rank: int, world: int, dev) -> dict:
    """The cases of `phase17_sharded_rank` on this rank of a process group
    already joined; returns the results."""
    import dataclasses

    from gsrast_tpu_torch import _kernels, benchmark
    from gsrast_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                           render_primitive_sharded,
                                           render_tile_sharded)
    from gsrast_tpu_torch.render.api import render
    from gsrast_tpu_torch.scene.dataset import Dataset, orbit_cameras

    plain = _PlainCounts()
    mesh = make_mesh((1, world))
    res = {}

    def case(run, act, ref_image):
        _kernels.reset_launch_counts()
        plain.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = run(act)
        torch.cuda.synchronize()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "image_err": float((out.image - ref_image).abs().max()),
                "stats": {k: int(v) for k, v in out.stats.items()},
                "launches": dict(_kernels.launch_counts),
                "plain_calls": dict(plain.counts)}

    for name, quantized in (("quantized_depth", True), ("bench", False)):
        if quantized:
            scene, cam = quantized_depth_scene(N_SMALL, SMALL_SIZE, dev)
        else:
            scene, cam = benchmark.bench_scene_camera(
                N_SMALL, SMALL_SIZE, SMALL_SIZE, device=dev)
        rcfg = benchmark.bench_render_config(scene, cam, "cuda", tiers=())
        act = scene.activated()
        act = dataclasses.replace(act, **{
            f.name: getattr(act, f.name).detach()
            for f in dataclasses.fields(act)})
        with torch.no_grad():
            ref = render(act, cam, rcfg).image
        runs = {"tile_interleaved": lambda g: render_tile_sharded(
            g, cam, rcfg, mesh)}
        if quantized:
            nl = N_SMALL // world
            rows = slice(rank * nl, (rank + 1) * nl)
            runs.update(
                tile_contiguous=lambda g: render_tile_sharded(
                    g, cam, rcfg, mesh, interleave=False),
                primitive=lambda g: render_primitive_sharded(
                    dataclasses.replace(g, **{
                        f.name: getattr(g, f.name)[rows]
                        for f in dataclasses.fields(g)}),
                    cam, rcfg, mesh))
            res["depth_lossless"] = legacy_depth_lossless(scene, cam, rcfg)
        res[name] = {k: case(run, act, ref) for k, run in runs.items()}

    # One legacy train step on a (2, 1) mesh: a camera a data rank.
    scene, cam = quantized_depth_scene(N_SMALL, SMALL_SIZE, dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda", tiers=())
    views = orbit_cameras((0.0, 0.0, 0.0), 2.5, SMALL_SIZE, SMALL_SIZE, 2,
                          device=dev)
    data = Dataset(cameras=views, images=torch.full(
        (2, SMALL_SIZE, SMALL_SIZE, 3), 0.25, device=dev))
    step = make_sharded_train_step(rcfg, make_mesh((world, 1)), SMALL_SIZE,
                                   SMALL_SIZE)
    _kernels.reset_launch_counts()
    plain.reset()
    t0 = time.perf_counter()
    loss, grads = step(scene, data.batch_cameras([0, 1]),
                       data.batch_images([0, 1]))
    torch.cuda.synchronize()
    res["train"] = {
        "loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in grads.values()),
        "launches": dict(_kernels.launch_counts),
        "plain_calls": dict(plain.counts)}
    return res


def oracle_bytes(tiles: int, tile_chunk: int, k: int, p: int) -> int:
    """The autograd oracle's reckoned saved bytes for a backward: per chunk
    ORACLE_SAVED_TENSORS float32 (tile_chunk, k, p) tensors."""
    chunks = -(-tiles // tile_chunk)
    return chunks * ORACLE_SAVED_TENSORS * tile_chunk * k * p * 4


def phase_legacy(dev, tier_ms: dict) -> dict:
    """Phase 17: the reference's default path on the card. The 1M/1080p
    bench scene's fwd+bwd on the legacy binning with the reference bench's
    knobs (benchmark.run_bench, best and median of 10; one launch of each
    blend kernel a step, no plain call) and its stage table;
    trained_116k/1080p on it with the
    reference's trained-scene capacity (overflow_tile_cap counted, equal on
    the plain path); both blend kernels against their plain versions on the
    1M legacy inputs, their times beside the tier plan's (`tier_ms`, this
    run); the autograd oracle against the kernels (trained_116k forward at
    1080p, --small gradients); build_binning on the card against the CPU;
    the legacy sharded renders and train step on 2 gloo ranks
    (`phase17_sharded_rank`). Returns the kernels' numbers on the path."""
    from gsrast_tpu_torch import _kernels, benchmark
    from gsrast_tpu_torch import config as cfg
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.api import render
    from gsrast_tpu_torch.render.blend import (blend_backward_cuda,
                                               blend_backward_torch,
                                               blend_forward_cuda,
                                               blend_forward_torch,
                                               tile_order, tile_order_cuda)
    from gsrast_tpu_torch.render.pipeline import pack_features
    from gsrast_tpu_torch.scene.ply import load_ply

    plain = _PlainCounts()
    res = {}

    def counters(stats):
        return {k: int(stats[k]) for k in (
            "num_intersections", "overflow_capacity", "overflow_tile_cap",
            "overflow_per_tile")}

    # The 1M bench scene at 1080p, fwd+bwd on the legacy binning.
    scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH, HEIGHT,
                                              device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda", tiers=())
    assert (rcfg.tiers, rcfg.tile_h, rcfg.tile_w,
            rcfg.max_tiles_per_gaussian, rcfg.intersect_capacity_factor) == (
                (), 16, 32, 16, 5.0), rcfg
    _kernels.reset_launch_counts()
    plain.reset()
    benchmark.bench_step(scene, cam, rcfg)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    plain_calls = dict(plain.counts)
    best, median, mpix = benchmark.run_bench(scene, cam, rcfg, iters=10)
    stages = benchmark.stage_table(scene, cam, rcfg, iters=3)
    with torch.no_grad():
        stats_1m = counters(render(scene, cam, rcfg).stats)
    print(f"phase 17 legacy fwd+bwd 1M SH3 {WIDTH}x{HEIGHT} tiles 16x32 "
          f"(tiers=(), K2 16, capacity 5 N): best {best:.3f} ms, median "
          f"{median:.3f} ms of 10 = {mpix:.3f} Mpix/s by the best "
          f"(benchmark.run_bench); one step's launches {json.dumps(launches)}"
          f", plain-version calls {json.dumps(plain_calls)}; counters "
          f"{json.dumps(stats_1m)}; stage table, best of 3 (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}",
          flush=True)
    assert launches["blend_forward"] == 1 and launches["blend_backward"] == 1
    assert launches["tile_order"] == 1, launches
    assert not any(plain_calls.values()), plain_calls
    assert stats_1m["overflow_tile_cap"] == stats_1m["overflow_capacity"] == 0
    res["step"] = {"best_ms": best, "median_ms": median, "mpix_s": mpix,
                   "launches": launches, "stages": stages, **stats_1m}

    # Both kernels against their plain versions on the 1M legacy inputs.
    gen = torch.Generator(device=dev).manual_seed(17)
    with torch.inference_mode():
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        th, tw = rcfg.tile_h, rcfg.tile_w
        prep = preprocess(scene.activated(), cam, rcfg)
        bins = binning.build_binning(prep, gh, gw, rcfg,
                                     rcfg.capacity(N_NORTH_STAR))
        feat, starts = pack_features(prep, bins), bins.tile_starts
        args = (feat, starts, gh, gw, th, tw)
        order = tile_order_cuda(starts)
        fwd = blend_forward_cuda(*args, order=order)
        cmp_f = compare_blend(fwd, blend_forward_torch(*args),
                              cfg.TRANSMITTANCE_MIN)
        d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen, device=dev)
        d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
        bargs = (feat, starts, d_rgb, d_ft, fwd[1], fwd[2], gh, gw, th, tw)
        bwd = blend_backward_cuda(*bargs, order=order)
        same = bool(torch.equal(bwd, blend_backward_cuda(*bargs,
                                                         order=order)))
        cmp_b = compare_backward(bwd, blend_backward_torch(*bargs),
                                 int(starts[-1]))
        work = blend_work(feat, starts, fwd[2], gw, th, tw)
        ms_f = cuda_ms(lambda: blend_forward_cuda(*args, order=order))
        ms_b = cuda_ms(lambda: blend_backward_cuda(*bargs, order=order))
        ms_fp = cuda_ms(lambda: blend_forward_torch(*args), iters=3)
        ms_bp = cuda_ms(lambda: blend_backward_torch(*bargs), iters=3)
        seg = starts[1:] - starts[:-1]
        launch = order_launch(starts)
        assert launch() == 0
        res["tile_order"] = {
            "launches": launches["tile_order"],
            "ms": cuda_ms(lambda: [launch() for _ in range(RAW_REPS)])
            / RAW_REPS,
            "plain_ms": cuda_ms(lambda: tile_order(starts)),
            "max_abs_err": order_err(order, starts),
            **dict(zip(("bound_ms", "bound_by"), order_bound(gh * gw))),
            "library_ms": None}
    print(f"phase 17 blend kernels on the legacy inputs, 1M SH3 "
          f"{WIDTH}x{HEIGHT} tiles {th}x{tw} (capacity {feat.shape[1]}, "
          f"isect={int(starts[-1])}, longest segment {int(seg.max())}): "
          f"forward {ms_f:.3f} ms (plain {ms_fp:.3f} ms; tier plan this run "
          f"{tier_ms['blend_forward']:.3f} ms) {json.dumps(cmp_f)}; "
          f"{work_line(work, 'fwd', ms_f)}; backward {ms_b:.3f} ms (plain "
          f"{ms_bp:.3f} ms; tier plan this run "
          f"{tier_ms['blend_backward']:.3f} ms), rows "
          f"{json.dumps(cmp_b['row_rel_err'])} of their scale, bitwise equal "
          f"over two launches {same}; {work_line(work, 'bwd', ms_b)}; tile "
          f"order {json.dumps(res['tile_order'])}", flush=True)
    assert cmp_f["err_rgb"] <= ATOL and cmp_f["err_final_t"] <= ATOL
    assert cmp_f["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp_f["mismatch_at_boundary"] and same
    assert max(cmp_b["row_rel_err"]) <= BWD_RTOL, cmp_b
    assert cmp_b["dead_abs_sum"] == 0.0, cmp_b
    assert res["tile_order"]["max_abs_err"] == 0.0
    res["blend_forward"] = {
        "launches": launches["blend_forward"], "ms": ms_f, "plain_ms": ms_fp,
        "max_abs_err": cmp_f["max_abs_err"], "bound_ms": work["fwd_bound_ms"],
        "bound_by": work["fwd_bound_by"], "library_ms": None,
        "nc_mismatch": cmp_f["nc_mismatch"]}
    res["blend_backward"] = {
        "launches": launches["blend_backward"], "ms": ms_b, "plain_ms": ms_bp,
        "max_abs_err": cmp_b["max_abs_err"], "bound_ms": work["bwd_bound_ms"],
        "bound_by": work["bwd_bound_by"], "library_ms": None,
        "bitwise_equal_over_two_launches": same}
    del scene, prep, bins, feat, starts, fwd, bwd, bargs, d_rgb, d_ft, order
    torch.cuda.empty_cache()

    # trained_116k at 1080p on the legacy binning, the reference's trained-
    # scene capacity, its tile grid and K2 from bench_config (no auto tile).
    scene = load_ply(FIXTURE_116K, device=dev)
    cam = auto_frame(*scene.bbox(), WIDTH, HEIGHT, device=dev)
    n116 = scene.capacity
    rcfg = benchmark.bench_render_config(
        scene, cam, "cuda", tiers=(),
        intersect_capacity_factor=max(64.0, 8e6 / n116))
    with torch.no_grad():
        out_k = render(scene, cam, rcfg)
        out_p = render(scene, cam, rcfg.replace(backend="torch"))
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        bins = binning.build_binning(
            preprocess(scene.activated(), cam, rcfg), gh, gw, rcfg,
            rcfg.capacity(n116))
        longest = int((bins.tile_starts[1:] - bins.tile_starts[:-1]).max())
    stats_k, stats_p = counters(out_k.stats), counters(out_p.stats)

    def tiles_of(o):
        return (o.image.permute(2, 0, 1).reshape(1, 3, -1),
                o.final_t.reshape(1, -1), o.n_contrib.reshape(1, -1))

    cmp_kp = compare_blend(tiles_of(out_k), tiles_of(out_p),
                           cfg.TRANSMITTANCE_MIN)
    print(f"phase 17 legacy trained_116k {WIDTH}x{HEIGHT} tiles 16x32 "
          f"(capacity factor {rcfg.intersect_capacity_factor:.1f}, K2 "
          f"{rcfg.max_tiles_per_gaussian}): counters on the kernels "
          f"{json.dumps(stats_k)}, on the plain versions "
          f"{json.dumps(stats_p)}; longest segment {longest}; image against "
          f"the plain path {json.dumps(cmp_kp)}", flush=True)
    assert stats_k["overflow_tile_cap"] > 0 and stats_k == stats_p
    assert cmp_kp["err_rgb"] <= ATOL and cmp_kp["err_final_t"] <= ATOL
    assert cmp_kp["nc_mismatch_share"] <= MAX_NC_MISMATCH
    res["trained_116k"] = stats_k

    # The oracle forward at trained_116k/1080p, its cap above the longest
    # segment, against the kernels' render.
    ocfg = rcfg.replace(backend="autograd", max_per_tile=longest)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        out_o = render(scene, cam, ocfg)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
    peak_fwd = torch.cuda.max_memory_allocated() / 2**30
    cmp_o = compare_blend(tiles_of(out_k), tiles_of(out_o),
                          cfg.TRANSMITTANCE_MIN)
    stats_o = counters(out_o.stats)
    print(f"phase 17 autograd oracle forward trained_116k {WIDTH}x{HEIGHT} "
          f"(max_per_tile {longest}, tile_chunk {ocfg.tile_chunk}; "
          f"{oracle_s:.2f} s, peak {peak_fwd:.2f} GiB): counters "
          f"{json.dumps(stats_o)}; the kernels' render against it "
          f"{json.dumps(cmp_o)}", flush=True)
    assert stats_o["overflow_per_tile"] == 0
    assert {k: v for k, v in stats_o.items() if k != "overflow_per_tile"} == {
        k: v for k, v in stats_k.items() if k != "overflow_per_tile"}
    assert cmp_o["err_rgb"] <= ORACLE_ATOL, cmp_o
    assert cmp_o["err_final_t"] <= ORACLE_ATOL, cmp_o
    assert cmp_o["nc_mismatch_share"] <= MAX_NC_MISMATCH, cmp_o
    assert cmp_o["mismatch_at_boundary"], cmp_o
    res["oracle_forward"] = dict(cmp_o, seconds=oracle_s, peak_gib=peak_fwd)
    del scene, out_k, out_p, out_o, bins
    torch.cuda.empty_cache()

    # The oracle's gradients at --small against the kernels': mean(img^2)
    # through the five parameter groups (benchmark.bench_step).
    scene, cam = benchmark.bench_scene_camera(N_SMALL, SMALL_SIZE,
                                              SMALL_SIZE, device=dev)
    rcfg = benchmark.bench_render_config(scene, cam, "cuda", tiers=())
    with torch.no_grad():
        gh, gw = rcfg.grid_shape(SMALL_SIZE, SMALL_SIZE)
        bins = binning.build_binning(
            preprocess(scene.activated(), cam, rcfg), gh, gw, rcfg,
            rcfg.capacity(N_SMALL))
        longest = int((bins.tile_starts[1:] - bins.tile_starts[:-1]).max())
    k = -(-longest // 128) * 128
    ocfg = rcfg.replace(backend="autograd", max_per_tile=k, tile_chunk=16)
    reckoned = oracle_bytes(gh * gw, ocfg.tile_chunk, k,
                            rcfg.tile_h * rcfg.tile_w)
    print(f"phase 17 autograd oracle gradients --small ({N_SMALL}, "
          f"{SMALL_SIZE}x{SMALL_SIZE}, {gh * gw} tiles of 16x32, K {k}, TC "
          f"{ocfg.tile_chunk}): reckoned {reckoned / 2**30:.2f} GiB saved "
          f"for the backward", flush=True)
    grads_k = {f: g.clone() for f, g in
               benchmark.bench_step(scene, cam, rcfg).items()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads_o = benchmark.bench_step(scene, cam, ocfg)
    torch.cuda.synchronize()
    oracle_grad_s = time.perf_counter() - t0
    peak_bwd = torch.cuda.max_memory_allocated() / 2**30
    grad_err = {}
    for f, ref in grads_o.items():
        scale = float(ref.abs().max())
        assert scale > 0 and bool(torch.isfinite(grads_k[f]).all()), f
        grad_err[f] = float((grads_k[f] - ref).abs().max()) / scale
    with torch.no_grad():
        ovf = int(render(scene, cam, ocfg).stats["overflow_per_tile"])
    print(f"phase 17 autograd oracle gradients --small: the kernels' "
          f"against the oracle's, relative to each group's largest |g| "
          f"{json.dumps(grad_err)}; oracle fwd+bwd {oracle_grad_s:.2f} s, "
          f"peak allocated {peak_bwd:.2f} GiB; oracle overflow_per_tile "
          f"{ovf}", flush=True)
    assert ovf == 0
    assert max(grad_err.values()) <= ORACLE_GRAD_RTOL, grad_err
    res["oracle_gradients"] = dict(grad_err, seconds=oracle_grad_s,
                                   peak_gib=peak_bwd,
                                   reckoned_gib=reckoned / 2**30)
    del scene, grads_k, grads_o, bins
    torch.cuda.empty_cache()

    # build_binning on the card against the CPU, on one Preprocessed.
    small = load_ply(FIXTURE_SMALL, device=dev)
    cam_s = auto_frame(*small.bbox(), 128, 128, device=dev)
    equal = {}
    for label, over, local in (
            ("default", {}, None),
            ("16x32 K1 2 K2 6", dict(tile_h=16, tile_w=32,
                                     max_tiles_per_gaussian=6,
                                     base_tiles_per_gaussian=2), None),
            ("16x32 rows 1 + 2r", dict(tile_h=16, tile_w=32,
                                       max_tiles_per_gaussian=6,
                                       base_tiles_per_gaussian=2),
             (4, 1, 2)),
            ("capacity 0.5 N", dict(intersect_capacity_factor=0.5), None)):
        bcfg = cfg.RenderConfig(**over)
        with torch.no_grad():
            prep = preprocess(small.activated(), cam_s, bcfg)
        gh, gw = bcfg.grid_shape(128, 128)
        kw = {} if local is None else dict(zip(
            ("num_local_rows", "row0", "row_stride"), local))
        cap = bcfg.capacity(small.capacity)
        on_card = binning.build_binning(prep, gh, gw, bcfg, cap, **kw)
        prep_cpu = prep._replace(**{f: getattr(prep, f).cpu()
                                    for f in prep._fields if f != "rect"},
                                 rect=prep.rect._replace(**{
                                     f: getattr(prep.rect, f).cpu()
                                     for f in prep.rect._fields}))
        on_cpu = binning.build_binning(prep_cpu, gh, gw, bcfg, cap, **kw)
        equal[label] = {
            "equal": all(torch.equal(a.cpu(), b)
                         for a, b in zip(on_card, on_cpu)),
            **{k: int(getattr(on_card, k)) for k in (
                "num_intersections", "overflow_capacity",
                "overflow_tile_cap")}}
    print(f"phase 17 build_binning on the card against the CPU, "
          f"trained_small 128x128, every field: {json.dumps(equal)}",
          flush=True)
    assert all(v["equal"] for v in equal.values()), equal
    res["build_binning_card_vs_cpu"] = equal

    # The legacy sharded renders and train step on 2 gloo ranks.
    os.makedirs(LEGACY_DIR, exist_ok=True)
    t0 = time.perf_counter()
    ranks = spawn_ranks(phase17_sharded_rank, 2, out_dir=LEGACY_DIR)
    sec = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        print(f"phase 17 legacy sharded, 2 gloo ranks on the card, rank {r} "
              f"({sec:.1f} s for the group): {json.dumps(out)}", flush=True)
        assert out["backend"] == "gloo" and out["depth_lossless"], out
        for name, c in out["quantized_depth"].items():
            assert c["image_err"] <= SHARD_IMAGE_ATOL, (name, c)
            assert not any(v for k, v in c["stats"].items()
                           if k.startswith("overflow")), (name, c)
            assert c["launches"]["blend_forward"] == 1, (name, c)
            assert not any(c["plain_calls"].values()), (name, c)
        train = out["train"]
        assert train["loss"] == ranks[0]["train"]["loss"], "ranks disagree"
        assert math.isfinite(train["loss"]) and train["grads_finite"], train
        assert train["launches"]["blend_forward"] >= 1, train
        assert train["launches"]["blend_backward"] >= 1, train
        assert not any(train["plain_calls"].values()), train
    res["sharded"] = ranks
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "gsrast_tpu_torch")):
        print(f"chip_smoke: no gsrast_tpu_torch package beside {ROOT}; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gsrast_tpu_torch import _kernels, benchmark, cli
    from gsrast_tpu_torch import config as cfg
    from gsrast_tpu_torch.camera import auto_frame, look_at, make_camera
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.render.blend import (blend_backward_cuda,
                                               blend_backward_torch,
                                               blend_forward_cuda,
                                               blend_forward_torch,
                                               tile_order, tile_order_cuda)
    from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack
    from gsrast_tpu_torch.render.tiled import untile, untile_cf
    from gsrast_tpu_torch.scene.gaussians import (from_numpy, pad_to_capacity,
                                                  random_scene)
    from gsrast_tpu_torch.scene.ply import load_ply
    from gsrast_tpu_torch.train import checkpoint as ckpt
    from gsrast_tpu_torch.train.loss import rgb_loss
    from gsrast_tpu_torch.train.trainer import (TrainConfig, apply_gradients,
                                                init_train_state,
                                                make_train_step,
                                                maybe_densify, step_generator)
    from gsrast_tpu_torch.diag import bisect_bwd as bb
    from gsrast_tpu_torch.ops.sh import SH_C0
    from gsrast_tpu_torch.scene import colmap
    from gsrast_tpu_torch.scene.dataset import orbit_cameras, save_dataset
    from gsrast_tpu_torch.train.resilience import (ResilienceConfig,
                                                   all_finite,
                                                   read_heartbeat,
                                                   run_resilient)
    from gsrast_tpu_torch.utils.image import load_png, save_png
    from gsrast_tpu_torch.utils.profiling import device_memory_report
    import numpy as np

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    os.makedirs(OUT_DIR, exist_ok=True)

    # -- phase 1: the card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}",
          flush=True)

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = _kernels.load()
    ptxas = [ln.strip() for ln in built.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f}s (nvcc "
          f"{built.build_seconds:.2f}s) {built.path.name}; "
          + " | ".join(ptxas), flush=True)

    with torch.inference_mode():
        # -- phase 3: kernel against plain version, trained_116k/1080p -----
        scene = load_ply(FIXTURE_116K, device=dev)
        cam = auto_frame(*scene.bbox(), WIDTH, HEIGHT, device=dev)
        rcfg = auto_render_config(scene, cam)
        assert rcfg.backend == "cuda"
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        th, tw = rcfg.tile_h, rcfg.tile_w
        prep = preprocess(scene.activated(), cam, rcfg)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
        feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
        args = (feat, starts, gh, gw, th, tw)
        order = tile_order_cuda(starts)
        order_err116 = order_err(order, starts)
        launch = order_launch(starts)
        assert launch() == 0
        order_ms = {"kernel": cuda_ms(lambda: [launch() for _ in range(
                        RAW_REPS)]) / RAW_REPS,
                    "wrapper": cuda_ms(lambda: tile_order_cuda(starts)),
                    "plain": cuda_ms(lambda: tile_order(starts))}
        out_k = blend_forward_cuda(*args, order=order)
        cmp116 = compare_blend(out_k, blend_forward_torch(*args),
                               cfg.TRANSMITTANCE_MIN)
        # Blended (pixel, position) pairs, skipped positions included.
        positions = int(out_k[2].sum())
        n_tiles_116k = gh * gw
        ms_k = cuda_ms(lambda: blend_forward_cuda(*args, order=order))
        ms_p = cuda_ms(lambda: blend_forward_torch(*args))
        ab116 = order_ab(lambda o: blend_forward_cuda(*args, order=o), starts)
        work116 = blend_work(feat, starts, out_k[2], gw, th, tw)
        print(f"phase 3 tile order trained_116k ({gh * gw} tiles, longest "
              f"segment {int((starts[1:] - starts[:-1]).max())}): largest "
              f"bucket difference from the plain version {order_err116}; "
              f"kernel alone {order_ms['kernel']:.4f} ms, through the "
              f"wrapper {order_ms['wrapper']:.4f} ms, plain "
              f"{order_ms['plain']:.4f} ms, bound "
              f"{order_bound(gh * gw)[0]:.6f} ms", flush=True)
        print(f"phase 3 blend trained_116k {WIDTH}x{HEIGHT} tiles {th}x{tw} "
              f"tiers={rcfg.tiers} isect={int(plan.total)} "
              f"positions={positions}: "
              f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms; "
              f"{json.dumps(cmp116)}; {work_line(work116, 'fwd', ms_k)}; "
              f"tile order A/B (kernel alone) {json.dumps(ab116)}",
              flush=True)
        assert order_err116 == 0.0
        assert cmp116["err_rgb"] <= ATOL and cmp116["err_final_t"] <= ATOL
        assert cmp116["nc_mismatch_share"] <= MAX_NC_MISMATCH
        assert cmp116["mismatch_at_boundary"] and ab116["same_bits"]

        # Small input: the card's render of trained_small against the
        # plain CPU path, which the CPU tests hold against the reference.
        small = load_ply(FIXTURE_SMALL)
        cam_s = auto_frame(*small.bbox(), 128, 128)
        cfg_s = auto_render_config(small, cam_s)
        ref_s = render(small, cam_s, cfg_s)
        out_s = render(load_ply(FIXTURE_SMALL, device=dev), cam_s.to(dev),
                       cfg_s.replace(backend="cuda"))
        err_s = float((out_s.image.cpu() - ref_s.image).abs().max())
        nc_s = int((out_s.n_contrib.cpu() != ref_s.n_contrib).sum())
        print(f"phase 3 small trained_small 128x128: max |gpu - cpu| image "
              f"{err_s:.3g}, n_contrib mismatches {nc_s}", flush=True)
        assert out_s.image.shape == (128, 128, 3) and err_s <= 1e-3

    # -- phase 4: end to end through the CLI -------------------------------
    _kernels.reset_launch_counts()
    png = os.path.join(OUT_DIR, "chip_smoke_116k.png")
    img = cli.main(["render", FIXTURE_116K, "--width", str(WIDTH),
                    "--height", str(HEIGHT), "--out", png])
    torch.cuda.synchronize()
    launches_cli = dict(_kernels.launch_counts)
    assert min(launches_cli[k] for k in PATH_KERNELS[:2]) > 0, launches_cli
    assert img.device == dev and img.shape == (HEIGHT, WIDTH, 3)
    assert bool(torch.isfinite(img).all())
    assert float(img.amax()) > 0.05, "image is all background"
    assert os.path.getsize(png) > 0
    print(f"phase 4 cli render: launches={launches_cli} image mean "
          f"{float(img.mean()):.4f} -> {os.path.relpath(png, ROOT)}",
          flush=True)

    # -- phase 5: north-star scale, forward --------------------------------
    with torch.inference_mode():
        scene = random_scene(N_NORTH_STAR, np.random.default_rng(0), sh_degree=3,
                             isotropic=False, scale_range=(0.002, 0.008),
                             device=dev)
        cam = make_camera(look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0],
                                  device=dev), 1.2, 1.0, WIDTH, HEIGHT,
                          device=dev)
        rcfg = auto_render_config(scene, cam)
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        th, tw = rcfg.tile_h, rcfg.tile_w
        _kernels.reset_launch_counts()
        out = render(scene, cam, rcfg)
        torch.cuda.synchronize()
        launches_1m = dict(_kernels.launch_counts)
        assert min(launches_1m[k] for k in PATH_KERNELS[:2]) > 0, launches_1m
        assert bool(torch.isfinite(out.image).all())
        overflow = int(out.stats["overflow_tile_cap"])
        isect = int(out.stats["num_intersections"])
        assert overflow == 0, f"overflow_tile_cap={overflow}"

        act = scene.activated()
        prep = preprocess(act, cam, rcfg)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
        feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
        args = (feat, starts, gh, gw, th, tw)
        blend = blend_forward_cuda(*args)
        cmp1m = compare_blend(blend, blend_forward_torch(*args),
                              cfg.TRANSMITTANCE_MIN)
        ab1m = order_ab(lambda o: blend_forward_cuda(*args, order=o), starts)
        stages = {
            "preprocess": cuda_ms(lambda: preprocess(scene.activated(), cam,
                                                     rcfg)),
            "plan": cuda_ms(lambda: binning.plan_tiers(prep, gh, gw, rcfg)),
            "sort_pack": cuda_ms(lambda: sort_pack(feature_rows(prep), plan,
                                                   gh * gw)),
            "blend": cuda_ms(lambda: blend_forward_cuda(*args)),
            "untile": cuda_ms(lambda: (
                untile_cf(blend[0], gh, gw, rcfg, HEIGHT, WIDTH),
                untile(blend[1], gh, gw, rcfg, HEIGHT, WIDTH),
                untile(blend[2], gh, gw, rcfg, HEIGHT, WIDTH))),
        }
        plain_1m = cuda_ms(lambda: blend_forward_torch(*args), iters=5)
        fwd_ms = cuda_ms(lambda: render(scene, cam, rcfg))
        work1m = blend_work(feat, starts, blend[2], gw, th, tw)
    print(f"phase 5 north-star 1M SH3 {WIDTH}x{HEIGHT} tiles {th}x{tw} "
          f"tiers={rcfg.tiers}: forward {fwd_ms:.3f} ms = "
          f"{WIDTH * HEIGHT / fwd_ms / 1e3:.3f} Mpix/s; stages ms "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
          f"plain blend {plain_1m:.3f} ms; isect={isect} "
          f"positions={int(blend[2].sum())} "
          f"overflow_tile_cap={overflow} launches={launches_1m}; "
          f"{json.dumps(cmp1m)}; blend (the stage: order and kernel) "
          f"{work_line(work1m, 'fwd', stages['blend'])}; tile order A/B "
          f"(kernel alone) {json.dumps(ab1m)}", flush=True)
    assert cmp1m["err_rgb"] <= ATOL and cmp1m["err_final_t"] <= ATOL
    assert cmp1m["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp1m["mismatch_at_boundary"] and ab1m["same_bits"]

    # -- phase 6: backward kernel against plain backward, 1080p ----------
    gen = torch.Generator(device=dev).manual_seed(0)
    bwd = {}
    with torch.inference_mode():
        scenes = {"trained_116k": load_ply(FIXTURE_116K, device=dev),
                  "1M": random_scene(N_NORTH_STAR, np.random.default_rng(0),
                                     sh_degree=3, scale_range=(0.002, 0.008),
                                     device=dev)}
        for name, scn in scenes.items():
            if name == "1M":
                cam = make_camera(look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0],
                                          device=dev), 1.2, 1.0, WIDTH,
                                  HEIGHT, device=dev)
            else:
                cam = auto_frame(*scn.bbox(), WIDTH, HEIGHT, device=dev)
            rcfg = auto_render_config(scn, cam)
            gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
            th, tw = rcfg.tile_h, rcfg.tile_w
            prep = preprocess(scn.activated(), cam, rcfg)
            plan = binning.plan_tiers(prep, gh, gw, rcfg)
            feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
            order = tile_order_cuda(starts)
            _, ft, nc = blend_forward_cuda(feat, starts, gh, gw, th, tw,
                                           order)
            d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen,
                                device=dev)
            d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
            args = (feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw)
            first = blend_backward_cuda(*args, order=order)
            # Sums in a fixed order: a second launch gives the same bits.
            same_bits = bool(torch.equal(
                first, blend_backward_cuda(*args, order=order)))
            cmp = compare_backward(first, blend_backward_torch(*args),
                                   int(starts[-1]))
            cmp["bitwise_equal_over_two_launches"] = same_bits
            cmp["tile_order_err"] = order_err(order, starts)
            cmp["kernel_ms"] = cuda_ms(
                lambda: blend_backward_cuda(*args, order=order))
            cmp["plain_ms"] = cuda_ms(lambda: blend_backward_torch(*args))
            cmp["tile_order_ab"] = order_ab(
                lambda o: blend_backward_cuda(*args, order=o), starts)
            cmp["work"] = blend_work(feat, starts, nc, gw, th, tw)
            bwd[name] = cmp
            shown = {k: v for k, v in cmp.items() if k != "work"}
            print(f"phase 6 blend backward {name} {WIDTH}x{HEIGHT} tiles "
                  f"{th}x{tw} isect={int(plan.total)} positions="
                  f"{int(nc.sum())}: kernel {cmp['kernel_ms']:.3f} ms, plain "
                  f"{cmp['plain_ms']:.3f} ms; {json.dumps(shown)}; "
                  f"{work_line(cmp['work'], 'bwd', cmp['kernel_ms'])}",
                  flush=True)
            assert same_bits, f"{name}: two launches differ"
            assert cmp["tile_order_err"] == 0.0, name
            assert cmp["tile_order_ab"]["same_bits"], name
            assert max(cmp["row_rel_err"]) <= BWD_RTOL, cmp
            assert min(cmp["row_scale"]) > 0 and cmp["dead_abs_sum"] == 0.0
        del scenes, prep, plan, feat, starts, ft, nc, d_rgb, d_ft, args, first
        del order

    # -- phase 7: whole-render gradients, card against CPU -----------------
    def render_grads(scn, cam, rcfg) -> dict:
        delta = torch.zeros((scn.capacity, 2), device=cam.device,
                            requires_grad=True)
        out = render(scn, cam, rcfg, mean2d_delta=delta)
        (torch.mean((out.image - 0.25) ** 2)
         + 0.1 * torch.mean(out.final_t)).backward()
        grads = {f: p.grad.cpu() for f, p in scn.param_groups().items()}
        grads["mean2d_delta"] = delta.grad.cpu()
        return grads

    small = load_ply(FIXTURE_SMALL)
    cam_s = auto_frame(*small.bbox(), 128, 128)
    cfg_s = auto_render_config(small, cam_s).replace(background=BACKGROUND)
    g_cpu = render_grads(small, cam_s, cfg_s)
    _kernels.reset_launch_counts()
    g_gpu = render_grads(load_ply(FIXTURE_SMALL, device=dev), cam_s.to(dev),
                         cfg_s.replace(backend="cuda"))
    torch.cuda.synchronize()
    launches_grad = dict(_kernels.launch_counts)
    grad_err = {}
    for name, ref in g_cpu.items():
        scale = float(ref.abs().max())
        assert scale > 0, f"{name}: zero gradient"
        assert bool(torch.isfinite(g_gpu[name]).all()), name
        grad_err[name] = float((g_gpu[name] - ref).abs().max()) / scale
    print(f"phase 7 render gradients trained_small 128x128, card vs CPU, "
          f"relative to each group's largest magnitude: "
          f"{json.dumps(grad_err)} launches={launches_grad}", flush=True)
    assert max(grad_err.values()) <= GRAD_RTOL, grad_err
    assert min(launches_grad[k] for k in PATH_KERNELS) > 0, launches_grad

    # -- phase 8: training at full width, trained_116k at 1080p ------------
    base = load_ply(FIXTURE_116K, device=dev)
    n_116k = base.capacity
    cam = auto_frame(*base.bbox(), WIDTH, HEIGHT, device=dev)
    mn, mx = (x.cpu().numpy() for x in base.bbox())
    extent = float(np.linalg.norm(mx - mn))
    rcfg = auto_render_config(base, cam, margin=1.5)
    with torch.no_grad():
        target = render(base, cam, rcfg).image
    arrays = {f: p.detach().cpu().numpy()
              for f, p in base.param_groups().items()}
    # The reference's perturbation (N(0, 0.03^2) on a scene in [-1, 1]^3)
    # scaled to this scene's half bbox diagonal.
    arrays["means"] = arrays["means"] + 0.03 * 0.5 * extent * (
        np.random.default_rng(2).standard_normal(arrays["means"].shape))
    arrays["opacity_logits"] = arrays["opacity_logits"] - 0.5
    scene = pad_to_capacity(from_numpy(arrays, device=dev), n_116k + 4096)
    tc = TrainConfig(densify_from=10, densify_until=10, densify_every=10)
    state = init_train_state(scene, tc, extent)
    step = make_train_step(rcfg, tc, extent)
    _kernels.reset_launch_counts()
    metrics, step_ms, dens = [], [], None
    for i in range(30):
        step_ms.append(event_ms(
            lambda: metrics.append(step(state, cam, target))))
        info = maybe_densify(state, tc, step_generator(dev, i), extent)
        if info is not None:
            dens = {k: v for k, v in info.items() if k != "changed_slots"}
    torch.cuda.synchronize()
    launches_train = dict(_kernels.launch_counts)
    loss0, loss30 = float(metrics[0]["loss"]), float(metrics[-1]["loss"])
    psnr30 = float(metrics[-1]["psnr"])
    print(f"phase 8 train trained_116k {WIDTH}x{HEIGHT} tiles "
          f"{rcfg.tile_h}x{rcfg.tile_w} 30 steps: loss {loss0:.5f} -> "
          f"{loss30:.5f}, psnr {float(metrics[0]['psnr']):.2f} -> "
          f"{psnr30:.2f}, densify at step 10 {json.dumps(dens)}; step "
          f"{statistics.median(step_ms[-10:]):.3f} ms (median of the last "
          f"10, CUDA events); launches={launches_train}", flush=True)
    assert loss30 < loss0 and np.isfinite(psnr30)
    assert dens is not None and dens["num_active"] == int(
        state.scene.num_active())
    assert launches_train["blend_backward"] >= 30, launches_train
    del state, scene, step, metrics, target

    # -- phase 9: the CLI, train then resume ------------------------------
    ckpt_dir = os.path.join(OUT_DIR, "ckpt")
    ply = os.path.join(OUT_DIR, "trained.ply")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["train", "--scene", FIXTURE_116K, "--width", str(WIDTH),
            "--height", str(HEIGHT), "--steps", "4", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "2", "--save-ply", ply]
    _kernels.reset_launch_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        first = cli.main(argv)
        saved_at = ckpt.latest_step(ckpt_dir)
        argv[argv.index("--steps") + 1] = "6"
        resumed = cli.main(argv + ["--resume"])
    torch.cuda.synchronize()
    launches_cli_train = dict(_kernels.launch_counts)
    trained = load_ply(ply)
    print(f"phase 9 cli train trained_116k {WIDTH}x{HEIGHT}: steps "
          f"{first.step} then resumed to {resumed.step}; checkpoint at "
          f"{saved_at}; launches={launches_cli_train}; saved "
          f"{trained.capacity} Gaussians; cli: "
          f"{' | '.join(log.getvalue().splitlines())}", flush=True)
    assert first.step == 4 and saved_at == 4 and resumed.step == 6
    assert "resumed from step 4" in log.getvalue()
    assert min(launches_cli_train[k] for k in PATH_KERNELS) > 0, (
        launches_cli_train)
    # One order a blend, for its forward and its backward.
    assert launches_cli_train["tile_order"] == launches_cli_train[
        "blend_forward"], launches_cli_train
    assert trained.capacity == n_116k
    assert all(bool(torch.isfinite(p).all())
               for p in trained.param_groups().values())
    del first, resumed, trained

    # -- phase 10: north-star fwd+bwd and train step, 1M SH3 at 1080p -----
    scene = random_scene(N_NORTH_STAR, np.random.default_rng(0), sh_degree=3,
                         scale_range=(0.002, 0.008), device=dev)
    cam = make_camera(look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0], device=dev),
                      1.2, 1.0, WIDTH, HEIGHT, device=dev)
    rcfg = auto_render_config(scene, cam)
    mn, mx = (x.cpu().numpy() for x in scene.bbox())
    extent = float(np.linalg.norm(mx - mn))
    tc = TrainConfig()
    state = init_train_state(scene, tc, extent)
    step = make_train_step(rcfg, tc, extent)
    target = torch.full((HEIGHT, WIDTH, 3), 0.25, device=dev)
    torch.cuda.reset_peak_memory_stats()
    train_ms = cuda_ms(lambda: step(state, cam, target))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # The reference benchmark's step (grad of mean(img^2)), timed by the
    # benchmark's own definition, the one `bench` prints.
    fwd_bwd_best, fwd_bwd_ms, fwd_bwd_mpix = benchmark.run_bench(
        scene, cam, rcfg, iters=10)
    delta = torch.zeros((scene.capacity, 2), device=dev, requires_grad=True)
    split = {"forward": cuda_ms(lambda: render(scene, cam, rcfg,
                                               mean2d_delta=delta))}
    out = render(scene, cam, rcfg, mean2d_delta=delta)
    split["loss"] = cuda_ms(lambda: rgb_loss(out.image, target))
    backward = []
    for _ in range(12):
        state.optimizer.zero_grad(set_to_none=True)
        loss = rgb_loss(render(scene, cam, rcfg,
                               mean2d_delta=delta).image, target)
        backward.append(event_ms(loss.backward))
    split["backward"] = statistics.median(backward[2:])
    with torch.no_grad():
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        th, tw = rcfg.tile_h, rcfg.tile_w
        prep = preprocess(scene.activated(), cam, rcfg)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
        feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
        order = tile_order_cuda(starts)
        _, ft, nc = blend_forward_cuda(feat, starts, gh, gw, th, tw, order)
        d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen, device=dev)
        d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
        split["blend_backward_kernel"] = cuda_ms(lambda: blend_backward_cuda(
            feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw, order))
    split["rest_of_backward"] = split["backward"] - split[
        "blend_backward_kernel"]
    split["adam"] = cuda_ms(lambda: apply_gradients(state, tc, extent))
    print(f"phase 10 north-star 1M SH3 {WIDTH}x{HEIGHT} tiles {th}x{tw}: "
          f"train step {train_ms:.3f} ms; fwd+bwd best of 10 "
          f"{fwd_bwd_best:.3f} ms = {fwd_bwd_mpix:.3f} Mpix/s, median "
          f"{fwd_bwd_ms:.3f} ms (benchmark.run_bench, as bench); split ms "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
          f"peak allocated {peak_gib:.2f} GiB (train step)", flush=True)
    assert all(bool(torch.isfinite(p.grad).all())
               for p in scene.param_groups().values())

    del state, scene, step, target, out, delta, loss, feat, starts, ft, nc
    del order
    torch.cuda.empty_cache()

    # -- phase 11: bisection kernels against their plain versions ---------
    _kernels.reset_launch_counts()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        bb.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches_bisect = {k: v for k, v in _kernels.launch_counts.items()
                       if k.startswith("bisect_")}
    lines = log.getvalue().splitlines()
    print(f"phase 11 bisect entry point: {' | '.join(lines)}; "
          f"launches={launches_bisect}", flush=True)
    assert [ln.split(": ")[1].split()[0] for ln in lines[1:]] == ["OK"] * 4
    assert min(launches_bisect.values()) > 0, launches_bisect
    with torch.inference_mode():
        scene = load_ply(FIXTURE_116K, device=dev)
        cam = auto_frame(*scene.bbox(), WIDTH, HEIGHT, device=dev)
        rcfg = auto_render_config(scene, cam)
        gh, gw = rcfg.grid_shape(HEIGHT, WIDTH)
        prep = preprocess(scene.activated(), cam, rcfg)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
        _, starts = sort_pack(feature_rows(prep), plan, gh * gw)
        # Each tile's segment rounded up to whole chunks of 128.
        padded = (starts[1:] - starts[:-1] + 127) // 128 * 128
        full_starts = torch.cat([padded.new_zeros(1),
                                 padded.cumsum(0, dtype=torch.int32)])
        t = gh * gw
        gen_b = torch.Generator(device=dev).manual_seed(11)
        full = {"starts": full_starts,
                "feat": 2.0 * torch.rand((int(full_starts[-1]) // 8, 128),
                                         generator=gen_b, device=dev),
                "ft": torch.rand((t, 8, 128), generator=gen_b, device=dev),
                "nc": torch.randint(0, int(padded.max()) + 1, (t, 8, 128),
                                    generator=gen_b, device=dev,
                                    dtype=torch.int32),
                "drgb": torch.randn((t, 3, 8, 128), generator=gen_b,
                                    device=dev)}
        longest = int(padded.max())
        tile1 = {"starts": torch.tensor([0, longest], dtype=torch.int32,
                                        device=dev),
                 "feat": 2.0 * torch.rand((longest // 8, 128),
                                          generator=gen_b, device=dev),
                 **{k: full[k][int(padded.argmax())][None]
                    for k in ("ft", "nc", "drgb")}}
        del scene, prep, plan, starts
        sizes = {"script": bb.script_inputs(dev), "full": full,
                 "longest_tile": tile1}
        bisect = {}
        for name, (cuda_fn, torch_fn) in bb.KERNELS.items():
            res = {}
            for size, inputs in sizes.items():
                args = bb.kernel_args(name, inputs)
                got = cuda_fn(*args)
                torch.cuda.synchronize()
                ref = torch_fn(*args)
                assert bool(torch.isfinite(got).all()), name
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                assert scale > 0, name
                launch = bisect_launch(name, args)
                assert launch() == 0, name
                res[size] = {
                    "max_abs_err": err, "rel_err": err / scale,
                    "ms": cuda_ms(lambda: [launch() for _ in range(
                        RAW_REPS)]) / RAW_REPS,
                    "wrapper_ms": cuda_ms(lambda: cuda_fn(*args)),
                    "plain_ms": cuda_ms(lambda: torch_fn(*args), iters=3,
                                        warmup=1)}
            # Where every row lies in a full chunk (the full size), A and B
            # are one PyTorch product; C and D carry a chain, no call does.
            scale_of = {"a": 2.0, "b": torch.where(
                torch.arange(128, device=dev) % 16 == 0, 3.0, 0.0)}
            if name in scale_of:
                feat_full = full["feat"]
                assert torch.equal(torch.mul(feat_full, scale_of[name]),
                                   cuda_fn(*bb.kernel_args(name, full)))
                res["full"]["library_ms"] = cuda_ms(
                    lambda: torch.mul(feat_full, scale_of[name]))
            bisect[name] = res
            print(f"phase 11 bisect_{name} script (T=4, R=64), full "
                  f"(trained_116k {WIDTH}x{HEIGHT} plan: T={t}, "
                  f"R={int(full_starts[-1]) // 8}) and its longest tile "
                  f"alone ({longest} positions): {json.dumps(res)}",
                  flush=True)
            assert max(r["rel_err"] for r in res.values()) <= BISECT_RTOL, (
                name, res)
        del full, tile1, sizes

    # -- phase 12: training from data at full width, through the CLI ------
    base = load_ply(FIXTURE_116K, device=dev)
    mn, mx = (x.cpu().numpy() for x in base.bbox())
    fov_y = 1.0
    fov_x = float(2.0 * np.arctan(np.tan(fov_y / 2) * WIDTH / HEIGHT))
    views = orbit_cameras((mn + mx) / 2, float(np.linalg.norm(mx - mn)) * 1.1,
                          WIDTH, HEIGHT, N_VIEWS, fov_x=fov_x, fov_y=fov_y,
                          device=dev)
    with torch.no_grad():
        rcfg_gt = auto_render_config(base, views[0])
        photos = [render(base, c, rcfg_gt).image for c in views]
    scene_dir = os.path.join(OUT_DIR, "colmap_116k")
    shutil.rmtree(scene_dir, ignore_errors=True)
    t0 = time.perf_counter()
    for i, img in enumerate(photos):
        save_png(img, os.path.join(scene_dir, "images", f"v{i:02d}.png"))
    png_write_ms = (time.perf_counter() - t0) * 1e3 / N_VIEWS
    fx = WIDTH / (2.0 * np.tan(fov_x / 2))
    fy = HEIGHT / (2.0 * np.tan(fov_y / 2))
    sh0 = base.sh.detach()[:, 0].cpu().numpy()
    colmap.write_colmap_bin(
        scene_dir, {1: colmap.ColmapCamera("PINHOLE", WIDTH, HEIGHT, fx, fy,
                                           WIDTH / 2, HEIGHT / 2)},
        [colmap.ColmapImage(f"v{i:02d}.png",
                            colmap.rotmat_to_qvec(c.view[:3, :3].cpu()
                                                  .numpy()),
                            c.view[:3, 3].cpu().numpy(), 1)
         for i, c in enumerate(views)],
        xyz=base.means.detach().cpu().numpy(),
        rgb=np.clip(sh0 * SH_C0 + 0.5, 0.0, 1.0))
    t0 = time.perf_counter()
    for i in range(N_VIEWS):
        load_png(os.path.join(scene_dir, "images", f"v{i:02d}.png"))
    png_read_ms = (time.perf_counter() - t0) * 1e3 / N_VIEWS

    def cli_train(argv) -> tuple:
        _kernels.reset_launch_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            st = cli.main(["train", *argv])
        torch.cuda.synchronize()
        out = log.getvalue()
        losses = {int(m[0]): float(m[1]) for m in re.findall(
            r"step (\d+): loss=(\S+)", out)}
        assert np.all(np.isfinite(list(losses.values()))), out
        assert min(_kernels.launch_counts[k] for k in PATH_KERNELS) > 0, (
            _kernels.launch_counts)
        return st, out, losses, dict(_kernels.launch_counts)

    ck_colmap = os.path.join(OUT_DIR, "ckpt_colmap")
    shutil.rmtree(ck_colmap, ignore_errors=True)
    steps = 3 * N_VIEWS
    t0 = time.perf_counter()
    state, out, losses, launches_colmap = cli_train(
        ["--scene", "colmap", "--data", scene_dir, "--steps", str(steps),
         "--ckpt-every", "8", "--ckpt-dir", ck_colmap])
    colmap_s = time.perf_counter() - t0
    n_init = base.capacity
    assert f"initialized {n_init} gaussians from COLMAP SfM points" in out
    assert sorted(losses) == [0, steps - 1], out  # every 100th and the last
    heartbeat = read_heartbeat(os.path.join(ck_colmap, "heartbeat.json"))
    assert heartbeat is not None and heartbeat["step"] == steps
    assert state.step == steps and all_finite(state)

    ds, xyz, rgb = colmap.load_colmap(scene_dir, device=dev)
    # The photographs read back as written: 8-bit rounding only.
    png_err = float((ds.images - torch.stack(photos).clamp(0.0, 1.0))
                    .abs().max())
    assert png_err <= 0.5 / 255 + 1e-6, png_err
    init = colmap.init_scene_from_points(xyz, rgb, device=dev)
    rcfg0 = auto_render_config(init, ds.cameras[0], margin=1.5)
    tc = TrainConfig()
    # Every view scored at the SfM init and at the trained parameters, under
    # the render config the CLI derives from view 0.
    view_loss, overflow = {}, {}
    with torch.no_grad():
        for name, sc in (("init", init), ("trained", state.scene)):
            outs = [render(sc, c, rcfg0) for c in ds.cameras]
            view_loss[name] = [float(rgb_loss(o.image, img, tc.ssim_weight))
                               for o, img in zip(outs, ds.images)]
            overflow[name] = [int(o.stats["overflow_tile_cap"]) for o in outs]
    # The blend kernels at the tiles of the SfM init (32x64), on view 0,
    # against their plain versions.
    with torch.inference_mode():
        gh0, gw0 = rcfg0.grid_shape(HEIGHT, WIDTH)
        th0, tw0 = rcfg0.tile_h, rcfg0.tile_w
        prep0 = preprocess(init.activated(), ds.cameras[0], rcfg0)
        plan0 = binning.plan_tiers(prep0, gh0, gw0, rcfg0)
        feat0, starts0 = sort_pack(feature_rows(prep0), plan0, gh0 * gw0)
        fargs0 = (feat0, starts0, gh0, gw0, th0, tw0)
        order0 = tile_order_cuda(starts0)
        fwd0 = blend_forward_cuda(*fargs0, order0)
        cmp_f0 = compare_blend(fwd0, blend_forward_torch(*fargs0),
                               cfg.TRANSMITTANCE_MIN)
        d_rgb0 = torch.randn((gh0 * gw0, 3, th0 * tw0), generator=gen,
                             device=dev)
        d_ft0 = torch.randn((gh0 * gw0, th0 * tw0), generator=gen, device=dev)
        bargs0 = (feat0, starts0, d_rgb0, d_ft0, fwd0[1], fwd0[2], gh0, gw0,
                  th0, tw0)
        bwd0 = blend_backward_cuda(*bargs0, order0)
        same0 = bool(torch.equal(bwd0, blend_backward_cuda(*bargs0, order0)))
        cmp_b0 = compare_backward(bwd0, blend_backward_torch(*bargs0),
                                  int(starts0[-1]))
        work0 = blend_work(feat0, starts0, fwd0[2], gw0, th0, tw0)
        ms_f0 = cuda_ms(lambda: blend_forward_cuda(*fargs0, order0))
        ms_b0 = cuda_ms(lambda: blend_backward_cuda(*bargs0, order0))
    print(f"phase 12 blend kernels on the SfM init, view 0, tiles "
          f"{th0}x{tw0} isect={int(starts0[-1])}: forward {ms_f0:.3f} ms "
          f"{json.dumps(cmp_f0)}; {work_line(work0, 'fwd', ms_f0)}; "
          f"backward {ms_b0:.3f} ms, worst row "
          f"{max(cmp_b0['row_rel_err']):.3g} of its scale, bitwise equal "
          f"over two launches {same0}; {work_line(work0, 'bwd', ms_b0)}",
          flush=True)
    assert cmp_f0["err_rgb"] <= ATOL and cmp_f0["err_final_t"] <= ATOL
    assert cmp_f0["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp_f0["mismatch_at_boundary"] and same0
    assert max(cmp_b0["row_rel_err"]) <= BWD_RTOL, cmp_b0
    assert cmp_b0["dead_abs_sum"] == 0.0
    del prep0, plan0, feat0, starts0, fargs0, fwd0, d_rgb0, d_ft0, bargs0, bwd0
    del order0

    mn, mx = (x.cpu().numpy() for x in init.bbox())
    extent = float(np.linalg.norm(mx - mn))
    st2 = init_train_state(init, tc, extent)
    step = make_train_step(rcfg0, tc, extent)
    colmap_ms = [event_ms(lambda: step(st2, ds.cameras[i % N_VIEWS],
                                       ds.images[i % N_VIEWS]))
                 for i in range(2 * N_VIEWS)]
    print(f"phase 12 train --scene colmap --data: {N_VIEWS} views "
          f"{WIDTH}x{HEIGHT}, {n_init} SfM points, {steps} steps in "
          f"{colmap_s:.2f} s (CLI, with init and checkpoints); CLI loss at "
          f"steps 0 and {steps - 1} {json.dumps(losses)}; per-view loss at "
          f"the init and trained {json.dumps(view_loss)}; overflow_tile_cap "
          f"per view {json.dumps(overflow)} (tiers {rcfg0.tiers}, tiles "
          f"{rcfg0.tile_h}x{rcfg0.tile_w}, from view 0); step "
          f"{statistics.median(colmap_ms[-8:]):.3f} ms (median of the last "
          f"8 of 16, CUDA events); PNG 1920x1080 write {png_write_ms:.1f} ms, "
          f"read {png_read_ms:.1f} ms (host, per image), read back within "
          f"{png_err:.3g} of the renders; heartbeat "
          f"{json.dumps(heartbeat)}; launches={launches_colmap}", flush=True)
    for v, (first, last) in enumerate(zip(view_loss["init"],
                                          view_loss["trained"])):
        assert np.isfinite(first) and last < first, (v, view_loss)
    del state, st2, step, init, ds, outs

    ds_dir = os.path.join(OUT_DIR, "dataset_116k")
    shutil.rmtree(ds_dir, ignore_errors=True)
    save_dataset(ds_dir, views, photos)
    state, out, losses_ds, launches_ds = cli_train(
        ["--scene", FIXTURE_116K, "--data", ds_dir, "--steps", "8",
         "--ckpt-dir", os.path.join(OUT_DIR, "ckpt_dataset")])
    assert f"dataset: {N_VIEWS} views {WIDTH}x{HEIGHT}" in out
    assert state.step == 8 and sorted(losses_ds) == [0, 7]
    target_png = os.path.join(OUT_DIR, "target_116k.png")
    with torch.no_grad():
        cam = auto_frame(*base.bbox(), WIDTH, HEIGHT, device=dev)
        save_png(render(base, cam, auto_render_config(base, cam)).image,
                 target_png)
    state, out, losses_tg, launches_tg = cli_train(
        ["--scene", FIXTURE_116K, "--target", target_png, "--steps", "8",
         "--width", str(WIDTH), "--height", str(HEIGHT), "--ckpt-dir",
         os.path.join(OUT_DIR, "ckpt_target")])
    assert state.step == 8 and sorted(losses_tg) == [0, 7]
    print(f"phase 12 train --data <cameras.json dir>: losses at steps 0, "
          f"7 {json.dumps(losses_ds)} launches={launches_ds}; train --target "
          f"<png>: {json.dumps(losses_tg)} launches={launches_tg}",
          flush=True)
    del state

    # -- phase 13: NaN rollback on the card, trained_116k at 1080p --------
    mn, mx = (x.cpu().numpy() for x in base.bbox())
    extent = float(np.linalg.norm(mx - mn))
    tc = TrainConfig()
    state = init_train_state(base, tc, extent)
    step = make_train_step(rcfg_gt, tc, extent)
    rollback_log = []
    rc = ResilienceConfig(ckpt_dir=os.path.join(OUT_DIR, "ckpt_nan"),
                          ckpt_every=4, inject_nan_at_step=6,
                          heartbeat_path=os.path.join(OUT_DIR, "hb_nan.json"))
    shutil.rmtree(rc.ckpt_dir, ignore_errors=True)
    state, stopped = run_resilient(
        state, 10, lambda st, i: step(st, views[i % N_VIEWS],
                                      photos[i % N_VIEWS]),
        rc, log=rollback_log.append)
    print(f"phase 13 run_resilient trained_116k {WIDTH}x{HEIGHT}, NaN "
          f"injected after step 6: {rollback_log}; final step {state.step}, "
          f"finite {all_finite(state)}, stopped early {stopped}", flush=True)
    assert rollback_log == ["step 6: NON-FINITE state detected; rolling back "
                            "to checkpoint step 4 (1/3)"], rollback_log
    assert state.step == 10 and all_finite(state) and not stopped
    del state, step, views, photos, base
    torch.cuda.empty_cache()

    # -- phase 14: the viewer ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    viewer = phase_viewer(dev)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s; memory since "
          f"its start: {json.dumps(device_memory_report())}", flush=True)
    assert viewer["pose_bits_equal"]

    # -- phase 15: the benchmark -------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_bench(dev)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 16: the sharded path ----------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = phase_sharded(dev)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 17: the reference's default path ----------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    legacy = phase_legacy(dev, {
        "blend_forward": statistics.median(ab1m["longest_first"]),
        "blend_backward": bwd["1M"]["kernel_ms"]})
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)

    b116 = bwd["trained_116k"]
    rows_full, tiles_full = int(full_starts[-1]) // 8, t
    print(json.dumps({"kernels": [{
        "name": "tile_order", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/tile_order.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:325",
        "launches": launches_cli_train["tile_order"],
        "max_abs_err": order_err116, "ms": order_ms["kernel"],
        "plain_ms": order_ms["plain"],
        **dict(zip(("bound_ms", "bound_by"), order_bound(n_tiles_116k))),
        "library_ms": None, "legacy_path": legacy["tile_order"],
    }, {
        "name": "blend_forward", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/blend_forward.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:181",
        "launches": launches_cli["blend_forward"],
        "max_abs_err": cmp116["max_abs_err"], "ms": ms_k, "plain_ms": ms_p,
        "bound_ms": work116["fwd_bound_ms"],
        "bound_by": work116["fwd_bound_by"], "library_ms": None,
        "local_tiles": sharded["local_tiles"]["blend_forward"],
        "legacy_path": legacy["blend_forward"],
    }, {
        "name": "blend_backward", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/blend_backward.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:350",
        "launches": launches_cli_train["blend_backward"],
        "max_abs_err": b116["max_abs_err"], "ms": b116["kernel_ms"],
        "plain_ms": b116["plain_ms"],
        "bound_ms": b116["work"]["bwd_bound_ms"],
        "bound_by": b116["work"]["bwd_bound_by"], "library_ms": None,
        "local_tiles": sharded["local_tiles"]["blend_backward"],
        "legacy_path": legacy["blend_backward"],
    }] + [{
        "name": f"bisect_{name}", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/bisect_bwd.cu",
        "replaces": f"scripts/bisect_bwd.py:{line}",
        "launches": launches_bisect[f"bisect_{name}"],
        "max_abs_err": bisect[name]["full"]["max_abs_err"],
        "ms": bisect[name]["full"]["ms"],
        "plain_ms": bisect[name]["full"]["plain_ms"],
        **dict(zip(("bound_ms", "bound_by"),
                   bisect_bound(name, rows_full, tiles_full))),
        "library_ms": bisect[name]["full"].get("library_ms"),
    } for name, line in (("a", 48), ("b", 71), ("c", 105), ("d", 152))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
