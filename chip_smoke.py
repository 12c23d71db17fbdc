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
the CPU, 30 steps at 1080p through the `train.trainer` API in its CUDA
graph, the CLI `train` with a checkpoint resume equal to a straight run,
and the fwd+bwd and train-step times at the north-star size), the
fault-bisection kernels through their entry point (with the probe of
what the L2 fetches for kernel B's reads) and against their plain
versions at the script's shapes and at the size of
trained_116k's 1080p plan, training from data through the CLI (a COLMAP
scene of eight 1080p views of trained_116k with its means as SfM points,
whose 32x64 tiles the blend kernels are also held at, a cameras.json
directory, a target PNG), a NaN rollback at 1080p, and the viewer (the
CLI's point-cloud and ellipsoid modes on trained_116k at 1080p, the point
cloud at 1M, the three new renderers on the card against the CPU, a saved
pose rendered back bit for bit, `info`, the four apps, the native .ply
reader against numpy), and the benchmark through `bench` (the 1M scene
fwd+bwd with its stage table and forward only, `--small`, trained_116k,
the same four with `--chain 8`, each chain captured in one CUDA graph and
its replays held to an eager step, `--backend torch` on the card, the
scene statistics, the tile sweep, and a trained fixture made from a random
scene), and the sharded path (phase 16:
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
and train step on 2 gloo ranks), and the counterparts of the reference's
`__graft_entry__.py` and scaling harness (phase 18: the entry point's
image against the blend's plain versions, the dry run on 2 and 4 gloo ranks sharing the
card, the scaling harness --quick on 1, 2 and 4 ranks, its share
control at D = 1 within SHARE_CONTROL_BAND of the one-rank step), and
the train step as `train` runs it on the card, captured once in a CUDA
graph and replayed (phase 19: 30 graphed steps against 30 eager ones bit
for bit under deterministic algorithms on trained_116k with densify
between replays and on the COLMAP scene's 8 views, 5 on the 1M scene,
both timed with their peak memory, and a NaN rollback through the graph;
phases 8, 9 and 12 train through it too), and the preprocess kernels
(phase 20: forward and backward against their plain versions on the 1M
scene, trained_116k, the COLMAP init and an edge cell of 1,013 Gaussians
whose SH-3 rows are evaluated at degree 1 from an unaligned address,
integer flips held to ties, the backward bit for bit over two launches, a
capture replayed with a second camera, their times beside their bounds,
the backward's registers, spills, shared bytes and resident warps an SM,
and the 1M bench step's `prep` stage profiled), and the loss kernels
(phase 21: forward and backward against the plain version, both held to
the plain version run in float64, on trained_116k's render against its
target at 1080p, the COLMAP view against its photo, a 512x512 pair and
edge cells of 5x7 and a row-strided 1081x1919, a third of their rows tied
(d_pred held there too), two launches bit for bit, a capture replayed on a
new input, their times beside their bounds and the plain version's, each
kernel's registers, spills, shared bytes and blocks; phases 8, 9, 10, 12, 16 and 19 train through them); and
checks that each path went through the kernels.
Each phase prints its lines before the next begins; the line before the last is the per-kernel
JSON record, and the last is {"ok": true, "device": {...}}. Any failure
raises and exits nonzero, as does a run without a card or without the
package beside the script. It imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
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
# The kernels a forward render launches, and those of a fwd+bwd step.
FORWARD_KERNELS = ("preprocess_forward", "tile_order", "blend_forward")
PATH_KERNELS = (*FORWARD_KERNELS, "preprocess_backward", "blend_backward")
# A train step's kernels: the render's and the loss's.
TRAIN_KERNELS = (*PATH_KERNELS, "loss_forward", "loss_backward")
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

    def launch(_alive=out):  # its output lives as long as it
        return fn(*ptrs)
    return launch


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


def bisect_launch(name: str, args: tuple, order=None):
    """The bisection kernel `name` alone, for timing: one launch on `args`
    into an output allocated here, without the wrapper's bounds check (a
    host sync) and zero fill, and not counted. C's and D's blocks take the
    tiles in `order`, by default longest first (`tile_order_cuda`, made
    here), as the wrappers launch them. Returns the launcher, which returns
    the launch's CUDA error code."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.diag.bisect_bwd import CARRIED
    from gsrast_tpu_torch.render.blend import tile_order_cuda

    starts, feat, *blocks = args
    out = torch.zeros_like(feat)
    fn = getattr(_kernels.load().lib, f"gsrast_bisect_{name}")
    if name in CARRIED:
        order = tile_order_cuda(starts) if order is None else order
        blocks = (*blocks, order)
    ptrs = (starts.data_ptr(), len(starts) - 1, feat.data_ptr(),
            *(b.data_ptr() for b in blocks), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def launch(_alive=(out, *blocks)):  # its buffers live as long as it
        return fn(*ptrs)
    return launch


def bisect_sizes(dev) -> dict:
    """Phase 11's inputs of the bisection kernels, by size: the reference
    script's ("script"); "full", trained_116k's WIDTH x HEIGHT tile plan with
    each tile's segment rounded up to whole chunks of 128, feat 2 U[0, 1)
    and seeded ft, nc (over the longest tile's positions) and drgb; and
    "longest_tile", the longest of those tiles alone on fresh feat."""
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.diag import bisect_bwd as bb
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.api import auto_render_config
    from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack
    from gsrast_tpu_torch.scene.ply import load_ply

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
    return {"script": bb.script_inputs(dev), "full": full,
            "longest_tile": tile1}


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
    assert names == ["home"] and min(launches[k] for k in FORWARD_KERNELS)
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
    forward only, `--small`, trained_116k, the same four with `--chain 8`
    (`bench_chain`: one capture recording 8 times an eager step's kernel
    launches, none during the replays, the parameters bit for bit as they
    were, the last step's gradients within CHAIN_GRAD_RTOL of an eager
    step's, or SPREAD_FACTOR times eager steps' spread where that is
    larger, and
    under deterministic algorithms bit for bit, the forward image bit for
    bit, a replay following an in-place change of the opacities),
    `--chain 8 --backend torch`
    refused, the plain versions on the card
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
                FORWARD_KERNELS)
            assert min(launches[k] for k in need) > 0, launches
        else:
            assert not any(_kernels.launch_counts.values()), launches
        res[label] = dict(out, launches=launches, seconds=sec)

    bench("1M fwd+bwd", size)
    bench("1M fwd", ["--fwd-only", "--no-stages", *size])
    bench("--small", ["--small"])
    bench("trained_116k", ["--scene", FIXTURE_116K, *size])
    # The same cells chained: CHAIN steps in one CUDA graph a call.
    # Each with `cli.bench_inputs`' arguments for the checks' own chain.
    big = (N_NORTH_STAR, WIDTH, HEIGHT, None)
    for label, argv, spec in (
            ("1M fwd+bwd", size, big),
            ("1M fwd", ["--fwd-only", *size], big),
            ("--small", ["--small"], (N_SMALL, SMALL_SIZE, SMALL_SIZE, None)),
            ("trained_116k", ["--scene", FIXTURE_116K, *size],
             (0, WIDTH, HEIGHT, FIXTURE_116K))):
        res[f"chain {label}"] = bench_chain(label, argv, spec)
    try:
        cli.main(["bench", "--chain", str(CHAIN), "--backend", "torch",
                  "--scene", FIXTURE_SMALL, "--no-stages"])
    except ValueError as err:
        print(f"phase 15 bench --chain {CHAIN} --backend torch refused: "
              f"{err}", flush=True)
    else:
        raise AssertionError("--chain with --backend torch did not raise")
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


CHAIN = 8  # steps a chained bench call captures in one CUDA graph
CHAIN_REPLAYS = 3  # timed replays of the checks' own chain
# The chained step's gradients against an eager step's: the gather's
# backward sums by atomics (`index_add_`) in no fixed order, so a group's
# gradient moves within rounding of its largest magnitude (phase 16's bound).
CHAIN_GRAD_RTOL = 1e-6
# That rounding grows with the terms an atomic sum takes: on trained_116k
# (up to 460 tiles a Gaussian) eager steps differ from each other by
# several times 1e-6 of a group's largest |g|, and no sum order is fixed. There the chained step is
# held to SPREAD_FACTOR times the most that EAGER_PAIRS eager steps differ
# from a first one, measured beside it, and a chain captured under
# deterministic algorithms to an eager step's bits.
EAGER_PAIRS = 3
SPREAD_FACTOR = 4.0
# After the opacity logits drop by 1 in place, the next replay's opacity
# gradients (or image) move by more than this share of their largest
# magnitude: far above the atomics' rounding, so the graph followed.
CHAIN_MOVED = 1e-3


def param_bits(scene) -> dict:
    """Each parameter group's bits (int32 view), -0.0 told from 0.0."""
    return {k: v.detach().clone().view(torch.int32)
            for k, v in scene.param_groups().items()}


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """PyTorch's deterministic algorithms inside (an op without one
    raises, or with `warn_only` warns and runs), the previous setting
    restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def gib_above(base: int) -> float:
    """The most memory allocated since the last peak reset, above `base`
    bytes, in GiB (after a synchronize)."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def bench_chain(label: str, argv: list, spec: tuple) -> dict:
    """`bench --chain CHAIN --no-stages` on one cell through the CLI (its
    JSON, and the kernel launches per step that its capture recorded), then
    a chain of the same inputs (`cli.bench_inputs(*spec)`, as the CLI makes
    them) held to the checks of phase 15 (`phase_bench`), its peak memory
    over warm-up and capture beside an eager step's. Returns the JSON and
    the checks' numbers."""
    from gsrast_tpu_torch import _kernels, benchmark, cli

    out, lines, sec = captured(cli.main, ["bench", "--chain", str(CHAIN),
                                          "--no-stages", *argv])
    assert json.loads(lines[-1]) == out
    cli_per_step = json.loads(lines[-2].split("in the capture ", 1)[1])
    dev = torch.device("cuda")
    scene, camera, rcfg = cli.bench_inputs(*spec, "cuda", dev)
    args = (scene, camera, rcfg, "--fwd-only" in argv)
    before = param_bits(scene)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = benchmark.StepChain(*args, CHAIN)
    chain_peak = gib_above(base)
    counts = dict(_kernels.launch_counts)
    benchmark.time_steps(steps, CHAIN_REPLAYS)
    replay_launches = sum(_kernels.launch_counts.values()) - sum(
        counts.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    eager = benchmark.bench_step(*args)
    step_peak = gib_above(base)
    eager_counts = dict(_kernels.launch_counts)

    def against_eager(chained, eager) -> float:
        """The largest gap over the groups, in units of each group's
        largest |g| (fwd+bwd), or 0 where the images are bit-equal."""
        if steps.fwd_only:
            assert torch.equal(chained, eager), "the chained image differs"
            return 0.0
        gaps = []
        for name, g in eager.items():
            scale = float(g.abs().max())
            assert scale > 0, name
            gaps.append(float((chained[name] - g).abs().max()) / scale)
        return max(gaps)

    # Eager steps differ from each other by the atomics' order alone: the
    # spread (the most of three) that bounds a replay where it exceeds
    # CHAIN_GRAD_RTOL (trained_116k).
    spread = max(against_eager(benchmark.bench_step(*args), eager)
                 for _ in range(EAGER_PAIRS))
    gap = against_eager(steps.out, eager)
    unchanged = all(torch.equal(v, before[k])
                    for k, v in param_bits(scene).items())
    # An in-place change of an input: the next replay must follow it.
    with torch.no_grad():
        scene.opacity_logits.sub_(1.0)
    old = (steps.out.clone() if steps.fwd_only
           else steps.out["opacity_logits"].clone())
    steps()
    moved = steps.out if steps.fwd_only else steps.out["opacity_logits"]
    moved = float((moved - old).abs().max()) / float(old.abs().max())
    gap_after = against_eager(steps.out, benchmark.bench_step(*args))
    det_gap = 0.0
    if not steps.fwd_only:
        # With PyTorch's deterministic algorithms (`index_add_` sorted, no
        # atomics) a captured chain's replay is an eager step bit for bit.
        with deterministic():
            det_eager = benchmark.bench_step(*args)
            det_steps = benchmark.StepChain(*args, CHAIN)
            det_gap = against_eager(det_steps(), det_eager)
        del det_steps, det_eager
    torch.cuda.synchronize()
    res = {
        "chained_ms": out["chained_ms"],
        "per_dispatch_ms": out["per_dispatch_ms"],
        "ratio": out["chained_ms"] / out["per_dispatch_ms"],
        "captures": steps.captures, "captured": steps.captured,
        "eager_step": eager_counts, "cli_per_step": cli_per_step,
        "replay_launches": replay_launches,
        "params_unchanged": unchanged, "grad_gap": gap,
        "eager_spread": spread, "moved_by_input": moved,
        "grad_gap_after_input": gap_after, "deterministic_gap": det_gap,
        "peak_gib": {"chain": chain_peak, "step": step_peak},
        "seconds": sec,
    }
    print(f"phase 15 bench --chain {CHAIN} {label} ({sec:.1f} s): "
          f"chained_ms {res['chained_ms']:.4f}, per_dispatch_ms "
          f"{res['per_dispatch_ms']:.4f}, ratio {res['ratio']:.4f}; "
          f"{' | '.join(lines[:-1])}; checks {json.dumps(res)}", flush=True)
    print(f"phase 15 {lines[-1]}", flush=True)
    assert out["chain"] == CHAIN and out["value"] > 0
    assert steps.captures == 1, "the chain was not captured once"
    assert steps.captured == {k: CHAIN * v for k, v in eager_counts.items()}
    assert cli_per_step == {k: v for k, v in eager_counts.items() if v}
    assert min(eager_counts[k] for k in (
        FORWARD_KERNELS if steps.fwd_only else PATH_KERNELS)) == 1
    assert replay_launches == 0, "a replay launched a wrapper"
    assert unchanged, "the zero updates changed a parameter"
    bound = max(CHAIN_GRAD_RTOL, SPREAD_FACTOR * spread)
    assert gap <= bound and gap_after <= bound, res
    assert det_gap == 0.0, "the deterministic replay is not the eager step"
    assert moved > CHAIN_MOVED, "the replay did not follow its input"
    return dict(out, **res)


# -- phase 16: the sharded path -------------------------------------------
# The ranks are processes of torch.multiprocessing (spawn), all on cuda:0
# (`diag.dryrun.spawn_ranks`): NCCL takes one rank per GPU, so ranks that
# share the card take gloo and one rank alone takes NCCL. Each rank returns
# its results through the spawner's queue; the first failure of any rank
# fails the phase.
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


def phase16_sharded_rank(world: int, dev) -> dict:
    """D gloo ranks on the card: the tile-sharded render, interleaved and
    contiguous, and the primitive-sharded render of the 1M SH-3 scene at
    1080p (`tie_free_bench_scene`), fwd+bwd, each against `render` on the
    same card; the bench scene's ties, printed; with 4 ranks then the
    data x tile train step on a (2, 2) mesh."""
    import torch.distributed as dist
    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch.parallel import (comm, make_mesh,
                                           render_primitive_sharded,
                                           render_tile_sharded)

    plain = _PlainCounts()
    rank = dist.get_rank()
    mesh = make_mesh((1, world))
    res = {"backend": dist.get_backend()}
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
        res["train"] = _train_2x2(dev, plain)
    return res


def _train_2x2(dev, plain) -> dict:
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


def phase16_nccl_rank(world: int, dev) -> dict:
    """One rank over NCCL on the card: the tile-sharded render of the 1M
    scene at 1080p against `render` (the same launches: bit for bit) with
    its gradient, an all_reduce over NCCL, and the train step against the
    single-device step."""
    import torch.distributed as dist
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
    res = {"backend": dist.get_backend(),
           "transports": dict(comm.transports),
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
    ref_loss = rgb_loss(render(scene, cam, rcfg).image, target,
                        backend=rcfg.backend)
    ref_loss.backward()
    res["train_loss"] = [float(loss), float(ref_loss.detach())]
    res["train_grads"] = {k: _grad_compare(grads[k], p.grad)
                          for k, p in scene.param_groups().items()}
    return res


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
    from gsrast_tpu_torch.diag.dryrun import free_port, spawn_ranks

    res = {}
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn_ranks(phase16_sharded_rank, world, "cuda",
                            timeout=RANK_TIMEOUT)
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
        assert min(out["launches"][k] for k in TRAIN_KERNELS) > 0, out
        assert not any(out["plain_calls"].values()), out

    t0 = time.perf_counter()
    (nccl,) = spawn_ranks(phase16_nccl_rank, 1, "cuda",
                          timeout=RANK_TIMEOUT)
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


def phase17_sharded_rank(world: int, dev) -> dict:
    """2 gloo ranks on the card: the legacy tile-sharded render,
    interleaved and contiguous, and the legacy primitive-sharded render of
    `quantized_depth_scene` at --small, each against the single-device
    legacy `render` (2e-5, the reference's tests/test_sharded.py:77-78); the
    same tile-interleaved render of the bench scene itself, whose gap is
    printed, not held; one legacy train step on a (2, 1) mesh."""
    import torch.distributed as dist

    res = legacy_sharded_cases(dist.get_rank(), world, dev)
    res["backend"] = dist.get_backend()
    return res


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
    from gsrast_tpu_torch.diag.dryrun import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(phase17_sharded_rank, 2, "cuda",
                        timeout=RANK_TIMEOUT)
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


# -- phase 18: the entry point, the dry run and the scaling harness -------

DRYRUN_RANKS = (2, 4)
SCALING_RANKS = 4  # the harness's D = 1, 2, 4
QUICK = (20_000, 512, 256)  # scaling_bench --quick: N, width, height
# The share control at D = 1 over the one-rank tile step, timed in turns:
# the step's work without the exchange's column pack and unpack and the
# image assembly, so at most 1 (and 5% for the spread of host-bound bests
# of scaling_bench.ONE_RANK_ITERS calls). Timed in turns on an H100,
# those parts took 0.59-1.29 ms of a 6.9-8.0 ms forward
# (`phase18_control_rank`; PERF.md §6): if their backward costs no
# more than their forward, the control reads at least 1 - 2 x 1.29 /
# 10.39 of the 10.39-12.24 ms step, so 0.75.
SHARE_CONTROL_BAND = (0.75, 1.05)


def phase18_control_rank(world: int, dev) -> dict:
    """On a group of one rank at the harness's --quick size, each the best
    of scaling_bench.ONE_RANK_ITERS, in turns (ms): the tile step and the
    share control at D = 1 as the harness times them (forward and
    backward), each forward alone, the step's forward up to its tiles (`tile_prefix`'s
    blend stage: no image assembly), its one-rank exchange (the prefix's
    prep stage: preprocess, the screen state packed into columns and
    unpacked) and the control's preprocess alone."""
    from gsrast_tpu_torch.diag import scaling_bench as sb
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.parallel import make_mesh, render_tile_sharded

    scene, camera = sb.scene_camera(*QUICK, dev)
    cfg = sb.bench_config(scene, camera)
    with torch.no_grad():
        act = scene.activated()
    mesh = make_mesh((1, 1))
    loss = sb.share_loss(act, camera, cfg, 1)
    prefix = sb.tile_prefix(act, camera, cfg, mesh)
    res = dict(zip(("step", "control"), sb.timed_turns(
        [sb.tile_step(act, camera, cfg, mesh)[0], lambda: loss().backward()],
        sb.ONE_RANK_ITERS, dev)))
    with torch.no_grad():
        res.update(zip(
            ("step_fwd", "control_fwd", "step_tiles", "exchange",
             "preprocess"),
            sb.timed_turns([
                lambda: render_tile_sharded(act, camera, cfg, mesh), loss,
                lambda: prefix("blend"), lambda: prefix("prep"),
                lambda: preprocess(act, camera, cfg)],
                sb.ONE_RANK_ITERS, dev)))
    return res


def phase_dryrun(dev) -> dict:
    """Phase 18: `diag.dryrun.entry` on the card (100k SH3 at 1024x768; its
    image finite, through the blend kernels, and held against the plain
    versions' image, `render` with the entry config on backend 'torch', as
    phase 15 holds them); `dryrun_multichip` on 2 and 4 gloo ranks sharing
    the card (every overflow counter 0, the ranks agreeing, each through
    the kernels); the scaling harness `--quick` on D = 1, 2, 4 (its JSON in
    `_build/`), its share control at D = 1 over the one-rank tile step
    within SHARE_CONTROL_BAND. Returns the results."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.config import TRANSMITTANCE_MIN
    from gsrast_tpu_torch.diag import dryrun, scaling_bench
    from gsrast_tpu_torch.render.api import render

    res = {}
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        fn, (act, view) = dryrun.entry(device=dev)
        image = fn(act, view)
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        sec = time.perf_counter() - t0
        # The plain versions' image, and final_t and n_contrib of both.
        camera = dryrun.front_camera(image.shape[1], image.shape[0], 2.5, dev)
        outs = [render(act, camera, dryrun.entry_config(dev).replace(
            backend=b)) for b in ("torch", "cuda")]
    tiles = [(img.permute(2, 0, 1).reshape(1, 3, -1),
              o.final_t.reshape(1, -1), o.n_contrib.reshape(1, -1))
             for img, o in ((outs[0].image, outs[0]), (image, outs[1]))]
    cmp_plain = compare_blend(tiles[1], tiles[0], TRANSMITTANCE_MIN)
    res["entry"] = {"shape": list(image.shape), "mean": float(image.mean()),
                    "finite": bool(torch.isfinite(image).all()),
                    "against_plain": cmp_plain, "launches": launches,
                    "s": sec}
    print(f"phase 18 entry(): {json.dumps(res['entry'])}", flush=True)
    assert res["entry"]["finite"], res["entry"]
    assert res["entry"]["shape"] == [768, 1024, 3], res["entry"]
    assert cmp_plain["err_rgb"] <= ATOL and cmp_plain["err_final_t"] <= ATOL
    assert cmp_plain["nc_mismatch_share"] <= MAX_NC_MISMATCH, cmp_plain
    assert min(launches[k] for k in ("tile_order", "blend_forward")) > 0
    del fn, act, view, image, outs, tiles

    # Both groups at once (each rank takes seconds to reach the card).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(DRYRUN_RANKS)) as pool:
        groups = dict(zip(DRYRUN_RANKS, pool.map(
            lambda world: dryrun.spawn_ranks(
                dryrun._dryrun_rank, world, "cuda", timeout=RANK_TIMEOUT),
            DRYRUN_RANKS)))
    sec = time.perf_counter() - t0
    for world, ranks in groups.items():
        print(f"phase 18 dryrun_multichip({world}), gloo ranks sharing the "
              f"card ({sec:.1f} s for both groups): "
              f"{dryrun.dryrun_line(ranks[0])}; launches per rank "
              f"{[r['launches'] for r in ranks]}", flush=True)
        for r in ranks:
            assert r["loss"] == ranks[0]["loss"], "ranks disagree"
            assert r["tile_intersections"] == ranks[0]["tile_intersections"]
            assert min(r["launches"][k] for k in PATH_KERNELS) > 0, r
        res[f"dryrun_{world}"] = ranks

    out = os.path.join(OUT_DIR, "scaling_quick.json")
    t0 = time.perf_counter()
    scaling_bench.main(["--quick", "--ranks", str(SCALING_RANKS),
                        "--iters", "2", "--out", out])
    with open(out) as f:
        scaling = json.load(f)
    print(f"phase 18 scaling_bench --quick on D = "
          f"{scaling['device_counts']} ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(scaling)}", flush=True)
    assert scaling["device_counts"] == [1, 2, 4], scaling
    assert scaling["transport"][1:] == ["gloo", "gloo"], scaling
    assert scaling["cards"] == [1, 1, 1], scaling
    for mode in ("tile", "primitive"):
        assert all(t > 0 for t in scaling["modes"][mode]["step_ms"]), mode
    ratio = (scaling["share_control_ms"]["1"]
             / scaling["modes"]["tile"]["step_ms"][0])
    print(f"phase 18 share control at D = 1 over the one-rank tile step: "
          f"{scaling['share_control_ms']['1']:.4f} / "
          f"{scaling['modes']['tile']['step_ms'][0]:.4f} ms = {ratio:.4f} "
          f"(band {SHARE_CONTROL_BAND})", flush=True)
    # What the control leaves out of the one-rank step, measured apart.
    t0 = time.perf_counter()
    (parts,) = dryrun.spawn_ranks(phase18_control_rank, 1, "cuda",
                                  timeout=RANK_TIMEOUT)
    parts.update(
        ratio=parts["control"] / parts["step"],
        fwd_ratio=parts["control_fwd"] / parts["step_fwd"],
        exchange_over_preprocess=parts["exchange"] - parts["preprocess"],
        assembly=parts["step_fwd"] - parts["step_tiles"])
    print(f"phase 18 share control's parts at D = 1, best of "
          f"{scaling_bench.ONE_RANK_ITERS} ms "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(parts)}",
          flush=True)
    assert SHARE_CONTROL_BAND[0] <= ratio <= SHARE_CONTROL_BAND[1], ratio
    res["scaling"], res["control_parts"] = scaling, parts
    return res


# -- phase 19: the train step in a CUDA graph -----------------------------

# Steps of the eager and the graphed run held bit for bit under
# deterministic algorithms, per cell (1M: fewer, for the time limit).
TRAIN_EQUAL_STEPS = {"trained_116k": 30, "colmap": 30, "1M": 5}
TRAIN_TIMED = 30  # steps timed of each of eager and graphed
TRAIN_READ = 20   # the last of them that the best and median read
NAN_STEPS = 10    # run_resilient's steps: NaN after step 5, checkpoints at 4


def train_bits(state) -> dict:
    """Copies of `state.tensors()`, float32 as int32 bits."""
    return {k: (v.detach().clone().view(torch.int32)
                if v.dtype == torch.float32 else v.detach().clone())
            for k, v in state.tensors().items()}


def train_addresses(state) -> dict:
    """The storage address of each of `state.tensors()`."""
    return {k: v.data_ptr() for k, v in state.tensors().items()}


def train_run(cell, state, fn, steps: int, dev) -> list:
    """`steps` calls of fn(state, view, target) over the cell's views round
    robin, the densify schedule between them; returns each loss (a
    clone: a replay's metrics are the graph's)."""
    from gsrast_tpu_torch.train.trainer import maybe_densify, step_generator

    losses = []
    for _ in range(steps):
        i = state.step
        v = i % len(cell.views)
        losses.append(fn(state, cell.views[v], cell.targets[v])["loss"]
                      .clone())
        maybe_densify(state, cell.tc, step_generator(dev, i), cell.extent)
    return losses


def train_graph_cell(label: str, cell, dev) -> dict:
    """Phase 19 on one cell (a `diag.profile_step.TrainCell`): from two
    copies of its start, TRAIN_EQUAL_STEPS[label] eager and graphed steps
    under deterministic algorithms, every loss and state tensor compared
    bit for bit and the graphed state's addresses held; then, without the
    flag, on the eager copy, TRAIN_TIMED eager steps and TRAIN_TIMED calls
    of a new graph, each timed by CUDA events (best and median of the last
    TRAIN_READ), the peak memory allocated over each run, the launches of
    one eager step and of the capture, and the launches of the replays."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.train.trainer import TrainGraph, make_train_step

    step = make_train_step(cell.rcfg, cell.tc, cell.extent)
    steps = TRAIN_EQUAL_STEPS[label]
    t0 = time.perf_counter()
    with deterministic():
        eager_state, graph_state = cell.state(), cell.state()
        eager_losses = train_run(cell, eager_state, step, steps, dev)
        graph = TrainGraph(step)
        graph_losses = train_run(cell, graph_state, graph, 2, dev)
        addresses = train_addresses(graph_state)
        graph_losses += train_run(cell, graph_state, graph, steps - 2, dev)
        torch.cuda.synchronize()
    moved = [k for k, v in train_addresses(graph_state).items()
             if addresses[k] != v]
    loss_equal = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                  for a, b in zip(eager_losses, graph_losses)]
    eager_bits, graph_bits = train_bits(eager_state), train_bits(graph_state)
    unequal = [k for k in eager_bits
               if not torch.equal(eager_bits[k], graph_bits[k])]
    res = {"equal_steps": steps, "equal_seconds": time.perf_counter() - t0,
           "losses_bit_equal": all(loss_equal),
           "state_tensors": len(eager_bits), "unequal_tensors": unequal,
           "moved_tensors": moved,
           "deterministic_graph": {"captures": graph.captures,
                                   "replays": graph.replays},
           "loss": [float(eager_losses[0]), float(eager_losses[-1])]}
    del graph, graph_state, graph_bits, eager_bits

    view, target = cell.views[0], cell.targets[0]
    _kernels.reset_launch_counts()
    step(eager_state, view, target)
    torch.cuda.synchronize()
    res["eager_step_launches"] = dict(_kernels.launch_counts)
    for name, fn in (("eager", step), ("graphed", TrainGraph(step))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, after_capture = [], None
        for i in range(TRAIN_TIMED):
            v = i % len(cell.views)
            ms.append(event_ms(lambda: fn(eager_state, cell.views[v],
                                          cell.targets[v])))
            if i == 1:
                after_capture = sum(_kernels.launch_counts.values())
        torch.cuda.synchronize()
        tail = ms[-TRAIN_READ:]
        res[name] = {"best_ms": min(tail),
                     "median_ms": statistics.median(tail),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name == "graphed":
            res["captured"] = dict(fn.captured)
            res["replay_launches"] = (sum(_kernels.launch_counts.values())
                                      - after_capture)
            res["graphed"].update(captures=fn.captures, replays=fn.replays)
    res["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    res["eager_over_graphed"] = {
        k: res["eager"][k] / res["graphed"][k] for k in ("best_ms",
                                                         "median_ms")}
    del eager_state, fn
    print(f"phase 19 train step in a CUDA graph, {label} "
          f"({cell.scene.capacity} slots, {cell.views[0].width}x"
          f"{cell.views[0].height}, {len(cell.views)} views, tiles "
          f"{cell.rcfg.tile_h}x{cell.rcfg.tile_w}): eager "
          f"{res['eager']['best_ms']:.3f} / {res['eager']['median_ms']:.3f}"
          f" ms, graphed {res['graphed']['best_ms']:.3f} / "
          f"{res['graphed']['median_ms']:.3f} ms (best / median of the last "
          f"{TRAIN_READ} of {TRAIN_TIMED}, CUDA events); {json.dumps(res)}",
          flush=True)
    assert res["losses_bit_equal"] and not unequal, res
    assert not moved, moved
    assert res["deterministic_graph"] == {"captures": 1,
                                          "replays": steps - 1}
    assert all(res["eager_step_launches"][k] == 1 for k in TRAIN_KERNELS)
    assert res["captured"] == res["eager_step_launches"], res
    assert res["replay_launches"] == 0, "a replay launched a wrapper"
    return res


def nan_rollback_graphed(cell, dev) -> dict:
    """`run_resilient` over a TrainGraph with NaN injected after step 5
    (checkpoints every 4), against the same run uninterrupted, under
    deterministic algorithms: the rollback restores in place and the
    graph, captured once, replays on the restored state to the same
    bits."""
    from gsrast_tpu_torch.train.resilience import (ResilienceConfig,
                                                   run_resilient)
    from gsrast_tpu_torch.train.trainer import (TrainGraph, make_train_step,
                                                maybe_densify, step_generator)

    step = make_train_step(cell.rcfg, cell.tc, cell.extent)
    runs = {}
    with deterministic():
        for label, inject in (("clean", None), ("nan", 5)):
            state, graph, log = cell.state(), TrainGraph(step), []
            held = {}

            def fn(st, i):
                m = graph(st, cell.views[0], cell.targets[0])
                maybe_densify(st, cell.tc, step_generator(dev, i),
                              cell.extent)
                held.setdefault("addresses", train_addresses(st))
                return m

            rc = ResilienceConfig(
                ckpt_dir=os.path.join(OUT_DIR, f"ckpt_graph_{label}"),
                ckpt_every=4, inject_nan_at_step=inject)
            shutil.rmtree(rc.ckpt_dir, ignore_errors=True)
            state, stopped = run_resilient(state, NAN_STEPS, fn, rc,
                                           log=log.append)
            torch.cuda.synchronize()
            runs[label] = {"bits": train_bits(state), "log": log,
                           "step": state.step, "stopped": stopped,
                           "captures": graph.captures,
                           "replays": graph.replays,
                           "kept_addresses": train_addresses(state) == held[
                               "addresses"]}
            del state, graph
    clean, nan = runs["clean"], runs["nan"]
    unequal = [k for k in clean["bits"]
               if not torch.equal(clean["bits"][k], nan["bits"][k])]
    res = {k: {x: v for x, v in run.items() if x != "bits"}
           for k, run in runs.items()}
    res["unequal_tensors"] = unequal
    print(f"phase 19 NaN rollback through the graph, trained_116k "
          f"{WIDTH}x{HEIGHT}: {json.dumps(res)}", flush=True)
    assert nan["log"] == ["step 5: NON-FINITE state detected; rolling back "
                          "to checkpoint step 4 (1/3)"], nan["log"]
    assert clean["log"] == [] and nan["step"] == clean["step"] == NAN_STEPS
    assert nan["captures"] == clean["captures"] == 1
    assert nan["kept_addresses"] and clean["kept_addresses"]
    assert not unequal, unequal
    return res


def phase_train_graph(dev, colmap_dir: str) -> dict:
    """Phase 19: the train step captured once into a CUDA graph and
    replayed (`trainer.TrainGraph`, as the CLI's `train` runs it on the
    card) against eager steps on three cells: trained_116k at 1080p from
    phase 8's start with densify at step 10 between replays, the 1M SH-3
    scene of phase 10, and the SfM init of phase 12's COLMAP scene with its
    8 views round robin through the graph's static inputs
    (`train_graph_cell`); then the NaN rollback through the graph on
    trained_116k (`nan_rollback_graphed`)."""
    from gsrast_tpu_torch.diag.profile_step import (TrainCell, scene_extent,
                                                    train_cell)
    from gsrast_tpu_torch.render.api import auto_render_config
    from gsrast_tpu_torch.scene import colmap
    from gsrast_tpu_torch.train.trainer import TrainConfig

    out = {}
    cell = train_cell("train_trained_116k", dev)
    out["trained_116k"] = train_graph_cell("trained_116k", cell, dev)
    out["nan_rollback"] = nan_rollback_graphed(cell, dev)
    del cell
    torch.cuda.empty_cache()
    ds, xyz, rgb = colmap.load_colmap(colmap_dir, device=dev)
    init = colmap.init_scene_from_points(xyz, rgb, device=dev)
    cell = TrainCell(init, list(ds.cameras), list(ds.images),
                     auto_render_config(init, ds.cameras[0], margin=1.5),
                     TrainConfig(), scene_extent(init))
    out["colmap"] = train_graph_cell("colmap", cell, dev)
    del cell, ds, init
    torch.cuda.empty_cache()
    out["1M"] = train_graph_cell("1M", train_cell("train_default", dev), dev)
    torch.cuda.empty_cache()
    return out


# -- phase 20: the preprocess kernels --------------------------------------

# The preprocess kernels (csrc/preprocess.cu) against their plain versions
# (ops/preprocess.py): float outputs within PRE_RTOL / PRE_ATOL (the forward
# rounds op by op as the plain version does, but a short sum may run in
# another order); radius, rect and visibility equal but at ties, each
# Gaussian that differs within PRE_TIE (relative) of an integer or a cull
# threshold in a float64 recomputation (`preprocess_margins`); gradients
# within PRE_GRAD_RTOL of each group's largest magnitude (the backward's
# products contract into FMAs and its derivatives are taken in closed
# form), non-finite exactly where the plain VJP is.
PRE_RTOL, PRE_ATOL, PRE_TIE, PRE_GRAD_RTOL = 1e-5, 1e-6, 1e-5, 1e-5
# Float operations a Gaussian, read off csrc/preprocess.cu: the forward's
# projection, covariance, conic, direction and extents, the backward's
# recomputation and chain rule, and per evaluated SH coefficient and
# channel (a product and a sum forward; basis, gradient and direction terms
# backward). The kernels are bound by bytes many times over.
PRE_FWD_FLOPS, PRE_BWD_FLOPS = 150, 400
PRE_OUTPUTS = ("mean2d", "depth", "conic", "color", "opacity")
PRE_GRADS = ("means", "scales", "quats", "opacities", "sh")
PRE_SH_FLOPS = {"forward": 3, "backward": 10}
ROT_Y = 0.05  # radians: phase 20's second camera turns the first about y
# The most kernels the bench step's `prep` stage may launch (996 before the
# preprocess kernels): the camera block's ops (camera.device_camera) and
# the two kernels, forward and backward.
PREP_STAGE_KERNELS = 64


def colmap_views(base, dev) -> tuple:
    """Phase 12's COLMAP views of the scene `base`: (N_VIEWS orbit cameras
    at 1080p around its bounding box, fov_x, fov_y)."""
    from gsrast_tpu_torch.diag.profile_step import colmap_views as views

    return views(base, WIDTH, HEIGHT, N_VIEWS, dev)


def preprocess_bound(kind: str, n: int, used: int, k: int) -> tuple:
    """bound() of one preprocess kernel over n Gaussians with `used` SH
    coefficients evaluated of their k, as phase 20 launches it (no
    mean2d_delta, a cotangent on every output): each input read once, each
    output written once. Forward: means 12 B, scales 12, quats 16, opacity
    4, mask 1, the used SH 12 each, writing mean2d, depth, conic, colour,
    opacity, radius and rect (60 B); backward: the same inputs but the
    opacity, the 10 cotangent floats (40 B), writing the five gradients
    (44 B and 12 k of SH)."""
    inputs = 45 + 12 * used
    if kind == "forward":
        nbytes = inputs + 60
        flops = PRE_FWD_FLOPS + PRE_SH_FLOPS[kind] * 3 * used
    else:
        nbytes = inputs - 4 + 40 + 44 + 12 * k
        flops = PRE_BWD_FLOPS + PRE_SH_FLOPS[kind] * 3 * used
    return bound(n * nbytes, n * flops)


def preprocess_margins(act, cam, rcfg) -> dict:
    """The quantities that decide each Gaussian's radius, rect and
    visibility, recomputed in float64 by the plain version's ops: the
    distance of each ceil or floor argument from the nearest integer and of
    each cull test from its threshold, relative to the argument, (N,) each;
    the smallest per Gaussian is its margin."""
    from gsrast_tpu_torch import config as cfg
    from gsrast_tpu_torch.ops import covariance, projection

    def f64(x):
        return x.detach().double()

    means = f64(act.means)
    view = f64(cam.view)
    mv = projection.to_camera(means, view)
    _, ndc = projection.project(means, f64(cam.full_projection()),
                                cam.width, cam.height)
    front = projection.in_frustum(mv[:, 2], ndc) & act.mask
    safe = torch.cat([mv[:, :2], torch.where(front, mv[:, 2], 1.0)[:, None]],
                     dim=1)
    a, b, c = covariance.compute_cov2d(
        safe, covariance.compute_cov3d(f64(act.scales), f64(act.quats)),
        view[:3, :3], f64(cam.focal_x), f64(cam.focal_y),
        f64(cam.tan_fov_x), f64(cam.tan_fov_y)).unbind(-1)
    cfac = torch.clamp(2.0 * torch.log(f64(act.opacities)
                                       / (0.98 * cfg.ALPHA_MIN)),
                       0.0, cfg.GAUSSIAN_EXTENT_SIGMA ** 2)
    ext = [torch.sqrt(cfac * torch.clamp(v, min=0.0)) for v in (a, c)]
    px = ((ndc[:, 0] + 1.0) * cam.width - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * cam.height - 1.0) * 0.5

    def to_int(x):
        return (x - torch.round(x)).abs() / torch.clamp(x.abs(), min=1.0)

    def to_edge(x, edge):
        return (x - edge).abs() / max(abs(edge), 1.0)

    m = cfg.NDC_CULL_MARGIN
    det = a * c - b * b
    margins = {"ext_x": to_int(ext[0]), "ext_y": to_int(ext[1]),
               "depth": to_edge(mv[:, 2], cfg.NEAR_CULL_DEPTH),
               "det": det.abs() / torch.clamp(a * c, min=1e-30)}
    for sign in (-1.0, 1.0):
        margins[f"ndc_x{sign:+.0f}"] = to_edge(ndc[:, 0], sign * m)
        margins[f"ndc_y{sign:+.0f}"] = to_edge(ndc[:, 1], sign * m)
    for axis, (p, e, tile) in {"x": (px, ext[0], rcfg.tile_w),
                               "y": (py, ext[1], rcfg.tile_h)}.items():
        # The rect's floor and ceil arguments, with the extent or with 0
        # (culled), as either version may have taken it.
        args = [(p + sign * r + (sign > 0)) / tile for sign in (-1, 1)
                for r in (torch.ceil(e), torch.zeros_like(e))]
        margins[f"rect_{axis}"] = torch.stack([to_int(x) for x in args]).amin(0)
    return margins


def compare_preprocess(got, ref, act, cam, rcfg) -> dict:
    """The forward kernel's outputs `got` against the plain version's `ref`:
    per float output the largest difference and the count beyond PRE_RTOL /
    PRE_ATOL; the Gaussians whose radius, rect or visibility (the masked
    opacity) differ, and the largest of their margins
    (`preprocess_margins`), which must stay within PRE_TIE."""
    res = {}
    for name in PRE_OUTPUTS:
        a, b = getattr(got, name), getattr(ref, name)
        err = (a - b).abs()
        both = torch.isfinite(a) & torch.isfinite(b)
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        res[name] = {
            "max_abs_err": float(torch.where(both, err, 0.0).max()),
            "beyond": int(((~both & ~same)
                           | (both & (err > PRE_ATOL + PRE_RTOL * b.abs())))
                          .sum())}
    flips = (got.radius != ref.radius) | (got.opacity != ref.opacity)
    for a, b in zip(got.rect, ref.rect):
        flips |= a != b
    idx = torch.nonzero(flips).flatten()
    res["flips"] = int(len(idx))
    res["flip_margin"] = 0.0
    if len(idx):
        margins = preprocess_margins(act, cam, rcfg)
        res["flip_margin"] = float(torch.stack(
            [v[idx] for v in margins.values()]).amin(0).max())
    return res


def preprocess_cell(label: str, act, cam, rcfg, gen) -> dict:
    """Phase 20 on one cell's activated Gaussians and camera (from
    `preprocess_cells`): the forward kernel against
    `preprocess_torch` (`compare_preprocess`); the backward through
    `PreprocessFunction` with seeded cotangents on every output of every
    Gaussian against `preprocess_vjp_torch`, mean2d_delta's gradient
    against its cotangent, and the wrapper's second launch bit for bit;
    both kernels captured in a CUDA graph and replayed with a second camera
    (`cam` turned by ROT_Y) copied into the captured camera's tensors,
    against eager calls on it; the raw launches' and the plain versions'
    ms by CUDA events, with their bounds and shares; and the backward's
    launch (`backward_occupancy`)."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.camera import (CAMERA_TENSORS, device_camera,
                                         matmul_f32)
    from gsrast_tpu_torch.ops import preprocess as pp

    dev = cam.device
    n, k = act.sh.shape[:2]
    degree = pp.sh_degree(act, rcfg)
    used = (degree + 1) ** 2
    dcam = device_camera(cam)
    got = pp.preprocess_forward_cuda(act, dcam, rcfg)
    with torch.no_grad():
        ref = pp.preprocess_torch(act, cam, rcfg)
    res = {"gaussians": n, "sh_rows": k, "sh_used": used,
           "sh_offset_bytes": act.sh.data_ptr() % 16,
           "visible": int((ref.radius > 0).sum()),
           "forward": compare_preprocess(got, ref, act, cam, rcfg)}

    cot = pp.Cotangents(*(torch.randn((n, *shape), generator=gen,
                                      device=dev)
                          for shape in ((2,), (), (3,), (3,), ())))
    leaves = [getattr(act, f).detach().requires_grad_()
              for f in pp.INPUT_FIELDS]
    delta = torch.zeros((n, 2), device=dev, requires_grad=True)
    outs = pp.PreprocessFunction.apply(pp.PREPROCESS_CUDA, cam, rcfg, delta,
                                       *leaves, act.mask)
    grads = torch.autograd.grad(outs[:5], [*leaves, delta], list(cot))
    again = pp.preprocess_backward_cuda(act, dcam, rcfg, cot)
    plain = pp.preprocess_vjp_torch(act, cam, rcfg, cot, delta)
    torch.cuda.synchronize()
    bwd = {"same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip(grads[:5], again[:5])),
           "delta_is_cotangent": bool(torch.equal(grads[5], cot.mean2d))}
    for name, a, b in zip(PRE_GRADS, grads, plain):
        finite = torch.isfinite(b)
        scale = float(torch.where(finite, b, 0.0).abs().max())
        err = float(torch.where(finite, a - b, 0.0).abs().max())
        bwd[name] = {"rel_err": err / max(scale, 1e-30), "scale": scale,
                     "max_abs_err": err,
                     "non_finite": int((~finite).sum()),
                     "non_finite_agree": bool(torch.equal(
                         finite, torch.isfinite(a)))}
    res["backward"] = bwd

    # One capture, replayed with a second camera copied in.
    turn = torch.eye(4, device=dev)
    cs, sn = math.cos(ROT_Y), math.sin(ROT_Y)
    turn[0, 0], turn[0, 2], turn[2, 0], turn[2, 2] = cs, sn, -sn, cs
    second = cam.replace(view=matmul_f32(turn, cam.view))
    static = cam.replace(**{f: getattr(cam, f).clone()
                            for f in CAMERA_TENSORS})

    def both():
        d = device_camera(static)
        return (pp.preprocess_forward_cuda(act, d, rcfg),
                pp.preprocess_backward_cuda(act, d, rcfg, cot))

    _kernels.on_side_stream(both, dev)
    graph, (fwd_g, bwd_g), recorded = _kernels.capture(
        both, "the preprocess kernels")
    for f in CAMERA_TENSORS:
        getattr(static, f).copy_(getattr(second, f))
    graph.replay()
    d2 = device_camera(second)
    fwd_e = pp.preprocess_forward_cuda(act, d2, rcfg)
    bwd_e = pp.preprocess_backward_cuda(act, d2, rcfg, cot)
    torch.cuda.synchronize()
    res["capture"] = {
        "recorded": {k: v for k, v in recorded.items() if v},
        "replay_equals_eager": all(
            torch.equal(a, b) for a, b in zip(
                [*fwd_g[:6], *fwd_g.rect, *bwd_g[:5]],
                [*fwd_e[:6], *fwd_e.rect, *bwd_e[:5]])),
        "moved": float((fwd_g.mean2d - got.mean2d).abs().max())}
    del graph, fwd_g, bwd_g, fwd_e, bwd_e

    launches = {"forward": pp.forward_launch(act, dcam, rcfg),
                "backward": pp.backward_launch(act, dcam, rcfg, cot)}
    plains = {"forward": lambda: pp.preprocess_torch(act, cam, rcfg),
              "backward": lambda: pp.preprocess_vjp_torch(act, cam, rcfg,
                                                          cot)}
    for kind, launch in launches.items():
        assert launch.fn(*launch.args) == 0, kind
        ms = cuda_ms(lambda: [launch.fn(*launch.args)
                              for _ in range(RAW_REPS)]) / RAW_REPS
        bound_ms, by = preprocess_bound(kind, n, used, k)
        res[kind].update(ms=ms, bound_ms=bound_ms, bound_by=by,
                         share=bound_ms / ms,
                         plain_ms=cuda_ms(plains[kind], iters=3, warmup=1))
    launch = res["backward"]["launch"] = backward_occupancy(k, degree)
    print(f"phase 20 preprocess kernels, {label} ({n} Gaussians, SH "
          f"{used} of {k} rows, {cam.width}x{cam.height}, tiles "
          f"{rcfg.tile_h}x{rcfg.tile_w}): forward {res['forward']['ms']:.4f}"
          f" ms (plain {res['forward']['plain_ms']:.3f}), backward "
          f"{res['backward']['ms']:.4f} ms (plain "
          f"{res['backward']['plain_ms']:.3f}, "
          f"{res['backward']['share']:.3f} of its bound); backward launch: "
          f"{launch['registers']} registers, {launch['local_bytes']} B "
          f"local (spills), shared {launch['static_shared']} + "
          f"{launch['dynamic_shared']} B a block of {launch['threads']} "
          f"threads, {launch['resident_warps']} resident warps an SM; "
          f"{json.dumps(res)}", flush=True)
    fwd = res["forward"]
    assert all(fwd[name]["beyond"] == 0 for name in PRE_OUTPUTS), fwd
    assert fwd["flip_margin"] <= PRE_TIE, fwd
    assert bwd["same_bits_twice"] and bwd["delta_is_cotangent"], bwd
    for name in PRE_GRADS:
        assert bwd[name]["non_finite_agree"], (name, bwd[name])
        assert bwd[name]["rel_err"] <= PRE_GRAD_RTOL, (name, bwd[name])
    cap = res["capture"]
    assert cap["replay_equals_eager"] and cap["moved"] > 0, cap
    assert cap["recorded"] == {"preprocess_forward": 1,
                               "preprocess_backward": 1}, cap
    return res


# Phase 20's edge cell: a Gaussian count that leaves the backward's last
# warp 21 of its 32 lanes.
EDGE_N = 1_013
def preprocess_cells(dev, colmap_dir=None) -> list:
    """Phase 20's cells, (key, label, activated Gaussians, camera, config)
    each: the 1M SH-3 bench scene and trained_116k at 1080p; the SfM init
    of phase 12's COLMAP scene at its view 0, read from `colmap_dir` (or,
    without one, made from trained_116k's means and colours as phase 12
    writes them, without the files' rounding); and the edge cell: EDGE_N
    Gaussians of the bench scene's kind, SH 3, under a config of degree 1,
    their SH rows a view 4 bytes into its storage, so that neither the
    count nor the rows' address is aligned."""
    import numpy as np

    from gsrast_tpu_torch import benchmark
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.ops.sh import SH_C0
    from gsrast_tpu_torch.render.api import auto_render_config
    from gsrast_tpu_torch.scene import colmap
    from gsrast_tpu_torch.scene.ply import load_ply

    cells = []

    def add(key, label, scene, cam, rcfg, sh_offset=0):
        with torch.no_grad():
            act = scene.activated()
        if sh_offset:  # the SH rows a view sh_offset floats into storage
            sh = torch.empty(act.sh.numel() + sh_offset, device=dev)
            sh = sh[sh_offset:].view_as(act.sh).copy_(act.sh)
            act = dataclasses.replace(act, sh=sh)
        cells.append((key, label, act, cam, rcfg))

    scene, cam = benchmark.bench_scene_camera(N_NORTH_STAR, WIDTH, HEIGHT,
                                              device=dev)
    add("1M", "1M SH3", scene, cam, auto_render_config(scene, cam))
    base = load_ply(FIXTURE_116K, device=dev)
    cam = auto_frame(*base.bbox(), WIDTH, HEIGHT, device=dev)
    add("trained_116k", "trained_116k", base, cam,
        auto_render_config(base, cam))
    if colmap_dir is None:
        cam = colmap_views(base, dev)[0][0]
        sh0 = base.sh.detach()[:, 0].cpu().numpy()
        scene = colmap.init_scene_from_points(
            base.means.detach().cpu().numpy(),
            np.clip(sh0 * SH_C0 + 0.5, 0.0, 1.0), device=dev)
    else:
        ds, xyz, rgb = colmap.load_colmap(colmap_dir, device=dev)
        scene, cam = colmap.init_scene_from_points(xyz, rgb, device=dev), \
            ds.cameras[0]
    add("colmap", "COLMAP SfM init, view 0", scene, cam,
        auto_render_config(scene, cam, margin=1.5))
    scene, cam = benchmark.bench_scene_camera(EDGE_N, WIDTH, HEIGHT,
                                              device=dev)
    add("edge", f"edge: {EDGE_N} Gaussians, SH 3 rows at degree 1, rows 4 "
        "bytes off", scene, cam,
        auto_render_config(scene, cam).replace(sh_degree=1), sh_offset=1)
    return cells


def backward_occupancy(k: int, degree: int) -> dict:
    """The preprocess backward's launch for SH rows of k coefficients at SH
    degree `degree`, as the library reports it
    (`gsrast_preprocess_backward_occupancy`): threads and dynamic shared
    bytes a block; the kernel's registers and local (spilled) bytes a
    thread and static shared bytes a block (cudaFuncGetAttributes); and the
    warps that one SM holds at once (CUDA's occupancy calculator)."""
    import ctypes

    from gsrast_tpu_torch import _kernels

    keys = ("threads", "dynamic_shared", "blocks_per_sm", "registers",
            "local_bytes", "static_shared")
    out = [ctypes.c_int(0) for _ in keys]
    code = _kernels.load().lib.gsrast_preprocess_backward_occupancy(
        k, degree, *(ctypes.byref(x) for x in out))
    assert code == 0, f"CUDA error {code}"
    res = dict(zip(keys, (x.value for x in out)))
    res["resident_warps"] = res["blocks_per_sm"] * res["threads"] // 32
    return res


def phase_preprocess(dev, colmap_dir: str) -> dict:
    """Phase 20: the preprocess kernels (`preprocess_cell`) on each cell of
    `preprocess_cells`; then the bench step's profile at 1M
    (`diag.profile_step`), whose `prep` stage holds the camera block's ops
    and the two kernels."""
    from gsrast_tpu_torch.diag import profile_step

    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for key, label, act, cam, rcfg in preprocess_cells(dev, colmap_dir):
        out[key] = preprocess_cell(label, act, cam, rcfg, gen)
    del act
    torch.cuda.empty_cache()
    prof = profile_step.profile_cell(
        "default", os.path.join(OUT_DIR, "profile"), dev)
    out["profile"] = {k: prof[k] for k in ("eager", "chained")}
    prep = prof["eager"]["stages"]["prep"]
    print(f"phase 20 profile_step default (1M SH3 {WIDTH}x{HEIGHT} bench "
          f"step): prep {prep['kernels']} kernels, {prep['busy_ms']:.3f} "
          f"busy ms; eager {json.dumps(prof['eager'])}; chained "
          f"{json.dumps(prof['chained'])}", flush=True)
    assert prep["kernels"] <= PREP_STAGE_KERNELS, prep
    return out


# -- phase 21: the loss kernels --------------------------------------------

# Float operations a value (a pixel's channel), read off csrc/loss.cu: the
# forward's three products, two 11-tap passes of five quantities, S, and
# |x - y| with the two sums; the backward's recomputed forward but the sums,
# the three dS terms, their two passes and d_x. The least work (each value
# filtered once), without the tiles' halos.
LOSS_FWD_FLOPS, LOSS_BWD_FLOPS = 246, 402
# The kernels against the plain version, both held to the plain version run
# in float64 on the same inputs: the loss within max(LOSS_ATOL, 2 |plain32
# - plain64|), d_pred within max(LOSS_GRAD_RTOL max |g64|, 2 max |g32 -
# g64|). The card's float32 sums over millions of values, taken in another
# order, and E[x x] - mu mu cancelling where the image is flat make a fixed
# float32 tolerance arbitrary.
LOSS_ATOL, LOSS_GRAD_RTOL = 1e-6, 1e-5
LOSS_WEIGHT = 0.2  # TrainConfig().ssim_weight
LOSS_STRIDE_PAD = 6  # pixels past the edge cell's 1919 in its rows
LOSS_CELLS = ("trained_116k", "colmap", "512", "edge_5x7", "edge")


def loss_work(height: int, width: int, channels: int) -> dict:
    """Bytes, operations and bound() of each loss kernel on an (H, W, C)
    pair: the forward reads pred and target and writes the loss; the
    backward reads them and the cotangent and writes d_pred."""
    n = height * width * channels
    work = {}
    for kind, nbytes, per in (("forward", 8 * n + 4, LOSS_FWD_FLOPS),
                              ("backward", 12 * n + 4, LOSS_BWD_FLOPS)):
        bound_ms, by = bound(nbytes, n * per)
        work[kind] = {"bytes": nbytes, "flops": n * per,
                      "bound_ms": bound_ms, "bound_by": by}
    return work


def compare_loss(pred, target, weight: float) -> dict:
    """The kernels' loss and d_pred (cotangent 1) against the plain
    version's in float32 and both against the plain version in float64,
    with the tolerances those give (see LOSS_ATOL), d_pred's also at the
    ties alone (pred equal to target, where both take the reference's
    abs'(0) = 1); and the kernels' second launches bit for bit."""
    from gsrast_tpu_torch.train import loss as L

    ones = torch.ones((), device=pred.device)

    def kernels():
        return (L.loss_forward_cuda(pred, target, weight),
                L.loss_backward_cuda(pred, target, weight, ones))

    def plain(x, y, one):
        return (L.rgb_loss_torch(x, y, weight),
                L.rgb_loss_vjp_torch(x, y, weight, one))

    got, again = kernels(), kernels()
    p32 = plain(pred, target, ones)
    p64 = plain(pred.double(), target.double(), ones.double())
    torch.cuda.synchronize()

    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    ties = pred == target
    res = {"loss": float(got[0]), "plain_loss": float(p32[0]),
           "loss64": float(p64[0]), "loss_err": gap(got[0], p64[0]),
           "plain_loss_err": gap(p32[0], p64[0]),
           "grad_scale": float(p64[1].abs().max()),
           "grad_err": gap(got[1], p64[1]),
           "ties": int(ties.sum()),
           "tie_grad_err": gap(got[1][ties], p64[1][ties]) if bool(
               ties.any()) else 0.0,
           "plain_grad_err": gap(p32[1], p64[1]),
           "max_abs_err": max(gap(got[0], p32[0]), gap(got[1], p32[1])),
           "same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
           "finite": all(bool(torch.isfinite(t).all()) for t in got)}
    res["loss_tol"] = max(LOSS_ATOL, 2.0 * res["plain_loss_err"])
    res["grad_tol"] = max(LOSS_GRAD_RTOL * res["grad_scale"],
                          2.0 * res["plain_grad_err"])
    return res


def loss_capture(pred, target, weight: float) -> dict:
    """Both kernels captured once in a CUDA graph on a copy of pred, then
    replayed after a second image is copied in: the replay's loss and
    d_pred against eager calls on the second image."""
    from gsrast_tpu_torch import _kernels
    from gsrast_tpu_torch.train import loss as L

    static, ones = pred.clone(), torch.ones((), device=pred.device)
    second = (pred * 0.5 + 0.25).contiguous()

    def both():
        return (L.loss_forward_cuda(static, target, weight),
                L.loss_backward_cuda(static, target, weight, ones))

    first = [t.clone() for t in _kernels.on_side_stream(both, pred.device)]
    graph, out, recorded = _kernels.capture(both, "the loss kernels")
    static.copy_(second)
    graph.replay()
    eager = (L.loss_forward_cuda(second, target, weight),
             L.loss_backward_cuda(second, target, weight, ones))
    torch.cuda.synchronize()
    return {"recorded": {k: v for k, v in recorded.items() if v},
            "replay_equals_eager": all(torch.equal(a, b)
                                       for a, b in zip(out, eager)),
            "moved": float((out[0] - first[0]).abs())}


def loss_occupancy(kind: str, height: int, width: int, channels: int
                   ) -> dict:
    """A loss kernel's launch ("forward" or "backward") on an (H, W, C)
    image, as the library reports it (`gsrast_loss_occupancy`): threads and
    dynamic shared bytes a block, the blocks one SM holds at once, the
    grid's blocks and a segment's rows; the kernel's registers and local
    (spilled) bytes a thread and static shared bytes a block."""
    import ctypes

    from gsrast_tpu_torch import _kernels

    keys = ("threads", "dynamic_shared", "blocks_per_sm", "blocks",
            "segment_rows", "registers", "local_bytes", "static_shared")
    out = [ctypes.c_int(0) for _ in keys]
    code = _kernels.load().lib.gsrast_loss_occupancy(
        int(kind == "backward"), height, width, channels,
        *(ctypes.byref(x) for x in out))
    assert code == 0, f"CUDA error {code}"
    return dict(zip(keys, (x.value for x in out)))


def loss_cell(label: str, pred, target, weight: float = LOSS_WEIGHT
              ) -> dict:
    """Phase 21 on one (pred, target) pair: `compare_loss`; the raw
    launches of each kernel (RAW_REPS back to back, without the wrapper's
    checks) and the plain version's forward and VJP timed by CUDA events,
    with their bounds (`loss_work`) and shares."""
    from gsrast_tpu_torch.train import loss as L

    h, w, c = pred.shape
    res = {"shape": [h, w, c], "row_stride": pred.stride(0),
           **compare_loss(pred, target, weight)}
    ones = torch.ones((), device=pred.device)
    launches = {"forward": L.forward_launch(pred, target, weight),
                "backward": L.backward_launch(pred, target, weight, ones)}
    plains = {"forward": lambda: L.rgb_loss_torch(pred, target, weight),
              "backward": lambda: L.rgb_loss_vjp_torch(pred, target, weight,
                                                       ones)}
    work = loss_work(h, w, c)
    for kind, launch in launches.items():
        assert launch.fn(*launch.args) == 0, kind
        ms = cuda_ms(lambda: [launch.fn(*launch.args)
                              for _ in range(RAW_REPS)]) / RAW_REPS
        res[kind] = dict(work[kind], ms=ms,
                         share=work[kind]["bound_ms"] / ms,
                         plain_ms=cuda_ms(plains[kind], iters=5, warmup=1),
                         launch=loss_occupancy(kind, h, w, c))
    print(f"phase 21 loss kernels, {label} ({h}x{w}x{c}, row stride "
          f"{pred.stride(0)}): forward {res['forward']['ms']:.4f} ms (plain "
          f"{res['forward']['plain_ms']:.3f}, {res['forward']['share']:.3f} "
          f"of its bound), backward {res['backward']['ms']:.4f} ms (plain "
          f"{res['backward']['plain_ms']:.3f}, "
          f"{res['backward']['share']:.3f} of its bound); loss "
          f"{res['loss']:.7f}, error {res['loss_err']:.3g} (tolerance "
          f"{res['loss_tol']:.3g}), d_pred error {res['grad_err']:.3g} "
          f"(tolerance {res['grad_tol']:.3g}; at {res['ties']} ties "
          f"{res['tie_grad_err']:.3g}); " + "; ".join(
              f"{kind} {r['registers']} registers, {r['local_bytes']} "
              f"spilled bytes, {r['dynamic_shared']} dynamic shared bytes, "
              f"{r['blocks']} blocks of {r['segment_rows']} rows"
              for kind, r in ((k, res[k]["launch"]) for k in launches))
          + f"; {json.dumps(res)}", flush=True)
    assert res["finite"] and res["same_bits_twice"], res
    assert res["loss_err"] <= res["loss_tol"], res
    assert res["grad_err"] <= res["grad_tol"], res
    assert res["tie_grad_err"] <= res["grad_tol"], res
    return res


def loss_cells(dev, colmap_dir=None) -> list:
    """Phase 21's cells, (key, label, pred, target) each: the render of
    phase 8's perturbed trained_116k start against its target at 1080p;
    the SfM init of phase 12's COLMAP scene at view 0 against its photo,
    read from `colmap_dir` (or, without one, `profile_step`'s
    `train_colmap` cell, made in memory: the photo the scene's render);
    the same two scenes framed at 512x512 (phase 15's dataset size); and
    edge cells of seeded images, 5x7 (smaller than the window) and
    1081x1919 (ragged against both kernels' tiles), pred a view into rows
    LOSS_STRIDE_PAD pixels longer, a third of its rows equal to the
    target."""
    from gsrast_tpu_torch.camera import auto_frame
    from gsrast_tpu_torch.diag.profile_step import train_cell
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.scene import colmap
    from gsrast_tpu_torch.scene.ply import load_ply

    cells = []
    cell = train_cell("train_trained_116k", dev)
    base = load_ply(FIXTURE_116K, device=dev)
    cam = auto_frame(*base.bbox(), 512, 512, device=dev)
    if colmap_dir is None:
        sfm = train_cell("train_colmap", dev)
        init, view, photo = sfm.scene, sfm.views[0], sfm.targets[0]
    else:
        ds, xyz, rgb = colmap.load_colmap(colmap_dir, device=dev)
        init = colmap.init_scene_from_points(xyz, rgb, device=dev)
        view, photo = ds.cameras[0], ds.images[0]
    with torch.no_grad():
        cells.append(("trained_116k", f"trained_116k {WIDTH}x{HEIGHT}, the "
                      "perturbed start against its target",
                      render(cell.scene, cell.views[0], cell.rcfg).image,
                      cell.targets[0]))
        cells.append(("colmap", "COLMAP SfM init, view 0, against its photo",
                      render(init, view, auto_render_config(
                          init, view, margin=1.5)).image, photo))
        cells.append(("512", "512x512: the perturbed trained_116k against "
                      "trained_116k",
                      render(cell.scene, cam, auto_render_config(
                          cell.scene, cam, margin=1.5)).image,
                      render(base, cam, auto_render_config(base, cam)).image))
    gen = torch.Generator(device=dev).manual_seed(21)
    for key, (h, w) in (("edge_5x7", (5, 7)), ("edge", (1081, 1919))):
        target = torch.rand((h, w, 3), generator=gen, device=dev)
        rows = torch.empty((h, w + LOSS_STRIDE_PAD, 3), device=dev)
        pred = rows[:, :w].copy_((target + 0.1 * torch.randn(
            (h, w, 3), generator=gen, device=dev)).clamp(0.0, 1.0))
        pred[: h // 3] = target[: h // 3]
        cells.append((key, f"edge: {h}x{w}, seeded, a row stride of "
                      f"{w + LOSS_STRIDE_PAD} pixels", pred, target))
    return cells


def phase_loss(dev, colmap_dir: str) -> dict:
    """Phase 21: the loss kernels (`loss_cell`) on each cell of
    `loss_cells`, and one capture of both on the 512x512 cell
    (`loss_capture`)."""
    out = {}
    for key, label, pred, target in loss_cells(dev, colmap_dir):
        out[key] = loss_cell(label, pred, target)
        if key.startswith("edge"):  # a third of the rows tied
            assert out[key]["ties"] > 0, out[key]
        if key == "512":
            cap = out["capture"] = loss_capture(pred, target, LOSS_WEIGHT)
            print(f"phase 21 loss kernels captured in a CUDA graph and "
                  f"replayed on a second image (512x512): "
                  f"{json.dumps(cap)}", flush=True)
            assert cap["replay_equals_eager"] and cap["moved"] > 0, cap
            assert cap["recorded"] == {"loss_forward": 1,
                                       "loss_backward": 1}, cap
    return out


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
    from gsrast_tpu_torch.scene.gaussians import random_scene
    from gsrast_tpu_torch.scene.ply import load_ply
    from gsrast_tpu_torch.train import checkpoint as ckpt
    from gsrast_tpu_torch.train.loss import rgb_loss
    from gsrast_tpu_torch.train.trainer import (TrainConfig, TrainGraph,
                                                apply_gradients,
                                                init_train_state,
                                                make_train_step,
                                                maybe_densify, step_generator)
    from gsrast_tpu_torch.diag import bisect_bwd as bb
    from gsrast_tpu_torch.diag import bisect_timing, profile_step
    from gsrast_tpu_torch.ops.sh import SH_C0
    from gsrast_tpu_torch.scene import colmap
    from gsrast_tpu_torch.scene.dataset import save_dataset
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
    assert min(launches_cli[k] for k in FORWARD_KERNELS) > 0, launches_cli
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
        assert min(launches_1m[k] for k in FORWARD_KERNELS) > 0, launches_1m
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
    # The train cell of diag/profile_step.py: trained_116k framed at 1080p,
    # its render the target, the start perturbed, densify at step 10.
    cell = profile_step.train_cell("train_trained_116k", dev)
    n_116k = int(cell.scene.num_active())
    cam, target, rcfg = cell.views[0], cell.targets[0], cell.rcfg
    tc, extent = cell.tc, cell.extent
    state = cell.state()
    graph = TrainGraph(make_train_step(rcfg, tc, extent))
    _kernels.reset_launch_counts()
    metrics, step_ms, dens = [], [], None

    def kept_step():
        # A replay's metrics are the graph's, rewritten by the next one.
        out = graph(state, cam, target)
        metrics.append({k: v.clone() for k, v in out.items()})

    for i in range(30):
        step_ms.append(event_ms(kept_step))
        info = maybe_densify(state, tc, step_generator(dev, i), extent)
        if info is not None:
            dens = {k: v for k, v in info.items() if k != "changed_slots"}
    torch.cuda.synchronize()
    launches_train = dict(_kernels.launch_counts)
    loss0, loss30 = float(metrics[0]["loss"]), float(metrics[-1]["loss"])
    psnr30 = float(metrics[-1]["psnr"])
    print(f"phase 8 train trained_116k {WIDTH}x{HEIGHT} tiles "
          f"{rcfg.tile_h}x{rcfg.tile_w} 30 steps (TrainGraph: "
          f"{graph.captures} capture, {graph.replays} replays): loss "
          f"{loss0:.5f} -> {loss30:.5f}, psnr {float(metrics[0]['psnr']):.2f}"
          f" -> {psnr30:.2f}, densify at step 10 {json.dumps(dens)}; step "
          f"{statistics.median(step_ms[-10:]):.3f} ms (median of the last "
          f"10, CUDA events); launches={launches_train}", flush=True)
    assert loss30 < loss0 and np.isfinite(psnr30)
    assert dens is not None and dens["num_active"] == int(
        state.scene.num_active())
    assert graph.captures == 1 and graph.replays == 29
    # The warm-up step and the capture launch; the replays do not.
    assert all(launches_train[k] == 2 for k in TRAIN_KERNELS), launches_train
    del state, graph, metrics, target, cell
    # -- phase 9: the CLI, train then resume ------------------------------
    # Under deterministic algorithms (warn_only: the set-up's counting ops
    # have none, and run as they always do), so that 4 steps, a resume and
    # 4 more equal 8 uninterrupted steps bit for bit: the resumed run's
    # graph replays on the restored state.
    ckpt_dir = os.path.join(OUT_DIR, "ckpt")
    ply = os.path.join(OUT_DIR, "trained.ply")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["train", "--scene", FIXTURE_116K, "--width", str(WIDTH),
            "--height", str(HEIGHT), "--steps", "4", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "2", "--save-ply", ply]
    straight_dir = os.path.join(OUT_DIR, "ckpt_straight")
    shutil.rmtree(straight_dir, ignore_errors=True)
    straight_argv = argv[:argv.index("--ckpt-dir")] + [
        "--ckpt-dir", straight_dir, "--ckpt-every", "2"]
    straight_argv[straight_argv.index("--steps") + 1] = "8"
    _kernels.reset_launch_counts()
    logs = [io.StringIO() for _ in range(3)]
    with deterministic(warn_only=True):
        with contextlib.redirect_stdout(logs[0]):
            first = cli.main(argv)
        saved_at = ckpt.latest_step(ckpt_dir)
        argv[argv.index("--steps") + 1] = "8"
        with contextlib.redirect_stdout(logs[1]):
            resumed = cli.main(argv + ["--resume"])
        torch.cuda.synchronize()
        launches_cli_train = dict(_kernels.launch_counts)
        replayed_cli_train = dict(_kernels.replayed_counts)
        with contextlib.redirect_stdout(logs[2]):
            straight = cli.main(straight_argv)
    torch.cuda.synchronize()
    logs = [log.getvalue() for log in logs]
    trained = load_ply(ply)
    straight_bits = param_bits(straight.scene)
    resume_equal = {k: bool(torch.equal(v, straight_bits[k]))
                    for k, v in param_bits(resumed.scene).items()}
    print(f"phase 9 cli train trained_116k {WIDTH}x{HEIGHT}: steps "
          f"{first.step} then resumed to {resumed.step}; checkpoint at "
          f"{saved_at}; launches={launches_cli_train}; replayed="
          f"{replayed_cli_train}; saved "
          f"{trained.capacity} Gaussians; resumed against 8 straight steps, "
          f"bit for bit (deterministic algorithms): "
          f"{json.dumps(resume_equal)}; cli: "
          f"{' | '.join(' / '.join(log.splitlines()) for log in logs)}",
          flush=True)
    assert first.step == 4 and saved_at == 4 and resumed.step == 8
    assert "resumed from step 4" in logs[1]
    capture_line = (f"train: step captured in a CUDA graph ({HEIGHT} x "
                    f"{WIDTH})")
    assert all(log.count(capture_line) == 1 for log in logs), logs
    assert logs[1].index("resumed from step 4") < logs[1].index(capture_line)
    assert all(resume_equal.values()), resume_equal
    assert min(launches_cli_train[k] for k in TRAIN_KERNELS) > 0, (
        launches_cli_train)
    # Each 4-step run: an eager warm-up and a capture call the wrappers
    # (the forward's also render the run's target), and 3 replays run
    # what the capture recorded, one launch of each train kernel.
    assert all(launches_cli_train[k] == 4 for k in (
        "blend_backward", "loss_forward", "loss_backward")), (
        launches_cli_train)
    assert replayed_cli_train == {k: 6 * (k in TRAIN_KERNELS)
                                  for k in replayed_cli_train}, (
        replayed_cli_train)
    # One order a blend, for its forward and its backward.
    assert launches_cli_train["tile_order"] == launches_cli_train[
        "blend_forward"], launches_cli_train
    assert trained.capacity == n_116k
    assert all(bool(torch.isfinite(p).all())
               for p in trained.param_groups().values())
    del first, resumed, straight, trained

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
    _kernels.reset_launch_counts()
    train_ms = cuda_ms(lambda: step(state, cam, target))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches_1m_train = dict(_kernels.launch_counts)
    # cuda_ms: 2 warm-up steps and 10 timed, each through every kernel.
    assert all(launches_1m_train[k] == 12 for k in TRAIN_KERNELS), (
        launches_1m_train)

    # The reference benchmark's step (grad of mean(img^2)), timed by the
    # benchmark's own definition, the one `bench` prints.
    fwd_bwd_best, fwd_bwd_ms, fwd_bwd_mpix = benchmark.run_bench(
        scene, cam, rcfg, iters=10)
    delta = torch.zeros((scene.capacity, 2), device=dev, requires_grad=True)
    split = {"forward": cuda_ms(lambda: render(scene, cam, rcfg,
                                               mean2d_delta=delta))}
    out = render(scene, cam, rcfg, mean2d_delta=delta)
    split["loss"] = cuda_ms(lambda: rgb_loss(out.image, target,
                                             backend=rcfg.backend))
    backward = []
    for _ in range(12):
        state.optimizer.zero_grad(set_to_none=True)
        loss = rgb_loss(render(scene, cam, rcfg,
                               mean2d_delta=delta).image, target,
                        backend=rcfg.backend)
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
          f"peak allocated {peak_gib:.2f} GiB (train step); launches of the "
          f"12 train steps {json.dumps(launches_1m_train)}", flush=True)
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
        sizes = bisect_sizes(dev)
        full, tile1 = sizes["full"], sizes["longest_tile"]
        full_starts, t = full["starts"], len(full["starts"]) - 1
        longest = int(tile1["starts"][-1])
        bisect = {}
        bounds = {"full": (int(full_starts[-1]) // 8, t),
                  "longest_tile": (longest // 8, 1)}
        # What the L2 fetches from HBM for B's reads, one float every 64
        # bytes (diag/bisect_timing.py::probe_memory).
        probe = bisect_timing.probe_memory(full["feat"], lambda launch: (
            cuda_ms(lambda: [launch() for _ in range(RAW_REPS)]) / RAW_REPS))
        print(f"phase 11 memory probe over the full input's feat: "
              f"{json.dumps(probe)}", flush=True)
        # The order C's and D's wrappers launch first, alone on the full
        # plan, and C and D there in index order against it.
        order_raw = order_launch(full_starts)
        assert order_raw() == 0
        bisect_order_ms = cuda_ms(lambda: [order_raw() for _ in range(
            RAW_REPS)]) / RAW_REPS
        index_order = torch.arange(t, dtype=torch.int32, device=dev)
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
                if size in bounds:
                    # Sums in a fixed order: a second launch, the same bits.
                    res[size]["same_bits_twice"] = torch.equal(
                        got, cuda_fn(*args))
                    assert res[size]["same_bits_twice"], (name, size)
                    bound_ms, by = bisect_bound(name, *bounds[size])
                    res[size].update(bound_ms=bound_ms, bound_by=by,
                                     share=bound_ms / res[size]["ms"])
                if name in bb.CARRIED and size == "full":
                    in_index = bisect_launch(name, args, index_order)
                    assert in_index() == 0, name
                    res[size].update(
                        order_ms=bisect_order_ms, index_order_ms=cuda_ms(
                            lambda: [in_index() for _ in range(RAW_REPS)])
                        / RAW_REPS)
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
    views, fov_x, fov_y = colmap_views(base, dev)
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
        assert min(_kernels.launch_counts[k] for k in TRAIN_KERNELS) > 0, (
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
    assert out.count(capture_line) == 1, out  # 8 views, one graph
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
            view_loss[name] = [float(rgb_loss(o.image, img, tc.ssim_weight,
                                              backend=rcfg0.backend))
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
    assert out.count(capture_line) == 1, out
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
    assert out.count(capture_line) == 1, out
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

    # -- phase 18: the entry point, the dry run and the scaling harness ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_dryrun(dev)
    print(f"phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 19: the train step in a CUDA graph --------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train_graph(dev, scene_dir)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 20: the preprocess kernels ----------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pre = phase_preprocess(dev, scene_dir)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 21: the loss kernels ----------------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_res = phase_loss(dev, scene_dir)
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)

    b116 = bwd["trained_116k"]
    rows_full, tiles_full = int(full_starts[-1]) // 8, t
    print(json.dumps({"kernels": [{
        "name": "tile_order", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/tile_order.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:325",
        "launches": launches_cli_train["tile_order"],
        "replayed": replayed_cli_train["tile_order"],
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
        "replayed": replayed_cli_train["blend_backward"],
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
    } for name, line in (("a", 48), ("b", 71), ("c", 105), ("d", 152))] + [{
        "name": f"preprocess_{kind}", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/preprocess.cu",
        "replaces": "gsrast_tpu/ops/preprocess.py:38",
        "launches": launches_cli_train[f"preprocess_{kind}"],
        "replayed": replayed_cli_train[f"preprocess_{kind}"],
        "max_abs_err": max(pre["1M"][kind][o]["max_abs_err"] for o in (
            PRE_OUTPUTS if kind == "forward" else PRE_GRADS)),
        **{key: pre["1M"][kind][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "cells": {cell: {key: pre[cell][kind][key] for key in (
            "ms", "plain_ms", "bound_ms", "share")}
            for cell in ("1M", "trained_116k", "colmap", "edge")},
    } for kind in ("forward", "backward")] + [{
        "name": f"loss_{kind}", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/loss.cu",
        "replaces": "gsrast_tpu/train/loss.py:43",
        "launches": launches_cli_train[f"loss_{kind}"],
        "replayed": replayed_cli_train[f"loss_{kind}"],
        "max_abs_err": max(loss_res[cell]["max_abs_err"]
                           for cell in LOSS_CELLS),
        **{key: loss_res["trained_116k"][kind][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "cells": {cell: {key: loss_res[cell][kind][key] for key in (
            "ms", "plain_ms", "bound_ms", "share")} for cell in LOSS_CELLS},
    } for kind in ("forward", "backward")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
