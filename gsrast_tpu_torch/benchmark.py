"""The benchmark: the timed step at a size, its per-stage decomposition and
the statistics of its tile plan, shared by `python -m gsrast_tpu_torch
bench`, `diag/scene_stats.py`, `diag/tile_sweep.py` and `chip_smoke.py`.

Counterpart of the reference's `gsrast_tpu/benchmark.py`, which keeps the
headline number and the stage profile in one module so that they cannot
diverge. The target is the reference's: Mpixels/s forward+backward at
1920x1080 with 1M Gaussians (`BASELINE.json`). Times are CUDA-event times
on a CUDA device and host-clock times on the CPU.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Tuple

import numpy as np
import torch

from . import config as cfg
from .camera import Camera, look_at, make_camera
from .ops import binning
from .ops.preprocess import preprocess
from .render.api import auto_render_config, render, scene_tile_counts
from .render.blend import BlendFunction, blend_backward, blend_forward
from .render.pipeline import feature_rows, pack_features, sort_pack
from .scene.gaussians import GaussianScene, random_scene

# The activated fields the stage table differentiates, and the
# preprocessed ones that feed the sort-pack.
ACTIVATED_FIELDS = ("means", "scales", "quats", "opacities", "sh")
PREPROCESSED_FIELDS = ("mean2d", "conic", "color", "opacity")


def bench_config(backend: str) -> cfg.RenderConfig:
    """The benchmark's base RenderConfig, the reference bench's
    (`gsrast_tpu/benchmark.py:40-48`): 16x32 tiles, its pick from its sweep
    on the TPU (`diag/tile_sweep.py` sweeps the card), and its knobs of
    the legacy binning and the oracle (intersect_capacity_factor 5.0,
    max_tiles_per_gaussian 16, max_per_tile 4,096, tile_chunk 8). The tier
    plan is not fixed here: every bench derives it from the scene with
    `auto_render_config`, as `render` and `train` do, unless it is handed
    one (`bench_render_config`)."""
    return cfg.RenderConfig(backend=backend, tile_h=16, tile_w=32,
                            intersect_capacity_factor=5.0, max_per_tile=4096,
                            tile_chunk=8, max_tiles_per_gaussian=16)


def bench_scene_camera(n: int, width: int, height: int, sh: int = 3,
                       seed: int = 0,
                       device="cuda") -> Tuple[GaussianScene, Camera]:
    """The reference benchmark's scene and camera: n anisotropic Gaussians
    in [-1, 1]^3 with scales 0.002-0.008 and SH degree `sh`, seen from
    (0, 0, -2.5) toward the origin with fov 1.2 x 1.0. The scene is drawn
    from `numpy.random.default_rng(seed)` and the reference's from
    `jax.random.PRNGKey(seed)`: the same distributions, not the same
    arrays."""
    scene = random_scene(n, np.random.default_rng(seed), sh_degree=sh,
                         isotropic=False, scale_range=(0.002, 0.008),
                         device=device)
    camera = make_camera(look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0],
                                 device=device), 1.2, 1.0, width, height,
                         device=device)
    return scene, camera


def auto_tiers_for(scene, camera: Camera, rcfg: cfg.RenderConfig) -> tuple:
    """The tier spec of one preprocess pass over (scene, camera)."""
    return binning.auto_tiers(scene_tile_counts(scene, camera, rcfg))


def bench_render_config(scene, camera: Camera, backend: str,
                        **cfg_overrides) -> cfg.RenderConfig:
    """`bench_config(backend)` with `cfg_overrides`, its tier plan derived
    from the scene by `auto_render_config`, the tile grown by the big-splat
    rule unless they give `tile_w`. Where they give `tiers`, the config is
    taken as it is, as the reference's `run_bench` takes it (`tiers=()`:
    the legacy binning)."""
    rcfg = bench_config(backend).replace(**cfg_overrides)
    if "tiers" in cfg_overrides:
        return rcfg
    return auto_render_config(scene, camera, base=rcfg,
                              auto_tile_w="tile_w" not in cfg_overrides)


def timeit(fn: Callable, iters: int, device) -> Tuple[float, float]:
    """(best ms, median ms) of `iters` calls of fn() after one warm-up
    call. On a CUDA device each call is timed by a pair of CUDA events, from
    its start to the end of the work it queued; on the CPU by the host
    clock."""
    device = torch.device(device)
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return min(times), statistics.median(times)


def bench_step(scene: GaussianScene, camera: Camera, rcfg: cfg.RenderConfig,
               fwd_only: bool = False):
    """The benchmark's step, the reference's: render the activated scene.
    Forward only, under no_grad, it returns the image; else the gradient of
    mean(img * img) flows back to the five parameter groups, whose grads it
    sets to None first, and it returns them by field name."""
    if fwd_only:
        with torch.no_grad():
            return render(scene, camera, rcfg).image
    params = scene.param_groups()
    for p in params.values():
        p.grad = None
    img = render(scene, camera, rcfg).image
    torch.mean(img * img).backward()
    return {name: p.grad for name, p in params.items()}


def run_bench(scene: GaussianScene, camera: Camera, rcfg: cfg.RenderConfig,
              fwd_only: bool = False,
              iters: int = 10) -> Tuple[float, float, float]:
    """Time `bench_step` over `iters` calls after a warm-up, with `rcfg`
    (`bench_render_config`'s for the bench). Returns (best_ms, median_ms,
    mpix_s), Mpix/s from the best, as the reference computes it."""
    best, median = timeit(lambda: bench_step(scene, camera, rcfg, fwd_only),
                          iters, camera.device)
    return best, median, camera.width * camera.height / best / 1e3


def _grad_of(loss_fn: Callable, leaves: dict) -> Callable:
    """A call that takes the gradient of loss_fn() with respect to
    `leaves` (tensors that require grad)."""
    inputs = list(leaves.values())
    return lambda: torch.autograd.grad(loss_fn(), inputs, allow_unused=True)


def _leaves(obj, fields) -> dict:
    return {k: getattr(obj, k).detach().requires_grad_() for k in fields}


def stage_table(scene: GaussianScene, camera: Camera, rcfg: cfg.RenderConfig,
                iters: int = 3) -> dict:
    """Per-stage times of rendering `scene` from `camera` with `rcfg`, best
    of `iters`. Returns {stage: ms}. The
    first five nest, each the gradient of a sum through everything before
    it: `prep` (preprocess), `binning_fwd` (the tier plan, or with
    `tiers=()` the legacy `build_binning`, forward only), `pack` (the
    sort-pack, or the legacy `pack_features`), `pack_blend` (pack and
    blend), `full` (the whole render and image assembly). Then the blend
    alone on the plan's inputs, `blend_fwd` and `blend_bwd` (d_rgb ones,
    d_final_t zeros, with the tile order on the kernels), and `full_fwd`,
    the render forward only."""
    dev = camera.device
    grid_h, grid_w = rcfg.grid_shape(camera.height, camera.width)
    num_tiles, tile_h, tile_w = grid_h * grid_w, rcfg.tile_h, rcfg.tile_w
    with torch.no_grad():
        act = scene.activated()
        prep = preprocess(act, camera, rcfg)
    afloats = _leaves(act, ACTIVATED_FIELDS)
    pfloats = _leaves(prep, PREPROCESSED_FIELDS)
    out = {}

    def prep_loss():
        p = preprocess(dataclasses.replace(act, **afloats), camera, rcfg)
        return (torch.sum(p.mean2d) + torch.sum(p.conic) + torch.sum(p.color)
                + torch.sum(p.opacity))

    out["prep"] = timeit(_grad_of(prep_loss, afloats), iters, dev)[0]
    if rcfg.tiers:
        def make_plan():
            return binning.plan_tiers(prep, grid_h, grid_w, rcfg)

        def pack(p):
            return sort_pack(feature_rows(p), plan, num_tiles)
    else:
        capacity = rcfg.capacity(scene.capacity)

        def make_plan():
            return binning.build_binning(prep, grid_h, grid_w, rcfg,
                                         capacity)

        def pack(p):
            return pack_features(p, plan), plan.tile_starts
    with torch.no_grad():
        out["binning_fwd"] = timeit(make_plan, iters, dev)[0]
        plan = make_plan()

    def pack_loss():
        feat, _ = pack(prep._replace(**pfloats))
        return torch.sum(feat * feat)

    def blend_loss():
        feat, starts = pack(prep._replace(**pfloats))
        rgb, final_t, _ = BlendFunction.apply(feat, starts, grid_h, grid_w,
                                              tile_h, tile_w, rcfg.backend)
        return torch.sum(rgb) + torch.sum(final_t)

    def full_loss():
        return torch.sum(render(dataclasses.replace(act, **afloats), camera,
                                rcfg).image)

    out["pack"] = timeit(_grad_of(pack_loss, pfloats), iters, dev)[0]
    out["pack_blend"] = timeit(_grad_of(blend_loss, pfloats), iters, dev)[0]
    out["full"] = timeit(_grad_of(full_loss, afloats), iters, dev)[0]

    with torch.no_grad():
        feat, starts = pack(prep)
        geometry = (grid_h, grid_w, tile_h, tile_w)
        out["blend_fwd"] = timeit(lambda: blend_forward(
            feat, starts, *geometry, backend=rcfg.backend), iters, dev)[0]
        _, final_t, n_contrib = blend_forward(feat, starts, *geometry,
                                              backend=rcfg.backend)
        d_rgb = torch.ones((num_tiles, 3, tile_h * tile_w), device=dev)
        d_final_t = torch.zeros_like(final_t)
        out["blend_bwd"] = timeit(lambda: blend_backward(
            feat, starts, d_rgb, d_final_t, final_t, n_contrib, *geometry,
            backend=rcfg.backend), iters, dev)[0]
        out["full_fwd"] = timeit(lambda: render(act, camera, rcfg).image,
                                 iters, dev)[0]
    return out


def format_stage_table(stages: dict, width: int, height: int) -> str:
    lines = [f"{'stage (fwd+bwd unless _fwd)':<28}{'ms':>8}"]
    for k, v in stages.items():
        lines.append(f"{k:<20} {v:>15.3f}")
    full = stages.get("full")
    if full:
        lines.append(f"=> {width * height / full / 1e3:.2f} Mpixels/s fwd+bwd")
    return "\n".join(lines)


def scene_stats(scene: GaussianScene, camera: Camera,
                rcfg: cfg.RenderConfig) -> dict:
    """Intersection statistics of the scene's tier plan (`plan_tiers` with
    `rcfg`): visible Gaussians, intersections (live slots), the most and the
    mean tiles of a Gaussian with at least one intersection, the longest and
    the mean tile segment, the tiles with a segment, and the tiles the plan
    dropped (`overflow_tile_cap`)."""
    grid_h, grid_w = rcfg.grid_shape(camera.height, camera.width)
    num_tiles = grid_h * grid_w
    with torch.no_grad():
        prep = preprocess(scene.activated(), camera, rcfg)
        plan = binning.plan_tiers(prep, grid_h, grid_w, rcfg)
        live = plan.gauss >= 0
        per_gauss = torch.bincount(plan.gauss[live].long(),
                                   minlength=scene.capacity)
        seg = torch.bincount(plan.tile_key[live].long(), minlength=num_tiles)
        touched = int((per_gauss > 0).sum())
        return {
            "visible": int((prep.radius > 0).sum()),
            "total_isect": int(plan.total),
            "max_tiles_per_gaussian": int(per_gauss.max()),
            "mean_tiles_per_visible": float(per_gauss.sum()) / max(touched,
                                                                   1),
            "max_segment": int(seg.max()),
            "mean_segment": float(seg.float().mean()),
            "nonempty_tiles": int((seg > 0).sum()),
            "overflow_tile_cap": int(plan.overflow_tile_cap),
        }
