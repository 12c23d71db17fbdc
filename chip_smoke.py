"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of `gsrast_tpu_torch` from the sources
in this checkout, holds each against its plain PyTorch version at the shapes
the render and training paths give it, drives the forward render path
through its user entry points (the CLI on the trained 116k-Gaussian fixture
at 1920x1080, and `render` on the 1M-Gaussian SH-degree-3 scene of the
reference benchmark) and the training path (whole-render gradients against
the CPU, 30 steps at 1080p through the `train.trainer` API, the CLI `train`
with a checkpoint resume, and the fwd+bwd and train-step times at the
north-star size), the fault-bisection kernels through their entry point
and against their plain versions at the script's shapes and at the size of
trained_116k's 1080p plan, training from data through the CLI (a COLMAP
scene of eight 1080p views of trained_116k with its means as SfM points, a
cameras.json directory, a target PNG), and a NaN rollback at 1080p; and
checks that each path went through the kernels. Each phase prints one line
before the next begins; the line before the last is the per-kernel JSON
record, and the last is {"ok": true, "device": {...}}. Any failure raises
and exits nonzero. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
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
BISECT_REPS = 20  # back-to-back launches per timed interval
N_VIEWS = 8  # views of the COLMAP scene of phase 12
BLEND_KERNELS = ("blend_forward", "blend_backward")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gsrast_tpu_torch import _kernels, cli
    from gsrast_tpu_torch import config as cfg
    from gsrast_tpu_torch.camera import auto_frame, look_at, make_camera
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.api import auto_render_config, render
    from gsrast_tpu_torch.render.blend import (blend_backward_cuda,
                                               blend_backward_torch,
                                               blend_forward_cuda,
                                               blend_forward_torch)
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
        out_k = blend_forward_cuda(*args)
        cmp116 = compare_blend(out_k, blend_forward_torch(*args),
                               cfg.TRANSMITTANCE_MIN)
        # Blended (pixel, position) pairs, skipped positions included.
        positions = int(out_k[2].sum())
        ms_k = cuda_ms(lambda: blend_forward_cuda(*args))
        ms_p = cuda_ms(lambda: blend_forward_torch(*args))
        print(f"phase 3 blend trained_116k {WIDTH}x{HEIGHT} tiles {th}x{tw} "
              f"tiers={rcfg.tiers} isect={int(plan.total)} "
              f"positions={positions}: "
              f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms; "
              f"{json.dumps(cmp116)}",
              flush=True)
        assert cmp116["err_rgb"] <= ATOL and cmp116["err_final_t"] <= ATOL
        assert cmp116["nc_mismatch_share"] <= MAX_NC_MISMATCH
        assert cmp116["mismatch_at_boundary"]

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
    assert launches_cli["blend_forward"] > 0, launches_cli
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
        assert launches_1m["blend_forward"] > 0, launches_1m
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
    print(f"phase 5 north-star 1M SH3 {WIDTH}x{HEIGHT} tiles {th}x{tw} "
          f"tiers={rcfg.tiers}: forward {fwd_ms:.3f} ms = "
          f"{WIDTH * HEIGHT / fwd_ms / 1e3:.3f} Mpix/s; stages ms "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
          f"plain blend {plain_1m:.3f} ms; isect={isect} "
          f"positions={int(blend[2].sum())} "
          f"overflow_tile_cap={overflow} launches={launches_1m}; "
          f"{json.dumps(cmp1m)}", flush=True)
    assert cmp1m["err_rgb"] <= ATOL and cmp1m["err_final_t"] <= ATOL
    assert cmp1m["nc_mismatch_share"] <= MAX_NC_MISMATCH
    assert cmp1m["mismatch_at_boundary"]

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
            _, ft, nc = blend_forward_cuda(feat, starts, gh, gw, th, tw)
            d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen,
                                device=dev)
            d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
            args = (feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw)
            cmp = compare_backward(blend_backward_cuda(*args),
                                   blend_backward_torch(*args),
                                   int(starts[-1]))
            cmp["kernel_ms"] = cuda_ms(lambda: blend_backward_cuda(*args))
            cmp["plain_ms"] = cuda_ms(lambda: blend_backward_torch(*args))
            bwd[name] = cmp
            print(f"phase 6 blend backward {name} {WIDTH}x{HEIGHT} tiles "
                  f"{th}x{tw} isect={int(plan.total)} positions="
                  f"{int(nc.sum())}: kernel {cmp['kernel_ms']:.3f} ms, plain "
                  f"{cmp['plain_ms']:.3f} ms; {json.dumps(cmp)}", flush=True)
            assert max(cmp["row_rel_err"]) <= BWD_RTOL, cmp
            assert min(cmp["row_scale"]) > 0 and cmp["dead_abs_sum"] == 0.0
        del scenes, prep, plan, feat, starts, ft, nc, d_rgb, d_ft, args

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
    assert min(launches_grad[k] for k in BLEND_KERNELS) > 0, launches_grad

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
    assert min(launches_cli_train[k] for k in BLEND_KERNELS) > 0, (
        launches_cli_train)
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

    def fwd_bwd():  # the reference benchmark's step: grad of mean(img^2)
        state.optimizer.zero_grad(set_to_none=True)
        img = render(scene, cam, rcfg).image
        torch.mean(img * img).backward()

    fwd_bwd_ms = cuda_ms(fwd_bwd)
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
        _, ft, nc = blend_forward_cuda(feat, starts, gh, gw, th, tw)
        d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen, device=dev)
        d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
        split["blend_backward_kernel"] = cuda_ms(lambda: blend_backward_cuda(
            feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw))
    split["rest_of_backward"] = split["backward"] - split[
        "blend_backward_kernel"]
    split["adam"] = cuda_ms(lambda: apply_gradients(state, tc, extent))
    print(f"phase 10 north-star 1M SH3 {WIDTH}x{HEIGHT} tiles {th}x{tw}: "
          f"train step {train_ms:.3f} ms; fwd+bwd {fwd_bwd_ms:.3f} ms = "
          f"{WIDTH * HEIGHT / fwd_bwd_ms / 1e3:.3f} Mpix/s; split ms "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
          f"peak allocated {peak_gib:.2f} GiB (train step)", flush=True)
    assert all(bool(torch.isfinite(p.grad).all())
               for p in scene.param_groups().values())

    del state, scene, step, target, out, delta, loss, feat, starts, ft, nc
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
                        BISECT_REPS)]) / BISECT_REPS,
                    "wrapper_ms": cuda_ms(lambda: cuda_fn(*args)),
                    "plain_ms": cuda_ms(lambda: torch_fn(*args), iters=3,
                                        warmup=1)}
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
        assert min(_kernels.launch_counts[k] for k in BLEND_KERNELS) > 0, (
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

    b116 = bwd["trained_116k"]
    print(json.dumps({"kernels": [{
        "name": "blend_forward", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/blend_forward.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:181",
        "launches": launches_cli["blend_forward"],
        "max_abs_err": cmp116["max_abs_err"], "ms": ms_k, "plain_ms": ms_p,
    }, {
        "name": "blend_backward", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/blend_backward.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:350",
        "launches": launches_cli_train["blend_backward"],
        "max_abs_err": b116["max_abs_err"], "ms": b116["kernel_ms"],
        "plain_ms": b116["plain_ms"],
    }] + [{
        "name": f"bisect_{name}", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/bisect_bwd.cu",
        "replaces": f"scripts/bisect_bwd.py:{line}",
        "launches": launches_bisect[f"bisect_{name}"],
        "max_abs_err": bisect[name]["full"]["max_abs_err"],
        "ms": bisect[name]["full"]["ms"],
        "plain_ms": bisect[name]["full"]["plain_ms"],
    } for name, line in (("a", 48), ("b", 71), ("c", 105), ("d", 152))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
