"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of `gsrast_tpu_torch` from the sources
in this checkout, holds each against its plain PyTorch version at the shapes
the render path gives it, drives the forward render path through its user
entry points (the CLI on the trained 116k-Gaussian fixture at 1920x1080, and
`render` on the 1M-Gaussian SH-degree-3 scene of the reference benchmark),
and checks that the path went through the kernels. Each phase prints one
line before the next begins; the line before the last is the per-kernel
JSON record, and the last is {"ok": true, "device": {...}}. Any failure
raises and exits nonzero. It imports no JAX.
"""

from __future__ import annotations

import json
import os
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

# Kernel against plain version: rgb/final_t where n_contrib agrees, and the
# share of pixels whose n_contrib may differ at the saturation boundary.
ATOL = 1e-5
MAX_NC_MISMATCH = 1e-4


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
    from gsrast_tpu_torch.render.blend import (blend_forward_cuda,
                                               blend_forward_torch)
    from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack
    from gsrast_tpu_torch.render.tiled import untile, untile_cf
    from gsrast_tpu_torch.scene.gaussians import random_scene
    from gsrast_tpu_torch.scene.ply import load_ply
    import numpy as np

    dev = torch.device("cuda:0")
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
    assert img.device.type == "cuda" and img.shape == (HEIGHT, WIDTH, 3)
    assert bool(torch.isfinite(img).all())
    assert float(img.amax()) > 0.05, "image is all background"
    assert os.path.getsize(png) > 0
    print(f"phase 4 cli render: launches={launches_cli} image mean "
          f"{float(img.mean()):.4f} -> {os.path.relpath(png, ROOT)}",
          flush=True)

    # -- phase 5: north-star scale, forward --------------------------------
    with torch.inference_mode():
        scene = random_scene(1_000_000, np.random.default_rng(0), sh_degree=3,
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

    print(json.dumps({"kernels": [{
        "name": "blend_forward", "route": "cuda",
        "source": "gsrast_tpu_torch/csrc/blend_forward.cu",
        "replaces": "gsrast_tpu/render/pallas_blend.py:181",
        "launches": launches_cli["blend_forward"],
        "max_abs_err": cmp116["max_abs_err"], "ms": ms_k, "plain_ms": ms_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
