"""What the loops share: the cell's views and render plan, the device's
clock and memory, the traced window's readings and the work of the traced
steps as the reference counts it, and the verdict of a comparison."""

from __future__ import annotations

import collections
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from .. import poses, scenes, trace
from ..reference import splat
from ..work import model

MARK = "gsbench.window"


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block (the reference's
    float32 products and convolutions), the flags restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def steal_s() -> float:
    """Seconds this machine's processors have lost to others so far (the
    `steal` column of /proc/stat), 0 where it is not read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def card_state() -> dict:
    """The card's SM clock (MHz) and temperature (C) where NVML answers,
    else nothing: they explain run-to-run spread."""
    if not torch.cuda.is_available():
        return {}
    try:
        return {"sm_mhz": torch.cuda.clock_rate(),
                "temp_c": torch.cuda.temperature()}
    except (ModuleNotFoundError, RuntimeError):
        return {}


def rates(ticks: list) -> list:
    """Steps or frames a second between successive (time, count) ticks."""
    return [round((n1 - n0) / (t1 - t0), 1)
            for (t0, n0), (t1, n1) in zip(ticks, ticks[1:])]


class _HostEvent:
    """A CUDA event's stand-in off the card, on the host's clock."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class Loop:
    """A cell's driver: `setup`, `window(seconds)`, `trace(out_dir)`,
    `release`, `check` and `work(ctx)`."""

    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.rng = np.random.default_rng(self.seed % (1 << 64))
        self.backend = "cuda" if device == "cuda" else "torch"
        r = cell.settings["render"]
        self.plan = (int(r["tile_h"]), int(r["tile_w"]),
                     tuple((int(k), float(f)) for k, f in r["tiers"]))
        self.sh_degree = min(3, int(cell.config["scene"]["sh_degree"]))
        self.peak_bytes = 0
        self.parts, self._lap = {}, time.perf_counter()
        self.window_stats = {}

    def lap(self, name: str) -> None:
        """Book the host seconds since the last lap under `name` (set-up's
        parts, printed with the result)."""
        now = time.perf_counter()
        self.parts[name] = now - self._lap
        self._lap = now

    def make_views(self, params: dict) -> None:
        from gsrast_tpu_torch.camera import make_camera

        cfg = self.cell.config
        w, h = cfg["image"]["width"], cfg["image"]["height"]
        fr = self.framing = scenes.framing(cfg["framing"], params, w, h)
        self.views = poses.pose_list(self.cell.traffic["poses"], fr["target"],
                                     fr["distance"])
        self.cams = [make_camera(v, fr["fov_x"], fr["fov_y"], w, h,
                                 znear=fr["znear"], zfar=fr["zfar"],
                                 device=self.device) for v in self.views]
        self.ref_cams = [self.ref_cam(i) for i in range(len(self.views))]

    def ref_cam(self, i: int, dtype=torch.float32) -> splat.Camera:
        """The reference's camera of pose i, in `dtype`."""
        fr, image = self.framing, self.cell.config["image"]
        return splat.camera(self.views[i], fr["fov_x"], fr["fov_y"],
                            fr["znear"], fr["zfar"], image["width"],
                            image["height"], self.device, dtype)

    def drops(self, params: dict, views) -> int:
        """The most (splat, tile) pairs that the cell's tier plan grants no
        slot on any of `views`, for the raw parameters `params`, as the
        reference counts them: any is a splat missing from a tile, so a
        run with one is not correct."""
        return splat.view_drops(params, [self.ref_cams[k] for k in views],
                                *self.plan)

    def sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def event(self, timing: bool = False):
        """An event recorded now on the current stream (unrecorded where
        `timing`)."""
        if self.device != "cuda":
            ev = _HostEvent()
        else:
            ev = torch.cuda.Event(enable_timing=timing)
        if not timing:
            ev.record()
        return ev

    def reset_peak(self) -> None:
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        if self.device == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated())
        return self.peak_bytes

    def empty_cache(self) -> None:
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def trace_context(self, events: list, steps: int) -> dict:
        """The readings of a traced window of `steps` steps or frames."""
        win = trace.Window(events, MARK)
        seen = win.count("blend_forward_kernel")
        if self.device == "cuda" and seen != steps:
            print(f"gsbench: the trace holds {seen} blend_forward launches "
                  f"of {steps} steps", file=sys.stderr)
        return {"steps": steps, "window": win, "busy_s": win.busy_s,
                "window_s": win.window_s, "peak_bytes": self.peak_bytes,
                "breakdown": {"device_ops": win.device_ops(),
                              "idle_gaps": win.idle_gaps()}}


def step_work(params: dict, cams: list, plan: tuple, sh_degree: int,
              backward: bool) -> dict:
    """The work of one step or frame on each camera, summed, as the
    reference counts it on `params`: per kernel group, operations, bytes
    and the sum of each call's bound (s)."""
    tile_h, tile_w, _ = plan
    n, k = params["means"].shape[0], params["sh"].shape[1]
    used = (sh_degree + 1) ** 2
    floats = sum(params[f][0].numel() for f in scenes.FIELDS) * n
    work = collections.defaultdict(lambda: [0.0, 0.0, 0.0])

    def add(name, flops_bytes):
        flops, nbytes = flops_bytes
        w = work[name]
        w[0] += flops
        w[1] += nbytes
        w[2] += model.bound_s(nbytes, flops)

    with exact_float32():
        for cam in cams:
            out, _, pr = splat.render(params, cam, sh_degree, *plan)
            b = model.blend(out.fwd_pairs, out.fwd_blended, out.bwd_pairs,
                            out.bwd_blended, int(pr.splat.shape[0]),
                            pr.grid_h * pr.grid_w, tile_h * tile_w)
            add("preprocess_forward", model.preprocess("forward", n, used, k))
            add("blend_forward", b["forward"])
            if backward:
                add("blend_backward", b["backward"])
                add("preprocess_backward",
                    model.preprocess("backward", n, used, k))
                add("loss_forward", model.loss("forward", cam.height,
                                               cam.width))
                add("loss_backward", model.loss("backward", cam.height,
                                                cam.width))
                add("adam", model.adam(floats, n, len(scenes.FIELDS)))
    return {"work": {name: {"flops": w[0], "bytes": w[1], "bound_s": w[2]}
                     for name, w in work.items()}}


def judged(numbers: dict, limits: dict) -> dict:
    """The verdict: every number under its limit (names starting with '_'
    are diagnostics, printed and not judged)."""
    compared = {name: {"value": numbers[name], "limit": limits[name]}
                for name in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    return {"correct": correct, "compared": compared,
            "diagnostics": {k: v for k, v in numbers.items()
                            if k.startswith("_")}}
