"""The viewer loop: the program's graphed splat frame (`FrameGraph` over
`render`, as its viewer app runs it) along the traffic's camera path from
its first pose, one viewer in a closed loop: each frame is awaited before
the next pose is sent.

Set-up makes the scene from the seed, builds the frame and draws the
first `warm_frames` poses (eager, captured, replayed). Each frame of the
window is timed on the device's clock by CUDA events from before its
camera copy to after its image; every `keep_every`-th frame, from an
offset drawn from the seed, is copied aside for the correctness check,
after its end event.
"""

from __future__ import annotations

import time

import torch

from .. import poses, scenes, trace
from ..reference import splat
from . import common


class Loop(common.Loop):
    kind = "view"

    def setup(self) -> None:
        from gsrast_tpu_torch import config as pcfg
        from gsrast_tpu_torch.render.api import render
        from gsrast_tpu_torch.render.frame import FrameGraph
        from gsrast_tpu_torch.scene.gaussians import GaussianScene

        traffic = self.cell.traffic
        self.params = scenes.make(self.cell.config["scene"], self.seed,
                                  self.device)
        self.make_views(self.params)
        self.lap("scene")
        scene = GaussianScene(*(self.params[k].clone()
                                for k in scenes.FIELDS),
                              self.params["mask"].clone())
        rcfg = pcfg.RenderConfig(
            tile_h=self.plan[0], tile_w=self.plan[1], tiers=self.plan[2],
            backend=self.backend, sh_degree=self.sh_degree)
        with torch.no_grad():
            act = scene.activated()

        def draw(cam):
            with torch.inference_mode():
                return render(act, cam, rcfg).image

        self.frame = FrameGraph(draw, "gaussians", rcfg.backend)
        self.order = poses.visits(traffic["visit"], len(self.views),
                                  self.rng)
        self.keep_offset = int(self.rng.integers(traffic["keep_every"]))
        self.lap("program")
        for _ in range(traffic["warm_frames"]):
            self.frame(self.cams[next(self.order)])
        self.sync()
        self.lap("warm")

    def window(self, seconds: float) -> dict:
        every = self.cell.traffic["keep_every"]
        start, end = self.event(timing=True), self.event(timing=True)
        self.kept, frame_ms = [], []
        host = wait = 0.0
        self.sync()
        self.reset_peak()
        steal, card = common.steal_s(), common.card_state()
        t0 = time.perf_counter()
        n = 0
        ticks = [(t0, 0)]
        while True:
            k = next(self.order)
            start.record()
            h0 = time.perf_counter()
            image = self.frame(self.cams[k])
            h1 = time.perf_counter()
            end.record()
            if n % every == self.keep_offset:
                self.kept.append((k, image.clone()))
            end.synchronize()
            wait += time.perf_counter() - h1
            host += h1 - h0
            frame_ms.append(start.elapsed_time(end))
            n += 1
            now = time.perf_counter()
            if now - ticks[-1][0] >= 1.0:
                ticks.append((now, n))
            if now - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.window_stats = {
            "wall_ms": 1e3 * elapsed / n, "call_ms": 1e3 * host / n,
            "wait_ms": 1e3 * wait / n, "frame_ms": sum(frame_ms) / n,
            "steal_s": common.steal_s() - steal,
            "per_s": common.rates(ticks), "card_before": card,
            "card_after": common.card_state()}
        if not self.kept:  # a window shorter than the first kept frame
            self.kept.append((k, image.clone()))
        self.host_ms = 1e3 * host / n
        frame_ms.sort()
        return {"frames_per_s": n / elapsed,
                "frame_ms_p95": frame_ms[min(n - 1, int(0.95 * n))],
                "attempted": n, "failed": 0,
                "memory_peak_bytes": self.peak()}

    def trace(self, out_dir: str) -> dict:
        """Trace `trace_frames` frames at poses spread evenly over the path
        (the same poses in every run), each awaited."""
        frames = self.cell.traffic["trace_frames"]
        visited = [i * len(self.views) // frames for i in range(frames)]

        def draw():
            for k in visited:
                self.frame(self.cams[k])
                self.sync()

        self.sync()
        ctx = self.trace_context(trace.profiled(draw, common.MARK, out_dir),
                                 frames)
        ctx["traced_views"] = visited
        ctx["host_ms"] = self.host_ms
        return ctx

    def release(self) -> None:
        self.frame = None
        self.empty_cache()

    def check(self) -> dict:
        """Compare the kept frames with the reference's renders of their
        poses, and count the pairs the plan drops on any pose of the
        path."""
        gaps, self.ref_images = [], {}
        with common.exact_float32():
            for k, image in self.kept:
                ref = self.ref_images[k] = splat.render(
                    self.params, self.ref_cams[k], self.sh_degree,
                    *self.plan)[0].image
                gaps.append(float((image.float() - ref).abs().mean()))
        numbers = {"frame_gap": max(gaps), "_frames": len(gaps),
                   "dropped": self.drops(self.params, range(len(self.views)))}
        return common.judged(numbers, self.cell.settings["limits"])

    def work(self, ctx: dict) -> dict:
        return common.step_work(self.params, [self.ref_cams[k] for k in
                                              ctx["traced_views"]],
                                self.plan, self.sh_degree, backward=False)
