"""The train loop: the program's graphed train step (`TrainGraph` over
`make_train_step`, as its `train` command runs it) stepping a scene toward
target views, one view a step in the order of the traffic's `visit`.

Set-up makes the scene from the seed, its targets (the reference's renders
of the scene as made) and the start (the scene perturbed as the
configuration's `train.start` says), builds one train state and one graph,
and drives them through the first `check_steps` steps (eager, captured,
replayed) and `warm_steps` more: the correctness check compares those
first steps with the reference. The window then replays the same graph on
the next views, never waiting for the device but to keep at most `lead`
steps queued ahead of it, and ends with a sync.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import poses, scenes, trace
from ..reference import splat, train as ref_train
from . import common

LEAVES = ref_train.PARAMS


class Loop(common.Loop):
    kind = "train"
    traced = None  # the parameters as the trace began, with --trace 1

    def setup(self) -> None:
        from gsrast_tpu_torch import config as pcfg
        from gsrast_tpu_torch.scene.gaussians import GaussianScene
        from gsrast_tpu_torch.train.trainer import (TrainConfig, TrainGraph,
                                                    init_train_state,
                                                    make_train_step)

        cfg, traffic, dev = self.cell.config, self.cell.traffic, self.device
        truth = scenes.make(cfg["scene"], self.seed, dev)
        self.make_views(truth)
        self.lap("scene")
        self.extent = scenes.extent(truth)
        self.targets, self.target_drops = [], 0
        with torch.no_grad(), common.exact_float32():
            for rc in self.ref_cams:
                out, _, pr = splat.render(truth, rc, self.sh_degree,
                                          *self.plan)
                self.targets.append(out.image)
                self.target_drops = max(self.target_drops, pr.dropped)
        self.lap("targets")
        self.start = scenes.perturbed(truth, cfg["train"]["start"],
                                      self.seed, dev)
        del truth
        self.settings = ref_train.Settings(**cfg["train"]["settings"])
        s = self.settings
        tc = TrainConfig(lr_means=s.lr_means, lr_means_final=s.lr_means_final,
                         lr_decay_steps=s.lr_decay_steps, lr_sh=s.lr_sh,
                         lr_sh_rest_div=s.sh_rest_div,
                         lr_opacity=s.lr_opacity, lr_scales=s.lr_scales,
                         lr_quats=s.lr_quats, ssim_weight=s.ssim_weight)
        scene = GaussianScene(*(self.start[k].clone() for k in LEAVES),
                              self.start["mask"].clone())
        self.rcfg = pcfg.RenderConfig(
            tile_h=self.plan[0], tile_w=self.plan[1], tiers=self.plan[2],
            backend=self.backend, sh_degree=self.sh_degree)
        self.state = init_train_state(scene, tc, self.extent)
        self.graph = TrainGraph(make_train_step(self.rcfg, tc, self.extent))
        self.order = poses.visits(traffic["visit"], len(self.views),
                                  self.rng)
        self.lap("program")
        self.first = []
        losses = []
        for i in range(traffic["check_steps"]):
            k = next(self.order)
            self.first.append(k)
            out = self.graph(self.state, self.cams[k], self.targets[k])
            losses.append(out["loss"].detach().clone())
            if i == 0:
                self.first_grad = first_gradient(self.state.optimizer)
        self.after = {k: p.detach().clone()
                      for k, p in self.state.scene.param_groups().items()}
        self.losses = [float(x) for x in losses]
        self.lap("first_steps")
        for _ in range(traffic["warm_steps"]):
            k = next(self.order)
            self.graph(self.state, self.cams[k], self.targets[k])
        self.sync()
        self.lap("warm")

    def step(self) -> None:
        k = next(self.order)
        self.graph(self.state, self.cams[k], self.targets[k])
        self.visited.append(k)

    def window(self, seconds: float) -> dict:
        lead = self.cell.traffic["lead"]
        marks = [None] * lead
        self.visited = []
        self.sync()
        self.reset_peak()
        host = 0.0
        steal, card = common.steal_s(), common.card_state()
        t0 = time.perf_counter()
        n = 0
        ticks = [(t0, 0)]
        while True:
            mark = marks[n % lead]
            if mark is not None:
                mark.synchronize()
            h0 = time.perf_counter()
            self.step()
            host += time.perf_counter() - h0
            marks[n % lead] = self.event()
            n += 1
            now = time.perf_counter()
            if now - ticks[-1][0] >= 1.0:
                ticks.append((now, n))
            if now - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self.host_ms = 1e3 * host / n
        self.window_stats = {
            "step_ms": 1e3 * elapsed / n, "call_ms": self.host_ms,
            "steal_s": common.steal_s() - steal, "per_s": common.rates(ticks),
            "card_before": card, "card_after": common.card_state()}
        pixels = self.cams[0].width * self.cams[0].height
        finite = all(bool(torch.isfinite(p).all())
                     for p in self.state.scene.param_groups().values())
        return {"train_mpix_s": n * pixels / elapsed / 1e6,
                "attempted": n, "failed": 0 if finite else n,
                "memory_peak_bytes": self.peak()}

    def snapshot(self) -> dict:
        """The program's parameters now, with the start's mask (the loop
        neither densifies nor prunes)."""
        return dict({k: p.detach().clone() for k, p in
                     self.state.scene.param_groups().items()},
                    mask=self.start["mask"])

    def trace(self, out_dir: str) -> dict:
        steps = self.cell.traffic["trace_steps"]
        self.visited = []
        self.sync()
        self.traced = self.snapshot()
        events = trace.profiled(lambda: [self.step() for _ in range(steps)],
                                common.MARK, out_dir)
        ctx = self.trace_context(events, steps)
        ctx["traced_views"] = list(self.visited)
        ctx["host_ms"] = self.host_ms
        # The sort-pack's device time, from eager steps of the same state:
        # a graph's replay carries no host ranges.
        step_fn = self.graph.step_fn
        eager = self.cell.traffic["eager_steps"]

        def eager_steps():
            for _ in range(eager):
                k = next(self.order)
                step_fn(self.state, self.cams[k], self.targets[k])

        eager_steps()  # the eager path's first allocations
        events = trace.profiled(eager_steps, "gsbench.eager", out_dir)
        ctx["sortpack_s"] = trace.range_seconds(
            events, "gsbench.eager", "render.pack") / eager
        return ctx

    def release(self) -> None:
        self.final = self.snapshot()
        for name in ("state", "graph"):
            setattr(self, name, None)
        self.empty_cache()

    def check(self) -> dict:
        """Compare the program's first steps with the reference's."""
        got = {"losses": self.losses, "first_grad": self.first_grad,
               "params": self.after}
        with common.exact_float32():
            ref = ref_train.steps(
                self.start, [self.ref_cams[k] for k in self.first],
                [self.targets[k] for k in self.first], self.plan,
                self.sh_degree, self.extent, self.settings)
        self.ref = ref
        numbers = compare_steps(got, ref, self.start)
        # The plan has to grant every pair of every view, from the targets
        # through the state the window and the trace left.
        views = range(len(self.views))
        drops = {"targets": self.target_drops}
        for name in ("start", "traced", "final"):
            if getattr(self, name) is not None:
                drops[name] = self.drops(getattr(self, name), views)
        numbers["dropped"], numbers["_drops"] = max(drops.values()), drops
        return common.judged(numbers, self.cell.settings["limits"])

    def work(self, ctx: dict) -> dict:
        """The work of the traced steps, counted by the reference on the
        program's parameters as the trace began."""
        cams = [self.ref_cams[k] for k in ctx["traced_views"]]
        return common.step_work(self.traced, cams, self.plan,
                                self.sh_degree, backward=True)


def first_gradient(optimizer) -> dict:
    """Each group's gradient as Adam took it in its first update, worked
    out from its first moment, (1 - b1) g; zero where Adam holds no state."""
    out = {}
    for g in optimizer.param_groups:
        (param,) = g["params"]
        m = optimizer.state.get(param, {}).get("exp_avg")
        out[g["name"]] = (torch.zeros_like(param.detach()) if m is None
                          else m.clone() / (1.0 - g["betas"][0]))
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(tensors[k].double()))
            for k in LEAVES}


def _worst(got: dict, ref: dict, leaves) -> tuple:
    """The worst leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[k] for k in leaves]))
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def compare_steps(got: dict, ref: dict, start: dict) -> dict:
    """The numbers a train cell compares: each step's loss (the largest
    relative gap), the first gradient as the optimizer took it and the
    parameters' change after the steps (the worst leaf's gap of norms);
    the change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                      ref["losses"]))
    g_got, g_ref = _norms(got["first_grad"]), _norms(ref["first_grad"])
    grad_gap, grad_leaf = _worst(g_got, g_ref, LEAVES)
    med = float(np.median(list(g_ref.values())))
    counted = [k for k in LEAVES if g_ref[k] >= 1e-3 * med]
    d_got = _norms({k: got["params"][k] - start[k] for k in LEAVES})
    d_ref = _norms({k: ref["params"][k].float() - start[k] for k in LEAVES})
    change_gap, change_leaf = _worst(d_got, d_ref, counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "_leaves": {"grad": grad_leaf, "change": change_leaf,
                        "counted": counted}}
