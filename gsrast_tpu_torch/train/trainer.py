"""Training loop pieces: per-group Adam, the train step, the densify
schedule. Port of the reference's `gsrast_tpu/train/trainer.py`.

The standard 3DGS optimizer recipe: one learning rate per parameter group,
exponential decay of the means' rate scaled by the scene extent, the SH
rest bands at 1/20 of the DC rate, and masked gradients so dead capacity
slots stay frozen. The train step updates its `TrainState` in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import config as cfg
from ..camera import Camera
from ..render.api import render
from ..scene.gaussians import GaussianScene
from . import densify as densify_mod
from .loss import psnr, rgb_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-4          # x scene_extent, exp-decayed
    lr_means_final: float = 1.6e-6
    lr_decay_steps: int = 30000
    lr_sh: float = 2.5e-3
    lr_sh_rest_div: float = 20.0      # rest bands train 20x slower than DC
    lr_opacity: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    ssim_weight: float = 0.2
    densify_from: int = 500
    densify_until: int = 15000
    densify_every: int = 100
    opacity_reset_every: int = 3000
    grad_threshold: float = 2e-4
    max_new_per_densify: int = 4096


@dataclasses.dataclass
class TrainState:
    scene: GaussianScene
    optimizer: torch.optim.Adam
    densify_state: densify_mod.DensifyState
    step: int = 0


def means_lr(tc: TrainConfig, scene_extent: float, count: int) -> float:
    """The means' learning rate after `count` updates: the reference's
    `optax.exponential_decay(init, lr_decay_steps, rate, end_value=end)`,
    init * rate^(count / steps) floored at end, in float32."""
    f32 = np.float32
    init = f32(tc.lr_means * scene_extent)
    rate = f32(max(tc.lr_means_final / tc.lr_means, 1e-8))
    end = f32(tc.lr_means_final * scene_extent)
    lr = init * rate ** (f32(count) / f32(tc.lr_decay_steps))
    return float(max(lr, end) if rate < 1 else min(lr, end))


def make_optimizer(scene: GaussianScene, tc: TrainConfig,
                   scene_extent: float) -> torch.optim.Adam:
    """One Adam over the scene's five parameters, a group each (named by
    field), eps 1e-15 as the reference's optax.adam."""
    lrs = {"means": means_lr(tc, scene_extent, 0),
           "log_scales": tc.lr_scales, "quats": tc.lr_quats,
           "opacity_logits": tc.lr_opacity, "sh": tc.lr_sh}
    return torch.optim.Adam(
        [{"params": [p], "lr": lrs[name], "name": name}
         for name, p in scene.param_groups().items()], eps=1e-15)


def _group(optimizer: torch.optim.Adam, name: str) -> dict:
    return next(g for g in optimizer.param_groups if g["name"] == name)


def _updates_so_far(optimizer: torch.optim.Adam) -> int:
    """Adam's update count (the means group's; every group steps together)."""
    (param,) = _group(optimizer, "means")["params"]
    step = optimizer.state.get(param, {}).get("step")
    return 0 if step is None else int(step)


def init_train_state(scene: GaussianScene, tc: TrainConfig,
                     scene_extent: float) -> TrainState:
    return TrainState(
        scene=scene, optimizer=make_optimizer(scene, tc, scene_extent),
        densify_state=densify_mod.init_densify_state(scene.capacity,
                                                     scene.means.device))


def apply_gradients(state: TrainState, tc: TrainConfig,
                    scene_extent: float) -> None:
    """The optimizer half of a step, on the gradients in `.grad`: SH rest
    bands / lr_sh_rest_div, every gradient times the live mask, the means'
    decayed rate, one Adam update."""
    scene, opt = state.scene, state.optimizer
    with torch.no_grad():
        sh = scene.sh.grad
        if sh.shape[1] > 1:
            sh[:, 1:] *= 1.0 / tc.lr_sh_rest_div
        live = scene.mask.float()
        for p in scene.param_groups().values():
            p.grad *= live.reshape((-1,) + (1,) * (p.dim() - 1))
    _group(opt, "means")["lr"] = means_lr(tc, scene_extent,
                                          _updates_so_far(opt))
    opt.step()


def make_train_step(render_cfg: cfg.RenderConfig, tc: TrainConfig,
                    scene_extent: float) -> Callable:
    """The step (state, camera, target (H, W, 3)) -> metrics, updating
    `state` in place. A zero `mean2d_delta` that requires grad exposes the
    screen-space positional gradient (the densify signal) without a second
    render. Metrics stay on the device: loss, psnr and num_active."""

    def train_step(state: TrainState, camera: Camera,
                   target: torch.Tensor) -> dict:
        scene = state.scene
        delta = torch.zeros((scene.capacity, 2), device=scene.means.device,
                            requires_grad=True)
        out = render(scene, camera, render_cfg, mean2d_delta=delta)
        loss = rgb_loss(out.image, target, tc.ssim_weight)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state, tc, scene_extent)
        state.densify_state = densify_mod.accumulate_stats(
            state.densify_state, delta.grad, out.stats["radii"])
        state.step += 1
        return {"loss": loss.detach(),
                "psnr": psnr(out.image.detach(), target),
                "num_active": scene.num_active()}

    return train_step


def surgery_opt_state(optimizer: torch.optim.Adam,
                      changed: Optional[torch.Tensor] = None,
                      reset_opacity_moments: bool = False) -> None:
    """Zero Adam's moments in place, only of the slots that changed (the
    3DGS `replace_tensor_to_optimizer` semantics): untouched Gaussians keep
    their optimizer state. `reset_opacity_moments` also zeroes the opacity
    moments of every slot (the opacity reset clamped every logit). The
    update counts are kept."""
    for group in optimizer.param_groups:
        (param,) = group["params"]
        st = optimizer.state.get(param)
        if not st:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            if changed is not None:
                st[key][changed] = 0.0
            if reset_opacity_moments and group["name"] == "opacity_logits":
                st[key].zero_()


def maybe_densify(state: TrainState, tc: TrainConfig,
                  generator: torch.Generator,
                  scene_extent: float) -> Optional[dict]:
    """The densify schedule, run between steps at `state.step`: densify and
    prune every `densify_every` steps in [densify_from, densify_until], and
    reset opacities every `opacity_reset_every` steps, each followed by its
    moment surgery. Returns densify's info, or None when it did not run."""
    step = state.step
    info = None
    if (tc.densify_from <= step <= tc.densify_until
            and step % tc.densify_every == 0):
        _, state.densify_state, info = densify_mod.densify_and_prune(
            state.scene, state.densify_state, generator,
            grad_threshold=tc.grad_threshold, scene_extent=scene_extent,
            max_new=tc.max_new_per_densify)
        surgery_opt_state(state.optimizer, changed=info["changed_slots"])
    if step > 0 and step % tc.opacity_reset_every == 0:
        densify_mod.reset_opacity(state.scene)
        surgery_opt_state(state.optimizer, reset_opacity_moments=True)
    return info


def step_generator(device, step: int, seed: int = 1) -> torch.Generator:
    """The split noise's generator for step `step`: a fresh seed per step,
    so a resumed run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)
