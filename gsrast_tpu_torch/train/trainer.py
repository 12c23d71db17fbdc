"""Training loop pieces: per-group Adam, the train step, the densify
schedule. Port of the reference's `gsrast_tpu/train/trainer.py`.

The standard 3DGS optimizer recipe: one learning rate per parameter group,
exponential decay of the means' rate scaled by the scene extent, the SH
rest bands at 1/20 of the DC rate, and masked gradients so dead capacity
slots stay frozen; the update itself is `adam.py`'s. The train step
updates its `TrainState` in place, and on a card `TrainGraph` captures it
once into a CUDA graph and replays it, as the reference jits it once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import _kernels
from .. import config as cfg
from ..camera import Camera
from ..render.api import render
from ..scene.gaussians import GaussianScene
from ..utils import profiling
from ..utils.profiling import span
from . import adam
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

    def tensors(self) -> dict:
        """Every tensor the train step keeps, by name: the five parameters
        (`param.<field>`), the mask, each Adam count and moment once Adam
        has state (`adam.<group>.<key>`) and the densify statistics
        (`densify.<field>`). A captured step replays on these; densify,
        the opacity reset and a restore write into them."""
        out = {f"param.{k}": p for k, p in self.scene.param_groups().items()}
        out["mask"] = self.scene.mask
        for group in self.optimizer.param_groups:
            (param,) = group["params"]
            for key, v in self.optimizer.state.get(param, {}).items():
                out[f"adam.{group['name']}.{key}"] = v
        for f in dataclasses.fields(self.densify_state):
            out[f"densify.{f.name}"] = getattr(self.densify_state, f.name)
        return out


def _schedule(tc: TrainConfig, scene_extent: float) -> tuple:
    """(init, rate, end) of the means' decay, in float32."""
    f32 = np.float32
    return (f32(tc.lr_means * scene_extent),
            f32(max(tc.lr_means_final / tc.lr_means, 1e-8)),
            f32(tc.lr_means_final * scene_extent))


def means_lr(tc: TrainConfig, scene_extent: float, count: int) -> float:
    """The means' learning rate after `count` updates: the reference's
    `optax.exponential_decay(init, lr_decay_steps, rate, end_value=end)`,
    init * rate^(count / steps) floored at end, in float32."""
    init, rate, end = _schedule(tc, scene_extent)
    lr = init * rate ** (np.float32(count) / np.float32(tc.lr_decay_steps))
    return float(max(lr, end) if rate < 1 else min(lr, end))


def means_lr_tensor(tc: TrainConfig, scene_extent: float,
                    count: torch.Tensor) -> torch.Tensor:
    """`means_lr` of a 0-d count tensor (Adam's float32 update count) on
    its device, with no host sync: the rate a CUDA graph of the step
    recomputes on every replay. The divisor is a tensor because a CUDA
    division by a host scalar multiplies by its reciprocal, one rounding
    more than the reference's division."""
    init, rate, end = _schedule(tc, scene_extent)
    steps = torch.full((), float(tc.lr_decay_steps), device=count.device)
    lr = float(init) * torch.pow(float(rate), count.float() / steps)
    return lr.clamp(min=float(end)) if rate < 1 else lr.clamp(max=float(end))


def make_optimizer(scene: GaussianScene, tc: TrainConfig,
                   scene_extent: float) -> torch.optim.Adam:
    """One Adam over the scene's five parameters, a group each (named by
    field), eps 1e-15 as the reference's optax.adam. It holds the state and
    the rates; the train step updates them with `adam.update`
    (`apply_gradients`), and only the sharded step calls its `step()`.

    On a CUDA device Adam is capturable: its update counts stay on the
    device, and the means' rate is a 0-d device tensor that
    `apply_gradients` rewrites from the count, so the whole step can be
    captured in a CUDA graph (`TrainGraph`). PyTorch refuses capturable
    Adam on the CPU, where the counts live on the host and the rate is a
    float."""
    device = scene.means.device
    capturable = device.type == "cuda"
    lr0 = means_lr(tc, scene_extent, 0)
    lrs = {"means": torch.full((), lr0, device=device) if capturable else lr0,
           "log_scales": tc.lr_scales, "quats": tc.lr_quats,
           "opacity_logits": tc.lr_opacity, "sh": tc.lr_sh}
    opt = torch.optim.Adam(
        [{"params": [p], "lr": lrs[name], "name": name}
         for name, p in scene.param_groups().items()], eps=1e-15,
        capturable=capturable)
    # Capturable Adam warns once when it steps outside a capture; here the
    # eager steps use it on purpose.
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def _group(optimizer: torch.optim.Adam, name: str) -> dict:
    return next(g for g in optimizer.param_groups if g["name"] == name)


def init_train_state(scene: GaussianScene, tc: TrainConfig,
                     scene_extent: float) -> TrainState:
    return TrainState(
        scene=scene, optimizer=make_optimizer(scene, tc, scene_extent),
        densify_state=densify_mod.init_densify_state(scene.capacity,
                                                     scene.means.device))


def apply_gradients(state: TrainState, tc: TrainConfig,
                    scene_extent: float, backend: str = "cuda") -> None:
    """The optimizer half of a step, on the gradients in `.grad`, which it
    reads and leaves as they are: the means' decayed rate, then one
    `adam.update` (SH rest bands / lr_sh_rest_div, every gradient times the
    live mask, Adam), the kernel of `csrc/adam.cu` for CUDA tensors under
    backend 'cuda'. On a card the rate is written on the device from Adam's
    count (`means_lr_tensor`); on the CPU it is read from the host's."""
    opt = state.optimizer
    with torch.no_grad():
        adam.make_state(opt)
        group = _group(opt, "means")
        (param,) = group["params"]
        count = opt.state[param]["step"]  # all groups step together
        if torch.is_tensor(group["lr"]):
            group["lr"].copy_(means_lr_tensor(tc, scene_extent, count))
        else:
            group["lr"] = means_lr(tc, scene_extent, int(count))
    adam.update(opt, state.scene.mask, 1.0 / tc.lr_sh_rest_div, backend)


def make_train_step(render_cfg: cfg.RenderConfig, tc: TrainConfig,
                    scene_extent: float) -> Callable:
    """The step (state, camera, target (H, W, 3)) -> metrics, updating
    `state` in place. A zero `mean2d_delta` that requires grad exposes the
    screen-space positional gradient (the densify signal) without a second
    render. Metrics stay on the device: loss, psnr and num_active.

    Its spans (`utils/profiling.py`): `train.stats` (the densify signal's
    zeros and `zero_grad`; after the update, the statistics and the
    metrics), the render's, `train.loss`, `train.backward` (around
    `loss.backward()`, holding the backward spans `train.loss.bwd` and the
    render's), `train.adam`."""

    def train_step(state: TrainState, camera: Camera,
                   target: torch.Tensor) -> dict:
        scene = state.scene
        dev = scene.means.device
        with span("stats", "train", dev):
            delta = torch.zeros((scene.capacity, 2), device=dev,
                                requires_grad=True)
            state.optimizer.zero_grad(set_to_none=True)
        out = render(scene, camera, render_cfg, mean2d_delta=delta)
        image = profiling.backward_end("train.loss", out.image)
        with span("loss", "train", dev):
            loss = rgb_loss(image, target, tc.ssim_weight,
                            backend=render_cfg.backend)
        loss = profiling.backward_start("train.loss", loss)
        with span("backward", "train", dev):
            loss.backward()
        with span("adam", "train", dev):
            apply_gradients(state, tc, scene_extent, render_cfg.backend)
        with span("stats", "train", dev):
            densify_mod.accumulate_stats(state.densify_state, delta.grad,
                                         out.stats["radii"])
            state.step += 1
            return {"loss": loss.detach(),
                    "psnr": psnr(out.image.detach(), target),
                    "num_active": scene.num_active()}

    return train_step


class TrainGraph(_kernels.ShapeGraphs):
    """The train step captured once per image shape into a CUDA graph and
    replayed: the counterpart of the reference's `jax.jit(train_step)`,
    which compiles the step once and dispatches it as one program.

    `TrainGraph(step_fn)(state, camera, target)` takes what `step_fn` (a
    `make_train_step` step) takes and returns its metrics, through
    `_kernels.ShapeGraphs`: per image shape (height, width) static inputs,
    a camera (`CAMERA_TENSORS`) and a target, into which each call copies
    the ones it is given, so views visited round robin, each with its own
    intrinsics, share one graph. The first call of a shape runs one eager
    step on a side stream (it creates Adam's state and the allocator's
    blocks); the second captures the step and replays it once, so no step
    is lost or run twice; every later call is one `replay()` and advances
    `state.step` on the host. Everything else the step changes it changes
    in place, so densify, the opacity reset, a checkpoint restore and a
    rollback between calls, which write into the same tensors
    (`train/densify.py`, `train/checkpoint.py`), are what the next replay
    reads.

    A graph replays on the tensors of the state it was captured with: call
    it with that state. The metrics of a replay are the graph's own
    tensors, rewritten by the next replay: clone what is kept. A capture
    that fails raises, chained to the step's error; nothing falls back to
    eager steps. On the CPU every call is `step_fn` itself.

    `captures`, `replays` and `captured` are `ShapeGraphs`'."""

    def __init__(self, step_fn: Callable):
        super().__init__("the train step")
        self.step_fn = step_fn

    def __call__(self, state: TrainState, camera: Camera,
                 target: torch.Tensor) -> dict:
        if camera.device.type != "cuda":
            return self.step_fn(state, camera, target)
        if self.replays_next(camera):
            state.step += 1
        return self.run(lambda cam, tgt: self.step_fn(state, cam, tgt),
                        camera, target)


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
        _, _, info = densify_mod.densify_and_prune(
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
