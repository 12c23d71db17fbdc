"""Checkpoint and resume, with `torch.save` in place of the reference's orbax
(`gsrast_tpu/train/checkpoint.py`).

A checkpoint is `ckpt_dir/step_%08d/state.pt`, holding the five parameter
tensors, the mask, the Adam state, the densify statistics and the step.
Restoring into a state built for the same scene capacity continues exactly:
k steps, save, restore and m steps equal k + m steps.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

import torch

from .densify import DensifyState
from .trainer import TrainState

STATE_FILE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save(ckpt_dir: str, state: TrainState, keep: int = 3) -> str:
    """Save `state`; keeps the newest `keep` checkpoints. Returns the
    checkpoint's directory."""
    path = _step_dir(ckpt_dir, state.step)
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": state.step,
        "params": {name: p.detach()
                   for name, p in state.scene.param_groups().items()},
        "mask": state.scene.mask,
        "optimizer": state.optimizer.state_dict(),
        "densify": dataclasses.asdict(state.densify_state),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))  # never half-written
    _prune(ckpt_dir, keep)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_")[1].isdigit()
             and os.path.exists(os.path.join(ckpt_dir, d, STATE_FILE))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state: TrainState,
            step: Optional[int] = None) -> Optional[TrainState]:
    """Load the given (or the newest) checkpoint into `state` in place and
    return it; None when there is none. `state` must hold a scene of the
    checkpoint's capacity and SH degree, with its optimizer."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    device = state.scene.means.device
    payload = torch.load(os.path.join(_step_dir(ckpt_dir, step), STATE_FILE),
                         map_location=device, weights_only=True)
    with torch.no_grad():
        for name, p in state.scene.param_groups().items():
            saved = payload["params"][name]
            if saved.shape != p.shape:
                raise ValueError(f"checkpoint {name} has shape "
                                 f"{tuple(saved.shape)}, the scene "
                                 f"{tuple(p.shape)}")
            p.copy_(saved)
        state.scene.mask.copy_(payload["mask"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.densify_state = DensifyState(**payload["densify"])
    state.step = int(payload["step"])
    return state


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
