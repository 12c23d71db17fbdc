"""Checkpoint and resume, with `torch.save` in place of the reference's orbax
(`gsrast_tpu/train/checkpoint.py`).

A checkpoint is `ckpt_dir/step_%08d/state.pt`, holding the five parameter
tensors, the mask, the Adam state, the densify statistics and the step.
Restoring into a state built for the same scene capacity continues exactly:
k steps, save, restore and m steps equal k + m steps. A restore writes into
the state's tensors, so a captured train step goes on with them.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

import torch

from .adam import make_state
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


def _saved_tensors(payload: dict, optimizer: torch.optim.Adam) -> dict:
    """A checkpoint's tensors under `TrainState.tensors()`' names."""
    out = {f"param.{k}": v for k, v in payload["params"].items()}
    out["mask"] = payload["mask"]
    # Adam's state_dict numbers the parameters in group order, one a group.
    adam = payload["optimizer"]["state"]
    for index, group in enumerate(optimizer.param_groups):
        for key, v in adam.get(index, {}).items():
            out[f"adam.{group['name']}.{key}"] = v
    out.update({f"densify.{k}": v for k, v in payload["densify"].items()})
    return out


def restore(ckpt_dir: str, state: TrainState,
            step: Optional[int] = None) -> Optional[TrainState]:
    """Load the given (or the newest) checkpoint into `state` in place and
    return it; None when there is none. `state` must hold a scene of the
    checkpoint's capacity and SH degree, with its optimizer.

    Every tensor of `state.tensors()` is written into in place (`copy_`):
    the parameters, the mask, Adam's counts and moments and the densify
    statistics keep their storage, so a CUDA graph of the train step
    (`trainer.TrainGraph`) replays on the restored values. A checkpoint
    saved before the first update holds no Adam state: restoring it zeroes
    the counts and moments, which is a fresh optimizer. The learning rates
    are not restored: they are the schedule's, from the count."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    device = state.scene.means.device
    payload = torch.load(os.path.join(_step_dir(ckpt_dir, step), STATE_FILE),
                         map_location=device, weights_only=True)
    saved = _saved_tensors(payload, state.optimizer)
    if payload["optimizer"]["state"]:
        make_state(state.optimizer)
    with torch.no_grad():
        for name, t in state.tensors().items():
            if name not in saved:  # Adam's, absent from the checkpoint
                t.zero_()
            elif saved[name].shape != t.shape:
                raise ValueError(f"checkpoint {name} has shape "
                                 f"{tuple(saved[name].shape)}, the state "
                                 f"{tuple(t.shape)}")
            else:
                t.copy_(saved[name])
    state.step = int(payload["step"])
    return state


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
