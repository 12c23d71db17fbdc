"""Failure detection and recovery around a training loop. Port of the
reference's `gsrast_tpu/train/resilience.py`:

  * a non-finite step (loss, parameters, Adam moments or densify
    statistics) is rolled back to the last checkpoint, so a poisoned
    update never reaches the persisted state;
  * SIGTERM/SIGINT request a graceful stop: the loop checkpoints and
    returns at the next step boundary (the preemption contract);
  * a heartbeat file {step, time, pid} that a supervisor can watch;
  * fault injection for tests: a deliberate NaN at step k.

The port's `TrainState` is updated in place, so a rollback restores the
checkpoint into the same state (`checkpoint.restore`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Optional

import torch

from . import checkpoint as ckpt_mod
from .trainer import TrainState


@dataclasses.dataclass
class ResilienceConfig:
    ckpt_dir: str = "ckpts"
    ckpt_every: int = 500
    heartbeat_path: Optional[str] = None
    heartbeat_every: int = 50
    max_rollbacks: int = 3          # consecutive NaN rollbacks before abort
    inject_nan_at_step: Optional[int] = None   # fault injection (tests)


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop; the
    training loop checkpoints and exits at the next step boundary. Restores
    the previous handlers on exit."""

    def __init__(self):
        self.stop_requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.stop_requested = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread: polling only
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def write_heartbeat(path: str, step: int) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "time": time.time(), "pid": os.getpid()}, f)
    os.replace(tmp, path)  # atomic: watchers never see a partial write


def read_heartbeat(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def all_finite(state: TrainState, loss: Optional[torch.Tensor] = None
               ) -> bool:
    """Whether the loss and every floating tensor of the state (the five
    parameters, Adam's moments, the densify statistics) are finite: one
    reduction per tensor, combined on the device, and one host sync."""
    tensors = list(state.scene.param_groups().values())
    for st in state.optimizer.state.values():
        tensors += [v for v in st.values()
                    if isinstance(v, torch.Tensor) and v.is_floating_point()
                    and v.dim() > 0]
    tensors += [getattr(state.densify_state, f.name)
                for f in dataclasses.fields(state.densify_state)]
    if loss is not None:
        tensors.append(loss)
    return bool(torch.stack([torch.isfinite(x).all() for x in tensors]).all())


def run_resilient(state: TrainState, num_steps: int,
                  step_fn: Callable[[TrainState, int], dict],
                  rc: ResilienceConfig,
                  log: Callable[[str], None] = print):
    """Drive `step_fn(state, i) -> metrics`, which advances `state` in
    place by one step, up to step `num_steps`, with checkpoints (one at the
    start), NaN rollback, preemption-safe shutdown and heartbeats. Returns
    (state, stopped_early).

    A rollback restores the last saved checkpoint into `state` and goes on
    from its step; with a deterministic step_fn the run ends where an
    uninterrupted one would."""
    rollbacks = 0
    last_saved = state.step
    ckpt_mod.save(rc.ckpt_dir, state)
    inject_at = rc.inject_nan_at_step

    with PreemptionGuard() as guard:
        i = state.step
        while i < num_steps:
            metrics = step_fn(state, i)
            if inject_at is not None and i == inject_at:
                with torch.no_grad():  # poison the scene once
                    state.scene.means.mul_(float("nan"))
                inject_at = None

            if not all_finite(state, metrics.get("loss")):
                rollbacks += 1
                log(f"step {i}: NON-FINITE state detected; rolling back to "
                    f"checkpoint step {last_saved} "
                    f"({rollbacks}/{rc.max_rollbacks})")
                if rollbacks > rc.max_rollbacks:
                    raise RuntimeError(
                        f"aborting: {rollbacks} consecutive non-finite steps")
                if ckpt_mod.restore(rc.ckpt_dir, state) is None:
                    raise RuntimeError("no checkpoint to roll back to")
                i = state.step
                continue

            rollbacks = 0
            i += 1
            if rc.heartbeat_path and i % rc.heartbeat_every == 0:
                write_heartbeat(rc.heartbeat_path, i)
            if rc.ckpt_every and i % rc.ckpt_every == 0:
                ckpt_mod.save(rc.ckpt_dir, state)
                last_saved = i
            if guard.stop_requested:
                log(f"step {i}: preemption requested; checkpointing and "
                    "stopping")
                ckpt_mod.save(rc.ckpt_dir, state)
                if rc.heartbeat_path:
                    write_heartbeat(rc.heartbeat_path, i)
                return state, True

    ckpt_mod.save(rc.ckpt_dir, state)
    if rc.heartbeat_path:
        write_heartbeat(rc.heartbeat_path, state.step)
    return state, False
