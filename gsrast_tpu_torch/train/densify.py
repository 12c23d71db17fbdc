"""Adaptive density control: densify (clone/split), prune, opacity reset.

Port of the reference's `gsrast_tpu/train/densify.py`. The scene lives in
fixed-capacity tensors with a validity mask, so these functions move
Gaussians between live and dead slots in place, under `torch.no_grad()`:
no tensor is reallocated and the optimizer's state keeps its shapes.

Semantics follow the standard 3DGS recipe:
  * accumulate per-Gaussian screen-space positional gradient norms;
  * clone small high-gradient Gaussians (copy, keep scale);
  * split large high-gradient Gaussians (2 children sampled inside the
    parent, scale / 1.6, the parent dies);
  * prune by minimum opacity and, optionally, by maximum screen radius;
  * periodically clamp opacity to a small value.
Split noise comes from the `torch.Generator` the caller passes, so its
values differ from the reference's `jax.random` draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..ops.covariance import quat_to_rotmat
from ..scene.gaussians import PARAM_FIELDS, GaussianScene


@dataclasses.dataclass
class DensifyState:
    """Running statistics between densify steps, (M,) float32 each."""

    grad_accum: torch.Tensor  # sum of ||d mean2d|| over views
    denom: torch.Tensor       # number of views the Gaussian was visible in
    max_radii: torch.Tensor   # largest screen radius seen


def init_densify_state(capacity: int, device="cpu") -> DensifyState:
    return DensifyState(*(torch.zeros(capacity, device=device)
                          for _ in range(3)))


def accumulate_stats(state: DensifyState, mean2d_grad: torch.Tensor,
                     radii: torch.Tensor) -> DensifyState:
    """Add one view into `state` in place and return it: `mean2d_grad`
    (M, 2), `radii` (M,) int32 (0 = not visible). The statistics keep
    their storage, so a CUDA graph of the train step reads and writes the
    same tensors on every replay."""
    with torch.no_grad():
        visible = radii > 0
        norm = torch.linalg.vector_norm(mean2d_grad, dim=-1)
        state.grad_accum.add_(torch.where(visible, norm, 0.0))
        state.denom.add_(visible.float())
        torch.maximum(state.max_radii, radii.float(), out=state.max_radii)
    return state


def reset_stats(state: DensifyState) -> DensifyState:
    """Zero the statistics in place (after a densify) and return them."""
    for f in dataclasses.fields(state):
        getattr(state, f.name).zero_()
    return state


def _first_true(flags: torch.Tensor, limit: int) -> torch.Tensor:
    """Indices of the first `limit` True flags, ascending."""
    return torch.nonzero(flags).flatten()[:limit]


def densify_and_prune(
    scene: GaussianScene,
    state: DensifyState,
    generator: torch.Generator,
    grad_threshold: float = 2e-4,
    scale_threshold: float = 0.01,  # fraction of the scene extent
    scene_extent: float = 1.0,
    min_opacity: float = 0.005,
    max_screen_radius: float = 0.0,  # 0 disables screen-size pruning
    max_new: int = 4096,
) -> Tuple[GaussianScene, DensifyState, dict]:
    """One adaptive-density step on `scene`, in place. Returns (scene,
    `state` zeroed in place, info). `max_new` bounds the new Gaussians
    (clones plus split children) per step; demand beyond it is counted in
    info["densify_overflow"]. info["changed_slots"] (M,) bool marks every
    slot whose parameters were written or freed: only those lose their
    optimizer moments."""
    with torch.no_grad():
        avg_grad = state.grad_accum / torch.clamp(state.denom, min=1.0)
        high_grad = (avg_grad > grad_threshold) & scene.mask
        world_scale = torch.amax(torch.exp(scene.log_scales), dim=-1)
        is_small = world_scale <= scale_threshold * scene_extent
        clone_flags = high_grad & is_small
        split_flags = high_grad & ~is_small

        prune = scene.mask & (torch.sigmoid(scene.opacity_logits)
                              < min_opacity)
        if max_screen_radius > 0:
            prune |= scene.mask & (state.max_radii > max_screen_radius)
        prune &= ~clone_flags & ~split_flags  # densify targets survive
        mask = scene.mask & ~prune

        # Clones need one free slot each, splits two (the parent dies).
        clone_budget = max_new // 2
        split_budget = (max_new - clone_budget) // 2
        clone_src = _first_true(clone_flags, clone_budget)
        parents = _first_true(split_flags, split_budget)
        free = _first_true(~mask, max_new)
        n_clone = min(len(clone_src), len(free))
        n_split = min(len(parents), max(len(free) - n_clone, 0) // 2)
        clone_src, parents = clone_src[:n_clone], parents[:n_split]
        clone_dst = free[:n_clone]
        children = free[n_clone:n_clone + 2 * n_split]  # parent i: 2i, 2i+1
        demand = int(clone_flags.sum()) + 2 * int(split_flags.sum())

        params = scene.param_groups()
        p_rows = {f: params[f][parents] for f in PARAM_FIELDS}
        for f in PARAM_FIELDS:
            params[f][clone_dst] = params[f][clone_src]
        mask[clone_dst] = True

        qn = p_rows["quats"] / (torch.linalg.vector_norm(
            p_rows["quats"], dim=-1, keepdim=True) + 1e-12)
        rot = quat_to_rotmat(qn)  # (S, 3, 3)
        noise = torch.randn((n_split, 2, 3), generator=generator,
                            device=generator.device).to(scene.means.device)
        noise = noise * torch.exp(p_rows["log_scales"])[:, None, :]
        # offsets[s, k] = rot[s] @ noise[s, k], as elementwise sums.
        offsets = (rot[:, None] * noise[:, :, None, :]).sum(-1)
        child = {f: p_rows[f].repeat_interleave(2, dim=0)
                 for f in PARAM_FIELDS}
        child["means"] = (p_rows["means"][:, None] + offsets).reshape(-1, 3)
        child["log_scales"] = child["log_scales"] - math.log(1.6)
        for f in PARAM_FIELDS:
            params[f][children] = child[f]
        mask[children] = True
        mask[parents] = False
        scene.mask.copy_(mask)

        changed = prune.clone()
        changed[clone_dst] = True
        changed[children] = True
        changed[parents] = True
    info = {
        "num_cloned": n_clone,
        "num_split": n_split,
        "num_pruned": int(prune.sum()),
        "densify_overflow": max(demand - (n_clone + 2 * n_split), 0),
        "num_active": int(scene.num_active()),
        "changed_slots": changed,
    }
    return scene, reset_stats(state), info


def reset_opacity(scene: GaussianScene,
                  max_opacity: float = 0.01) -> GaussianScene:
    """Clamp opacities to <= max_opacity in place (the periodic 3DGS
    opacity reset)."""
    cap = math.log(max_opacity / (1.0 - max_opacity))
    with torch.no_grad():
        scene.opacity_logits.clamp_(max=cap)
    return scene
