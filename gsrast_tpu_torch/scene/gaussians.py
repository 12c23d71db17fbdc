"""Gaussian scene representation.

`GaussianScene` stores the raw (pre-activation) parameters a trained .ply
holds, as the five parameter groups of an `nn.Module`, with a validity mask
as a buffer. `activated()` applies the activations the renderer consumes:
exp scales, normalised quaternions, masked sigmoid opacity.

Capacity vs count: a scene may hold `capacity` rows of which the mask marks
the live ones; densification fills dead slots and pruning frees them in
place, without reallocating (see `train/densify.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


PARAM_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def _sh_degree(sh: torch.Tensor) -> int:
    return int(round(sh.shape[1] ** 0.5)) - 1


@dataclasses.dataclass(frozen=True)
class ActivatedGaussians:
    """Render-ready view of a scene (post-activation)."""

    means: torch.Tensor      # (N, 3)
    scales: torch.Tensor     # (N, 3)
    quats: torch.Tensor      # (N, 4) unit (w, x, y, z)
    opacities: torch.Tensor  # (N,) 0 where masked out
    sh: torch.Tensor         # (N, K, 3), DC first
    mask: torch.Tensor       # (N,) bool

    @property
    def sh_degree(self) -> int:
        return _sh_degree(self.sh)


class GaussianScene(nn.Module):
    """Raw (trainable) Gaussian parameters, SoA.

    means (N, 3); log_scales (N, 3); quats (N, 4) unnormalised (w, x, y, z);
    opacity_logits (N,); sh (N, K, 3) with K = (degree + 1)^2, DC first;
    mask (N,) bool buffer, True for live Gaussians.
    """

    def __init__(self, means, log_scales, quats, opacity_logits, sh, mask):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_logits = nn.Parameter(opacity_logits)
        self.sh = nn.Parameter(sh)
        self.register_buffer("mask", mask)

    @property
    def sh_degree(self) -> int:
        return _sh_degree(self.sh)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.mask, dtype=torch.int32)

    def param_groups(self) -> Dict[str, nn.Parameter]:
        """The five trainable parameters by field name, in `PARAM_FIELDS`
        order: the optimizer's parameter groups."""
        return {name: getattr(self, name) for name in PARAM_FIELDS}

    def activated(self) -> ActivatedGaussians:
        q = self.quats
        norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
        return ActivatedGaussians(
            means=self.means,
            scales=torch.exp(self.log_scales),
            quats=q / (norm + 1e-12),
            opacities=torch.where(
                self.mask, torch.sigmoid(self.opacity_logits), 0.0),
            sh=self.sh,
            mask=self.mask,
        )

    def bbox(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Min and max corner over the live Gaussians (no gradient)."""
        big = 3.0e38
        live = self.mask[:, None]
        means = self.means.detach()
        mn = torch.amin(torch.where(live, means, big), dim=0)
        mx = torch.amax(torch.where(live, means, -big), dim=0)
        return mn, mx


def from_numpy(arrays: dict, device="cpu") -> GaussianScene:
    """A scene from host arrays keyed by field name: the five parameter
    groups and optionally `mask` (all live when absent). This is how weights
    cross from the reference package: pass its scene's fields as numpy."""
    def f32(name):  # a copy: training updates the parameters in place
        return torch.tensor(np.asarray(arrays[name], np.float32),
                            device=device)

    means = f32("means")
    n = means.shape[0]
    mask = arrays.get("mask")
    mask = (torch.ones(n, dtype=torch.bool, device=device) if mask is None
            else torch.tensor(np.asarray(mask, bool), device=device))
    return GaussianScene(means, f32("log_scales"), f32("quats"),
                         f32("opacity_logits").reshape(n), f32("sh"), mask)


def pad_to_capacity(scene: GaussianScene, capacity: int) -> GaussianScene:
    """A new scene with `capacity` rows: the live rows of `scene` followed
    by dead slots (identity rotation, log-scale and opacity logit -10, zero
    elsewhere), as the reference pads."""
    n = scene.capacity
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current size {n}")
    pad = capacity - n

    def _pad(x: torch.Tensor, fill=0.0) -> torch.Tensor:
        x = x.detach()
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    quats = _pad(scene.quats)
    quats[n:, 0] = 1.0
    return GaussianScene(_pad(scene.means), _pad(scene.log_scales, -10.0),
                         quats, _pad(scene.opacity_logits, -10.0),
                         _pad(scene.sh), _pad(scene.mask, False))


def random_scene(n: int, generator: np.random.Generator, sh_degree: int = 0,
                 extent: float = 1.0, isotropic: bool = False,
                 scale_range: Tuple[float, float] = (0.01, 0.05),
                 device="cpu") -> GaussianScene:
    """Synthetic scene with the reference's `random_scene` distributions:
    means uniform in the cube [-extent, extent]^3, log-uniform scales over
    `scale_range * extent`, random unit quaternions (identity when
    isotropic), opacity logits uniform in [-1, 3), SH DC uniform in [-1, 1)
    and higher orders N(0, 0.1^2). The values differ from the reference's:
    the two packages draw from different generators."""
    g = generator
    means = g.uniform(-extent, extent, (n, 3))
    lo, hi = np.log(scale_range[0] * extent), np.log(scale_range[1] * extent)
    if isotropic:
        log_scales = np.repeat(g.uniform(lo, hi, (n, 1)), 3, axis=1)
        quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n, 1))
    else:
        log_scales = g.uniform(lo, hi, (n, 3))
        quats = g.standard_normal((n, 4))
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity_logits = g.uniform(-1.0, 3.0, (n,))
    ksh = (sh_degree + 1) ** 2
    sh = np.zeros((n, ksh, 3))
    sh[:, 0, :] = g.uniform(-1.0, 1.0, (n, 3))
    if ksh > 1:
        sh[:, 1:, :] = 0.1 * g.standard_normal((n, ksh - 1, 3))
    return from_numpy(dict(means=means, log_scales=log_scales, quats=quats,
                           opacity_logits=opacity_logits, sh=sh),
                      device=device)
