"""The plain reference of a 3DGS train step, in PyTorch ops: render, the
L1 + D-SSIM loss, its gradient back to the raw parameters, and one Adam
update per parameter group, with the published 3DGS settings (Kerbl et al.
2023; graphdeco-inria/gaussian-splatting `arguments/__init__.py`,
OptimizationParams): the means' rate 1.6e-4 x the scene extent decaying
exponentially to 1.6e-6 x extent over 30,000 steps, SH DC 2.5e-3 and the
rest bands 20 times slower (their gradient scaled by 1/20), opacity 5e-2,
scales 5e-3, rotations 1e-3, SSIM weight 0.2, Adam's betas (0.9, 0.999)
and eps 1e-15, every gradient masked by the live mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import splat

PARAMS = ("means", "log_scales", "quats", "opacity_logits", "sh")


class Settings(NamedTuple):
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_decay_steps: int = 30000
    lr_sh: float = 2.5e-3
    sh_rest_div: float = 20.0
    lr_opacity: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    ssim_weight: float = 0.2
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-15


def _window(device, dtype, size: int = 11, sigma: float = 1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32)).to(
        device=device, dtype=dtype)


def loss(pred: torch.Tensor, target: torch.Tensor, weight: float):
    """(1 - w) L1 + w (1 - SSIM) of two (H, W, 3) images; SSIM with the
    11x11 sigma-1.5 Gaussian window and zero padding, C1 = 0.01^2, C2 =
    0.03^2. The L1 term's slope is +1 where pred == target."""
    win = _window(pred.device, pred.dtype)
    kernel = win.expand(3, 1, *win.shape)

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[None], kernel, padding=5,
                        groups=3)[0]

    mu0, mu1 = filt(pred), filt(target)
    s00 = filt(pred * pred) - mu0 * mu0
    s11 = filt(target * target) - mu1 * mu1
    s01 = filt(pred * target) - mu0 * mu1
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = torch.mean(((2.0 * mu0 * mu1 + c1) * (2.0 * s01 + c2))
                      / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2)))
    d = pred - target
    return (1.0 - weight) * torch.mean(torch.where(d >= 0, d, -d)) + (
        weight * (1.0 - ssim))


def means_lr(s: Settings, extent: float, count: int) -> float:
    """The means' rate before update `count` + 1, in float32 arithmetic."""
    f32 = np.float32
    init = f32(s.lr_means * extent)
    rate = f32(max(s.lr_means_final / s.lr_means, 1e-8))
    end = f32(s.lr_means_final * extent)
    lr = init * rate ** (f32(count) / f32(s.lr_decay_steps))
    return float(max(lr, end))


def gradients(params: dict, cam: splat.Camera, target: torch.Tensor,
              plan: tuple, sh_degree: int, weight: float,
              loss_fn=None) -> tuple:
    """(loss, image, gradient of each raw parameter, blend) of one view;
    `loss_fn(pred, target, weight)` in place of `loss` where given."""
    tile_h, tile_w, tiers = plan
    leaves = {k: params[k].detach().requires_grad_() for k in PARAMS}
    act = splat.activate({**leaves, "mask": params["mask"]})
    sp = splat.project(act, cam, sh_degree, tile_h, tile_w)
    pr = splat.pairs(sp, cam, tile_h, tile_w, tiers)
    image = splat.blend(sp.features.detach(), pr, cam, tile_h, tile_w).image
    img = image.detach().requires_grad_()
    value = (loss_fn or loss)(img, target, weight)
    (d_image,) = torch.autograd.grad(value, img)
    feats = sp.features.detach().requires_grad_()
    out = splat.blend(feats, pr, cam, tile_h, tile_w, d_image=d_image)
    d_feats = feats.grad if feats.grad is not None else torch.zeros_like(feats)
    torch.autograd.backward(sp.features, d_feats)
    grads = {k: (leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k])) for k in PARAMS}
    return value.detach(), image, grads, out


def adam(params: dict, grads: dict, state: dict, s: Settings,
         extent: float) -> dict:
    """One masked Adam update of every group in place; returns the
    gradients as Adam took them (rest bands scaled, masked)."""
    b1, b2 = s.betas
    count = state.setdefault("count", 0) + 1
    state["count"] = count
    lrs = {"means": means_lr(s, extent, count - 1), "log_scales": s.lr_scales,
           "quats": s.lr_quats, "opacity_logits": s.lr_opacity, "sh": s.lr_sh}
    live = params["mask"]
    taken = {}
    for k in PARAMS:
        g = grads[k].clone()
        if k == "sh":
            g[:, 1:] = g[:, 1:] * (1.0 / s.sh_rest_div)
        g = g * live.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
        m = state.setdefault(f"m.{k}", torch.zeros_like(g))
        v = state.setdefault(f"v.{k}", torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).add_(g * g, alpha=1.0 - b2)
        mh = m / (1.0 - b1 ** count)
        vh = v / (1.0 - b2 ** count)
        params[k] = params[k] - lrs[k] * (mh / (torch.sqrt(vh) + s.eps))
        taken[k] = g
    return taken


def steps(params: dict, views: list, targets: list, plan: tuple,
          sh_degree: int, extent: float, s: Settings = Settings(),
          loss_fn=None) -> dict:
    """The first len(views) train steps from `params` (raw parameters and
    `mask`), one view and target each: each step's loss, the gradient of
    the first as Adam took it, and the parameters after the last."""
    params = dict(params)
    state, losses, first = {}, [], None
    for cam, target in zip(views, targets):
        value, _, grads, _ = gradients(params, cam, target, plan, sh_degree,
                                       s.ssim_weight, loss_fn)
        taken = adam(params, grads, state, s, extent)
        losses.append(float(value))
        if first is None:
            first = taken
    return {"losses": losses, "first_grad": first,
            "params": {k: params[k] for k in PARAMS}}
