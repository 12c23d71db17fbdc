"""Nested render-target composition on (H, W, C) float32 tensors.

A render target is an image; nesting is composition: `blit` places a child
target's image into a parent at a viewport rectangle (optionally scaled by
nearest-neighbour resampling), `overlay` alpha-composites an RGBA child,
and `RenderStack` keeps the stack of targets, compositing the top into the
one below on `pop`. The functions return new tensors and leave their
inputs unchanged, as the reference's (`gsrast_tpu/utils/compositor.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch


def solid(height: int, width: int, color=(0.0, 0.0, 0.0),
          device="cpu") -> torch.Tensor:
    """A cleared render target."""
    return torch.tensor(color, dtype=torch.float32,
                        device=device).expand(height, width, 3)


def resize_nearest(img: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """Nearest-neighbour resample to height x width."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.arange(height, device=img.device) * h // height
    xs = torch.arange(width, device=img.device) * w // width
    return img[ys][:, xs]


def blit(parent: torch.Tensor, child: torch.Tensor, y: int = 0, x: int = 0,
         scale_to: Tuple[int, int] | None = None) -> torch.Tensor:
    """`child` drawn into `parent` at (y, x); the parts outside the parent
    are clipped."""
    if scale_to is not None:
        child = resize_nearest(child, *scale_to)
    ph, pw = parent.shape[0], parent.shape[1]
    ch, cw = child.shape[0], child.shape[1]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + ch, ph), min(x + cw, pw)
    if y1 <= y0 or x1 <= x0:
        return parent
    out = parent.clone()
    out[y0:y1, x0:x1] = child[y0 - y:y1 - y, x0 - x:x1 - x]
    return out


def overlay(parent: torch.Tensor, child_rgba: torch.Tensor, y: int = 0,
            x: int = 0) -> torch.Tensor:
    """An RGBA child alpha-composited over the parent at (y, x)."""
    ph, pw = parent.shape[0], parent.shape[1]
    ch, cw = child_rgba.shape[0], child_rgba.shape[1]
    y1, x1 = min(y + ch, ph), min(x + cw, pw)
    region = parent[y:y1, x:x1]
    child = child_rgba[:y1 - y, :x1 - x]
    a = child[..., 3:4]
    out = parent.clone()
    out[y:y1, x:x1] = child[..., :3] * a + region * (1.0 - a)
    return out


class RenderStack:
    """A stack of render targets with their viewports: `push` a target,
    `draw` into it, `pop` composites it into the target below."""

    def __init__(self, height: int, width: int, clear=(0.0, 0.0, 0.0),
                 device="cpu"):
        self._device = device
        self._stack = [solid(height, width, clear, device)]
        self._viewports = [(0, 0)]

    def push(self, height: int, width: int, y: int = 0, x: int = 0,
             clear=(0.0, 0.0, 0.0)) -> None:
        self._stack.append(solid(height, width, clear, self._device))
        self._viewports.append((y, x))

    def draw(self, fn_or_image) -> None:
        """Draw into the current target: an image blitted at (0, 0), or a
        callable image -> image."""
        top = self._stack[-1]
        if callable(fn_or_image):
            self._stack[-1] = fn_or_image(top)
        else:
            self._stack[-1] = blit(top, torch.as_tensor(fn_or_image,
                                                        device=top.device))

    def pop(self) -> torch.Tensor:
        """Composite the top target into the one below at its viewport;
        returns the popped target."""
        child = self._stack.pop()
        y, x = self._viewports.pop()
        if not self._stack:
            return child
        self._stack[-1] = blit(self._stack[-1], child, y, x)
        return child

    @property
    def image(self) -> torch.Tensor:
        return self._stack[0]
