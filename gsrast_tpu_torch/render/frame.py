"""The viewer's frame captured once per image shape and replayed: the
counterpart of the reference viewer's
`jax.jit(lambda view: draw(base.replace(view=view)))`
(`apps/render_app.py:101`), which compiles the frame once and dispatches it
as one program for each of the three modes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import _kernels
from ..benchmark import capture_refusal
from ..camera import Camera
from ..cli import MODES


def frame_refusal(mode: str, backend: str) -> Optional[str]:
    """Why a `mode` frame on `backend` cannot be captured in a CUDA graph,
    or None where it can: the splats only on the blend kernels
    (`benchmark.capture_refusal`), the ellipsoids only on their kernel (the
    plain version lists its pairs on the host); the point cloud has no
    backend and reads nothing on the host."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if mode == "gaussians":
        return capture_refusal(backend)
    if mode == "ellipsoids" and backend != "cuda":
        return ("the plain ray trace counts its (Gaussian, tile) pairs on "
                "the host")
    return None


class FrameGraph(_kernels.ShapeGraphs):
    """`FrameGraph(draw, mode, backend)(camera)` returns `draw(camera)`'s
    image. On a card it goes through one CUDA graph per (height, width)
    (`_kernels.ShapeGraphs`): each call copies the camera's tensors into
    the shape's static camera; the first call of a shape draws eagerly on a
    side stream, the second captures the draw and replays it, later calls
    replay. From the second call of a shape on, the image is the graph's
    own tensor, which the next replay rewrites: copy what is kept.

    A `backend` that cannot be captured for `mode` (`frame_refusal`) is
    refused before any frame; a capture that fails raises, chained to the
    draw's error and naming the mode. Nothing falls back to eager frames.
    On the CPU every call is `draw(camera)` itself."""

    def __init__(self, draw: Callable[[Camera], torch.Tensor],
                 mode: str = "gaussians", backend: str = "cuda"):
        super().__init__(f"the {mode} frame")
        self.draw, self.mode, self.backend = draw, mode, backend
        self.refusal = frame_refusal(mode, backend)

    def __call__(self, camera: Camera) -> torch.Tensor:
        if camera.device.type != "cuda":
            return self.draw(camera)
        if self.refusal:
            raise ValueError(
                f"a {self.mode} frame on a card is captured in a CUDA graph, "
                f"which backend {self.backend!r} cannot enter: "
                f"{self.refusal}")
        return self.run(self.draw, camera)
