"""Batched Gaussian preprocessing: cull, project, shade, and bound each
splat's support by a per-axis tile rectangle.

Two versions of one function, as the reference's preprocess is one fused
computation over all N Gaussians (`gsrast_tpu/ops/preprocess.py`):
  * `preprocess_torch`, the plain version in PyTorch ops, differentiated by
    autograd, with its VJP `preprocess_vjp_torch`;
  * the hand-written kernels of `csrc/preprocess.cu`, forward and backward
    (`preprocess_forward_cuda`, `preprocess_backward_cuda`; CUDA tensors
    only), the backward recomputing the forward's intermediates.
`PreprocessFunction` pairs a forward with its backward for autograd;
`preprocess` runs the kernels on CUDA tensors under backend 'cuda' and the
plain version, through autograd, everywhere else. Activation
(`GaussianScene.activated`) stays outside: autograd carries the gradients
through it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from .. import config as cfg
from ..camera import (CAMERA_FLOATS, CAMERA_TENSORS, Camera, DeviceCamera,
                      device_camera)
from ..scene.gaussians import ActivatedGaussians
from . import covariance, projection, sh as sh_ops

# The activated inputs the function differentiates, in its argument order.
INPUT_FIELDS = ("means", "scales", "quats", "opacities", "sh")


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space state."""

    mean2d: torch.Tensor   # (N, 2) pixel coords
    depth: torch.Tensor    # (N,) camera-space z
    conic: torch.Tensor    # (N, 3) inverse 2D covariance [A, B, C]
    color: torch.Tensor    # (N, 3) RGB from SH
    opacity: torch.Tensor  # (N,) 0 where culled
    radius: torch.Tensor   # (N,) int32 pixel extent (0 = culled)
    rect: projection.TileRect  # covered tile rectangle

    def detach(self) -> "Preprocessed":
        """The same state cut from the graph: the integer structure the
        tile plans are built from (the reference's `stop_gradient(prep)`)."""
        return Preprocessed(*(x.detach() if isinstance(x, torch.Tensor)
                              else x for x in self))


class Cotangents(NamedTuple):
    """Cotangents of the differentiable outputs; None is zero. Any strides."""

    mean2d: Optional[torch.Tensor]   # (N, 2)
    depth: Optional[torch.Tensor]    # (N,)
    conic: Optional[torch.Tensor]    # (N, 3)
    color: Optional[torch.Tensor]    # (N, 3)
    opacity: Optional[torch.Tensor]  # (N,)


class Grads(NamedTuple):
    """Gradients of the activated inputs, and of `mean2d_delta` (None where
    there is none)."""

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    mean2d_delta: Optional[torch.Tensor]


def sh_degree(gaussians: ActivatedGaussians,
              render_cfg: cfg.RenderConfig) -> int:
    """The SH degree evaluated: the config's, at most the scene's."""
    return min(render_cfg.sh_degree, gaussians.sh_degree)


def preprocess_torch(gaussians: ActivatedGaussians, camera: Camera,
                     render_cfg: cfg.RenderConfig,
                     mean2d_delta: torch.Tensor | None = None) -> Preprocessed:
    """The plain version, on any device. `mean2d_delta`: optional (N, 2) zero
    perturbation added to the screen positions; its gradient is the
    per-Gaussian screen-space positional gradient that drives
    densification."""
    view = camera.view
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)

    mean_view = projection.to_camera(gaussians.means, view)
    depth = mean_view[..., 2]
    mean2d, ndc = projection.project(
        gaussians.means, camera.full_projection(), camera.width,
        camera.height)
    if mean2d_delta is not None:
        mean2d = mean2d + mean2d_delta
    visible = projection.in_frustum(depth, ndc) & gaussians.mask

    cov6 = covariance.compute_cov3d(gaussians.scales, gaussians.quats)
    # Guard the EWA division by z for culled points.
    safe_view = torch.cat(
        [mean_view[..., :2], torch.where(visible, depth, 1.0)[..., None]],
        dim=-1)
    cov2d = covariance.compute_cov2d(
        safe_view, cov6, view[:3, :3], camera.focal_x, camera.focal_y,
        camera.tan_fov_x, camera.tan_fov_y)
    conic, cov_valid = covariance.conic(cov2d)
    visible = visible & cov_valid

    direction = gaussians.means - camera.position
    norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    direction = direction / (norm + 1e-12)
    color = sh_ops.eval_sh(gaussians.sh, direction,
                           sh_degree(gaussians, render_cfg))

    # Opacity-aware per-axis extent: the blend skips alpha < ALPHA_MIN, so
    # the support is the ellipse d^T Sigma^-1 d <= c with
    # c = 2 ln(opacity / ALPHA_MIN), capped at (3 sigma)^2, whose tight
    # axis-aligned bound is +-sqrt(c Sigma_xx) by +-sqrt(c Sigma_yy). The 2%
    # margin on the threshold keeps the dropped pixels provably below
    # ALPHA_MIN under float32 rounding. The extents reach only int32 values
    # (radius, rect): ceil(sqrt(0)) would give a NaN gradient in autograd.
    cfac = torch.clamp(
        2.0 * torch.log(gaussians.opacities / (0.98 * cfg.ALPHA_MIN)),
        0.0, cfg.GAUSSIAN_EXTENT_SIGMA ** 2)
    ext_x = torch.ceil(torch.sqrt(cfac * torch.clamp(cov2d[..., 0], min=0.0)))
    ext_y = torch.ceil(torch.sqrt(cfac * torch.clamp(cov2d[..., 2], min=0.0)))
    radius = torch.where(visible, torch.maximum(ext_x, ext_y),
                         0.0).to(torch.int32)
    rect = projection.tile_rect(
        mean2d, torch.where(visible, ext_x, 0.0),
        torch.where(visible, ext_y, 0.0), grid_h, grid_w,
        render_cfg.tile_h, render_cfg.tile_w)
    opacity = torch.where(visible, gaussians.opacities, 0.0)
    return Preprocessed(mean2d=mean2d, depth=depth, conic=conic, color=color,
                        opacity=opacity, radius=radius, rect=rect)


def preprocess_vjp_torch(inputs: ActivatedGaussians, camera: Camera,
                         render_cfg: cfg.RenderConfig, cotangents: Cotangents,
                         mean2d_delta: torch.Tensor | None = None) -> Grads:
    """The plain backward: `preprocess_torch` recomputed with grad on
    detached copies of the inputs, and `torch.autograd.grad` of its outputs
    against the cotangents. A group no cotangent reaches gets zeros."""
    with torch.enable_grad():
        leaves = {f: getattr(inputs, f).detach().requires_grad_()
                  for f in INPUT_FIELDS}
        delta = (None if mean2d_delta is None
                 else mean2d_delta.detach().requires_grad_())
        out = preprocess_torch(dataclasses.replace(inputs, **leaves), camera,
                               render_cfg, delta)
        wrt = [*leaves.values()] + ([] if delta is None else [delta])
        pairs = [(o, c) for o, c in zip(out[:5], cotangents) if c is not None]
        grads = (torch.autograd.grad([o for o, _ in pairs],
                                     wrt, [c for _, c in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(wrt))
    grads = [torch.zeros_like(w) if g is None else g
             for g, w in zip(grads, wrt)]
    return Grads(*grads[:5], grads[5] if delta is not None else None)


def _check_inputs(inputs: ActivatedGaussians, camera: DeviceCamera,
                  mean2d_delta=None, cuda: bool = True) -> dict:
    """The kernels' inputs checked (one device, CUDA where `cuda`, float32,
    the shapes of N Gaussians with K SH rows) and made contiguous (no copy
    where they are), by name; the mask as bytes."""
    n = inputs.means.shape[0]
    k = inputs.sh.shape[1] if inputs.sh.dim() == 3 else -1
    shapes = {"means": (n, 3), "scales": (n, 3), "quats": (n, 4),
              "opacities": (n,), "sh": (n, k, 3), "mask": (n,),
              "block": (CAMERA_FLOATS,)}
    tensors = {f: getattr(inputs, f) for f in shapes if f != "block"}
    tensors["block"] = camera.block
    if mean2d_delta is not None:
        tensors["mean2d_delta"], shapes["mean2d_delta"] = mean2d_delta, (n, 2)
    dev = inputs.means.device
    for name, x in tensors.items():
        dtype = torch.bool if name == "mask" else torch.float32
        if tuple(x.shape) != shapes[name] or x.dtype != dtype or (
                x.device != dev) or (cuda and dev.type != "cuda"):
            raise ValueError(
                f"the preprocess kernels need {name} {shapes[name]} {dtype} "
                f"on one {'CUDA ' if cuda else ''}device, got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
    if n >= 2**31:
        raise ValueError(f"{n} Gaussians exceed the kernels' int32 count")
    tensors = {name: x.contiguous() for name, x in tensors.items()}
    tensors["mask"] = tensors["mask"].view(torch.uint8)
    return tensors


def _constants():
    """The config's float constants as the kernels take them: the near
    depth, the NDC margin, the dilation, the reciprocal of the extent's
    opacity threshold 0.98 ALPHA_MIN (PyTorch's CUDA kernel multiplies by
    a host scalar divisor's float32 reciprocal), and the extent cap."""
    inv = np.float32(1.0) / np.float32(0.98 * cfg.ALPHA_MIN)
    return (cfg.NEAR_CULL_DEPTH, cfg.NDC_CULL_MARGIN, cfg.COV2D_DILATION,
            float(inv), cfg.GAUSSIAN_EXTENT_SIGMA ** 2)


def _stream(dev: torch.device, cuda: bool):
    """The device's current CUDA stream where `cuda`, else None."""
    return torch.cuda.current_stream(dev).cuda_stream if cuda else None


def forward_args(inputs: ActivatedGaussians, camera: DeviceCamera,
                 render_cfg: cfg.RenderConfig,
                 mean2d_delta: torch.Tensor | None = None,
                 cuda: bool = True) -> tuple:
    """The arguments of `gsrast_preprocess_forward` on checked inputs: on
    one CUDA device and its current stream where `cuda`, else on any
    device and no stream (a host build of the source). (args, a
    Preprocessed of empty outputs, the tensors the arguments point
    into)."""
    t = _check_inputs(inputs, camera, mean2d_delta, cuda)
    n, k = inputs.sh.shape[:2]
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    dev = inputs.means.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    rect = empty(4, n, dtype=torch.int32)
    out = Preprocessed(empty(n, 2), empty(n), empty(n, 3), empty(n, 3),
                       empty(n), empty(n, dtype=torch.int32),
                       projection.TileRect(*rect.unbind(0)))
    delta = t.get("mean2d_delta")
    args = (t["block"].data_ptr(), *(t[f].data_ptr() for f in INPUT_FIELDS),
            t["mask"].data_ptr(), None if delta is None else delta.data_ptr(),
            n, k, sh_degree(inputs, render_cfg), camera.width, camera.height,
            grid_h, grid_w, render_cfg.tile_h, render_cfg.tile_w,
            *_constants(), *(x.data_ptr() for x in out[:6]), rect.data_ptr(),
            _stream(dev, cuda))
    return args, out, dict(t, rect=rect)


def forward_launch(inputs: ActivatedGaussians, camera: DeviceCamera,
                   render_cfg: cfg.RenderConfig,
                   mean2d_delta: torch.Tensor | None = None) -> _kernels.Launch:
    """The forward kernel's launch on checked inputs; `out` is a
    Preprocessed of empty outputs."""
    args, out, held = forward_args(inputs, camera, render_cfg, mean2d_delta)
    return _kernels.Launch(_kernels.load().lib.gsrast_preprocess_forward,
                           args, out, held, inputs.means.device)


def _cotangent_args(cotangents: Cotangents, n: int, dev) -> list:
    """Per cotangent its pointer (None where absent) and its strides, two
    for (N, k) and one for (N,), as csrc/preprocess.cu takes them."""
    args = []
    for name, cols in zip(Cotangents._fields, (2, 1, 3, 3, 1)):
        x = getattr(cotangents, name)
        shape = (n,) if cols == 1 else (n, cols)
        if x is not None and (tuple(x.shape) != shape or (
                x.dtype != torch.float32) or x.device != dev):
            raise ValueError(f"the {name} cotangent must be {shape} float32 "
                             f"on {dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        strides = (0,) * len(shape) if x is None else x.stride()
        args += [None if x is None else x.data_ptr(), *strides]
    return args


def backward_args(inputs: ActivatedGaussians, camera: DeviceCamera,
                  render_cfg: cfg.RenderConfig, cotangents: Cotangents,
                  cuda: bool = True) -> tuple:
    """The arguments of `gsrast_preprocess_backward` on checked inputs and
    the cotangents with their strides (no copy), as `forward_args` takes
    the device and stream: (args, the empty gradients by field, the tensors
    the arguments point into)."""
    t = _check_inputs(inputs, camera, cuda=cuda)
    n, k = inputs.sh.shape[:2]
    dev = inputs.means.device
    grads = {f: torch.empty_like(t[f]) for f in INPUT_FIELDS}
    near, margin, dilation, _, _ = _constants()
    args = (t["block"].data_ptr(), t["means"].data_ptr(),
            t["scales"].data_ptr(), t["quats"].data_ptr(), t["sh"].data_ptr(),
            t["mask"].data_ptr(), n, k, sh_degree(inputs, render_cfg),
            camera.width, camera.height, near, margin, dilation,
            *_cotangent_args(cotangents, n, dev),
            *(grads[f].data_ptr() for f in INPUT_FIELDS), _stream(dev, cuda))
    return args, grads, dict(t, cotangents=cotangents)


def backward_launch(inputs: ActivatedGaussians, camera: DeviceCamera,
                    render_cfg: cfg.RenderConfig,
                    cotangents: Cotangents) -> _kernels.Launch:
    """The backward kernel's launch on checked inputs and the cotangents
    with their strides (no copy); `out` holds the empty gradients by
    field."""
    args, grads, held = backward_args(inputs, camera, render_cfg, cotangents)
    return _kernels.Launch(_kernels.load().lib.gsrast_preprocess_backward,
                           args, grads, held, inputs.means.device)


def preprocess_forward_cuda(inputs: ActivatedGaussians, camera: DeviceCamera,
                            render_cfg: cfg.RenderConfig,
                            mean2d_delta: torch.Tensor | None = None
                            ) -> Preprocessed:
    """The hand-written forward kernel (`csrc/preprocess.cu`) on CUDA
    tensors: `preprocess_torch`'s outputs for every Gaussian, culled ones
    included. Runs on the current stream without synchronising."""
    launch = forward_launch(inputs, camera, render_cfg, mean2d_delta)
    _kernels.run(launch, "preprocess_forward")
    return launch.out


def preprocess_backward_cuda(inputs: ActivatedGaussians, camera: DeviceCamera,
                             render_cfg: cfg.RenderConfig,
                             cotangents: Cotangents,
                             mean2d_delta: torch.Tensor | None = None
                             ) -> Grads:
    """The hand-written backward kernel (`csrc/preprocess.cu`) on CUDA
    tensors: `preprocess_vjp_torch`'s gradients, each written once, with
    no atomics (two launches give the same bits), from the inputs and the
    cotangents with their strides. `mean2d_delta`'s gradient is the mean2d
    cotangent. Runs on the current stream without synchronising."""
    launch = backward_launch(inputs, camera, render_cfg, cotangents)
    _kernels.run(launch, "preprocess_backward")
    d_delta = None
    if mean2d_delta is not None:
        d_delta = (torch.zeros_like(mean2d_delta) if cotangents.mean2d is None
                   else cotangents.mean2d)
    return Grads(*(launch.out[f] for f in INPUT_FIELDS), d_delta)


class PreprocessPair(NamedTuple):
    """A forward and its backward, with the camera form both take."""

    camera: Callable    # Camera -> the camera the two take
    forward: Callable   # (inputs, camera, cfg, mean2d_delta) -> Preprocessed
    backward: Callable  # (inputs, camera, cfg, Cotangents, mean2d_delta)
    #                     -> Grads


PREPROCESS_CUDA = PreprocessPair(device_camera, preprocess_forward_cuda,
                                 preprocess_backward_cuda)
PREPROCESS_TORCH = PreprocessPair(lambda camera: camera, preprocess_torch,
                                  preprocess_vjp_torch)


class PreprocessFunction(torch.autograd.Function):
    """The preprocess as one autograd node: (pair, camera, render_cfg,
    mean2d_delta, means, scales, quats, opacities, sh, mask) -> (mean2d,
    depth, conic, color, opacity, radius, x_min, y_min, x_max, y_max). The
    backward runs the pair's backward on the saved inputs (nothing else is
    kept); radius and rect are not differentiable; an output the loss does
    not reach hands the backward None (grads are not materialized). The
    camera gets no gradient: a camera tensor that requires one raises."""

    @staticmethod
    def forward(ctx, pair, camera, render_cfg, mean2d_delta, means, scales,
                quats, opacities, sh, mask):
        held = [name for name in CAMERA_TENSORS
                if getattr(camera, name).requires_grad]
        if held:
            raise ValueError(f"the preprocess gives the camera no gradient, "
                             f"but its {held} require grad")
        ctx.set_materialize_grads(False)
        cam = pair.camera(camera)
        inputs = ActivatedGaussians(means, scales, quats, opacities, sh, mask)
        out = pair.forward(inputs, cam, render_cfg, mean2d_delta)
        ctx.save_for_backward(means, scales, quats, opacities, sh, mask,
                              mean2d_delta)
        ctx.pair, ctx.camera, ctx.render_cfg = pair, cam, render_cfg
        ctx.mark_non_differentiable(out.radius, *out.rect)
        return (*out[:6], *out.rect)

    @staticmethod
    def backward(ctx, d_mean2d, d_depth, d_conic, d_color, d_opacity,
                 *_int_outputs):
        *saved, delta = ctx.saved_tensors
        grads = ctx.pair.backward(
            ActivatedGaussians(*saved), ctx.camera, ctx.render_cfg,
            Cotangents(d_mean2d, d_depth, d_conic, d_color, d_opacity), delta)
        need = ctx.needs_input_grad
        return (None, None, None, grads.mean2d_delta if need[3] else None,
                *(g if need[4 + i] else None for i, g in enumerate(grads[:5])),
                None)


def preprocess_pair(render_cfg: cfg.RenderConfig,
                    device: torch.device) -> Optional[PreprocessPair]:
    """The kernels (`PREPROCESS_CUDA`) where `_kernels.uses_kernel`; None,
    the plain version differentiated by autograd, otherwise."""
    if _kernels.uses_kernel(render_cfg.backend, device):
        return PREPROCESS_CUDA
    return None


def preprocess(gaussians: ActivatedGaussians, camera: Camera,
               render_cfg: cfg.RenderConfig,
               mean2d_delta: torch.Tensor | None = None) -> Preprocessed:
    """Per-Gaussian screen-space state of `gaussians` seen from `camera`:
    through `PreprocessFunction` with the pair `preprocess_pair` names, or
    `preprocess_torch` where it names none. A failed build or launch
    raises; nothing falls back to the plain version on CUDA tensors.
    `mean2d_delta`: see `preprocess_torch`."""
    pair = preprocess_pair(render_cfg, gaussians.means.device)
    if pair is None:
        return preprocess_torch(gaussians, camera, render_cfg, mean2d_delta)
    outs = PreprocessFunction.apply(
        pair, camera, render_cfg, mean2d_delta,
        *(getattr(gaussians, f) for f in INPUT_FIELDS), gaussians.mask)
    return Preprocessed(*outs[:6], projection.TileRect(*outs[6:]))
