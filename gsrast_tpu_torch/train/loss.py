"""Training losses: L1 + D-SSIM, the standard 3DGS objective, as the
reference (`gsrast_tpu/train/loss.py`) defines them.

SSIM uses the 11x11 sigma-1.5 Gaussian window as a depthwise convolution
with zero "same" padding. On a CUDA device a float32 convolution goes
through cuDNN in TF32 unless told otherwise, which keeps about three
decimal digits; the filter turns TF32 off for its own forward and backward
convolutions only and restores the flags afterwards. The window is built
once per device and kept: a host-to-device copy per call would stall the
step and is refused inside a CUDA graph capture.

`rgb_loss` has two versions, as the reference's is one computation that
XLA fuses into the train step:
  * `rgb_loss_torch`, the plain version in PyTorch ops, differentiated by
    autograd, with its VJP `rgb_loss_vjp_torch`;
  * the hand-written kernels of `csrc/loss.cu`, forward and backward
    (`loss_forward_cuda`, `loss_backward_cuda`; CUDA tensors only), the
    backward recomputing the forward's filtered maps.
`LossFunction` pairs a forward with its backward for autograd; `rgb_loss`
runs the kernels on CUDA tensors under backend 'cuda' and the plain
version everywhere else.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..camera import no_tf32


def _gaussian(size: int, sigma: float) -> np.ndarray:
    """The window's float64 1-D factor g, normalized."""
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


@functools.lru_cache()
def _gaussian_window(device: torch.device, size: int = 11,
                     sigma: float = 1.5) -> torch.Tensor:
    """The window on `device`, copied there once."""
    g = _gaussian(size, sigma)
    return torch.from_numpy(np.outer(g, g).astype(np.float32)).to(device)


@functools.lru_cache()
def _gaussian_taps(device: torch.device, size: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """float32(g), the kernels' separable taps, on `device`, copied there
    once: g_i g_j differs from the window's float32(outer(g, g)) by at most
    1.2 ulps a tap (1.18 at the largest)."""
    return torch.from_numpy(_gaussian(size, sigma).astype(np.float32)).to(
        device)


def _conv(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise "same" correlation of (1, C, H, W) with an odd window (in
    x's dtype: a float64 run takes the float32 window's values)."""
    c = x.shape[1]
    kernel = window.to(x.dtype).expand(c, 1, *window.shape)
    with no_tf32():
        return F.conv2d(x, kernel, padding=window.shape[-1] // 2, groups=c)


class _Filter(torch.autograd.Function):
    """The window filter with a backward that is the same filter: the
    adjoint of a zero-padded "same" correlation is the correlation with the
    flipped window, and the Gaussian window is symmetric. Writing it out
    keeps the backward convolution under the TF32 guard too, which autograd
    would run after the guard is gone."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(window)
        return _conv(x, window)

    @staticmethod
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        return _conv(grad.contiguous(), window), None


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter on (H, W, C) with zero "same" padding."""
    out = _Filter.apply(img.permute(2, 0, 1)[None].contiguous(), window)
    return out[0].permute(1, 2, 0)


def ssim(img0: torch.Tensor, img1: torch.Tensor, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair in [0, 1]."""
    window = _gaussian_window(img0.device)
    mu0 = _filter2d(img0, window)
    mu1 = _filter2d(img1, window)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _filter2d(img0 * img0, window) - mu00
    sigma11 = _filter2d(img1 * img1, window) - mu11
    sigma01 = _filter2d(img0 * img1, window) - mu01
    num = (2.0 * mu01 + c1) * (2.0 * sigma01 + c2)
    den = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(num / den)


def l1(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """mean |img0 - img1|, differentiated as the reference's `jax.grad` of
    `jnp.abs` is: 1 where img0 - img1 >= 0, -1 elsewhere (`torch.abs`
    would take 0 at a tie). The value is `torch.abs`'s, bit for bit."""
    d = img0 - img1
    return torch.mean(torch.where(d >= 0, d, -d))


def rgb_loss_torch(pred: torch.Tensor, target: torch.Tensor,
                   ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM): the 3DGS training objective, the plain
    version, on any device."""
    return (1.0 - ssim_weight) * l1(pred, target) + ssim_weight * (
        1.0 - ssim(pred, target))


def rgb_loss_vjp_torch(pred: torch.Tensor, target: torch.Tensor,
                       ssim_weight: float, grad: torch.Tensor
                       ) -> torch.Tensor:
    """The plain backward: `rgb_loss_torch` recomputed with grad on a
    detached copy of pred, and `torch.autograd.grad` of it against `grad`,
    the loss's cotangent. Returns d_pred."""
    with torch.enable_grad():
        p = pred.detach().requires_grad_()
        loss = rgb_loss_torch(p, target.detach(), ssim_weight)
        (d_pred,) = torch.autograd.grad(loss, p, grad)
    return d_pred


def _check_layout(x: torch.Tensor, name: str) -> tuple:
    """x's (H, W, C), checked: float32 and nonempty (the kernels take any
    strides: a crop's rows, the render's channel planes)."""
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(f"the loss kernels need pred and target of one "
                         f"(H, W, C) shape, float32; got {name} "
                         f"{tuple(x.shape)} {x.dtype}")
    h, w, c = x.shape
    if min(h, w, c) == 0:
        raise ValueError(f"the loss kernels take a nonempty image, got "
                         f"{name} {(h, w, c)}")
    return h, w, c


def _check_inputs(pred: torch.Tensor, target: torch.Tensor) -> tuple:
    """(height, width, channels) of the kernels' inputs, checked
    (`_check_layout`, one shape, one CUDA device)."""
    shape = _check_layout(pred, "pred")
    if _check_layout(target, "target") != shape:
        raise ValueError(f"the loss kernels need pred and target of one "
                         f"(H, W, C) shape, float32; got {shape} and "
                         f"{tuple(target.shape)}")
    if pred.device.type != "cuda" or target.device != pred.device:
        raise ValueError(f"the loss kernels need pred and target on one "
                         f"CUDA device, got {pred.device} and "
                         f"{target.device}")
    return shape


def forward_launch(pred: torch.Tensor, target: torch.Tensor,
                   ssim_weight: float) -> _kernels.Launch:
    """The forward kernel's launch on checked inputs; `out` is the 0-d
    float32 loss, written through per-block partial sums (`held`)."""
    h, w, c = _check_inputs(pred, target)
    dev = pred.device
    lib = _kernels.load().lib
    with torch.cuda.device(dev):  # the plan reads the current device
        count = lib.gsrast_loss_partials(h, w, c)
    if count <= 0:
        raise RuntimeError(f"the loss forward has no launch plan for "
                           f"{(h, w, c)} on {dev}")
    partials = torch.empty((count, 2), dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    taps = _gaussian_taps(dev)
    args = (pred.data_ptr(), *pred.stride(), target.data_ptr(),
            *target.stride(), h, w, c, taps.data_ptr(), ssim_weight,
            1.0 - ssim_weight, partials.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return _kernels.Launch(lib.gsrast_loss_forward, args, loss, dict(
        pred=pred, target=target, partials=partials), dev)


def backward_launch(pred: torch.Tensor, target: torch.Tensor,
                    ssim_weight: float, grad: torch.Tensor
                    ) -> _kernels.Launch:
    """The backward kernel's launch on checked inputs and the loss's
    cotangent `grad` (one float32 on the device, read there); `out` is the
    empty d_pred (H, W, C), laid out as pred where pred is dense (the
    render's channel planes), else contiguous."""
    h, w, c = _check_inputs(pred, target)
    dev = pred.device
    if (grad.numel() != 1 or grad.dtype != torch.float32
            or grad.device != dev):
        raise ValueError(f"the loss's cotangent must be one float32 on "
                         f"{dev}, got {tuple(grad.shape)} {grad.dtype} on "
                         f"{grad.device}")
    grad = grad.reshape(()).contiguous()
    n = h * w * c
    d_pred = torch.empty_like(pred)
    args = (pred.data_ptr(), *pred.stride(), target.data_ptr(),
            *target.stride(), h, w, c, _gaussian_taps(dev).data_ptr(),
            (1.0 - ssim_weight) / n, ssim_weight / n, grad.data_ptr(),
            d_pred.data_ptr(), *d_pred.stride(),
            torch.cuda.current_stream(dev).cuda_stream)
    return _kernels.Launch(_kernels.load().lib.gsrast_loss_backward, args,
                           d_pred, dict(pred=pred, target=target, grad=grad),
                           dev)


def loss_forward_cuda(pred: torch.Tensor, target: torch.Tensor,
                      ssim_weight: float = 0.2) -> torch.Tensor:
    """The hand-written forward (`csrc/loss.cu`) on CUDA tensors:
    `rgb_loss_torch`'s value as a 0-d float32 tensor, its partial sums
    summed in a fixed order (two launches give the same bits). Runs on the
    current stream without synchronising."""
    launch = forward_launch(pred, target, ssim_weight)
    _kernels.run(launch, "loss_forward")
    return launch.out


def loss_backward_cuda(pred: torch.Tensor, target: torch.Tensor,
                       ssim_weight: float, grad: torch.Tensor
                       ) -> torch.Tensor:
    """The hand-written backward (`csrc/loss.cu`) on CUDA tensors:
    `rgb_loss_vjp_torch`'s d_pred, every element written once with no
    atomics, the forward's filtered maps recomputed. Runs on the current
    stream without synchronising."""
    launch = backward_launch(pred, target, ssim_weight, grad)
    _kernels.run(launch, "loss_backward")
    return launch.out


class LossPair(NamedTuple):
    """A forward and its backward."""

    forward: Callable   # (pred, target, ssim_weight) -> 0-d loss
    backward: Callable  # (pred, target, ssim_weight, grad) -> d_pred


LOSS_CUDA = LossPair(loss_forward_cuda, loss_backward_cuda)
LOSS_TORCH = LossPair(rgb_loss_torch, rgb_loss_vjp_torch)


class LossFunction(torch.autograd.Function):
    """The loss as one autograd node: (pair, ssim_weight, pred, target) ->
    the 0-d loss. The backward runs the pair's backward on the saved
    inputs. The target gets no gradient (training never differentiates
    it): a target that requires grad raises."""

    @staticmethod
    def forward(ctx, pair, ssim_weight, pred, target):
        if target.requires_grad:
            raise ValueError("the loss's Function gives the target no "
                             "gradient, but it requires grad")
        ctx.save_for_backward(pred, target)
        ctx.pair, ctx.ssim_weight = pair, ssim_weight
        return pair.forward(pred, target, ssim_weight)

    @staticmethod
    def backward(ctx, grad):
        pred, target = ctx.saved_tensors
        return None, None, ctx.pair.backward(pred, target, ctx.ssim_weight,
                                             grad), None


def loss_pair(backend: str, device: torch.device) -> Optional[LossPair]:
    """The kernels (`LOSS_CUDA`) where `_kernels.uses_kernel`; None, the
    plain version differentiated by autograd, otherwise."""
    if _kernels.uses_kernel(backend, device):
        return LOSS_CUDA
    return None


def rgb_loss(pred: torch.Tensor, target: torch.Tensor,
             ssim_weight: float = 0.2, *, backend: str = "cuda"
             ) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM): the 3DGS training objective, through
    `LossFunction` with the pair `loss_pair` names, or `rgb_loss_torch`
    (which differentiates both inputs) where it names none. A failed build
    or launch raises; nothing falls back to the plain version on CUDA
    tensors."""
    pair = loss_pair(backend, pred.device)
    if pair is None:
        return rgb_loss_torch(pred, target, ssim_weight)
    return LossFunction.apply(pair, ssim_weight, pred, target)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
