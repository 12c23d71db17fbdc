"""The optimizer half of the train step: the SH rest-band scale, the live
mask and Adam over the five parameter groups, as one computation.

The reference (`gsrast_tpu/train/trainer.py`) scales the SH rest bands'
gradient by 1 / lr_sh_rest_div (`_scale_sh_rest`, `:80-86, 113`), masks
every gradient by the live mask (`:115-118`) and applies one `optax.adam`
per group under `optax.multi_transform` (`make_optimizer`, `:52-77`;
`:119-120`), all inside its jitted step, where XLA fuses them into passes
over the parameters. Here the same update has two versions:
  * `adam_update_torch`, the plain version in torch ops, on any device;
  * the hand-written kernel of `csrc/adam.cu` (`adam_update_cuda`, CUDA
    tensors only): one launch over all five groups that reads each
    gradient, parameter and moment once, writes each output once and adds
    one to each count.

Both take optax's order, in float32, each operation rounded alone:
  g' = g * (1 / rest_div) on SH bands 1..K-1 only, then g' *= live;
  m = (1 - b1) g' + b1 m;  v = (1 - b2) g'^2 + b2 v;  count += 1;
  u = (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps);
  p = p + (-lr) u.
Dead slots take the same arithmetic (their gradient is 0 after the mask,
and moment surgery has zeroed their moments), so they stay frozen as in
the reference. The gradients are read, never written.

The state is `torch.optim.Adam`'s: `optimizer.state[param]` holds `step`
(the update count, a 0-d float32 tensor on the parameter's device where
Adam is capturable), `exp_avg` and `exp_avg_sq`; `optimizer.param_groups`
hold each group's `name`, `lr`, `betas` and `eps`. Checkpoints, moment
surgery and the resilience checks read and write it there. `update` runs
the kernel for CUDA tensors under backend 'cuda' and the plain version for
every other device and backend (the 'torch', 'autograd' and 'dense'
oracles), the rule of `loss.loss_pair`; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Union

import torch

from .. import _kernels

# The group whose rows hold SH bands: its bands past the first (DC) take
# the rest-band scale.
REST_GROUP = "sh"
# The kernel's table (csrc/adam.cu): at most MAX_GROUPS groups, each with
# TENSORS pointers and SCALARS floats.
MAX_GROUPS = 8
TENSORS = 6
SCALARS = 6


class Group(NamedTuple):
    """One parameter group's tensors and settings for an update."""

    name: str
    param: torch.Tensor
    grad: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    step: torch.Tensor       # the update count so far, 0-d float32
    lr: Union[float, torch.Tensor]  # a 0-d float32 tensor where it is
    #                                 recomputed on the device each step
    betas: tuple
    eps: float
    row: int   # elements a row (a Gaussian)
    rest: int  # the row's first rest-band element; `row` where it has none


def make_state(optimizer: torch.optim.Adam) -> None:
    """Adam's state where the optimizer has not stepped yet, made as its
    lazy initialization makes it: a zero count (on the device where Adam
    is capturable) and zero moments. Groups that have state keep it."""
    for group in optimizer.param_groups:
        (param,) = group["params"]
        st = optimizer.state[param]
        if not st:
            st["step"] = torch.zeros(
                (), device=param.device if group["capturable"] else "cpu")
            st["exp_avg"] = torch.zeros_like(
                param, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                param, memory_format=torch.preserve_format)


def groups_of(optimizer: torch.optim.Adam,
              rest_group: str = REST_GROUP) -> list:
    """The optimizer's groups (one parameter each, with state and a
    gradient) as `Group`s, in order."""
    out = []
    for group in optimizer.param_groups:
        (param,) = group["params"]
        if param.grad is None:
            raise ValueError(f"group {group['name']!r} has no gradient")
        st = optimizer.state[param]
        row = math.prod(param.shape[1:])
        rest = (param.shape[2] if group["name"] == rest_group
                and param.dim() == 3 else row)
        out.append(Group(group["name"], param, param.grad, st["exp_avg"],
                         st["exp_avg_sq"], st["step"], group["lr"],
                         tuple(group["betas"]), group["eps"], row, rest))
    return out


def _live(live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return live.float().reshape((-1,) + (1,) * (x.dim() - 1))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root, correctly rounded (IEEE's, as XLA's and
    the kernel's are): taken in float64 and rounded once, which for a
    square root gives the same float. PyTorch's vectorized float32 sqrt on
    the CPU is an ulp off at some inputs."""
    return x.double().sqrt().float()


def adam_update_torch(groups: Sequence[Group], live: torch.Tensor,
                      rest_scale: float) -> None:
    """The plain version, in torch ops on any device: updates each group's
    parameter, moments and count in place, in optax's order (module
    docstring). Every division is by a tensor, never by a host scalar (a
    CUDA division by one multiplies by its reciprocal)."""
    with torch.no_grad():
        for gr in groups:
            b1, b2 = gr.betas
            g = gr.grad
            if gr.rest < gr.row:
                g = g.clone()
                g.view(g.shape[0], gr.row)[:, gr.rest:] *= rest_scale
            g = g * _live(live, g)
            m = g.mul(1.0 - b1).add(gr.exp_avg.mul(b1))
            v = g.mul(g).mul(1.0 - b2).add(gr.exp_avg_sq.mul(b2))
            count = gr.step.add(1.0)
            bc1 = torch.pow(b1, count).neg().add(1.0)
            bc2 = torch.pow(b2, count).neg().add(1.0)
            u = m.div(bc1).div(_sqrt(v.div(bc2)).add(gr.eps))
            neg_lr = (-gr.lr if not torch.is_tensor(gr.lr)
                      else gr.lr.neg())
            gr.param.add_(u.mul(neg_lr))
            gr.exp_avg.copy_(m)
            gr.exp_avg_sq.copy_(v)
            gr.step.copy_(count)


def _check(groups: Sequence[Group], live: torch.Tensor) -> torch.device:
    """The kernel's inputs, checked: float32, contiguous, each group's
    gradient and moments of its parameter's shape, rows of the mask's
    length, everything on one CUDA device. Returns the device."""
    dev = live.device
    if dev.type != "cuda":
        raise ValueError(f"the adam kernel needs CUDA tensors, got the mask "
                         f"on {dev}")
    if live.dtype != torch.bool or live.dim() != 1 or (
            not live.is_contiguous()):
        raise ValueError(f"the adam kernel needs a contiguous (N,) bool "
                         f"mask, got {tuple(live.shape)} {live.dtype}")
    if not 0 < len(groups) <= MAX_GROUPS:
        raise ValueError(f"the adam kernel takes 1 to {MAX_GROUPS} groups, "
                         f"got {len(groups)}")
    for gr in groups:
        arrays = (gr.param, gr.grad, gr.exp_avg, gr.exp_avg_sq)
        for name, t in zip(("param", "grad", "exp_avg", "exp_avg_sq"),
                           arrays):
            if (t.device != dev or t.dtype != torch.float32
                    or not t.is_contiguous() or t.shape != gr.param.shape
                    or t.dim() == 0 or t.shape[0] != live.shape[0]):
                raise ValueError(
                    f"the adam kernel needs group {gr.name!r}'s {name} "
                    f"contiguous float32 of shape (N, ...) = "
                    f"{tuple(gr.param.shape)} on {dev} with N = "
                    f"{live.shape[0]}, got {tuple(t.shape)} {t.dtype} on "
                    f"{t.device}")
        for name, t in (("step", gr.step), ("lr", gr.lr)):
            if torch.is_tensor(t) and (t.device != dev or t.numel() != 1
                                       or t.dtype != torch.float32):
                raise ValueError(f"the adam kernel needs group {gr.name!r}'s "
                                 f"{name} one float32 on {dev}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return dev


def kernel_args(groups: Sequence[Group], live: torch.Tensor,
                rest_scale: float, stream) -> tuple:
    """`gsrast_adam_update`'s arguments: the group count, a table of each
    group's pointers (parameter, gradient, moments, count, and its rate
    where that is a device tensor), floats (rate, b1, b2, 1 - b1, 1 - b2,
    eps), element count and row shape (width, first rest-band element),
    the mask, the rest-band scale, the mask's device's ticket (its
    `_kernels.device_counters`, which the update's last block takes back
    to zero: its count of the blocks that have read the counts) and the
    stream."""
    n = len(groups)
    tensors = (ctypes.c_void_p * (TENSORS * n))(*[
        t for gr in groups for t in (
            gr.param.data_ptr(), gr.grad.data_ptr(), gr.exp_avg.data_ptr(),
            gr.exp_avg_sq.data_ptr(), gr.step.data_ptr(),
            gr.lr.data_ptr() if torch.is_tensor(gr.lr) else None)])
    scalars = (ctypes.c_float * (SCALARS * n))(*[
        x for gr in groups for x in (
            0.0 if torch.is_tensor(gr.lr) else gr.lr, gr.betas[0],
            gr.betas[1], 1.0 - gr.betas[0], 1.0 - gr.betas[1], gr.eps)])
    numels = (ctypes.c_longlong * n)(*[gr.param.numel() for gr in groups])
    rows = (ctypes.c_int * (2 * n))(*[x for gr in groups
                                      for x in (gr.row, gr.rest)])
    return (n, tensors, scalars, numels, rows, live.data_ptr(), rest_scale,
            _kernels.device_counters("adam", live.device).data_ptr(), stream)


def update_launch(groups: Sequence[Group], live: torch.Tensor,
                  rest_scale: float) -> _kernels.Launch:
    """The kernel's launch on checked inputs (`kernel_args`). Each launch
    updates the groups in place and adds one to their counts."""
    dev = _check(groups, live)
    args = kernel_args(groups, live, rest_scale,
                       torch.cuda.current_stream(dev).cuda_stream)
    return _kernels.Launch(_kernels.load().lib.gsrast_adam_update, args,
                           None, dict(groups=tuple(groups), live=live), dev)


def adam_update_cuda(groups: Sequence[Group], live: torch.Tensor,
                     rest_scale: float) -> None:
    """The hand-written kernel (`csrc/adam.cu`) on CUDA tensors:
    `adam_update_torch`'s update, bit for bit, counts included, in one
    launch over all the groups. Runs on the current stream without
    synchronising, allocates nothing (after the device's first update
    made its ticket) and reads no count on the host, so a CUDA graph
    captures it."""
    _kernels.run(update_launch(groups, live, rest_scale), "adam")


def update(optimizer: torch.optim.Adam, live: torch.Tensor,
           rest_scale: float, backend: str = "cuda") -> None:
    """One update of every group of `optimizer` from its parameters'
    `.grad` (module docstring): the kernel where `_kernels.uses_kernel`,
    the plain version otherwise. Makes Adam's state first where it has
    none (`make_state`)."""
    make_state(optimizer)
    groups = groups_of(optimizer)
    if _kernels.uses_kernel(backend, live.device):
        adam_update_cuda(groups, live, rest_scale)
    else:
        adam_update_torch(groups, live, rest_scale)
