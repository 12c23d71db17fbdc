"""The optimizer kernel's CUDA source (`csrc/adam.cu`) run on the CPU:
compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (each block's threads real threads at a barrier, blocks
one after another, the _rn intrinsics plain float operations built without
contraction), its C entry point called through ctypes with the wrapper's
table (`adam.kernel_args`), and held to the plain version
(`adam_update_torch`) on the same CPU tensors bit for bit: both round each
operation alone, take the same powf for the bias corrections and a
correctly rounded square root. Groups of SH degree 0, 1 and 3, capacities
whose float counts leave ragged chunks of 1 to 3 floats, groups whose
arrays are not 16-byte aligned, the rate from the table or from memory,
and zero and subnormal moments and gradients (the operands the kernel
keeps on its division's and square root's fast path). The launch adds one
to each count itself (its last block, by a ticket that wraps back to 0):
updates in a row on grids of one block and of many."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.train import adam

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "adam.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
REST_SCALE = 1.0 / 20.0

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`adam.cu` built for the host: each launch rewritten to the shim's
    `launch(grid, block, kernel, ...)`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("adam_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    src += ('extern "C" void host_set_multiprocessors(int n) '
            '{ host_multiprocessors = n; }\n')
    cpp, so = out / "adam_host.cpp", out / "libadam_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    dll.gsrast_adam_update.argtypes = [ctypes.c_int, *[vp] * 5,
                                       ctypes.c_float, vp, vp]
    dll.gsrast_adam_update.restype = ctypes.c_int
    dll.gsrast_adam_occupancy.argtypes = [vp] * 5
    dll.gsrast_adam_occupancy.restype = ctypes.c_int
    dll.host_set_multiprocessors.argtypes = [ctypes.c_int]
    return dll


def _groups(degree, capacity, live, offset=0, lr_tensor=False, seed=0):
    """The five groups of a scene of `capacity` slots (`live` live), with
    drawn parameters, gradients and moments (dead slots' too) and count 4;
    every array `offset` floats into its storage; the means' rate a 0-d
    tensor where `lr_tensor`."""
    rng = np.random.default_rng(seed)
    k = (degree + 1) ** 2
    shapes = {"means": (capacity, 3), "log_scales": (capacity, 3),
              "quats": (capacity, 4), "opacity_logits": (capacity,),
              "sh": (capacity, k, 3)}

    def draw(shape, scale=1.0, positive=False):
        n = int(np.prod(shape))
        x = (rng.uniform(0.0, 1.0, n + offset) if positive
             else rng.standard_normal(n + offset))
        return torch.from_numpy((scale * x).astype(np.float32))[
            offset:].view(shape)

    groups = []
    for name, shape in shapes.items():
        row = int(np.prod(shape[1:]))
        lr = 2.5e-3
        if name == "means":
            lr = torch.tensor(1.6e-4) if lr_tensor else 1.6e-4
        groups.append(adam.Group(
            name, draw(shape), draw(shape), draw(shape, 0.1),
            draw(shape, 1e-3, True), torch.tensor(4.0), lr, (0.9, 0.999),
            1e-15, row, 3 if name == "sh" else row))
    mask = torch.zeros(capacity, dtype=torch.bool)
    mask[torch.from_numpy(rng.permutation(capacity)[:live])] = True
    return groups, mask


def _clone(groups):
    return [g._replace(**{f: getattr(g, f).clone() for f in (
        "param", "exp_avg", "exp_avg_sq", "step")}) for g in groups]


def _check(dll, degree, capacity, offset, lr_tensor):
    groups, live = _groups(degree, capacity, max(1, capacity * 3 // 4),
                           offset, lr_tensor, seed=capacity + degree)
    grads = [g.grad.clone() for g in groups]
    plain, kernel = _clone(groups), _clone(groups)
    adam.adam_update_torch(plain, live, REST_SCALE)
    assert dll.gsrast_adam_update(
        *adam.kernel_args(kernel, live, REST_SCALE, None)) == 0
    for p, q in zip(plain, kernel):
        for f in ("param", "exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(getattr(q, f), getattr(p, f)), (p.name, f)
    assert all(torch.equal(g.grad, x) for g, x in zip(groups, grads))
    assert float(kernel[0].step) == 5.0


@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("degree,capacity", [
    (0, 1), (1, 3), (3, 3), (3, 37), (0, 1_025), (1, 1_025)])
def test_source_matches_plain(lib, degree, capacity, offset, lr_tensor):
    _check(lib, degree, capacity, offset, lr_tensor)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("degree,capacity", [(0, 1), (3, 3), (1, 1_025),
                                             (3, 4_099)])
def test_source_updates_in_a_row(lib, degree, capacity, sms):
    """Three updates in a row, the kernel's and the plain version's from
    the same state, with fresh gradients each time: after each, every
    output bit-equal, each count one more (4 to 5, 6, 7) and the ticket
    back at 0. A thread a chunk would take one block of 256 chunks for
    one and three Gaussians and 24 and 237 blocks for the others; on a
    host card of one SM (32 blocks at once) the grid is capped at a wave,
    and the 237 blocks' chunks are walked by 32."""
    lib.host_set_multiprocessors(sms)
    groups, live = _groups(degree, capacity, max(1, capacity // 2),
                           seed=7 + capacity)
    plain, kernel = _clone(groups), _clone(groups)
    ticket = _kernels.device_counters("adam", live.device)
    rng = np.random.default_rng(capacity)
    for k in range(3):
        grads = [torch.from_numpy(rng.standard_normal(g.grad.shape)
                                  .astype(np.float32)) for g in groups]
        plain = [g._replace(grad=x) for g, x in zip(plain, grads)]
        kernel = [g._replace(grad=x) for g, x in zip(kernel, grads)]
        adam.adam_update_torch(plain, live, REST_SCALE)
        assert lib.gsrast_adam_update(
            *adam.kernel_args(kernel, live, REST_SCALE, None)) == 0
        for p, q in zip(plain, kernel):
            for f in ("param", "exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(getattr(q, f), getattr(p, f)), (
                    k, p.name, f)
        assert [float(g.step) for g in kernel] == [5.0 + k] * len(kernel)
        assert int(ticket) == 0
    lib.host_set_multiprocessors(132)


def test_source_needs_a_ticket(lib):
    """The entry point refuses a null ticket before any launch."""
    groups, live = _groups(1, 3, 2)
    args = list(adam.kernel_args(groups, live, REST_SCALE, None))
    args[-2] = None
    assert lib.gsrast_adam_update(*args) != 0
    assert float(groups[0].step) == 4.0


def test_source_matches_plain_at_zeros_and_subnormals(lib):
    """The kernel's shortcuts for zero and subnormal operands of its
    divisions and square root (`div_pos`, `sqrt_nonneg`) give the IEEE
    bits: moments zero (a Gaussian no pixel reached), subnormal, and
    gradients whose squares are subnormal or underflow to zero."""
    groups, live = _groups(3, 301, 250, seed=11)
    rng = np.random.default_rng(12)
    for g in groups:
        for t in (g.grad, g.exp_avg, g.exp_avg_sq):
            flat = t.view(-1)
            pick = torch.from_numpy(rng.integers(0, 4, flat.numel()))
            flat[pick == 0] = 0.0
            tiny = torch.from_numpy(rng.uniform(1e-45, 1e-38, flat.numel())
                                    .astype(np.float32))
            flat[pick == 1] = tiny[pick == 1] * (1 if t is not g.grad
                                                 else 1e-2)
        g.exp_avg_sq.abs_()
    plain, kernel = _clone(groups), _clone(groups)
    adam.adam_update_torch(plain, live, REST_SCALE)
    assert lib.gsrast_adam_update(
        *adam.kernel_args(kernel, live, REST_SCALE, None)) == 0
    for p, q in zip(plain, kernel):
        for f in ("param", "exp_avg", "exp_avg_sq"):
            assert torch.equal(getattr(q, f), getattr(p, f)), (p.name, f)
    v = torch.cat([g.exp_avg_sq.view(-1) for g in kernel])
    assert bool((v == 0).any()) and bool(((v > 0) & (v < 1.2e-38)).any())


def test_source_refuses_a_bad_table(lib):
    """No group, too many, or a row of width 0 with elements: the entry
    point returns an error before any launch."""
    groups, live = _groups(1, 3, 2)
    args = list(adam.kernel_args(groups, live, REST_SCALE, None))
    for n in (0, adam.MAX_GROUPS + 1):
        assert lib.gsrast_adam_update(n, *args[1:]) != 0
    bad = groups[:1] + [groups[1]._replace(row=0)]
    assert lib.gsrast_adam_update(
        *adam.kernel_args(bad, live, REST_SCALE, None)) != 0


def test_source_reports_its_launch(lib):
    vals = [ctypes.c_int(-1) for _ in range(5)]
    assert lib.gsrast_adam_occupancy(*(ctypes.byref(v) for v in vals)) == 0
    assert vals[0].value == 256
