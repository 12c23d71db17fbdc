"""The loss kernels' CUDA source (`csrc/loss.cu`) run on the CPU: compiled
by g++ against the host stand-in of the CUDA runtime in `tests/cuda_host/`
(each block's threads real threads at a barrier, `cp.async` a plain copy,
blocks one after another), its C entry points called through ctypes with
the wrappers' arguments, and held to the plain version run in float64 as
`chip_smoke.compare_loss` holds the kernels on the card: the loss within
max(1e-6, 2 |plain32 - plain64|), d_pred within max(1e-5 max |g64|, 2
max |g32 - g64|), everywhere and at the ties alone. Shapes ragged against
the strips and smaller than the window, both layouts (a crop's rows, the
render's channel planes), and the host "card" with 132 SMs (short segments)
and one (long segments of many 11-row steps)."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsrast_tpu_torch.train import loss as L

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "loss.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
WEIGHT = 0.2

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`loss.cu` built for the host: each launch rewritten to the shim's
    `launch(grid, block, kernel, ...)`, the dynamic shared memory a host
    array, and a setter of the host card's SM count."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("loss_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    src = src.replace("extern __shared__ float4 loss_shared[];",
                      "alignas(16) float4 loss_shared[kHostSharedPerSm / 16];")
    src += ('\nextern "C" void host_set_multiprocessors(int n) '
            '{ host_multiprocessors = n; }\n')
    cpp, so = out / "loss_host.cpp", out / "libloss_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    dll.gsrast_loss_partials.argtypes = [i32] * 3
    dll.gsrast_loss_forward.argtypes = [vp, *[i64] * 3, vp, *[i64] * 3,
                                        *[i32] * 3, vp, f32, f32, vp, vp, vp]
    dll.gsrast_loss_backward.argtypes = [vp, *[i64] * 3, vp, *[i64] * 3,
                                         *[i32] * 3, vp, f32, f32, vp, vp,
                                         *[i64] * 3, vp]
    dll.gsrast_loss_occupancy.argtypes = [*[i32] * 4, *[vp] * 8]
    dll.host_set_multiprocessors.argtypes = [i32]
    return dll


def _pair(shape, layout):
    """A seeded (pred, target) in [0, 1], a third of the rows tied; pred
    laid out as `layout`: "rows", rows 5 pixels longer than W (a crop);
    "planar", channel planes seen as (H, W, C) (the render's image)."""
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0.0, 1.0)
    b = b.astype(np.float32)
    b[: shape[0] // 3] = a[: shape[0] // 3]
    h, w, c = shape
    if layout == "planar":
        pred = torch.from_numpy(a).permute(2, 0, 1).contiguous()
        pred = pred.permute(1, 2, 0)
    else:
        pred = torch.zeros((h, w + 5, c))[:, :w]
        pred.copy_(torch.from_numpy(a))
    return pred, torch.from_numpy(b)


def _run(lib, pred, target):
    """The kernels' loss and d_pred (cotangent 1), as the wrappers launch
    them; d_pred starts as NaN so that an element never written shows."""
    h, w, c = pred.shape
    n = h * w * c
    partials = torch.empty((lib.gsrast_loss_partials(h, w, c), 2),
                           dtype=torch.float64)
    loss = torch.empty((), dtype=torch.float32)
    taps = L._gaussian_taps(torch.device("cpu"))
    assert lib.gsrast_loss_forward(
        pred.data_ptr(), *pred.stride(), target.data_ptr(), *target.stride(),
        h, w, c, taps.data_ptr(), WEIGHT, 1.0 - WEIGHT, partials.data_ptr(),
        loss.data_ptr(), None) == 0
    d_pred = torch.full_like(pred, float("nan"))
    one = torch.ones(())
    assert lib.gsrast_loss_backward(
        pred.data_ptr(), *pred.stride(), target.data_ptr(), *target.stride(),
        h, w, c, taps.data_ptr(), (1.0 - WEIGHT) / n, WEIGHT / n,
        one.data_ptr(), d_pred.data_ptr(), *d_pred.stride(), None) == 0
    return loss, d_pred


@pytest.mark.parametrize("multiprocessors", [132, 1])
@pytest.mark.parametrize("shape,layout", [
    ((37, 53, 3), "rows"), ((37, 53, 3), "planar"), ((5, 7, 3), "rows"),
    ((140, 260, 3), "rows"), ((61, 129, 1), "planar")])
def test_source_matches_plain(lib, shape, layout, multiprocessors):
    lib.host_set_multiprocessors(multiprocessors)
    pred, target = _pair(shape, layout)
    loss, d_pred = _run(lib, pred, target)
    one = torch.ones(())
    p32 = (L.rgb_loss_torch(pred, target, WEIGHT),
           L.rgb_loss_vjp_torch(pred, target, WEIGHT, one))
    x, y = pred.double(), target.double()
    p64 = (L.rgb_loss_torch(x, y, WEIGHT),
           L.rgb_loss_vjp_torch(x, y, WEIGHT, one.double()))
    loss_tol = max(1e-6, 2.0 * abs(float(p32[0]) - float(p64[0])))
    assert abs(float(loss) - float(p64[0])) <= loss_tol
    gap = (d_pred.double() - p64[1]).abs()
    grad_tol = max(1e-5 * float(p64[1].abs().max()),
                   2.0 * float((p32[1].double() - p64[1]).abs().max()))
    ties = pred == target
    assert ties.any() and bool(torch.isfinite(d_pred).all())
    assert float(gap.max()) <= grad_tol
    assert float(gap[ties].max()) <= grad_tol


def test_source_plans_fill_the_card(lib):
    """`plan()` on a card of 132 SMs that holds 4 forward and 3 backward
    blocks an SM (by shared memory): at 1080p one wave of 495 forward
    blocks of 100 rows (10 steps of 11 rows, less the halo) and 357
    backward blocks of 156 rows; at 512x512 516 forward blocks of 12 rows
    and 330 backward ones of 24; and the forward's partial sums one a
    block."""
    lib.host_set_multiprocessors(132)
    keys = ("threads", "dynamic_shared", "blocks_per_sm", "blocks",
            "segment_rows")

    def occupancy(backward, h, w, c):
        out = [ctypes.c_int(0) for _ in range(8)]
        assert lib.gsrast_loss_occupancy(backward, h, w, c, *(
            ctypes.byref(x) for x in out)) == 0
        return dict(zip(keys, (x.value for x in out)))

    assert occupancy(0, 1080, 1920, 3) == {
        "threads": 128, "dynamic_shared": 52800, "blocks_per_sm": 4,
        "blocks": 495, "segment_rows": 100}
    assert occupancy(1, 1080, 1920, 3) == {
        "threads": 128, "dynamic_shared": 70224, "blocks_per_sm": 3,
        "blocks": 357, "segment_rows": 156}
    assert occupancy(0, 512, 512, 3)["blocks"] == 516
    assert occupancy(1, 512, 512, 3)["segment_rows"] == 24
    for shape in ((1080, 1920, 3), (512, 512, 3), (5, 7, 3)):
        assert lib.gsrast_loss_partials(*shape) == occupancy(0, *shape)[
            "blocks"]
