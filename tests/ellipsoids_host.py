"""The ellipsoid kernel's CUDA source (`csrc/ellipsoids.cu`) built for the
CPU, for the tests: compiled by g++ against the host stand-in of the CUDA
runtime in `tests/cuda_host/` (each block's threads real threads at a
barrier, each warp's at one of its own, blocks one after another, the _rn
intrinsics plain float operations built without contraction, shared and
global atomics real atomics), each launch rewritten to the stand-in's
`launch(grid, block, kernel, ...)`, the dynamic shared memory a host
array, and a setter of the host card's SM count. Its entry points take the
wrapper's own arguments (`viz/ellipsoids.py::frame_args`) on CPU
tensors."""

import ctypes
import os
import re
import subprocess

import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.viz import ellipsoids as E
from gsrast_tpu_torch.viz.pointcloud import background_row

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "ellipsoids.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
SHARED = "extern __shared__ float4 ellipsoid_shared[];"


def build(out_dir, edits=()) -> ctypes.CDLL:
    """`ellipsoids.cu` built for the host into `out_dir`, loaded; `edits`:
    (old, new) source replacements, each of which must apply."""
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    assert SHARED in src
    src = src.replace(SHARED, "alignas(16) float4 ellipsoid_shared"
                              "[kHostSharedPerSm / 16];")
    src += ('\nextern "C" void host_set_multiprocessors(int n) '
            '{ host_multiprocessors = n; }\n')
    cpp = os.path.join(str(out_dir), "ellipsoids_host.cpp")
    so = os.path.join(str(out_dir), "libellipsoids_host.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", so, cpp], check=True)
    lib = ctypes.CDLL(so)
    _kernels.set_ellipsoid_argtypes(lib)
    lib.host_set_multiprocessors.argtypes = [ctypes.c_int]
    return lib


def _inputs(act, cam) -> dict:
    inputs = E.frame_inputs(act, cam)
    E._check(inputs, cuda=False)
    return inputs


def frame(lib, act, cam, background, sms: int = 1) -> torch.Tensor:
    """The kernel's image on the CPU, the host card holding `sms` SMs."""
    lib.host_set_multiprocessors(sms)
    inputs = _inputs(act, cam)
    n = inputs["means"].shape[0]
    offsets = E.scratch_offsets(lib, n, cam.height, cam.width)
    scratch = torch.full((offsets[8],), 0xA5, dtype=torch.uint8)
    out = torch.full((cam.height, cam.width, 3), -7.0)
    bg = background_row(tuple(float(v) for v in background),
                        torch.device("cpu"))
    code = lib.gsrast_ellipsoids(*E.frame_args(
        inputs, cam.height, cam.width, bg.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), None))
    assert code == 0
    return out


def terms(lib, act, cam) -> E.Terms:
    """The kernel's first launch alone on the CPU: its terms, spans and
    colours."""
    lib.host_set_multiprocessors(1)
    inputs = _inputs(act, cam)
    n = inputs["means"].shape[0]
    offsets = E.scratch_offsets(lib, n, cam.height, cam.width)
    scratch = torch.full((offsets[8],), 0xA5, dtype=torch.uint8)
    code = lib.gsrast_ellipsoids_terms(*E.frame_args(
        inputs, cam.height, cam.width, scratch.data_ptr(), None))
    assert code == 0
    return E.scratch_terms(scratch, offsets, n)
