"""The ellipsoid ray trace's CUDA source (`csrc/ellipsoids.cu`) run on the
CPU: compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (each block's threads real threads at a barrier, blocks
one after another, the _rn intrinsics plain float operations built without
contraction, shared-memory atomics real atomics), its C entry point called
through ctypes on the prologue's CPU tensors (`ellipsoid_terms`, the
directions of `camera_rays`), and held to the plain version
(`render_ellipsoids_torch`) on the same inputs: the image equal pixel for
pixel. The cases cover a framed trained scene, a camera inside the scene
(spans over the whole image, so the kernel's list fills and flushes within
a pass), more Gaussians than one pass tests, an image whose size is not a
multiple of 16 (nor its tile grid of 4), culled, masked and non-finite
Gaussians, a scene with none above the cull, and no Gaussians at all."""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch.camera import camera_rays
from gsrast_tpu_torch.scene.gaussians import ActivatedGaussians, random_scene
from gsrast_tpu_torch.viz import ellipsoids as E
from gsrast_tpu_torch.viz.pointcloud import background_row

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "ellipsoids.cu")
TRAINED_SMALL = os.path.join(HERE, "fixtures", "trained_small.ply")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
BACKGROUND = (0.1, 0.2, 0.3)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`ellipsoids.cu` built for the host: each launch rewritten to the
    shim's `launch(grid, block, kernel, ...)`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("ellipsoids_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    cpp, so = out / "ellipsoids_host.cpp", out / "libellipsoids_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.gsrast_ellipsoids.argtypes = [*[vp] * 5, *[i32] * 3, vp, vp, vp]
    dll.gsrast_ellipsoids.restype = ctypes.c_int
    dll.gsrast_ellipsoids_occupancy.argtypes = [vp] * 5
    dll.gsrast_ellipsoids_occupancy.restype = ctypes.c_int
    return dll


def _host_kernel(lib, act, cam, background=BACKGROUND) -> torch.Tensor:
    """The kernel's image on the CPU, from the wrapper's inputs."""
    pre = E.ellipsoid_terms(act, cam)
    _, dirs = camera_rays(cam)
    bg = background_row(background, torch.device("cpu"))
    out = torch.full((cam.height, cam.width, 3), -7.0)
    regions = E.region_room(pre.terms.shape[0], "cpu").fill_(-1)
    code = lib.gsrast_ellipsoids(
        pre.terms.data_ptr(), pre.spans.data_ptr(), pre.color.data_ptr(),
        dirs.data_ptr(), bg.data_ptr(), pre.terms.shape[0], cam.height,
        cam.width, regions.data_ptr(), out.data_ptr(), None)
    assert code == 0
    return out


def _framed(width, height, inside=False):
    scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*scene.bbox(), width, height)
    if inside:  # at the scene's centre, among the splats
        lo, hi = (x.numpy() for x in scene.bbox())
        center = 0.5 * (lo + hi)
        cam = cam.replace(view=gt.look_at(center, center + [0.3, 0.1, 1.0]))
    return scene.activated(), cam


def _seeded(n, width, height, seed=3):
    scene = random_scene(n, np.random.default_rng(seed),
                         scale_range=(0.01, 0.08))
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -2.5], [0.0, 0.0, 0.0]),
                         1.2, 1.0, width, height)
    return scene.activated(), cam


def _edited(act: ActivatedGaussians, **fields) -> ActivatedGaussians:
    return dataclasses.replace(act, **fields)


CASES = {
    "trained_small_64x48": lambda: _framed(64, 48),
    "trained_small_inside_48x40": lambda: _framed(48, 40, inside=True),
    "seeded_3000_96x64": lambda: _seeded(3000, 96, 64),
    "seeded_1500_ragged_83x37": lambda: _seeded(1500, 83, 37),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_source_matches_plain(lib, case):
    act, cam = CASES[case]()
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(act, cam, BACKGROUND)
        got = _host_kernel(lib, act, cam)
    drawn = (expected != torch.tensor(BACKGROUND)).any(-1)
    assert float(drawn.float().mean()) > 0.05, case
    assert torch.equal(got, expected), int((got != expected).any(-1).sum())


def test_kernel_source_culled_masked_and_non_finite(lib):
    """Gaussians below the cull, masked out, or with a NaN mean or scale
    are skipped by their empty spans, as the plain version skips them."""
    act, cam = _seeded(600, 70, 50, seed=5)
    n = act.means.shape[0]
    opac = act.opacities.clone()
    opac[::3] = 0.29
    mask = act.mask.clone()
    mask[1::7] = False
    means, scales = act.means.clone(), act.scales.clone()
    means[5] = float("nan")
    scales[11, 1] = float("nan")
    edited = _edited(act, opacities=opac, mask=mask, means=means,
                     scales=scales)
    pre = E.ellipsoid_terms(edited, cam)
    x0, x1, y0, y1 = pre.spans.unbind(-1)
    empty = (x1 <= x0) | (y1 <= y0)
    assert bool(empty[::3].all()) and bool(empty[1::7].all())
    assert bool(empty[5])
    assert int((~empty).sum()) < n
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(edited, cam, BACKGROUND)
    assert torch.equal(_host_kernel(lib, edited, cam), expected)


@pytest.mark.parametrize("n", [0, 40])
def test_kernel_source_nothing_drawn(lib, n):
    """No Gaussian above the cull (or none at all): every pixel is the
    background, clamped."""
    act, cam = _seeded(max(n, 1), 37, 21)
    act = _edited(act, **{f.name: getattr(act, f.name)[:n]
                          for f in dataclasses.fields(act)})
    act = _edited(act, opacities=torch.full_like(act.opacities, 0.2))
    bg = (1.5, 0.25, -0.5)
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(act, cam, bg)
    got = _host_kernel(lib, act, cam, bg)
    assert torch.equal(got, expected)
    assert torch.equal(got, torch.tensor([1.0, 0.25, 0.0]).expand(21, 37, 3))


def test_kernel_source_occupancy(lib):
    threads, blocks, regs, local, shared = (ctypes.c_int() for _ in range(5))
    assert lib.gsrast_ellipsoids_occupancy(
        *(ctypes.byref(v) for v in (threads, blocks, regs, local,
                                    shared))) == 0
    assert threads.value == 256 and blocks.value >= 1
