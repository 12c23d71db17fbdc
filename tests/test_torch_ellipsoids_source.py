"""The ellipsoid ray trace's CUDA source (`csrc/ellipsoids.cu`) run on the
CPU: built by g++ against the host stand-in of the CUDA runtime
(`tests/ellipsoids_host.py`), its C entry point called through ctypes with
the wrapper's own arguments on CPU tensors (the activated Gaussians and
the camera: its first launch computes the prologue, its trace the rays),
and held to the plain version (`render_ellipsoids_torch`) on the same
inputs: the image equal pixel for pixel. The cases cover a framed trained
scene, a camera inside the scene (spans over the whole image, so the
walk's list fills and flushes within a pass), more Gaussians than one pass
tests, images whose size is not a multiple of 16 (nor of the 4 x 4-tile
region), one tile whose list is many times longer than its neighbours'
(the warps' units balance it; the region's Gaussians split into items), a
camera inside an ellipsoid (t from the far root), Gaussians whose terms
leave the exact-scaling range (the written-out solve), culled, masked and
non-finite Gaussians, a scene with none above the cull, and no Gaussians
at all; and the host card's SM count, which sets the persistent blocks and
the plan's items, does not change the image."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import ellipsoids_host as host
import gsrast_tpu_torch as gt
from gsrast_tpu_torch.scene.gaussians import ActivatedGaussians, random_scene
from gsrast_tpu_torch.viz import ellipsoids as E

TRAINED_SMALL = host.HERE + "/fixtures/trained_small.ply"
BACKGROUND = (0.1, 0.2, 0.3)
SPECIAL_DC = (1.0, -1.0, 0.5)  # SH-DC of the Gaussians a case is about

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`ellipsoids.cu` built for the host."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return host.build(tmp_path_factory.mktemp("ellipsoids_host"))


def _host_kernel(lib, act, cam, background=BACKGROUND, sms=1) -> torch.Tensor:
    """The kernel's image on the CPU, from the wrapper's inputs."""
    return host.frame(lib, act, cam, background, sms)


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


def _cluster(n=6000, width=96, height=64):
    """Most Gaussians packed in front of one tile, a few spread over the
    image: that tile's list is many times its neighbours', a region's list
    overflows a flush within one pass, and with n >= 4,096 its Gaussians
    split into several items."""
    act, cam = _seeded(n, width, height, seed=11)
    means = act.means.clone()
    g = torch.Generator().manual_seed(11)
    dense = torch.arange(n) % 10 != 0
    means[dense] = (torch.tensor([0.05, -0.02, 0.0])
                    + 0.04 * torch.randn(int(dense.sum()), 3, generator=g))
    scales = act.scales.clone()
    scales[dense] *= 0.3
    return _edited(act, means=means, scales=scales), cam


def _inside_ellipsoid(width=64, height=48):
    """The camera inside a large ellipsoid (and among smaller ones): its
    pixels take t from the far root, t1."""
    act, cam = _seeded(400, width, height, seed=5)
    means, scales = act.means.clone(), act.scales.clone()
    means[7] = torch.tensor([0.0, 0.0, -2.4])
    scales[7] = torch.tensor([0.9, 0.6, 1.2])
    opac, sh = act.opacities.clone(), act.sh.clone()
    opac[7] = 0.9
    sh[7, 0] = torch.tensor(SPECIAL_DC)
    return _edited(act, means=means, scales=scales, opacities=opac,
                   sh=sh), cam


def _out_of_range(width=80, height=60):
    """Terms outside the exact-scaling range, so those Gaussians take the
    written-out solve: quaternions far from unit length (R^T not
    orthonormal), tiny far Gaussians (|oo| > 2^28), a huge one holding the
    camera (1 / (2s) < 2^-28), beside ordinary ones."""
    act, cam = _seeded(800, width, height, seed=9)
    quats, scales = act.quats.clone(), act.scales.clone()
    means = act.means.clone()
    quats[0::4] *= 1.7
    quats[1::4] *= 0.4
    scales[2::16] = 1e-9
    means[2::16] *= 40.0
    scales[3] = 4e8
    means[3] = torch.tensor([0.0, 0.0, -2.5])
    sh = act.sh.clone()
    sh[0::4, 0] = torch.tensor(SPECIAL_DC)  # the stretched rotations' colour
    return _edited(act, quats=quats, scales=scales, means=means, sh=sh), cam


CASES = {
    "trained_small_64x48": lambda: _framed(64, 48),
    "trained_small_inside_48x40": lambda: _framed(48, 40, inside=True),
    "seeded_3000_96x64": lambda: _seeded(3000, 96, 64),
    "seeded_1500_ragged_83x37": lambda: _seeded(1500, 83, 37),
    "cluster_6000_96x64": _cluster,
    "inside_an_ellipsoid_64x48": _inside_ellipsoid,
    "out_of_range_80x60": _out_of_range,
    "seeded_2500_ragged_131x75": lambda: _seeded(2500, 131, 75, seed=4),
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
    """Each launch as the library reports it: the trace's grid is the host
    card's resident blocks (by shared memory: 3 an SM)."""
    lib.host_set_multiprocessors(2)
    grids = []
    for kernel in range(4):
        vals = [ctypes.c_int() for _ in range(6)]
        assert lib.gsrast_ellipsoids_occupancy(
            kernel, 1000, 64, 96, *(ctypes.byref(v) for v in vals)) == 0
        threads, blocks = vals[0].value, vals[1].value
        assert threads == 256 and blocks >= 1
        grids.append(vals[5].value)
    assert grids == [4, 1, 6, 24]
    lib.host_set_multiprocessors(1)


@pytest.mark.parametrize("sms", [2, 8])
def test_kernel_source_sms_do_not_change_the_image(lib, sms):
    """More resident blocks and more planned items (the host card's SMs):
    the same image."""
    act, cam = _cluster(5000, 70, 50)
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(act, cam, BACKGROUND)
    assert torch.equal(_host_kernel(lib, act, cam, sms=sms), expected)


@pytest.mark.parametrize("case", ["inside_an_ellipsoid_64x48",
                                  "out_of_range_80x60"])
def test_kernel_source_special_gaussians_are_drawn(case):
    """The premise of the t1 and the written-out cases: the Gaussians they
    are about (their colour, 0.2 SPECIAL_DC + 0.5) win many pixels of the
    plain image; the camera lies inside the large ellipsoid (c < 0)."""
    act, cam = CASES[case]()
    with torch.no_grad():
        img = E.render_ellipsoids_torch(act, cam, BACKGROUND)
        pre = E.ellipsoid_terms(act, cam)
    colour = torch.clamp(0.2 * torch.tensor(SPECIAL_DC) + 0.5, 0.0, 1.0)
    shown = (img == colour).all(-1)
    assert int(shown.sum()) >= 20, int(shown.sum())
    if case.startswith("inside"):
        assert float(pre.terms[7, 15]) < 0.0


def test_kernel_source_pairs_counted_in_global_memory(tmp_path):
    """With more regions than a block sums in shared memory (here more
    than one), the first launch adds each Gaussian's pairs to the frame's
    counts directly: the same image."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    lib = host.build(tmp_path, [("constexpr int kPairBins = 4096;",
                                 "constexpr int kPairBins = 1;")])
    act, cam = _seeded(1500, 83, 37)
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(act, cam, BACKGROUND)
    assert torch.equal(_host_kernel(lib, act, cam, sms=2), expected)


def test_kernel_source_cluster_is_unbalanced():
    """The cluster case's premise: its busiest tile's list is many times
    its neighbours' and its region's pairs need several items."""
    act, cam = _cluster()
    pre = E.ellipsoid_terms(act, cam)
    grid_w = -(-cam.width // E.TILE)
    _, tile = E._pairs(pre.spans, grid_w)
    counts = torch.bincount(tile, minlength=grid_w * -(-cam.height // 16))
    assert int(counts.max()) >= 4 * float(counts.float().median())
    assert int(counts.max()) > 256  # more than one flush's stage
