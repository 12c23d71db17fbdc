"""The ellipsoid ray trace's prologue, dispatch and wrapper
(`viz/ellipsoids.py`), and its kernel (`csrc/ellipsoids.cu`) on the card.

On the CPU: the prologue's terms against float64 numpy; its spans cull
what cannot hit (a float64 solve of every live (Gaussian, pixel) pair finds
each hit inside its Gaussian's span) and are empty for culled, masked and
non-finite Gaussians; the rays and the prologue's sums in a fixed order,
bit for bit against numpy float32 operations in that order; the kernel's
first launch (its CUDA source built for the host, `ellipsoids_host.py`)
bit-equal to `ellipsoid_terms`; the plain version lists exactly the span's
pairs; `chip_smoke.ellipsoid_work`'s count of the solves the spans need;
the counting build's records as `diag/ellipsoid_probe.py` reads them;
the one dispatch rule of `_kernels.uses_kernel`; the wrapper's
checks; `render --mode ellipsoids --backend torch`. The `cuda` cases hold
the kernel to its plain version on the card, pixel for pixel, eager and in
a CUDA graph, and its first launch to `ellipsoid_terms` bit for bit
(phase 23 of `chip_smoke.py` does so at 1080p); they import only the
port."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels, cli
from gsrast_tpu_torch.camera import camera_rays
from gsrast_tpu_torch.scene.gaussians import random_scene
from gsrast_tpu_torch.viz import ellipsoids as E

HERE = os.path.dirname(os.path.abspath(__file__))
TRAINED_SMALL = os.path.join(HERE, "fixtures", "trained_small.ply")

torch.set_num_threads(2)


def _seeded(n=300, width=64, height=48, seed=7, device="cpu"):
    scene = random_scene(n, np.random.default_rng(seed),
                         scale_range=(0.02, 0.12), device=device)
    cam = gt.make_camera(gt.look_at([0.3, -0.2, -2.5], [0.0, 0.0, 0.0],
                                    device=device), 1.2, 1.0, width, height,
                         device=device)
    return scene.activated(), cam


def _f64(x):
    return x.detach().cpu().double().numpy()


def _rot_np(q):
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def test_prologue_terms_match_float64():
    """R^T, 1/(2s), oo = (R^T o - R^T mu) / (2s) and c = oo.oo - 1 within
    float32 rounding of their float64 values; the colour 0.2 SH-DC + 0.5."""
    act, cam = _seeded()
    pre = E.ellipsoid_terms(act, cam)
    rot_t = _rot_np(_f64(act.quats)).transpose(0, 2, 1)
    isc = 1.0 / np.maximum(2.0 * _f64(act.scales), 1e-8)
    o = _f64(cam.position)
    oo = np.einsum("nij,nj->ni", rot_t, o[None] - _f64(act.means)) * isc
    c = (oo * oo).sum(-1) - 1.0
    terms = _f64(pre.terms)
    np.testing.assert_allclose(terms[:, :9], rot_t.reshape(-1, 9),
                               atol=1e-6)
    np.testing.assert_allclose(terms[:, 9:12], isc, rtol=1e-6)
    scale = np.abs(oo).max(-1, keepdims=True) + 1.0
    assert np.abs(terms[:, 12:15] - oo).max() <= 1e-5 * scale.max()
    np.testing.assert_allclose(terms[:, 15], c, rtol=1e-5,
                               atol=1e-5 * float((oo * oo).sum(-1).max()))
    np.testing.assert_array_equal(
        _f64(pre.color), _f64(0.2 * act.sh[:, 0, :] + 0.5))


@pytest.mark.parametrize("inside", [False, True])
def test_spans_hold_every_hit(inside):
    """Every (live Gaussian, pixel) pair solved in float64: each hit lies
    in a tile of the Gaussian's span, so the spans drop no hit. Inside the
    scene some spans cover the whole image."""
    act, cam = _seeded()
    if inside:
        cam = cam.replace(view=gt.look_at([0.05, 0.0, 0.0], [0.3, 0.1, 1.0]))
    pre = E.ellipsoid_terms(act, cam)
    _, dirs = camera_rays(cam)
    d = _f64(dirs).reshape(-1, 3)
    o = _f64(cam.position)
    rot_t = _rot_np(_f64(act.quats)).transpose(0, 2, 1)
    isc = 1.0 / np.maximum(2.0 * _f64(act.scales), 1e-8)
    live = _f64(act.opacities) >= E.ALPHA_CULL
    oo = np.einsum("nij,nj->ni", rot_t, o[None] - _f64(act.means)) * isc
    dd = np.einsum("nij,pj->npi", rot_t, d) * isc[:, None, :]
    a = (dd * dd).sum(-1)
    b = 2.0 * (oo[:, None, :] * dd).sum(-1)
    c = (oo * oo).sum(-1)[:, None] - 1.0
    disc = b * b - 4.0 * a * c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
    t = np.where(t0 > E.T_MIN, t0, t1)
    hit = (disc >= 0) & (t > E.T_MIN) & live[:, None]
    g, p = np.nonzero(hit)
    ty, tx = (p // cam.width) // E.TILE, (p % cam.width) // E.TILE
    x0, x1, y0, y1 = _f64(pre.spans).T
    assert len(g) > 100
    inside_span = (tx >= x0[g]) & (tx < x1[g]) & (ty >= y0[g]) & (ty < y1[g])
    assert inside_span.all(), int((~inside_span).sum())
    grid = (-(-cam.width // E.TILE), -(-cam.height // E.TILE))
    whole = (x0 == 0) & (x1 == grid[0]) & (y0 == 0) & (y1 == grid[1])
    assert whole.any() == inside


def test_spans_empty_where_culled():
    """Below the cull, masked out, a NaN mean or scale: an empty span."""
    act, cam = _seeded(n=200)
    opac, mask = act.opacities.clone(), act.mask.clone()
    means, scales = act.means.clone(), act.scales.clone()
    opac[0:20] = 0.2999
    mask[20:40] = False
    means[40] = float("nan")
    scales[41] = float("nan")
    act = dataclasses.replace(act, opacities=opac, mask=mask, means=means,
                              scales=scales)
    x0, x1, y0, y1 = E.ellipsoid_terms(act, cam).spans.unbind(-1)
    empty = (x1 <= x0) | (y1 <= y0)
    assert bool(empty[:42].all())
    assert int((~empty).sum()) > 50


def _f32(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32)


def test_camera_rays_fixed_order_bits():
    """camera_rays as numpy float32 operations in its written order: the
    pixel centre times 1 / n in float32, (px tan_x, py tan_y, 1) V[:3, :3]
    summed left to right, the norm's square root correctly rounded (in
    float64, then float32), the division: the same bits on any device."""
    for width, height in ((64, 48), (83, 37)):
        _, cam = _seeded(width=width, height=height)
        _, dirs = camera_rays(cam)
        one = np.float32(1.0)
        xs, ys = ((np.arange(n, dtype=np.float32) + np.float32(0.5))
                  * (one / np.float32(n)) * np.float32(2.0) - one
                  for n in (width, height))
        rot = _f32(cam.view)[:3, :3]
        px = (xs * _f32(cam.tan_fov_x))[None, :, None]
        py = (ys * _f32(cam.tan_fov_y))[:, None, None]
        w = px * rot[0] + py * rot[1] + rot[2]
        sq = (w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]
              + w[..., 2] * w[..., 2])
        norm = np.sqrt(sq.astype(np.float64)).astype(np.float32)
        want = w / norm[..., None]
        np.testing.assert_array_equal(_f32(dirs).view(np.int32),
                                      want.view(np.int32))


def test_prologue_sums_fixed_order_bits():
    """The prologue's 3-term sums as numpy float32 operations left to
    right: R^T o - R^T mu, oo.oo - 1, and the camera-space centre whose
    box gives the spans, bit for bit."""
    act, cam = _seeded(n=500)
    pre = E.ellipsoid_terms(act, cam)
    rt = _f32(pre.terms[:, :9]).reshape(-1, 3, 3)
    isc, o, mu = _f32(pre.terms[:, 9:12]), _f32(cam.position), _f32(act.means)

    def dot3(x, y):
        return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]

    oo = (dot3(rt, o) - dot3(rt, mu[:, None, :])) * isc
    np.testing.assert_array_equal(_f32(pre.terms[:, 12:15]).view(np.int32),
                                  oo.view(np.int32))
    c = dot3(oo, oo) - np.float32(1.0)
    np.testing.assert_array_equal(_f32(pre.terms[:, 15]).view(np.int32),
                                  c.view(np.int32))
    view = _f32(cam.view)
    mu_cam = dot3(mu[:, None, :], view[None, :3, :3]) + view[:3, 3]
    got = _f32(E._dot3(act.means[:, None, :], cam.view[:3, :3])
               + cam.view[:3, 3])
    np.testing.assert_array_equal(got.view(np.int32), mu_cam.view(np.int32))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`csrc/ellipsoids.cu` built for the host (`ellipsoids_host.py`)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    import ellipsoids_host

    return ellipsoids_host.build(tmp_path_factory.mktemp("ellipsoids_host"))


def _first_launch_cases():
    act, cam = _seeded(n=400, width=83, height=37)
    opac, mask = act.opacities.clone(), act.mask.clone()
    means, scales, quats = (act.means.clone(), act.scales.clone(),
                            act.quats.clone())
    opac[0:30] = 0.2999
    mask[30:50] = False
    means[50] = float("nan")
    scales[51] = float("nan")
    scales[52] = 0.0
    quats[53] = float("inf")
    edited = dataclasses.replace(act, opacities=opac, mask=mask, means=means,
                                 scales=scales, quats=quats)
    scene = gt.load_ply(TRAINED_SMALL)
    framed = gt.auto_frame(*scene.bbox(), 64, 48)
    lo, hi = (x.numpy() for x in scene.bbox())
    center = 0.5 * (lo + hi)
    inside = framed.replace(view=gt.look_at(center, center + [0.3, 0.1, 1.0]))
    return {"seeded_ragged": (act, cam), "culled_and_non_finite": (edited, cam),
            "trained_small_framed": (scene.activated(), framed),
            "trained_small_inside": (scene.activated(), inside)}


@pytest.mark.parametrize("case", ["seeded_ragged", "culled_and_non_finite",
                                  "trained_small_framed",
                                  "trained_small_inside"])
def test_first_launch_matches_prologue(host_lib, case):
    """The kernel's first launch (host build) writes `ellipsoid_terms`'
    terms, spans and colours bit for bit, NaN and infinity included."""
    import ellipsoids_host

    act, cam = _first_launch_cases()[case]
    with torch.no_grad():
        want = E.ellipsoid_terms(act, cam)
        got = ellipsoids_host.terms(host_lib, act, cam)
    for name in ("terms", "spans", "color"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
            name, int((a.view(torch.int32) != b.view(torch.int32)).sum()))


def test_pairs_are_the_spans_tiles():
    """The plain version's (Gaussian, tile) pairs are the spans' tiles,
    each once, Gaussian by Gaussian."""
    act, cam = _seeded(n=120, width=83, height=37)
    pre = E.ellipsoid_terms(act, cam)
    grid_w = -(-cam.width // E.TILE)
    gauss, tile = E._pairs(pre.spans, grid_w)
    want = [(i, y * grid_w + x)
            for i, (x0, x1, y0, y1) in enumerate(pre.spans.tolist())
            for y in range(y0, y1) for x in range(x0, x1)]
    assert list(zip(gauss.tolist(), tile.tolist())) == want


@pytest.mark.parametrize("size", [(83, 37), (64, 48)])
def test_bound_counts_the_spans_pixels_in_the_image(size):
    """chip_smoke.ellipsoid_work, which bounds the kernel's time, counts a
    solve for each pixel inside the image of each (Gaussian, tile) pair,
    at 31 operations (33 written out), and bytes for the activated
    Gaussians, the image and the background."""
    import sys

    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke

    act, cam = _seeded(n=120, width=size[0], height=size[1])
    pre = E.ellipsoid_terms(act, cam)
    solves = sum((min(cam.width, 16 * x + 16) - 16 * x)
                 * (min(cam.height, 16 * y + 16) - 16 * y)
                 for x0, x1, y0, y1 in pre.spans.tolist()
                 for y in range(y0, y1) for x in range(x0, x1))
    work = chip_smoke.ellipsoid_work(pre, cam.height, cam.width)
    assert work["pixel_solves"] == solves > 0
    assert work["ops"] == 31 * solves
    assert work["written_out_ops"] == 33 * solves
    assert work["bytes"] == 120 * 57 + cam.height * cam.width * 12 + 12
    assert work["pairs"] == int(((pre.spans[:, 1] - pre.spans[:, 0])
                                 * (pre.spans[:, 3] - pre.spans[:, 2])).sum())


def test_probe_summary_reads_the_counting_build_records():
    """diag.ellipsoid_probe.summarise reads the counting build's records
    (per block: cycles, warps, the phases' cycles, then per warp its
    fields) into totals, shares and ratios."""
    from gsrast_tpu_torch.diag import ellipsoid_probe as P

    warps, phases, fields = 2, len(P.PHASES), len(P.WARP_FIELDS)
    rec = torch.zeros((2, 2 + phases + warps * fields), dtype=torch.int64)
    rec[:, 0] = torch.tensor([100, 300])
    rec[:, 1] = warps
    rec[:, 2:2 + phases] = torch.tensor([[10, 20, 60, 5, 5],
                                         [30, 30, 200, 20, 20]])
    w = rec[:, 2 + phases:].view(2, warps, fields)
    w[0] = torch.tensor([[40, 2, 64, 50, 5, 4], [20, 1, 16, 10, 1, 1]])
    w[1] = torch.tensor([[90, 3, 96, 96, 9, 9], [90, 3, 96, 96, 9, 9]])
    res = P.summarise(rec)
    assert res["phase_share"] == pytest.approx(
        {"walk": 0.1, "stage": 0.125, "units": 0.65, "merge": 0.0625,
         "rest": 0.0625})
    assert (res["blocks"], res["busy_blocks"]) == (2, 2)
    assert (res["pixel_solves"], res["disc_hits"], res["key_hits"]) == (
        252, 24, 23)
    assert res["idle_lane_share"] == pytest.approx(1 - 272 / (32 * 9))
    assert res["busiest_warp_cycles_over_mean"] == pytest.approx(
        [(40 / 30 + 1.0) / 2, 40 / 30])
    assert res["block_cycles_max_over_mean"] == pytest.approx(1.5)


@pytest.mark.parametrize("backend", ["cuda", "torch", "autograd", "dense"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_one_dispatch_rule(backend, device):
    """The kernel for CUDA tensors under backend 'cuda'; the plain version
    for every other device and backend."""
    assert _kernels.uses_kernel(backend, torch.device(device)) == (
        backend == "cuda" and device == "cuda")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_dispatch(backend, monkeypatch):
    """CPU tensors take the plain version whatever the backend; where the
    rule names the kernel, the kernel's wrapper is called."""
    act, cam = _seeded(n=50, width=32, height=32)

    def refuse(*args):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(E, "render_ellipsoids_cuda", refuse)
    assert torch.equal(E.render_ellipsoids(act, cam, backend=backend),
                       E.render_ellipsoids_torch(act, cam))
    seen = []
    monkeypatch.setattr(E, "render_ellipsoids_cuda",
                        lambda *args: seen.append(args) or "kernel")
    monkeypatch.setattr(_kernels, "uses_kernel",
                        lambda b, d: b == "cuda")
    got = E.render_ellipsoids(act, cam, (0.1, 0.2, 0.3), backend=backend)
    assert (got == "kernel") == (backend == "cuda") == bool(seen)


def test_wrapper_checks():
    """The wrapper refuses CPU tensors and inputs of the wrong shape or
    type before it builds anything."""
    act, cam = _seeded(n=20, width=32, height=16)
    bg = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.ellipsoids_launch(act, cam, bg)
    with pytest.raises(ValueError, match="quats"):
        E.ellipsoids_launch(dataclasses.replace(act, quats=act.quats[:, :3]),
                            cam, bg)
    with pytest.raises(ValueError, match="mask"):
        E.ellipsoids_launch(dataclasses.replace(act, mask=act.mask.int()),
                            cam, bg)


def test_cli_render_ellipsoids_backend(tmp_path):
    """`render --mode ellipsoids --backend torch` draws the plain version
    (the default backend, 'cuda', on CPU tensors too)."""
    scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*scene.bbox(), 48, 40)
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(scene.activated(), cam)
    for extra in ([], ["--backend", "torch"]):
        img = cli.main(["render", TRAINED_SMALL, "--mode", "ellipsoids",
                        "--width", "48", "--height", "40", "--out",
                        str(tmp_path / "e.png"), "--device", "cpu", *extra])
        assert torch.equal(img, expected)


# -- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["framed_128", "inside_96x80",
                                  "seeded_ragged_83x37"])
def test_cuda_kernel_matches_plain(case):
    """The kernel's image against the plain version's on the card, pixel
    for pixel, with one launch a call."""
    dev = _cuda()
    if case == "seeded_ragged_83x37":
        act, cam = _seeded(n=3000, width=83, height=37, device=dev)
    else:
        scene = gt.load_ply(TRAINED_SMALL, device=dev)
        size = (128, 128) if case == "framed_128" else (96, 80)
        cam = gt.auto_frame(*scene.bbox(), *size, device=dev)
        if case.startswith("inside"):
            lo, hi = (x.cpu().numpy() for x in scene.bbox())
            center = 0.5 * (lo + hi)
            cam = cam.replace(view=gt.look_at(center, center + np.array(
                [0.3, 0.1, 1.0], np.float32), device=dev))
        act = scene.activated()
    with torch.no_grad():
        expected = E.render_ellipsoids_torch(act, cam, (0.1, 0.2, 0.3))
        _kernels.reset_launch_counts()
        got = E.render_ellipsoids(act, cam, (0.1, 0.2, 0.3))
        torch.cuda.synchronize()
    assert _kernels.launch_counts["ellipsoids"] == 1
    assert torch.equal(got, expected), int((got != expected).any(-1).sum())


@pytest.mark.cuda
def test_cuda_first_launch_matches_prologue():
    """The kernel's first launch on the card writes `ellipsoid_terms`'
    terms, spans and colours (the torch ops on the card) bit for bit."""
    dev = _cuda()
    scene = gt.load_ply(TRAINED_SMALL, device=dev)
    cam = gt.auto_frame(*scene.bbox(), 128, 96, device=dev)
    act = scene.activated()
    with torch.no_grad():
        want = E.ellipsoid_terms(act, cam)
        got = E.ellipsoid_terms_cuda(act, cam)
        torch.cuda.synchronize()
    for name in ("terms", "spans", "color"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name


@pytest.mark.cuda
def test_cuda_kernel_in_a_graph_follows_the_camera():
    """The kernel captured with its prologue in a CUDA graph: a replay
    after the camera's view is rewritten draws the new view."""
    dev = _cuda()
    scene = gt.load_ply(TRAINED_SMALL, device=dev)
    base = gt.auto_frame(*scene.bbox(), 96, 64, device=dev)
    other = base.replace(view=gt.look_at([0.5, -0.3, -2.0], [0.0, 0.0, 0.0],
                                         device=dev))
    act = scene.activated()
    with torch.no_grad():
        cam = base.replace(view=base.view.clone())
        _kernels.on_side_stream(lambda: E.render_ellipsoids(act, cam), dev)
        graph, out, launches = _kernels.capture(
            lambda: E.render_ellipsoids(act, cam), "the ellipsoid frame")
        assert launches["ellipsoids"] == 1
        cam.view.copy_(other.view)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, E.render_ellipsoids_torch(act, other))
