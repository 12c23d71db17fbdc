"""The viewer's renderers of `gsrast_tpu_torch` against `gsrast_tpu` on the
same arrays: the point cloud, the ellipsoid ray trace and the dense
oracle (image, final_t, n_contrib, gradients, and against the port's tiled
renderer on the tiled inclusion set). The `cuda` cases hold the card's
renders against the CPU's; they import only the port."""

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import config as tcfg
from gsrast_tpu_torch.render.dense import render_dense
from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids
from gsrast_tpu_torch.viz.pointcloud import render_pointcloud

from torch_parity import (TRAINED_SMALL, camera_to_torch, front_camera,
                          scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

# A pixel of the point cloud may differ only where a point's mean2d lies
# within this many pixels of a rounding boundary (x.5) in either package.
ROUND_EPS = 1e-4
# Ellipsoids: at most this share of pixels may show another Gaussian (two
# hits within rounding of each other); elsewhere the images agree to 1e-6.
MAX_WINNER_FLIPS = 0.005
# Dense: image and final_t within 1e-5 where n_contrib agrees; n_contrib
# may differ only at pixels whose transmittance ends within 0.1% above
# T_MIN, on at most this share of pixels.
DENSE_ATOL = 1e-5
MAX_NC_FLIPS = 0.005
GRAD_RTOL = 1e-4
BACKGROUND = (0.1, 0.2, 0.3)


def _case(case):
    """(reference scene, port scene, reference camera, port camera)."""
    import gsrast_tpu as gs

    if case.startswith("trained_small"):
        size = int(case.rsplit("_", 1)[1])
        ref = gs.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref.bbox(), size, size)
        if "inside" in case:  # at the scene's centre, among the splats
            center = 0.5 * (np.asarray(ref.bbox()[0])
                            + np.asarray(ref.bbox()[1]))
            jcam = jcam.replace(view=gs.look_at(center,
                                                center + [0.3, 0.1, 1.0]))
        return ref, gt.load_ply(TRAINED_SMALL), jcam, camera_to_torch(jcam)
    n, w, h = {"seeded_2000_64x48": (2000, 64, 48),
               "seeded_300_64x48": (300, 64, 48),
               "seeded_120_40x32": (120, 40, 32)}[case]
    ref, port = scenes(seeded_arrays(3, n, sh_degree=1,
                                     scale_range=(0.01, 0.08)))
    jcam, cam = front_camera(w, h)
    return ref, port, jcam, cam


def _boundary_pixels(mean2d: np.ndarray, visible: np.ndarray, w: int,
                     h: int, point_size: int = 2) -> np.ndarray:
    """(h, w) bool: the pixels a point near a rounding boundary may draw
    under either rounding."""
    frac = np.abs(mean2d - np.floor(mean2d) - 0.5)
    near = visible & (frac < ROUND_EPS).any(axis=1)
    mask = np.zeros((h, w), bool)
    half = point_size // 2
    for x, y in mean2d[near]:
        for px in {int(np.floor(x)), int(np.ceil(x))}:
            for py in {int(np.floor(y)), int(np.ceil(y))}:
                mask[max(py - half, 0):max(py - half + point_size, 0),
                     max(px - half, 0):max(px - half + point_size, 0)] = True
    return mask


@pytest.mark.parametrize("case", ["seeded_2000_64x48", "trained_small_128"])
def test_pointcloud_matches_reference(case):
    """Equal pixel for pixel, apart from the counted pixels of points whose
    mean2d lies within ROUND_EPS of a rounding boundary. The seeded scene
    puts 2,000 points on 3,072 pixels, so many collide and the far-to-near
    winner of each pass decides."""
    from gsrast_tpu.ops import projection as jproj
    from gsrast_tpu.viz.pointcloud import render_pointcloud as jax_pc

    ref, port, jcam, cam = _case(case)
    act = ref.activated()
    expected = np.asarray(jax_pc(act, jcam))
    got = t2n(render_pointcloud(port.activated(), cam))
    depth = jproj.to_camera(act.means, jcam.view)[..., 2]
    mean2d, ndc = jproj.project(act.means, jcam.full_projection(),
                                jcam.width, jcam.height)
    visible = np.asarray(jproj.in_frustum(depth, ndc) & act.mask)
    mean2d = np.asarray(mean2d)
    allowed = _boundary_pixels(np.where(visible[:, None], mean2d, -9.0),
                               visible, cam.width, cam.height)
    differ = (got != expected).any(axis=-1)
    print(f"{case}: {int(differ.sum())} pixels differ, "
          f"{int(allowed.sum())} pixels near a rounding boundary, "
          f"{int((expected.max(-1) > 0).sum())} drawn")
    assert got.shape == expected.shape
    assert not (differ & ~allowed).any()
    assert (expected.max(-1) > 0).sum() > 0.1 * differ.size


@pytest.mark.parametrize("chunk", [256, 7])
@pytest.mark.parametrize("case", ["seeded_2000_64x48", "trained_small_64",
                                  "trained_small_inside_48"])
def test_ellipsoids_match_reference(case, chunk):
    """Within 1e-6 at chunks of 256 and 7 (Gaussian, tile) pairs (the
    reference at its 256 Gaussians); the pixels whose winning ellipsoid
    differs (a ray grazing one ellipsoid within rounding, nearer than the
    next hit) are counted and bounded. Inside the scene many bounding
    spheres reach the camera's plane and cover the whole image."""
    from gsrast_tpu.viz.ellipsoids import render_ellipsoids as jax_el

    ref, port, jcam, cam = _case(case)
    expected = np.asarray(jax_el(ref.activated(), jcam))
    got = t2n(render_ellipsoids(port.activated(), cam, pair_chunk=chunk))
    flips = (np.abs(got - expected) > 1e-6).any(axis=-1)
    print(f"{case} chunk {chunk}: {int(flips.sum())} winners differ of "
          f"{flips.size} pixels, {int((expected.max(-1) > 0).sum())} drawn")
    assert flips.mean() <= MAX_WINNER_FLIPS
    assert (expected.max(-1) > 0).mean() > 0.1


def test_ellipsoids_depth_and_cull():
    """Two overlapping ellipsoids: the nearer one (green) wins the centre
    pixel, as in the reference, whose image is matched exactly."""
    from gsrast_tpu.scene.gaussians import from_arrays
    from gsrast_tpu.viz.ellipsoids import render_ellipsoids as jax_el

    arrays = dict(
        means=np.asarray([[0, 0, 0], [0, 0, -1.0]], np.float32),
        log_scales=np.log(np.full((2, 3), 0.4, np.float32)),
        quats=np.asarray([[1, 0, 0, 0], [1, 0, 0, 0]], np.float32),
        opacity_logits=np.asarray([4.0, 4.0], np.float32),
        sh=np.asarray([[[2.0, -1.0, -1.0]], [[-1.0, 2.0, -1.0]]],
                      np.float32))
    jcam, cam = front_camera(64, 48, dist=3.0)
    expected = np.asarray(jax_el(from_arrays(**arrays).activated(), jcam))
    got = t2n(render_ellipsoids(gt.from_numpy(arrays).activated(), cam))
    assert got[24, 32, 1] > got[24, 32, 0]
    np.testing.assert_array_equal(got, expected)


def _compare_nc(nc, nc_ref, ft, ft_ref) -> int:
    """n_contrib flips: rare, and at each the longer count ends within 0.1%
    above T_MIN. Returns their number."""
    flip = nc != nc_ref
    longer = np.where(nc > nc_ref, ft, ft_ref)[flip]
    t_min = tcfg.TRANSMITTANCE_MIN
    assert flip.mean() <= MAX_NC_FLIPS
    assert ((longer >= t_min) & (longer <= t_min * (1 + 1e-3))).all()
    return int(flip.sum())


@pytest.mark.parametrize("case", ["seeded_300_64x48", "trained_small_48"])
def test_dense_matches_reference(case):
    """Image and final_t within 1e-5 where n_contrib agrees; n_contrib
    exact outside the counted T ~ 1e-4 flips (cumulative products in
    another order)."""
    import gsrast_tpu as gs
    from gsrast_tpu.render.dense import render_dense as jax_dense

    ref, port, jcam, cam = _case(case)
    jcfg = gs.RenderConfig(backend="dense", background=BACKGROUND)
    expected = jax_dense(ref.activated(), jcam, jcfg)
    out = gt.render(port, cam, tcfg.RenderConfig(backend="dense",
                                                 background=BACKGROUND))
    img, ft, nc = (t2n(x) for x in out[:3])
    img_r, ft_r, nc_r = (np.asarray(x) for x in expected[:3])
    n_flip = _compare_nc(nc, nc_r, ft, ft_r)
    agree = nc == nc_r
    print(f"{case}: {n_flip} n_contrib flips, max n_contrib {nc_r.max()}")
    np.testing.assert_allclose(img[agree], img_r[agree], atol=DENSE_ATOL)
    np.testing.assert_allclose(ft[agree], ft_r[agree], atol=DENSE_ATOL)
    assert nc_r.max() > 0
    assert int(out.stats["num_visible"]) == int(expected.stats["num_visible"])


def test_dense_gradient_matches_jax():
    """d mean(image) / d means through the dense renderer, against jax.grad
    through the reference's, within 1e-4 of the gradient's largest
    magnitude."""
    import jax
    import jax.numpy as jnp
    import gsrast_tpu as gs
    from gsrast_tpu.render.dense import render_dense as jax_dense

    ref, port, jcam, cam = _case("seeded_120_40x32")
    act = ref.activated()
    jcfg = gs.RenderConfig(backend="dense", background=BACKGROUND)

    def jax_loss(means):
        return jnp.mean(jax_dense(act.replace(means=means), jcam,
                                  jcfg).image)

    expected = np.asarray(jax.grad(jax_loss)(act.means))
    img = gt.render(port, cam, tcfg.RenderConfig(
        backend="dense", background=BACKGROUND)).image
    torch.mean(img).backward()
    got = t2n(port.means.grad)
    scale = float(np.abs(expected).max())
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, expected / scale, atol=GRAD_RTOL)


def test_dense_matched_rects_against_tiled_backend():
    """`match_tiled_rects` restricts the oracle to the tiles' rectangles:
    against the port's plain tiled backend on the same tiles, image and
    final_t within 1e-5 except at the counted pixels whose transmittance
    ends within 0.1% above T_MIN in one of them. n_contrib is not compared:
    the tile plan culls a splat's tiles outside its ellipse on tiers >= 1,
    which changes the count of skipped positions but no pixel's blend."""
    port = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*port.bbox(), 64, 64)
    rcfg = gt.auto_render_config(port, cam).replace(background=BACKGROUND)
    with torch.no_grad():
        tiled = gt.render(port, cam, rcfg)
        dense = render_dense(port.activated(), cam, rcfg,
                             match_tiled_rects=True)
    img, ft = t2n(dense.image), t2n(dense.final_t)
    img_t, ft_t = t2n(tiled.image), t2n(tiled.final_t)
    t_min = tcfg.TRANSMITTANCE_MIN
    boundary = np.minimum(ft, ft_t) <= t_min * (1 + 1e-3)
    differ = ((np.abs(img - img_t) > DENSE_ATOL).any(axis=-1)
              | (np.abs(ft - ft_t) > DENSE_ATOL))
    print(f"matched rects, tiles {rcfg.tile_h}x{rcfg.tile_w}: "
          f"{int(differ.sum())} pixels differ, {int(boundary.sum())} end "
          "at T_MIN")
    assert not (differ & ~boundary).any()
    assert differ.mean() <= MAX_NC_FLIPS
    assert float(ft.min()) < 0.5


def test_dense_takes_no_mean2d_delta():
    port = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*port.bbox(), 16, 16)
    with pytest.raises(ValueError, match="mean2d_delta"):
        gt.render(port, cam, tcfg.RenderConfig(backend="dense"),
                  mean2d_delta=torch.zeros((port.capacity, 2)))


RENDERERS = ("pointcloud", "ellipsoids", "dense")


def _draw(name, scene, cam):
    with torch.no_grad():
        if name == "pointcloud":
            return render_pointcloud(scene.activated(), cam)
        if name == "ellipsoids":
            return render_ellipsoids(scene.activated(), cam)
        return gt.render(scene, cam, tcfg.RenderConfig(
            backend="dense", background=BACKGROUND)).image


@pytest.mark.cuda
@pytest.mark.parametrize("name", RENDERERS)
def test_card_matches_cpu(name):
    """trained_small at 128x128, the card's render against the CPU's: the
    point cloud and the ellipsoids equal apart from at most 0.1% of pixels
    (rounding boundaries, near-equal hits), the dense image within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cpu_scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*cpu_scene.bbox(), 128, 128)
    expected = _draw(name, cpu_scene, cam)
    got = _draw(name, gt.load_ply(TRAINED_SMALL, device=dev),
                cam.to(dev)).cpu()
    assert bool(torch.isfinite(got).all())
    if name == "dense":
        assert float((got - expected).abs().max()) <= DENSE_ATOL
    else:
        differ = (got != expected).any(dim=-1)
        assert float(differ.float().mean()) <= 1e-3
