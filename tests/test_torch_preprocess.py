"""Scene loading, activation, camera and preprocess of `gsrast_tpu_torch`
against `gsrast_tpu`, on the same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
from gsrast_tpu_torch.ops.preprocess import preprocess

from torch_parity import (TRAINED_SMALL, camera_to_torch, front_camera,
                          jax_scene_arrays, scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

# float32 ops that round differently in the two frameworks (exp, log, sqrt
# of sums, reductions) stay within a few ulps: rel 1e-6 plus atol 1e-6 for
# values near zero.
RTOL, ATOL = 1e-6, 1e-6


def _assert_prep_close(p_ref, p_port):
    for name in ("mean2d", "depth", "conic", "color", "opacity"):
        a = np.asarray(getattr(p_ref, name))
        b = t2n(getattr(p_port, name))
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


def _count_int_mismatch(p_ref, p_port):
    """Integer outputs must agree except where a ceil/floor argument sits
    within rounding of an integer; returns the mismatching Gaussians."""
    bad = np.asarray(p_ref.radius) != t2n(p_port.radius)
    for r_ref, r_port in zip(p_ref.rect, p_port.rect):
        bad |= np.asarray(r_ref) != t2n(r_port)
    bad &= np.asarray(p_ref.radius) > 0  # culled rects are never read
    return np.flatnonzero(bad)


def _assert_ties_only(p_ref, p_port, idx, tile_h, tile_w):
    """Each mismatch must be a documented tie: some ceil/floor argument of
    the extent or rect lies within 1e-5 relative of an integer."""
    for i in idx:
        mx, my = np.asarray(p_ref.mean2d[i], np.float64)
        r = float(p_ref.radius[i])
        args = [(mx - r) / tile_w, (my - r) / tile_h,
                (mx + r + 1) / tile_w, (my + r + 1) / tile_h]
        near = [abs(a - round(a)) <= 1e-5 * max(1.0, abs(a)) for a in args]
        assert any(near), f"gaussian {i}: integer mismatch off any tie"


class TestScene:
    def test_load_ply_arrays_equal(self):
        ref = gs.load_ply(TRAINED_SMALL)
        port = gt.load_ply(TRAINED_SMALL)
        for name, arr in jax_scene_arrays(ref).items():
            np.testing.assert_array_equal(t2n(getattr(port, name)), arr,
                                          err_msg=name)

    def test_activations(self):
        ref = gs.load_ply(TRAINED_SMALL).activated()
        port = gt.load_ply(TRAINED_SMALL).activated()
        for name in ("means", "scales", "quats", "opacities", "sh"):
            np.testing.assert_allclose(t2n(getattr(port, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)

    def test_scene_module_and_bbox(self):
        port = gt.from_numpy(seeded_arrays(3, 50))
        assert {n for n, _ in port.named_parameters()} == {
            "means", "log_scales", "quats", "opacity_logits", "sh"}
        assert port.mask.dtype == torch.bool and not port.mask.requires_grad
        ref = gs.scene.gaussians.from_arrays(
            *(seeded_arrays(3, 50)[f] for f in
              ("means", "log_scales", "quats", "opacity_logits", "sh")))
        for a, b in zip(port.bbox(), ref.bbox()):
            np.testing.assert_array_equal(t2n(a), np.asarray(b))

    def test_random_scene_distributions(self):
        s = gt.random_scene(4000, np.random.default_rng(0), sh_degree=3,
                            scale_range=(0.002, 0.008))
        act = s.activated()
        assert t2n(s.means).min() >= -1.0 and t2n(s.means).max() < 1.0
        sc = t2n(act.scales)
        assert sc.min() >= 0.002 * (1 - 1e-6) and sc.max() <= 0.008 * 1.000001
        np.testing.assert_allclose(np.linalg.norm(t2n(act.quats), axis=-1),
                                   1.0, atol=1e-6)
        assert s.sh.shape == (4000, 16, 3)


class TestCamera:
    def test_auto_frame_matches(self):
        ref_scene = gs.load_ply(TRAINED_SMALL)
        port_scene = gt.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref_scene.bbox(), 160, 96)
        cam = gt.auto_frame(*port_scene.bbox(), 160, 96)
        np.testing.assert_allclose(t2n(cam.view), np.asarray(jcam.view),
                                   rtol=1e-6, atol=1e-6)
        for name in ("fov_x", "fov_y", "znear", "zfar"):
            assert float(getattr(cam, name)) == float(getattr(jcam, name))
        np.testing.assert_allclose(t2n(cam.full_projection()),
                                   np.asarray(jcam.full_projection()),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t2n(cam.position),
                                   np.asarray(jcam.position),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["sh3_aniso", "trained_small"])
def test_preprocess_matches(case):
    if case == "sh3_aniso":
        ref_scene, port_scene = scenes(
            seeded_arrays(11, 200, sh_degree=3, extent=2.5))
        jcam, cam = front_camera(128, 96)
        rcfg = gs.RenderConfig(tile_h=16, tile_w=32)
    else:
        ref_scene = gs.load_ply(TRAINED_SMALL)
        port_scene = gt.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref_scene.bbox(), 128, 128)
        cam = camera_to_torch(jcam)
        rcfg = gs.RenderConfig(tile_h=16, tile_w=32)
    p_ref = jax_preprocess(ref_scene.activated(), jcam, rcfg)
    p_port = preprocess(port_scene.activated(), cam,
                        gt.RenderConfig(tile_h=rcfg.tile_h,
                                        tile_w=rcfg.tile_w,
                                        sh_degree=rcfg.sh_degree))
    _assert_prep_close(p_ref, p_port)
    bad = _count_int_mismatch(p_ref, p_port)
    _assert_ties_only(p_ref, p_port, bad, rcfg.tile_h, rcfg.tile_w)
    assert len(bad) <= 2, f"{len(bad)} integer mismatches"
    n_vis = int(jnp.sum(p_ref.radius > 0))
    assert n_vis > 50
    if case == "sh3_aniso":
        assert n_vis < 200  # the frustum cull is exercised
