"""COLMAP ingestion of `gsrast_tpu_torch` against the reference's
`gsrast_tpu.scene.colmap`: a scene written by the reference (its PNGs by
PIL, with adaptive scanline filters) reads the same in both packages; the
SfM-point initialization matches; JPEG photographs read as in the
reference; the port's writer is the reference's byte for byte; and a
port-loaded camera renders the fixture's views."""

import os

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu.scene import colmap as jax_colmap
from gsrast_tpu_torch.scene import colmap

from torch_parity import reference_colmap_fixture, t2n

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    path = tmp_path_factory.mktemp("colmap")
    arrays = reference_colmap_fixture(path)
    return str(path), arrays


def test_readers_match_reference(fixture):
    path, _ = fixture
    sp = os.path.join(path, "sparse", "0")
    assert colmap.read_cameras_bin(os.path.join(sp, "cameras.bin")) == (
        jax_colmap.read_cameras_bin(os.path.join(sp, "cameras.bin")))
    ims = colmap.read_images_bin(os.path.join(sp, "images.bin"))
    ref = jax_colmap.read_images_bin(os.path.join(sp, "images.bin"))
    assert [im.name for im in ims] == [im.name for im in ref] == [
        "v00.png", "v01.png", "v02.png"]
    for a, b in zip(ims, ref):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        assert a.camera_id == b.camera_id
    for a, b in zip(colmap.read_points3d_bin(os.path.join(sp, "points3D.bin")),
                    jax_colmap.read_points3d_bin(
                        os.path.join(sp, "points3D.bin"))):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert colmap.is_colmap_dir(path) and not colmap.is_colmap_dir(sp + "/x")


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_colmap_matches_reference(fixture, downscale):
    """Intrinsics, views, fovs and images equal (both decode the same PNG
    bytes, the reference with PIL, the port with its own reader)."""
    path, _ = fixture
    ds, xyz, rgb = colmap.load_colmap(path, downscale=downscale)
    ref, rxyz, rrgb = jax_colmap.load_colmap(path, downscale=downscale)
    assert ds.num_frames == ref.num_frames == 3
    for cam, rcam in zip(ds.cameras, ref.cameras):
        assert (cam.width, cam.height) == (rcam.width, rcam.height) == (
            96 // downscale, 64 // downscale)
        np.testing.assert_array_equal(t2n(cam.view), np.asarray(rcam.view))
        assert float(cam.fov_x) == float(rcam.fov_x)
        assert float(cam.fov_y) == float(rcam.fov_y)
    assert ds.images.dtype == torch.float32
    np.testing.assert_array_equal(t2n(ds.images), ref.images)
    np.testing.assert_array_equal(xyz, rxyz)
    np.testing.assert_array_equal(rgb, rrgb)


def test_load_colmap_jpeg_matches_reference(tmp_path):
    """A capture whose photographs are JPEG loads as in the reference (the
    port sends them to PIL, as the reference reads every image)."""
    reference_colmap_fixture(tmp_path, n_views=2, ext=".jpg")
    ds, _, _ = colmap.load_colmap(str(tmp_path), downscale=2)
    ref, _, _ = jax_colmap.load_colmap(str(tmp_path), downscale=2)
    assert sorted(os.listdir(tmp_path / "images")) == ["v00.jpg", "v01.jpg"]
    assert ds.images.shape == (2, 32, 48, 3)
    np.testing.assert_array_equal(t2n(ds.images), ref.images)


@pytest.mark.parametrize("n", [300, 5000])
def test_init_scene_from_points_matches_reference(n):
    """The five arrays and the mask equal the reference's; 5,000 points
    take the 4,096-anchor branch, and the search runs in several chunks."""
    rng = np.random.default_rng(n)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    port = colmap.init_scene_from_points(xyz, rgb, capacity=n + 12)
    ref = jax_colmap.init_scene_from_points(xyz, rgb, capacity=n + 12)
    for field in ("means", "log_scales", "quats", "opacity_logits", "sh",
                  "mask"):
        np.testing.assert_array_equal(t2n(getattr(port, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert port.capacity == n + 12 and int(port.num_active()) == n


def test_writer_matches_reference_bytes_and_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    cams = {1: colmap.ColmapCamera("PINHOLE", 64, 48, 70.5, 71.25, 32, 24),
            2: colmap.ColmapCamera("PINHOLE", 32, 32, 40.0, 40.0, 16, 16)}
    ims = [colmap.ColmapImage(f"im{i}.png", colmap.rotmat_to_qvec(
        _rotation(rng)), rng.normal(size=3), 1 + i % 2) for i in range(4)]
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    port = colmap.write_colmap_bin(str(tmp_path / "port"), cams, ims, xyz,
                                   rgb)
    ref = jax_colmap.write_colmap_bin(str(tmp_path / "ref"), cams, ims, xyz,
                                      rgb)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(port, name), "rb") as a, open(
                os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    assert jax_colmap.read_cameras_bin(port + "/cameras.bin") == cams
    back = jax_colmap.read_images_bin(port + "/images.bin")
    for a, b in zip(back, ims):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
    bxyz, brgb = jax_colmap.read_points3d_bin(port + "/points3D.bin")
    np.testing.assert_array_equal(bxyz, xyz)
    np.testing.assert_array_equal(brgb * 255, (rgb * 255).astype(np.uint8))


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_rotmat_to_qvec_inverts_qvec_to_rotmat():
    rng = np.random.default_rng(5)
    mats = [_rotation(rng) for _ in range(50)] + [
        np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
        np.diag([-1.0, -1.0, 1.0]), np.eye(3)]
    for m in mats:
        q = colmap.rotmat_to_qvec(m)
        assert q[0] >= 0 and abs(np.linalg.norm(q) - 1) < 1e-12
        np.testing.assert_allclose(colmap.qvec_to_rotmat(q), m, atol=1e-12)


def test_port_camera_renders_fixture_views(fixture):
    """The qvec -> view reconstruction and the fov math: the port renders
    the fixture's scene from each port-loaded camera within 2.5/255 of the
    reference's 8-bit render, the reference test's own bound."""
    path, arrays = fixture
    ds, _, _ = colmap.load_colmap(path)
    scene = gt.from_numpy(arrays)
    for cam, img in zip(ds.cameras, ds.images):
        with torch.no_grad():
            got = gt.render(scene, cam, gt.auto_render_config(scene, cam))
        np.testing.assert_allclose(t2n(got.image), t2n(img), atol=2.5 / 255)
