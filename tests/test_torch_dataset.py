"""Multi-view datasets and PNG input of `gsrast_tpu_torch` against the
reference: cameras.json directories written by either package load in the
other, the orbit rig matches `gsrast_tpu.scene.dataset.orbit_cameras`, the
PNG, JPEG, palette and 16-bit files read as the reference reads them
(through PIL), and the `make-dataset` command."""

import json
import os
import re
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, UnidentifiedImageError

import gsrast_tpu_torch as gt
from gsrast_tpu.camera import Camera as JaxCamera
from gsrast_tpu.scene import dataset as jax_dataset
from gsrast_tpu.utils.image import load_png as jax_load_png
from gsrast_tpu_torch import cli
from gsrast_tpu_torch.scene import dataset
from gsrast_tpu_torch.utils.image import load_png, save_png

from torch_parity import TRAINED_SMALL, t2n

torch.set_num_threads(2)


def _pil_rgb(path) -> np.ndarray:
    """The reference's `load_png`."""
    return np.asarray(Image.open(path).convert("RGB")).astype(
        np.float32) / 255.0


def _images(n, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx + yy) / (w + h), xx / w, yy / h], -1)
    return [np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1)
            .astype(np.float32) for _ in range(n)]


def test_orbit_cameras_match_reference():
    center, radius = [0.1, -0.2, 0.3], 2.7
    port = dataset.orbit_cameras(center, radius, 40, 24, 5)
    ref = jax_dataset.orbit_cameras(center, radius, 40, 24, 5)
    for cam, rcam in zip(port, ref):
        # look_at in float32 on both sides: a few ulps of the unit axes.
        np.testing.assert_allclose(t2n(cam.view), np.asarray(rcam.view),
                                   atol=2e-6)
        assert float(cam.fov_x) == float(rcam.fov_x) == np.float32(1.2)
        assert (cam.width, cam.height) == (rcam.width, rcam.height)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cameras_json_loads_in_both_packages(tmp_path, writer):
    """Same cameras written by both packages: cameras.json byte for byte;
    the directory written by `writer` loads in both, views, fovs and images
    equal (the port's PNGs are filter 0, PIL's adaptive)."""
    imgs = _images(3)
    cams = dataset.orbit_cameras([0.0, 0.0, 0.0], 3.0, 40, 24, 3)
    jcams = [JaxCamera(view=jnp.asarray(t2n(c.view)),
                       fov_x=jnp.float32(float(c.fov_x)),
                       fov_y=jnp.float32(float(c.fov_y)), width=40, height=24)
             for c in cams]
    port_dir = dataset.save_dataset(str(tmp_path / "port"), cams,
                                    [torch.from_numpy(i) for i in imgs])
    ref_dir = jax_dataset.save_dataset(str(tmp_path / "ref"), jcams, imgs)
    with open(os.path.join(port_dir, "cameras.json"), "rb") as a, open(
            os.path.join(ref_dir, "cameras.json"), "rb") as b:
        assert a.read() == b.read()

    path = port_dir if writer == "port" else ref_dir
    port = dataset.load_dataset(path)
    ref = jax_dataset.load_dataset(path)
    assert port.num_frames == ref.num_frames == 3
    np.testing.assert_array_equal(t2n(port.images), ref.images)
    np.testing.assert_allclose(t2n(port.images), np.stack(imgs),
                               atol=0.5 / 255 + 1e-7)
    for cam, rcam in zip(port.cameras, ref.cameras):
        np.testing.assert_array_equal(t2n(cam.view), np.asarray(rcam.view))
        assert float(cam.fov_y) == float(rcam.fov_y)
        assert (cam.width, cam.height) == (40, 24)


def _write_png(path, arr: np.ndarray, color: int, filters) -> None:
    """An 8-bit PNG whose scanline y uses filter filters[y % len] (PNG spec
    section 9), so every filter's decoding is exercised."""
    h, w = arr.shape[:2]
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    rows = arr.reshape(h, w * bpp).astype(np.int32)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind, line = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        corner = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - corner
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - corner)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, corner))
        raw += bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,color", [("L", 0), ("RGB", 2), ("LA", 4),
                                        ("RGBA", 6)])
def test_load_png_matches_pil(tmp_path, mode, color):
    """PNGs written by PIL (its adaptive filters) and by an encoder that
    cycles through all five filters read as PIL reads them."""
    ch = len(mode)
    rng = np.random.default_rng(ch)
    yy, xx = np.mgrid[0:29, 0:37]
    arr = np.stack([(3 * xx + 2 * yy + 50 * c) % 256 for c in range(ch)], -1)
    arr = ((arr + rng.integers(0, 4, arr.shape)) % 256).astype(np.uint8)
    arr = arr[..., 0] if ch == 1 else arr
    pil = str(tmp_path / "pil.png")
    Image.fromarray(arr, mode=mode).save(pil)
    cycled = str(tmp_path / "cycled.png")
    _write_png(cycled, arr, color, filters=[0, 1, 2, 3, 4])
    for path in (pil, cycled):
        got = load_png(path)
        assert got.dtype == np.float32 and got.shape == (29, 37, 3)
        np.testing.assert_array_equal(got, _pil_rgb(path))


def test_load_png_reads_the_ports_own_png(tmp_path):
    img = _images(1, 31, 17)[0]
    path = save_png(torch.from_numpy(img), str(tmp_path / "own.png"))
    np.testing.assert_array_equal(load_png(path), _pil_rgb(path))


# Formats beside 8-bit PNG, written by PIL.
PIL_FORMATS = {
    "photo.jpg": lambda arr, p: Image.fromarray(arr).save(p, "JPEG"),
    "palette.png": lambda arr, p: Image.fromarray(arr).convert("P").save(p),
    "gray16.png": lambda arr, p: Image.fromarray(
        arr[..., 0].astype(np.uint16) * 257).save(p),
}


@pytest.mark.parametrize("name", sorted(PIL_FORMATS))
def test_load_png_reads_other_formats_like_the_reference(tmp_path, name):
    """A JPEG, a palette PNG and a 16-bit PNG load through PIL equal to the
    reference's `load_png`."""
    arr = (_images(1, 29, 37)[0] * 255).astype(np.uint8)
    path = str(tmp_path / name)
    PIL_FORMATS[name](arr, path)
    got = load_png(path)
    assert got.dtype == np.float32 and got.shape == (29, 37, 3)
    np.testing.assert_array_equal(got, jax_load_png(path))
    assert float(got.max()) > 0.5


def test_load_png_rejects_what_it_does_not_read(tmp_path):
    """A damaged PNG and a file that is no image raise what the reference
    raises (PIL's errors)."""
    good = str(tmp_path / "good.png")
    save_png(torch.zeros((4, 5, 3)), good)
    data = bytearray(open(good, "rb").read())
    data[45] ^= 0xFF  # inside the IDAT chunk: the zlib stream is broken
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    text = tmp_path / "notes.png"
    text.write_text("not an image")
    for path, err in ((bad, OSError), (text, UnidentifiedImageError)):
        for loader in (load_png, jax_load_png):
            with pytest.raises(err):
                loader(str(path))


def test_load_png_without_pil_names_the_file(tmp_path, monkeypatch):
    """Without PIL every file, PNG or JPEG, raises ImportError naming it."""
    arr = (_images(1, 8, 6)[0] * 255).astype(np.uint8)
    jpeg, png = str(tmp_path / "j.jpg"), str(tmp_path / "p.png")
    Image.fromarray(arr).save(jpeg, "JPEG")
    save_png(torch.from_numpy(arr / np.float32(255.0)), png)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
    for path in (jpeg, png):
        with pytest.raises(ImportError,
                           match=re.escape(f"reading {path} needs PIL")):
            load_png(path)


def test_make_dataset_cli(tmp_path, capsys):
    """`make-dataset` at 64x64 on the CPU: an orbit of 3 views that both
    packages load, whose images are the port's renders of those views."""
    out = str(tmp_path / "ds")
    cams = cli.main(["make-dataset", TRAINED_SMALL, "--out", out, "--views",
                     "3", "--width", "64", "--height", "64", "--device",
                     "cpu"])
    assert f"wrote 3 views to {out}" in capsys.readouterr().out
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)["frames"]) == 3
    ref = jax_dataset.load_dataset(out)
    port = dataset.load_dataset(out)
    np.testing.assert_array_equal(t2n(port.images), ref.images)
    scene = gt.load_ply(TRAINED_SMALL)
    with torch.no_grad():
        rcfg = gt.auto_render_config(scene, gt.auto_frame(*scene.bbox(), 64,
                                                          64), margin=1.5)
        for cam, img in zip(cams, port.images):
            want = gt.render(scene, cam, rcfg).image.clamp(0, 1)
            np.testing.assert_allclose(t2n(img), t2n(want),
                                       atol=0.5 / 255 + 1e-6)
    assert float(port.images.std()) > 0.01


def test_batch_cameras_and_images_match_reference(tmp_path):
    """`Dataset.batch_cameras` / `batch_images` against the reference's on
    the same directory: the stacked camera arrays (through
    `torch_parity.camera_batch_to_torch`) and images, and `camera_at`
    taking camera i back."""
    from torch_parity import camera_batch_to_torch

    cams = dataset.orbit_cameras([0.0, 0.0, 0.0], 2.5, 40, 24, 4)
    dataset.save_dataset(str(tmp_path), cams, _images(4))
    port = dataset.load_dataset(str(tmp_path))
    ref = jax_dataset.load_dataset(str(tmp_path))
    idx = [2, 0, 3]
    batch = port.batch_cameras(idx)
    expect = camera_batch_to_torch(ref.batch_cameras(idx))
    for f in ("view", "fov_x", "fov_y", "znear", "zfar"):
        np.testing.assert_array_equal(t2n(getattr(batch, f)),
                                      t2n(getattr(expect, f)), err_msg=f)
    assert (batch.width, batch.height) == (40, 24) == (expect.width,
                                                       expect.height)
    assert batch.view.shape == (3, 4, 4) and batch.fov_x.shape == (3,)
    np.testing.assert_array_equal(t2n(port.batch_images(idx)),
                                  np.asarray(ref.batch_images(idx)))
    one = dataset.camera_at(batch, 1)
    assert one.view.shape == (4, 4)
    np.testing.assert_array_equal(t2n(one.view), t2n(port.cameras[0].view))
    assert float(one.fov_y) == float(port.cameras[0].fov_y)
