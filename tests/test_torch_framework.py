"""The viewer's framework in `gsrast_tpu_torch` against `gsrast_tpu`: the
first-person controller and camera rays, the pose store's file, the
inspector's reports, the compositor, screenshots, profiling, the native
.ply codec, the `render`/`info`/`pose` commands and the four apps."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import camera as tcam
from gsrast_tpu_torch import cli
from gsrast_tpu_torch.apps.render_app import flythrough_views
from gsrast_tpu_torch.scene import native
from gsrast_tpu_torch.scene.ply import read_ply_raw
from gsrast_tpu_torch.utils import compositor, profiling
from gsrast_tpu_torch.utils.image import load_png, screenshot
from gsrast_tpu_torch.utils.inspector import (FrameStats, camera_report,
                                              goto_gaussian, peek_gaussian,
                                              scene_report)
from gsrast_tpu_torch.utils.posedb import PoseDB, Store

from torch_parity import (FIXTURES, TRAINED_SMALL, camera_to_torch,
                          front_camera, t2n)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_116K = os.path.join(FIXTURES, "trained_116k.ply")
CAM_ATOL = 1e-6   # camera and controller math, float32 both sides
PEEK_ATOL = 1e-5  # one Gaussian's preprocess state


# -- the first-person controller and camera rays ---------------------------

def _jax_flythrough(center, radius, frames, width, height):
    """The reference app's scripted session (`apps/render_app.py`) through
    the reference's controller."""
    from gsrast_tpu.camera import (fp_camera, fp_init, fp_look, fp_move,
                                   fp_speed)

    st = fp_init(center + np.array([0, 0, -max(radius, 1e-3)]),
                 yaw=np.pi / 2, speed=radius)
    script = ([("move", 1.0, 0.0)] * (frames // 2) + [("speed", 2.0)]
              + [("look", 40.0, -10.0), ("move", 0.0, 1.0)])
    views = []
    for op in script:
        if op[0] == "move":
            st = fp_move(st, forward=op[1], strafe=op[2], dt=1 / 30)
        elif op[0] == "look":
            st = fp_look(st, op[1], op[2])
        else:
            st = fp_speed(st, op[1])
        views.append(np.asarray(fp_camera(st, width, height).view))
    return views[:frames]


@pytest.mark.parametrize("frames", [4, 9])
def test_flythrough_script_matches_reference(frames):
    """Every view of `render_app --flythrough`'s script within 1e-6 (the
    script has frames // 2 + 3 steps, cut at `frames`)."""
    scene = gt.load_ply(TRAINED_SMALL)
    mn, mx = (t2n(x) for x in scene.bbox())
    center, radius = 0.5 * (mn + mx), float(np.linalg.norm(mx - mn))
    got = flythrough_views(center, radius, frames, 96, 64)
    expected = _jax_flythrough(center, radius, frames, 96, 64)
    assert len(got) == len(expected) == min(frames, frames // 2 + 3)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(t2n(g), e, atol=CAM_ATOL)


def test_controller_steps_match_reference():
    """fp_move (forward, strafe, both up conventions), fp_look past the
    pitch clamp, fp_speed and fp_camera's fields, within 1e-6."""
    import gsrast_tpu.camera as jc

    for invert_up in (True, False):
        js = jc.fp_init([0.1, -0.2, 0.3], yaw=0.4, pitch=0.2, speed=1.5,
                        invert_up=invert_up)
        ts = tcam.fp_init([0.1, -0.2, 0.3], yaw=0.4, pitch=0.2, speed=1.5,
                          invert_up=invert_up)
        for _ in range(3):
            js = jc.fp_move(jc.fp_look(js, 30.0, 250.0), 1.0, -1.0, 0.1)
            ts = tcam.fp_move(tcam.fp_look(ts, 30.0, 250.0), 1.0, -1.0, 0.1)
        js, ts = jc.fp_speed(js, 0.5), tcam.fp_speed(ts, 0.5)
        for f in ("eye", "yaw", "pitch", "speed"):
            np.testing.assert_allclose(t2n(getattr(ts, f)),
                                       np.asarray(getattr(js, f)),
                                       atol=CAM_ATOL, err_msg=f)
        assert float(ts.pitch) <= np.pi / 2 - 0.049
        jcam, cam = jc.fp_camera(js, 64, 48), tcam.fp_camera(ts, 64, 48)
        np.testing.assert_allclose(t2n(cam.view), np.asarray(jcam.view),
                                   atol=CAM_ATOL)
        np.testing.assert_allclose(float(cam.fov_x), float(jcam.fov_x),
                                   atol=CAM_ATOL)
        assert (cam.width, cam.height) == (64, 48)


@pytest.mark.parametrize("which", ["front", "debug", "yaw_pitch"])
def test_camera_rays_match_reference(which):
    """Ray origins and directions within 1e-6, on the front camera, the
    frozen debug pose and a yaw/pitch pose."""
    import gsrast_tpu.camera as jc

    if which == "front":
        jcam, cam = front_camera(40, 30)
    elif which == "debug":
        jcam, cam = jc.debug_camera(48, 27), tcam.debug_camera(48, 27)
        np.testing.assert_allclose(t2n(cam.view), np.asarray(jcam.view),
                                   atol=CAM_ATOL)
    else:
        jcam = jc.Camera(view=jc.from_yaw_pitch([0.5, 0.1, -2.0], 1.1, 0.3),
                         fov_x=1.2, fov_y=1.0, width=33, height=21)
        view = tcam.from_yaw_pitch([0.5, 0.1, -2.0], 1.1, 0.3)
        np.testing.assert_allclose(t2n(view), np.asarray(jcam.view),
                                   atol=CAM_ATOL)
        cam = camera_to_torch(jcam)
    (jo, jd), (o, d) = jc.camera_rays(jcam), tcam.camera_rays(cam)
    assert o.shape == d.shape == (jcam.height, jcam.width, 3)
    np.testing.assert_allclose(t2n(o), np.asarray(jo), atol=CAM_ATOL)
    np.testing.assert_allclose(t2n(d), np.asarray(jd), atol=CAM_ATOL)


# -- the pose store ----------------------------------------------------------

def _fill(store_cls, db_cls, path, cameras):
    store = store_cls(str(path))
    store.put("t", "__hidden", 1)
    store.put("t", "visible", 2)
    db = db_cls(store=store)
    for name, cam in cameras.items():
        db.save(name, cam)
    db.delete("gone")


def test_pose_store_file_equal_and_cross_loaded(tmp_path):
    """The same operations write byte-equal files in both packages; each
    package reads the other's poses exactly, and iteration skips the
    hidden keys."""
    import gsrast_tpu as gs
    from gsrast_tpu.utils.posedb import PoseDB as JaxPoseDB
    from gsrast_tpu.utils.posedb import Store as JaxStore

    from gsrast_tpu.camera import debug_camera

    jscene = gs.load_ply(TRAINED_SMALL)
    jcams = {"home": gs.auto_frame(*jscene.bbox(), 96, 64),
             "front": front_camera(40, 30)[0], "gone": debug_camera()}
    _fill(JaxStore, JaxPoseDB, tmp_path / "ref.json", jcams)
    _fill(Store, PoseDB, tmp_path / "port.json",
          {k: camera_to_torch(c) for k, c in jcams.items()})
    assert ((tmp_path / "ref.json").read_bytes()
            == (tmp_path / "port.json").read_bytes())

    port_db, ref_db = (PoseDB(path=str(tmp_path / "ref.json")),
                       JaxPoseDB(path=str(tmp_path / "port.json")))
    assert port_db.names() == ref_db.names() == ["front", "home"]
    assert [k for k, _ in port_db.store.iterate("t")] == ["visible"]
    assert [k for k, _ in port_db.store.iterate("t", include_hidden=True)
            ] == ["__hidden", "visible"]
    for name in ("home", "front"):
        cam, jcam = port_db.load(name), ref_db.load(name)
        np.testing.assert_array_equal(t2n(cam.view), np.asarray(jcam.view))
        for f in ("fov_x", "fov_y", "znear", "zfar"):
            assert float(getattr(cam, f)) == float(getattr(jcam, f)), f
        assert (cam.width, cam.height) == (jcam.width, jcam.height)
    assert port_db.load("gone") is None and not port_db.delete("gone")


def test_pose_dict_roundtrip():
    cam = tcam.debug_camera(64, 48)
    back = tcam.pose_from_dict(json.loads(json.dumps(tcam.pose_to_dict(cam))))
    assert torch.equal(back.view, cam.view) and back.width == 64
    assert float(back.zfar) == float(cam.zfar)


# -- the inspector -----------------------------------------------------------

def _padded_pair():
    """trained_small padded to 2,100 rows (100 dead), in both packages."""
    import gsrast_tpu as gs
    from gsrast_tpu.scene.gaussians import pad_to_capacity

    ref = pad_to_capacity(gs.load_ply(TRAINED_SMALL), 2100)
    return ref, gt.from_numpy({f: np.asarray(getattr(ref, f)) for f in (
        "means", "log_scales", "quats", "opacity_logits", "sh", "mask")})


def test_scene_report_equal():
    """Equal field for field; the centre, a float32 sum over 2,000 rows
    taken in another order, within 1e-6."""
    from gsrast_tpu.utils.inspector import scene_report as jax_report

    ref, port = _padded_pair()
    got, expected = scene_report(port), jax_report(ref)
    assert got["num_active"] == expected["num_active"] == 2000
    assert got["capacity"] == 2100
    np.testing.assert_allclose(got.pop("center"), expected.pop("center"),
                               atol=1e-6)
    assert json.dumps(got, sort_keys=True) == json.dumps(expected,
                                                          sort_keys=True)


@pytest.mark.parametrize("index", [0, 7, 1999, 2050])
def test_peek_gaussian_matches_reference(index):
    """Within 1e-5 (integers exact), live and dead rows."""
    import gsrast_tpu as gs
    from gsrast_tpu.utils.inspector import peek_gaussian as jax_peek

    ref, port = _padded_pair()
    jcam = gs.auto_frame(*ref.bbox(), 96, 64)
    got = peek_gaussian(port, camera_to_torch(jcam), index)
    expected = jax_peek(ref, jcam, index)
    assert got.keys() == expected.keys()
    for key in ("index", "radius", "tiles_touched", "rect"):
        assert got[key] == expected[key], key
    for key in ("depth", "mean2d", "conic", "color"):
        np.testing.assert_allclose(got[key], expected[key], atol=PEEK_ATOL,
                                   err_msg=key)
    for key, value in expected["raw"].items():
        np.testing.assert_allclose(got["raw"][key], value, atol=PEEK_ATOL)


def test_camera_report_and_goto_match_reference():
    import gsrast_tpu as gs
    from gsrast_tpu.utils.inspector import camera_report as jax_cam_report
    from gsrast_tpu.utils.inspector import goto_gaussian as jax_goto

    ref, port = _padded_pair()
    jcam = gs.auto_frame(*ref.bbox(), 96, 64)
    cam = camera_to_torch(jcam)
    got, expected = camera_report(cam), jax_cam_report(jcam)
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        np.testing.assert_allclose(got[key], value, atol=CAM_ATOL,
                                   rtol=1e-6, err_msg=key)
    moved = goto_gaussian(port, cam, 5, distance=0.5)
    np.testing.assert_allclose(t2n(moved.view),
                               np.asarray(jax_goto(ref, jcam, 5, 0.5).view),
                               atol=CAM_ATOL)


def test_frame_stats():
    stats = FrameStats(window_seconds=100.0)
    assert stats.report()["frames"] == 0
    for dt in (0.01, 0.01, 0.02, 0.01, 0.01):
        stats.record(dt, pixels=1000)
    rep = stats.report()
    assert rep["frames"] == 5
    assert rep["fps"] == pytest.approx(1 / 0.012)
    assert rep["mpixels_per_s"] == pytest.approx(5000 / 0.06 / 1e6)
    stats.clear()
    assert stats.report()["frames"] == 0


# -- the compositor, screenshots, profiling ---------------------------------

def test_compositor_functions_equal_reference():
    """solid, resize_nearest, blit (inside, clipped, off the target, scaled),
    overlay and a nested RenderStack give the reference's images exactly."""
    import jax.numpy as jnp
    from gsrast_tpu.utils import compositor as jcomp

    rng = np.random.default_rng(0)
    parent = rng.random((10, 12, 3)).astype(np.float32)
    child = rng.random((4, 5, 3)).astype(np.float32)
    rgba = rng.random((3, 4, 4)).astype(np.float32)
    tp, tc, tr = (torch.from_numpy(x) for x in (parent, child, rgba))
    jp, jch, jr = (jnp.asarray(x) for x in (parent, child, rgba))

    def same(got, expected):
        np.testing.assert_array_equal(t2n(got), np.asarray(expected))

    same(compositor.solid(3, 4, (0.5, 0.25, 1.0)),
         jcomp.solid(3, 4, (0.5, 0.25, 1.0)))
    same(compositor.resize_nearest(tc, 7, 3), jcomp.resize_nearest(jch, 7, 3))
    for y, x, scale in ((2, 3, None), (8, 9, None), (-2, -3, None),
                        (20, 0, None), (1, 1, (6, 8))):
        same(compositor.blit(tp, tc, y, x, scale_to=scale),
             jcomp.blit(jp, jch, y, x, scale_to=scale))
    same(compositor.overlay(tp, tr, 8, 10), jcomp.overlay(jp, jr, 8, 10))
    stacks = []
    for mod, img in ((compositor, tc), (jcomp, jch)):
        stack = mod.RenderStack(8, 9, clear=(0.5, 0.0, 0.0))
        stack.push(4, 5, y=2, x=3, clear=(0.0, 1.0, 0.0))
        stack.draw(img[:2, :2])
        stack.pop()
        stack.draw(lambda t, m=mod, i=img: m.blit(t, i, y=5, x=6,
                                                  scale_to=(2, 2)))
        stacks.append(stack.image)
    same(*stacks)
    assert torch.equal(tp, torch.from_numpy(parent))  # inputs unchanged


def test_screenshot_timestamped(tmp_path):
    img = torch.rand(4, 5, 3, generator=torch.Generator().manual_seed(0))
    path = screenshot(img, str(tmp_path), prefix="shot")
    name = os.path.basename(path)
    assert name.startswith("shot_") and name.endswith(".png")
    assert len(name) == len("shot_YYYYmmdd_HHMMSS.png")
    np.testing.assert_allclose(load_png(path), t2n(img), atol=0.5 / 255)


def test_profiling_on_the_cpu(tmp_path):
    """A profiler trace written as Chrome JSON and the memory report
    without a card."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    if not torch.cuda.is_available():
        assert profiling.device_memory_report() == [{"device": "cpu"}]


# -- the native .ply codec ---------------------------------------------------

@pytest.mark.parametrize("fixture", [TRAINED_SMALL, TRAINED_116K])
def test_native_reader_equals_numpy_reader(fixture):
    """The codec's columns equal the numpy reader's byte for byte, in the
    same order; `read_ply_raw` takes the codec for a path."""
    with open(fixture, "rb") as f:
        expected = read_ply_raw(f.read())  # bytes: the numpy reader
    got = native.read_ply_columns(fixture)
    assert list(got) == list(expected)
    for name, col in expected.items():
        assert got[name].dtype == np.float32
        assert got[name].tobytes() == col.tobytes(), name
    via_path = read_ply_raw(fixture)
    assert all(via_path[k].tobytes() == v.tobytes() for k, v in got.items())


def test_native_write_round_trip(tmp_path):
    """Columns written by the codec read back equal through both readers,
    and load as the same scene."""
    cols = native.read_ply_columns(TRAINED_SMALL)
    path = str(tmp_path / "copy.ply")
    native.write_ply_columns(path, cols)
    with open(path, "rb") as f:
        by_numpy = read_ply_raw(f.read())
    for reader in (by_numpy, native.read_ply_columns(path)):
        assert list(reader) == list(cols)
        assert all(reader[k].tobytes() == v.tobytes()
                   for k, v in cols.items())
    a, b = gt.load_ply(TRAINED_SMALL), gt.load_ply(path)
    for f in ("means", "log_scales", "quats", "opacity_logits", "sh"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_ascii_and_big_endian_take_the_numpy_path(tmp_path):
    cols = {"x": np.float32([1.5, -2.0]), "y": np.float32([0.25, 3.0])}
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                         "property float x\nproperty float y\nend_header\n"
                         "1.5 0.25\n-2.0 3.0\n")
    big = tmp_path / "b.ply"
    big.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 2\n"
                    b"property float x\nproperty float y\nend_header\n"
                    + np.stack([cols["x"], cols["y"]], 1).astype(">f4")
                    .tobytes())
    for path in (ascii_ply, big):
        raw = read_ply_raw(str(path))
        for k, v in cols.items():
            np.testing.assert_array_equal(raw[k], v)
        with pytest.raises(ValueError, match="native PLY reader"):
            native.read_ply_columns(str(path))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    falls back."""
    bad = tmp_path / "plyio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.load()
    finally:
        native.load.cache_clear()
    assert not any((tmp_path / "build").glob("*.so"))


# -- the commands ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["pointcloud", "ellipsoids"])
def test_cli_render_modes(mode, tmp_path, capsys):
    """`render --mode` on the CPU writes the renderer's image."""
    from gsrast_tpu_torch.viz.ellipsoids import render_ellipsoids
    from gsrast_tpu_torch.viz.pointcloud import render_pointcloud

    out = tmp_path / f"{mode}.png"
    img = cli.main(["render", TRAINED_SMALL, "--mode", mode, "--width", "64",
                    "--height", "48", "--out", str(out), "--device", "cpu"])
    assert f"{mode}: 64x48 on cpu" in capsys.readouterr().out
    scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*scene.bbox(), 64, 48)
    draw = render_pointcloud if mode == "pointcloud" else render_ellipsoids
    with torch.no_grad():
        expected = draw(scene.activated(), cam)
    assert torch.equal(img, expected)
    np.testing.assert_allclose(load_png(str(out)), t2n(expected),
                               atol=0.5 / 255)


def test_cli_render_dense_backend(tmp_path):
    img = cli.main(["render", TRAINED_SMALL, "--backend", "dense", "--width",
                    "32", "--height", "24", "--out", str(tmp_path / "d.png"),
                    "--device", "cpu"])
    scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*scene.bbox(), 32, 24)
    with torch.no_grad():
        tiled = gt.render(scene, cam, gt.auto_render_config(scene, cam)).image
    assert img.shape == (24, 32, 3)
    assert float((img - tiled).abs().max()) < 1e-4


def test_cli_pose_commands_and_render_pose(tmp_path, capsys):
    """pose save/list/show/delete, then `render --pose` gives the
    auto-framed image bit for bit; a missing pose exits."""
    store = str(tmp_path / "store.json")
    common = ["--store", store, "--device", "cpu"]
    cam = cli.main(["pose", "save", "home", "--scene", TRAINED_SMALL,
                    "--width", "64", "--height", "48", *common])
    assert cli.main(["pose", "list", *common]) == ["home"]
    shown = cli.main(["pose", "show", "home", *common])
    assert shown == tcam.pose_to_dict(cam)
    framed = cli.main(["render", TRAINED_SMALL, "--width", "64", "--height",
                       "48", "--out", str(tmp_path / "a.png"),
                       "--device", "cpu"])
    posed = cli.main(["render", TRAINED_SMALL, "--pose", "home", "--width",
                      "64", "--height", "48", "--out",
                      str(tmp_path / "b.png"), *common])
    assert torch.equal(framed, posed)
    with pytest.raises(SystemExit, match="'nope' not found"):
        cli.main(["render", TRAINED_SMALL, "--pose", "nope", *common])
    assert cli.main(["pose", "delete", "home", *common]) is True
    assert cli.main(["pose", "show", "home", *common]) is None
    assert cli.main(["pose", "list", *common]) == []
    capsys.readouterr()


def test_cli_info(capsys):
    """`info --gaussian 0` prints the reports as JSON."""
    report = cli.main(["info", TRAINED_SMALL, "--gaussian", "0", "--width",
                       "64", "--height", "48", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["scene"]["num_active"] == 2000
    assert printed["camera"]["width"] == 64
    assert printed["gaussian"]["index"] == 0
    assert printed["scene"] == report["scene"]


def test_cli_train_from_pose(tmp_path, capsys):
    """`train --pose` fits the scene's render from the stored camera."""
    store = str(tmp_path / "store.json")
    cli.main(["pose", "save", "side", "--scene", TRAINED_SMALL, "--width",
              "48", "--height", "32", "--store", store, "--device", "cpu"])
    state = cli.main(["train", "--scene", TRAINED_SMALL, "--steps", "1",
                      "--pose", "side", "--store", store, "--width", "48",
                      "--height", "32", "--ckpt-dir",
                      str(tmp_path / "ck"), "--device", "cpu"])
    assert state.step == 1 and "step 0: loss=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not found"):
        cli.main(["train", "--scene", TRAINED_SMALL, "--pose", "gone",
                  "--store", store, "--device", "cpu"])


# -- the apps ----------------------------------------------------------------

APPS = {
    "basic": (["{tmp}/basic.png"], "basic: wrote"),
    "fbtest": (["{tmp}/fb.png"], "fbtest: wrote"),
    "spheretrace": (["--out", "{tmp}/st.png"], "projected axes"),
    "render_app": ([TRAINED_SMALL, "--frames", "2", "--width", "48",
                    "--height", "32", "--outdir", "{tmp}/frames",
                    "--save-pose", "app", "--store", "{tmp}/store.json"],
                   "frames: {'frames': 2"),
}


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_runs_on_the_cpu(app, tmp_path):
    """`python -m gsrast_tpu_torch.apps.<app> --device cpu` in its own
    process."""
    args, expected = APPS[app]
    args = [a.format(tmp=tmp_path) for a in args]
    proc = subprocess.run(
        [sys.executable, "-m", f"gsrast_tpu_torch.apps.{app}", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expected in proc.stdout, proc.stdout[-2000:]
    assert any(tmp_path.rglob("*.png"))


def test_spheretrace_diagnostics_match_reference(tmp_path):
    """The app's projection diagnostics against the reference's formulas on
    the same ellipsoid."""
    import jax.numpy as jnp
    import gsrast_tpu.camera as jc
    from gsrast_tpu.ops.covariance import compute_cov2d, compute_cov3d
    from gsrast_tpu.ops.projection import to_camera
    from gsrast_tpu_torch.apps import spheretrace

    got = spheretrace.main(["--pos", "0.2", "-0.1", "0.3", "--out",
                            str(tmp_path / "st.png"), "--device", "cpu"])
    quat = spheretrace.axis_angle_quat([0.0, 1.0, 0.0], 30.0)
    rot = np.asarray(jc.Camera(view=jc.look_at(jnp.array([0.0, 0.0, -3.0]),
                                               jnp.asarray([0.2, -0.1, 0.3])),
                               fov_x=1.2, fov_y=1.0, width=512, height=512)
                     .view)
    jcam = jc.Camera(view=jnp.asarray(rot), fov_x=jnp.float32(1.2),
                     fov_y=jnp.float32(1.0), width=512, height=512)
    means = jnp.asarray([[0.2, -0.1, 0.3]], jnp.float32)
    cov6 = compute_cov3d(jnp.asarray([[0.6, 0.3, 0.15]], jnp.float32),
                         jnp.asarray(quat[None]))
    cov2d = np.asarray(compute_cov2d(
        to_camera(means, jcam.view), cov6, jcam.view[:3, :3], jcam.focal_x,
        jcam.focal_y, jcam.tan_fov_x, jcam.tan_fov_y))[0]
    np.testing.assert_allclose(got["cov2d"], cov2d, rtol=1e-5)
    np.testing.assert_allclose(got["cov3d"], np.asarray(cov6)[0], atol=1e-6)
    assert got["image"].shape == (512, 512, 3)
