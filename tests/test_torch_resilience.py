"""Failure handling of `gsrast_tpu_torch.train.resilience`, mirroring the
reference's `tests/test_train.py::TestResilience`: NaN rollback, abort on a
persistent NaN, SIGTERM checkpoint and stop, heartbeats; and the CLI's
`train` on the data paths it runs under `run_resilient` (a COLMAP scene
written by the reference, a cameras.json directory, a target PNG)."""

import dataclasses
import os
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu import Camera as JaxCamera
from gsrast_tpu import RenderConfig as JaxRenderConfig
from gsrast_tpu.scene.gaussians import from_arrays
from gsrast_tpu.train import resilience as jax_resilience
from gsrast_tpu.train import trainer as jax_trainer
from gsrast_tpu_torch import cli
from gsrast_tpu_torch.render.api import auto_render_config, render
from gsrast_tpu_torch.scene.dataset import orbit_cameras, save_dataset
from gsrast_tpu_torch.train import checkpoint as ckpt
from gsrast_tpu_torch.train.resilience import (ResilienceConfig, all_finite,
                                               read_heartbeat, run_resilient)
from gsrast_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                            make_train_step)
from gsrast_tpu_torch.utils.image import save_png

from torch_parity import (SCENE_FIELDS, TRAINED_SMALL,
                          reference_colmap_fixture, t2n)

torch.set_num_threads(2)


def _loop_inputs():
    """A 48-Gaussian scene's render at 32x32 and, as the start of training,
    its raw arrays with means moved by N(0, 0.03^2): (arrays, camera,
    render config, target)."""
    target_scene = gt.random_scene(48, np.random.default_rng(1),
                                   scale_range=(0.05, 0.15))
    cam = gt.make_camera(gt.look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
                         1.0, 1.0, 32, 32)
    rcfg = auto_render_config(target_scene, cam, margin=1.5)
    with torch.no_grad():
        target = render(target_scene, cam, rcfg).image
    arrays = {f: t2n(p) for f, p in target_scene.param_groups().items()}
    arrays["means"] = arrays["means"] + 0.03 * np.random.default_rng(
        2).standard_normal(arrays["means"].shape)
    return arrays, cam, rcfg, target


def _loop_pieces():
    """The port's training on `_loop_inputs`, with densify and opacity
    resets off: (state, step_fn(state, i))."""
    arrays, cam, rcfg, target = _loop_inputs()
    tc = TrainConfig(densify_from=10**9, opacity_reset_every=10**9)
    state = init_train_state(gt.from_numpy(arrays), tc, 1.0)
    step = make_train_step(rcfg, tc, 1.0)
    return state, lambda st, i: step(st, cam, target)


def _reference_loop_pieces():
    """The reference's training on the same inputs, as its own
    `tests/test_train.py::TestResilience` drives it: (state, step_fn)."""
    arrays, cam, _, target = _loop_inputs()
    jcam = JaxCamera(view=jnp.asarray(t2n(cam.view)),
                     fov_x=jnp.float32(float(cam.fov_x)),
                     fov_y=jnp.float32(float(cam.fov_y)),
                     width=cam.width, height=cam.height)
    rcfg = JaxRenderConfig(tile_h=8, tile_w=16, max_per_tile=256,
                           tile_chunk=8, intersect_capacity_factor=16.0)
    tc = jax_trainer.TrainConfig(densify_from=10**9,
                                 opacity_reset_every=10**9)
    opt = jax_trainer.make_optimizer(tc, scene_extent=1.0)
    state = jax_trainer.init_train_state(
        from_arrays(*(arrays[f] for f in SCENE_FIELDS)), opt)
    step = jax.jit(jax_trainer.make_train_step(rcfg, tc, opt))
    jtarget = jnp.asarray(t2n(target))
    return state, lambda st, i: step(st, jcam, jtarget)


def test_config_defaults_equal_reference():
    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(
        jax_resilience.ResilienceConfig())


def test_nan_rollback_recovers(tmp_path):
    """The NaN injected after step 7 is rolled back to the checkpoint of
    step 5 and the run reaches step 12, as the reference's run does under
    the same config: the same log, final step and checkpoints on disk.
    Replayed deterministically, the port's run ends where an uninterrupted
    run ends."""
    runs = {}
    for side, (pieces, run) in {
            "port": (_loop_pieces, run_resilient),
            "reference": (_reference_loop_pieces,
                          jax_resilience.run_resilient)}.items():
        state, fn = pieces()
        logs = []
        rc_cls = (ResilienceConfig if side == "port"
                  else jax_resilience.ResilienceConfig)
        rc = rc_cls(ckpt_dir=str(tmp_path / side / "ck"), ckpt_every=5,
                    heartbeat_path=str(tmp_path / side / "hb.json"),
                    heartbeat_every=5, inject_nan_at_step=7)
        final, stopped = run(state, 12, fn, rc, log=logs.append)
        runs[side] = dict(
            stopped=stopped, step=int(final.step), logs=logs,
            ckpts=sorted(os.listdir(rc.ckpt_dir)),
            heartbeat=read_heartbeat(rc.heartbeat_path)["step"])
        assert rc.inject_nan_at_step == 7  # the caller's config is kept
    assert runs["port"] == runs["reference"]
    assert runs["port"]["logs"] == [
        "step 7: NON-FINITE state detected; rolling back to checkpoint "
        "step 5 (1/3)"]
    assert runs["port"]["step"] == 12 and not runs["port"]["stopped"]

    state, fn = _loop_pieces()
    final, _ = run_resilient(state, 12, fn, ResilienceConfig(
        ckpt_dir=str(tmp_path / "again"), ckpt_every=5,
        inject_nan_at_step=7), log=lambda s: None)
    assert final is state and all_finite(final)
    clean, fn_clean = _loop_pieces()
    for i in range(12):
        fn_clean(clean, i)
    for name, p in final.scene.param_groups().items():
        np.testing.assert_allclose(t2n(p), t2n(clean.scene.param_groups()[
            name]), rtol=1e-6, atol=1e-7, err_msg=name)


def test_nan_persistent_aborts(tmp_path):
    state, fn = _loop_pieces()

    def poisoned(st, i):
        metrics = fn(st, i)
        with torch.no_grad():
            st.scene.means.mul_(float("nan"))
        return metrics

    rc = ResilienceConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                          max_rollbacks=2)
    with pytest.raises(RuntimeError, match="non-finite"):
        run_resilient(state, 5, poisoned, rc, log=lambda s: None)


def test_non_finite_adam_moment_is_caught():
    state, fn = _loop_pieces()
    fn(state, 0)
    assert all_finite(state, torch.tensor(0.5))
    assert not all_finite(state, torch.tensor(float("inf")))
    st = state.optimizer.state[state.scene.quats]
    st["exp_avg_sq"][3, 1] = float("nan")
    assert not all_finite(state)


def test_preemption_checkpoints_and_stops(tmp_path):
    state, fn = _loop_pieces()

    def fn_with_sigterm(st, i):
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)  # simulated eviction
        return fn(st, i)

    rc = ResilienceConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=10**9,
                          heartbeat_path=str(tmp_path / "hb.json"))
    previous = signal.getsignal(signal.SIGTERM)
    final, stopped = run_resilient(state, 100, fn_with_sigterm, rc,
                                   log=lambda s: None)
    assert stopped and final.step == 4
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4
    assert read_heartbeat(str(tmp_path / "hb.json"))["step"] == 4
    assert signal.getsignal(signal.SIGTERM) is previous


def test_heartbeat_written_and_read_by_both(tmp_path):
    state, fn = _loop_pieces()
    hb = str(tmp_path / "hb.json")
    rc = ResilienceConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=3,
                          heartbeat_path=hb, heartbeat_every=2)
    seen = []

    def watched(st, i):
        seen.append(read_heartbeat(hb))
        return fn(st, i)

    run_resilient(state, 5, watched, rc, log=lambda s: None)
    # Read before step i: a beat lands whenever a step ends on a multiple
    # of heartbeat_every.
    assert [s and s["step"] for s in seen] == [None, None, 2, 2, 4]
    beat = jax_resilience.read_heartbeat(hb)
    assert beat == read_heartbeat(hb) and beat["step"] == 5
    assert beat["pid"] == os.getpid()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 5
    assert read_heartbeat(str(tmp_path / "missing.json")) is None


def _losses(out: str) -> list:
    return [float(x) for x in re.findall(r"loss=([0-9.eE+-]+|nan|inf)", out)]


def test_cli_train_on_colmap(tmp_path, capsys):
    """`train --scene colmap --data DIR` on a COLMAP scene written by the
    reference: SfM-point init, COLMAP cameras and photographs, 3 steps."""
    reference_colmap_fixture(tmp_path / "scene", n_views=2, wh=(64, 64))
    ck = tmp_path / "ck"
    state = cli.main(["train", "--scene", "colmap", "--data",
                      str(tmp_path / "scene"), "--steps", "3", "--device",
                      "cpu", "--ckpt-dir", str(ck), "--ckpt-every", "1000"])
    out = capsys.readouterr().out
    assert "initialized 200 gaussians from COLMAP SfM points" in out
    assert "dataset: 2 views 64x64" in out
    losses = _losses(out)  # steps 0 and 2: every 100th and the last
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert state.step == 3 and state.scene.sh_degree == 3
    assert read_heartbeat(str(ck / "heartbeat.json"))["step"] == 3
    assert sorted(p.name for p in ck.iterdir() if p.is_dir()) == [
        "step_00000000", "step_00000003"]


def test_cli_train_on_jpeg_colmap(tmp_path, capsys):
    """`train --data` on a COLMAP capture of JPEG photographs, 2 steps."""
    reference_colmap_fixture(tmp_path / "scene", n_views=2, wh=(64, 48),
                             ext=".jpg")
    state = cli.main(["train", "--scene", "colmap", "--data",
                      str(tmp_path / "scene"), "--steps", "2", "--device",
                      "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "dataset: 2 views 64x48" in out
    losses = _losses(out)
    assert len(losses) == 2 and np.all(np.isfinite(losses)), out
    assert state.step == 2


def test_cli_train_on_dataset_and_target(tmp_path, capsys):
    """`train --data <cameras.json dir>` and `train --target PNG`, 2 steps
    each from trained_small at 32x24 on the CPU."""
    scene = gt.load_ply(TRAINED_SMALL)
    mn, mx = (t2n(x) for x in scene.bbox())
    cams = orbit_cameras((mn + mx) / 2, float(np.linalg.norm(mx - mn)),
                         32, 24, 2)
    rcfg = auto_render_config(scene, cams[0])
    with torch.no_grad():
        images = [render(scene, c, rcfg).image for c in cams]
    save_dataset(str(tmp_path / "ds"), cams, images)
    save_png(images[1], str(tmp_path / "target.png"))
    for source in (["--data", str(tmp_path / "ds")],
                   ["--target", str(tmp_path / "target.png")]):
        state = cli.main(["train", "--scene", TRAINED_SMALL, *source,
                          "--steps", "2", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path / source[0][2:])])
        out = capsys.readouterr().out
        losses = _losses(out)
        assert len(losses) == 2 and np.all(np.isfinite(losses)), out
        assert state.step == 2
        assert ("dataset: 2 views 32x24" in out) == (source[0] == "--data")


def test_cli_train_colmap_errors(tmp_path):
    with pytest.raises(SystemExit, match="requires a COLMAP --data"):
        cli.main(["train", "--scene", "colmap", "--device", "cpu"])
    save_dataset(str(tmp_path / "ds"), [gt.auto_frame(
        np.zeros(3), np.ones(3), 8, 8)], [torch.zeros((8, 8, 3))])
    with pytest.raises(SystemExit, match="requires a COLMAP --data"):
        cli.main(["train", "--scene", "colmap", "--data",
                  str(tmp_path / "ds"), "--device", "cpu"])
