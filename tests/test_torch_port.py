"""Package-level checks of `gsrast_tpu_torch`: constants and config equal
the reference's, the package stays free of JAX, and the CLI renders."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu.config as jcfg
import gsrast_tpu_torch as gt
import gsrast_tpu_torch.config as tcfg
from gsrast_tpu_torch import cli
from gsrast_tpu.utils.image import load_png

from torch_parity import TRAINED_SMALL, t2n

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_constants_equal_reference():
    names = ("PI", "EPSILON", "DEFAULT_NEAR", "DEFAULT_FAR",
             "DEFAULT_FOV_DEG", "DEFAULT_WIDTH", "DEFAULT_HEIGHT",
             "NUM_CHANNELS", "ALPHA_MIN", "ALPHA_MAX", "TRANSMITTANCE_MIN",
             "COV2D_DILATION", "NDC_CULL_MARGIN", "NEAR_CULL_DEPTH",
             "GAUSSIAN_EXTENT_SIGMA")
    for name in names:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_render_config_defaults_equal_reference():
    port, ref = tcfg.RenderConfig(), jcfg.RenderConfig()
    for field in dataclasses.fields(port):
        if field.name == "backend":
            continue  # 'cuda'/'torch'/'autograd' here, 'pallas'/'xla' there
        assert getattr(port, field.name) == getattr(ref, field.name), (
            field.name)
    assert port.backend == "cuda"
    assert tcfg.BACKENDS == ("cuda", "torch", "autograd", "dense")
    for n in (0, 1, 100, 1_000_000):
        assert port.capacity(n) == ref.capacity(n)
    assert port.padded_shape(1080, 1920) == ref.padded_shape(1080, 1920)
    for hw in ((1080, 1920), (128, 128), (7, 300)):
        assert port.grid_shape(*hw) == ref.grid_shape(*hw)


def test_import_leaves_jax_out():
    code = ("import sys, gsrast_tpu_torch, gsrast_tpu_torch.cli, "
            "gsrast_tpu_torch.render.blend, gsrast_tpu_torch.scene.ply, "
            "gsrast_tpu_torch.train.loss, gsrast_tpu_torch.train.densify, "
            "gsrast_tpu_torch.train.trainer, "
            "gsrast_tpu_torch.train.checkpoint, "
            "gsrast_tpu_torch.train.resilience, "
            "gsrast_tpu_torch.scene.colmap, gsrast_tpu_torch.scene.dataset, "
            "gsrast_tpu_torch.diag.bisect_bwd, "
            "gsrast_tpu_torch.render.dense, gsrast_tpu_torch.viz.pointcloud, "
            "gsrast_tpu_torch.viz.ellipsoids, gsrast_tpu_torch.utils.posedb, "
            "gsrast_tpu_torch.utils.inspector, "
            "gsrast_tpu_torch.utils.compositor, "
            "gsrast_tpu_torch.utils.profiling, gsrast_tpu_torch.scene.native, "
            "gsrast_tpu_torch.apps.basic, gsrast_tpu_torch.apps.fbtest, "
            "gsrast_tpu_torch.apps.spheretrace, "
            "gsrast_tpu_torch.apps.render_app, gsrast_tpu_torch.benchmark, "
            "gsrast_tpu_torch.diag.scene_stats, "
            "gsrast_tpu_torch.diag.tile_sweep, "
            "gsrast_tpu_torch.diag.make_trained_fixture, "
            "gsrast_tpu_torch.parallel.mesh, gsrast_tpu_torch.parallel.comm, "
            "gsrast_tpu_torch.parallel.sharded, "
            "gsrast_tpu_torch.diag.multihost_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gsrast_tpu.')) or m == 'gsrast_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_render_writes_png(tmp_path, capsys):
    out = tmp_path / "render.png"
    cli.main(["render", TRAINED_SMALL, "--width", "96", "--height", "64",
              "--out", str(out), "--device", "cpu"])
    assert "96x64 on cpu" in capsys.readouterr().out
    img = load_png(str(out))
    scene = gt.load_ply(TRAINED_SMALL)
    with torch.inference_mode():
        cam = gt.auto_frame(*scene.bbox(), 96, 64)
        ref = gt.render(scene, cam, gt.auto_render_config(scene, cam)).image
    np.testing.assert_allclose(img, np.clip(t2n(ref), 0, 1), atol=0.5 / 255)
    assert img.max() > 0.1


@pytest.mark.parametrize("argv", [["train", "--scene", TRAINED_SMALL,
                                   "--dist", "localhost:1234,2,0"]])
def test_cli_unported_exits(argv, monkeypatch):
    """`train --dist` is ported: without a card it exits for the card, as
    every command does, and not as an unported option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device") as exc:
        cli.main(argv)
    assert "not ported" not in str(exc.value)


DIST = ["--dist", "localhost:29999,4,3", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["render", TRAINED_SMALL], ["info", TRAINED_SMALL], ["pose", "list"],
    ["train", "--scene", TRAINED_SMALL], ["make-dataset", TRAINED_SMALL,
                                          "--out", "ds"], ["bench"]])
def test_cli_dist_parses_on_every_command(argv, monkeypatch):
    """Every command takes --dist COORD:PORT,NPROCS,RANK and bootstraps
    with it before any work (`initialize_distributed`, stubbed here)."""
    seen = []

    def init(coord, nprocs, rank, backend=None, device=None):
        seen.append((coord, nprocs, rank, backend, device))
        raise RuntimeError("bootstrapped")

    monkeypatch.setattr("gsrast_tpu_torch.parallel.mesh."
                        "initialize_distributed", init)
    with pytest.raises(RuntimeError, match="bootstrapped"):
        cli.main(argv + DIST)
    assert seen == [("localhost:29999", 4, 3, None, "cpu")]


def test_cli_dist_bootstrap_rules(monkeypatch):
    """A malformed --dist exits; one process is a no-op; the backend rule:
    gloo for CPU ranks and for more ranks than cards, NCCL for one rank a
    card."""
    from gsrast_tpu_torch.parallel import mesh

    with pytest.raises(SystemExit, match="COORD:PORT,NPROCS,RANK"):
        cli.main(["pose", "list", "--dist", "localhost:1,two,0", "--device",
                  "cpu"])
    assert mesh.initialize_distributed("localhost:1", 1, 0) is None
    assert mesh.choose_backend("cpu", 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.choose_backend("cuda", 2)[0] == "gloo"
    assert mesh.choose_backend("cuda", 1)[0] == "nccl"


@pytest.mark.parametrize("argv", [["render", TRAINED_SMALL],
                                  ["train", "--scene", TRAINED_SMALL],
                                  ["make-dataset", TRAINED_SMALL, "--out",
                                   "ds"],
                                  ["render", TRAINED_SMALL, "--mode",
                                   "ellipsoids"],
                                  ["info", TRAINED_SMALL],
                                  ["pose", "list"],
                                  ["bench", "--n", "1000"]])
def test_cli_without_a_card_exits_unless_cpu(argv, monkeypatch):
    """--device defaults to cuda: with no card the command exits with a
    clear error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        cli.main(argv)


def test_cli_train_runs_and_resumes(tmp_path, capsys):
    """`python -m gsrast_tpu_torch train` on the CPU: two steps with a
    checkpoint and a saved .ply, then a resume to step 3."""
    ckpts, ply = tmp_path / "ckpts", tmp_path / "trained.ply"
    argv = ["train", "--scene", TRAINED_SMALL, "--steps", "2", "--width",
            "64", "--height", "64", "--device", "cpu", "--ckpt-dir",
            str(ckpts), "--ckpt-every", "1", "--save-ply", str(ply)]
    state = cli.main(argv)
    out = capsys.readouterr().out
    assert state.step == 2 and "step 0: loss=" in out and "step 1:" in out
    # run_resilient saves at the start, as the reference's does.
    assert sorted(p.name for p in ckpts.iterdir() if p.is_dir()) == [
        "step_00000000", "step_00000001", "step_00000002"]
    assert (ckpts / "heartbeat.json").exists()
    saved = gt.load_ply(str(ply))
    assert saved.capacity == state.scene.capacity
    assert bool(torch.isfinite(saved.means).all())
    np.testing.assert_array_equal(t2n(saved.sh), t2n(state.scene.sh))

    argv[argv.index("--steps") + 1] = "3"
    state = cli.main(argv + ["--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert state.step == 3
