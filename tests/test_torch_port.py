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
            continue  # 'cuda'/'torch' here, 'xla'/'pallas'/'dense' there
        assert getattr(port, field.name) == getattr(ref, field.name), (
            field.name)
    assert port.backend == "cuda" and tcfg.BACKENDS == ("cuda", "torch")
    for hw in ((1080, 1920), (128, 128), (7, 300)):
        assert port.grid_shape(*hw) == ref.grid_shape(*hw)


def test_import_leaves_jax_out():
    code = ("import sys, gsrast_tpu_torch, gsrast_tpu_torch.cli, "
            "gsrast_tpu_torch.render.blend; "
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


@pytest.mark.parametrize("argv", [["render", TRAINED_SMALL, "--mode",
                                   "pointcloud"], ["train", "--scene", "x"]])
def test_cli_unported_exits(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(argv)
