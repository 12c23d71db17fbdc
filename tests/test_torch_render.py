"""The whole forward slice of `gsrast_tpu_torch` (auto config -> preprocess
-> plan -> sort-pack -> blend -> image) against the reference's
`render_tiled_pallas` (Pallas blend in interpret mode on the CPU)."""

import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.render.api import auto_render_config as jax_auto_config
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.utils.image import load_png

from torch_parity import (GOLDEN, TRAINED_SMALL, camera_to_torch,
                          front_camera, scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

# Image and final_t: per-pixel sums of up to a few hundred float32 terms
# whose inputs differ by a few ulps between the frameworks (exp, log, sqrt);
# 3e-5, as the reference's own trained-scene backend comparison uses.
ATOL = 3e-5


def _case(case):
    if case == "trained_small":
        ref_scene = gs.load_ply(TRAINED_SMALL)
        port_scene = gt.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref_scene.bbox(), 128, 128)
        cam = camera_to_torch(jcam)
        background = (0.0, 0.0, 0.0)
    else:
        ref_scene, port_scene = scenes(seeded_arrays(21, 120, sh_degree=3))
        jcam, cam = front_camera(96, 64)
        background = (0.1, 0.2, 0.3)
    jcfg = jax_auto_config(ref_scene, jcam, backend="pallas").replace(
        background=background)
    pcfg = gt.auto_render_config(port_scene, cam).replace(
        background=background)
    return ref_scene, port_scene, jcam, cam, jcfg, pcfg


@pytest.mark.parametrize("case", ["trained_small", "sh3_background"])
def test_render_matches_reference(case):
    ref_scene, port_scene, jcam, cam, jcfg, pcfg = _case(case)
    assert (pcfg.tile_h, pcfg.tile_w, pcfg.tiers) == (
        jcfg.tile_h, jcfg.tile_w, jcfg.tiers)
    assert pcfg.backend == "torch"
    ref = render_tiled_pallas(ref_scene.activated(), jcam, jcfg)
    with torch.inference_mode():
        out = gt.render(port_scene, cam, pcfg)
    assert out.image.shape == (cam.height, cam.width, 3)
    np.testing.assert_allclose(t2n(out.image), np.asarray(ref.image),
                               atol=ATOL)
    np.testing.assert_allclose(t2n(out.final_t), np.asarray(ref.final_t),
                               atol=ATOL)
    np.testing.assert_array_equal(t2n(out.n_contrib),
                                  np.asarray(ref.n_contrib))
    for key in ("num_intersections", "overflow_tile_cap", "num_visible"):
        assert int(out.stats[key]) == int(ref.stats[key]), key
    assert int(out.stats["overflow_tile_cap"]) == 0


def test_trained_small_matches_golden():
    scene = gt.load_ply(TRAINED_SMALL)
    with torch.inference_mode():
        cam = gt.auto_frame(*scene.bbox(), 128, 128)
        out = gt.render(scene, cam, gt.auto_render_config(scene, cam))
    golden = np.asarray(load_png(GOLDEN))[..., :3]
    img = np.clip(t2n(out.image), 0.0, 1.0)
    np.testing.assert_allclose(img, golden, atol=1.5 / 255.0)
