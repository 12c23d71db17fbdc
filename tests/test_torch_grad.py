"""Whole-render gradients of `gsrast_tpu_torch` against `jax.grad` through
the reference's `render_tiled_pallas` (Pallas blend forward and backward in
interpret mode on the CPU): the five parameter groups and `mean2d_delta`,
through preprocess, sort-pack, the blend backward and image assembly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.render.api import auto_render_config as jax_auto_config
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.scene.gaussians import merge_params, split_params
from gsrast_tpu.train.loss import rgb_loss as jax_rgb_loss
from gsrast_tpu_torch.train.loss import rgb_loss

from torch_parity import (SCENE_FIELDS, TRAINED_SMALL, camera_to_torch,
                          front_camera, scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

# Per group, |port - reference| <= RTOL * max |reference| of that group: the
# gradients are sums over pixels and intersections of float32 terms taken
# in other orders, with T replayed by division in both.
RTOL = 1e-4
BACKGROUND = (0.1, 0.2, 0.3)


def _case(case):
    if case == "trained_small_64":
        ref_scene = gs.load_ply(TRAINED_SMALL)
        port_scene = gt.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref_scene.bbox(), 64, 64)
        cam = camera_to_torch(jcam)
    else:
        ref_scene, port_scene = scenes(seeded_arrays(5, 60, sh_degree=2))
        jcam, cam = front_camera(256, 32)
    jcfg = jax_auto_config(ref_scene, jcam, backend="pallas").replace(
        background=BACKGROUND)
    pcfg = gt.auto_render_config(port_scene, cam).replace(
        background=BACKGROUND)
    assert (pcfg.tile_h, pcfg.tile_w, pcfg.tiers) == (
        jcfg.tile_h, jcfg.tile_w, jcfg.tiers)
    return ref_scene, port_scene, jcam, cam, jcfg, pcfg


def _loss(kind, image, final_t, xp):
    if kind == "mse_final_t":
        return (xp.mean((image - 0.25) ** 2) + 0.1 * xp.mean(final_t))
    target = xp.zeros_like(image) + xp.asarray(BACKGROUND, dtype=image.dtype)
    return (jax_rgb_loss if xp is jnp else rgb_loss)(image, target, 0.2)


@pytest.mark.parametrize("case,loss", [
    ("aniso_sh2_256x32", "mse_final_t"),
    ("trained_small_64", "mse_final_t"),
    ("trained_small_64", "rgb_loss"),
])
def test_render_gradients_match_jax(case, loss):
    ref_scene, port_scene, jcam, cam, jcfg, pcfg = _case(case)
    params, mask = split_params(ref_scene)
    n = ref_scene.capacity

    def jax_loss(p, delta):
        out = render_tiled_pallas(merge_params(p, mask).activated(), jcam,
                                  jcfg, mean2d_delta=delta)
        return _loss(loss, out.image, out.final_t, jnp)

    ref_grads, ref_delta = jax.grad(jax_loss, argnums=(0, 1))(
        params, jnp.zeros((n, 2), jnp.float32))

    delta = torch.zeros((n, 2), requires_grad=True)
    out = gt.render(port_scene, cam, pcfg, mean2d_delta=delta)
    _loss(loss, out.image, out.final_t, torch).backward()
    port = {f: getattr(port_scene, f).grad for f in SCENE_FIELDS}
    port["mean2d_delta"] = delta.grad
    ref = dict(ref_grads, mean2d_delta=ref_delta)
    for name, g in port.items():
        expected = np.asarray(ref[name])
        scale = float(np.abs(expected).max())
        assert scale > 0, f"{name}: reference gradient is zero"
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(t2n(g) / scale, expected / scale,
                                   atol=RTOL, err_msg=name)
