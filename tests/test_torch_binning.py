"""Tile planning and the (tile, depth) sort-pack of `gsrast_tpu_torch`
against `gsrast_tpu`. Both run on the reference's own `Preprocessed`
(converted through numpy), so preprocess rounding cannot leak in: the
integer structure must match exactly."""

import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.ops import binning as jax_binning
from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
from gsrast_tpu.render import pallas_pipeline as jax_pp
from gsrast_tpu.render.api import scene_tile_counts as jax_tile_counts
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.render import api
from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack

from torch_parity import (TRAINED_SMALL, camera_to_torch, front_camera,
                          prep_to_torch, scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

CASES = {
    # trained_small at 128^2, 16x32 tiles, the auto-derived tiers
    "trained_small": dict(tiles=(16, 32), tiers=None),
    # budgeted tiers >= 1 run the tile-vs-ellipse cull; k_last = 12 drops
    # tiles of the biggest splats (counted in overflow_tile_cap)
    "aniso_budgeted": dict(tiles=(8, 16), tiers=((2, 1.0), (6, 0.5),
                                                 (12, 0.25))),
    # P = 2048 tiles
    "aniso_32x64": dict(tiles=(32, 64), tiers=((1, 1.0), (4, 0.6))),
}


def _setup(case):
    spec = CASES[case]
    if case == "trained_small":
        ref_scene = gs.load_ply(TRAINED_SMALL)
        jcam = gs.auto_frame(*ref_scene.bbox(), 128, 128)
        port_scene = gt.load_ply(TRAINED_SMALL)
    else:
        ref_scene, port_scene = scenes(seeded_arrays(5, 180, extent=1.5))
        jcam, _ = front_camera(128, 96, dist=3.0)
    th, tw = spec["tiles"]
    jcfg = gs.RenderConfig(tile_h=th, tile_w=tw)
    tiers = spec["tiers"]
    if tiers is None:
        tiers = jax_binning.auto_tiers(
            jax_tile_counts(ref_scene, jcam, jcfg))
    jcfg = jcfg.replace(tiers=tiers)
    pcfg = gt.RenderConfig(tile_h=th, tile_w=tw, tiers=tiers, backend="torch")
    p_ref = jax_preprocess(ref_scene.activated(), jcam, jcfg)
    grid = jcfg.grid_shape(jcam.height, jcam.width)
    return ref_scene, port_scene, jcam, jcfg, pcfg, p_ref, grid


def test_auto_tiers_identical():
    ref_scene = gs.load_ply(TRAINED_SMALL)
    jcam = gs.auto_frame(*ref_scene.bbox(), 128, 128)
    jcfg = gs.RenderConfig(tile_h=16, tile_w=32)
    counts_ref = jax_tile_counts(ref_scene, jcam, jcfg)
    counts = api.scene_tile_counts(gt.load_ply(TRAINED_SMALL),
                                   camera_to_torch(jcam),
                                   gt.RenderConfig(tile_h=16, tile_w=32))
    np.testing.assert_array_equal(counts, counts_ref)
    rng = np.random.default_rng(2)
    skewed = np.concatenate([rng.integers(0, 4, 5000),
                             rng.integers(0, 300, 400), [0] * 700])
    for c in (counts_ref, skewed, np.zeros(10, np.int32)):
        assert binning.auto_tiers(c) == jax_binning.auto_tiers(c)
    assert binning.tier_dims(5100, ((2, 1.0), (8, 0.3), (40, 0.01))) == (
        jax_binning.tier_dims(5100, ((2, 1.0), (8, 0.3), (40, 0.01))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_tiers_exact(case):
    *_, jcfg, pcfg, p_ref, (gh, gw) = _setup(case)
    ref = jax_binning.plan_tiers(p_ref, gh, gw, jcfg)
    port = binning.plan_tiers(prep_to_torch(p_ref), gh, gw, pcfg)
    for name in ("tile_key", "depth_key", "gauss", "order", "total",
                 "overflow_tile_cap"):
        np.testing.assert_array_equal(t2n(getattr(port, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(ref.total) > 100
    if case == "aniso_budgeted":
        assert int(ref.overflow_tile_cap) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_pack_exact(case):
    *_, jcfg, pcfg, p_ref, (gh, gw) = _setup(case)
    n, num_tiles = p_ref.depth.shape[0], gh * gw
    plan_ref = jax_binning.plan_tiers(p_ref, gh, gw, jcfg)
    feat_ref, starts_ref = jax_pp.fused_pack(
        jax_pp.feature_rows(p_ref), plan_ref.tile_key, plan_ref.depth_key,
        plan_ref.slot, plan_ref.gauss, plan_ref.order, jcfg.tiers, n,
        num_tiles)
    prep = prep_to_torch(p_ref)
    plan = binning.plan_tiers(prep, gh, gw, pcfg)
    feat, starts = sort_pack(feature_rows(prep), plan, num_tiles)
    np.testing.assert_array_equal(t2n(starts), np.asarray(starts_ref))
    live = int(starts_ref[-1])
    assert live == int(plan_ref.total)
    # Rows 0:10 over the live prefix; sentinel order is not compared.
    np.testing.assert_array_equal(t2n(feat)[:, :live],
                                  np.asarray(feat_ref)[:10, :live])
    assert feat.shape == (10, plan.tile_key.shape[0])
