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


# The sharded paths' plans: 11 tile rows over D = 4 devices, 3 rows each,
# so the last device's third local row lies past the grid.
D = 4
SHARD_TIERS = ((2, 1.0), (6, 0.5), (12, 0.25))


def _shard_setup():
    ref_scene, _ = scenes(seeded_arrays(5, 180, extent=1.5))
    jcam, _ = front_camera(128, 88, dist=3.0)
    jcfg = gs.RenderConfig(tile_h=8, tile_w=16, tiers=SHARD_TIERS)
    pcfg = gt.RenderConfig(tile_h=8, tile_w=16, tiers=SHARD_TIERS,
                           backend="torch")
    p_ref = jax_preprocess(ref_scene.activated(), jcam, jcfg)
    gh, gw = jcfg.grid_shape(jcam.height, jcam.width)
    assert (gh, gw) == (11, 8)
    return jcfg, pcfg, p_ref, gh, gw


def _assert_plans_equal(port, ref):
    for name in ("tile_key", "depth_key", "gauss", "order", "total",
                 "overflow_tile_cap"):
        np.testing.assert_array_equal(t2n(getattr(port, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("interleave", [True, False])
def test_plan_tiers_row_local_exact(interleave):
    """Each device's owned rows (interleaved {d, d+4, ...} or contiguous
    blocks of 3), with the device-scaled tiers of the tile-sharded path:
    key for key the reference's; every device has work."""
    jcfg, pcfg, p_ref, gh, gw = _shard_setup()
    rpd = -(-gh // D)
    step = D if interleave else 1
    tiers = binning.shard_tiers(SHARD_TIERS, D if interleave else 1)
    assert tiers == jax_binning.shard_tiers(SHARD_TIERS,
                                            D if interleave else 1)
    jcfg_d, pcfg_d = jcfg.replace(tiers=tiers), pcfg.replace(tiers=tiers)
    prep = prep_to_torch(p_ref)
    totals = []
    for d in range(D):
        row0 = d if interleave else d * rpd
        ref = jax_binning.plan_tiers(p_ref, gh, gw, jcfg_d,
                                     num_local_rows=rpd, row0=row0,
                                     row_stride=step)
        port = binning.plan_tiers(prep, gh, gw, pcfg_d, num_local_rows=rpd,
                                  row0=row0, row_stride=step)
        _assert_plans_equal(port, ref)
        assert int(t2n(port.tile_key).max()) == rpd * gw  # the sentinel
        totals.append(int(port.total))
    assert min(totals) > 50, totals


def test_plan_tiers_routed_exact():
    """The primitive-sharded route keys (dest << bits | local tile, 3 rows
    a device of 4): key for key the reference's."""
    jcfg, pcfg, p_ref, gh, gw = _shard_setup()
    rpd = -(-gh // D)
    ref = jax_binning.plan_tiers(p_ref, gh, gw, jcfg, dest_rows=rpd,
                                 n_dest=D)
    port = binning.plan_tiers(prep_to_torch(p_ref), gh, gw, pcfg,
                              dest_rows=rpd, n_dest=D)
    _assert_plans_equal(port, ref)
    bits = binning.route_bits(rpd, gw, D)
    live = t2n(port.tile_key)[t2n(port.gauss) >= 0]
    assert set(np.unique(live >> bits)) == set(range(D))
    with pytest.raises(ValueError, match="overflow int32"):
        binning.route_bits(1 << 20, 1024, 4)
    with pytest.raises(ValueError, match="whole grid"):
        binning.plan_tiers(prep_to_torch(p_ref), gh, gw, pcfg,
                           num_local_rows=2, dest_rows=rpd, n_dest=D)


@pytest.mark.parametrize("tiers", [
    ((2, 1.0), (4, 1.0), (8, 0.5), (32, 0.25)),
    ((1, 0.9), (3, 0.6), (5, 0.7), (300, 0.01)),
    ((4, 1.0),),
])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_shard_tiers_matches_reference(tiers, n_dev):
    """The reference's `TestShardTiers` checks, and the spec itself."""
    td = binning.shard_tiers(tiers, n_dev)
    assert td == jax_binning.shard_tiers(tiers, n_dev)
    ks = [k for k, _ in td]
    assert ks == sorted(set(ks)) and td[0][1] >= min(1.0, tiers[0][1])
    if n_dev == 1:
        assert td == tiers
    elif n_dev == 8 and tiers[-1][0] > 8:  # TestShardTiers' case
        assert ks[-1] < tiers[-1][0]  # widths shrink with D
        assert td[0][1] >= 1.0
        assert binning.tier_dims(10_000, td)[1] < (
            binning.tier_dims(10_000, tiers)[1] / 2)
