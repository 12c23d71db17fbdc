"""The benchmark of `gsrast_tpu_torch` (`benchmark.py`, `bench`, the diag
scripts around it) against the reference's `gsrast_tpu/benchmark.py`: the
config and camera equal, the step's gradients equal `jax.grad` of the
reference's step on the same arrays (its Pallas pipeline in interpret mode
on the CPU), the tier plan of `auto_render_config(base=, auto_tile_w=)`
equal, and the command, the stage table, the scene statistics, the tile
sweep and the fixture maker at a small size on the CPU."""

import dataclasses
import json
import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu.config as jcfg
import gsrast_tpu_torch as gt
from gsrast_tpu import benchmark as jax_bench
from gsrast_tpu.render.api import auto_render_config as jax_auto_config
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.scene.gaussians import merge_params, split_params
from gsrast_tpu_torch import benchmark, cli
from gsrast_tpu_torch.diag import make_trained_fixture, scene_stats
from gsrast_tpu_torch.diag import tile_sweep
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.ops.preprocess import preprocess

from torch_parity import (FIXTURES, SCENE_FIELDS, TRAINED_SMALL,
                          camera_to_torch, front_camera, jax_scene_arrays,
                          scenes, seeded_arrays, t2n)

torch.set_num_threads(2)

N, W, H = 2000, 96, 64
# Per group, |port - reference| <= RTOL * max |reference| of that group, as
# in tests/test_torch_grad.py: sums over pixels and intersections taken in
# other orders, T replayed by division in both.
RTOL = 1e-4
# The forward image: colour sums in another order (the Pallas kernel's on
# the MXU), as tests/test_torch_blend.py.
ATOL = 3e-6
STAGES = ("prep", "binning_fwd", "pack", "pack_blend", "full", "blend_fwd",
          "blend_bwd", "full_fwd")
BENCH_KEYS = {"metric", "n", "width", "height", "scene", "backend",
              "best_ms", "value", "unit", "median_ms", "iters", "mode",
              "device", "chain"}


@pytest.fixture(scope="module")
def bench_case():
    """The reference's bench scene and camera at N, W x H, and the port's
    scene from its arrays with the port's bench camera and config."""
    ref_scene, jcam = jax_bench.bench_scene_camera(N, W, H)
    port_scene = gt.from_numpy(jax_scene_arrays(ref_scene))
    _, cam = benchmark.bench_scene_camera(N, W, H, device="cpu")
    jrc = jax_auto_config(ref_scene, jcam, backend="pallas",
                          base=jax_bench.bench_config("pallas"))
    rcfg = benchmark.bench_render_config(port_scene, cam, "torch")
    return ref_scene, jcam, jrc, port_scene, cam, rcfg


def test_bench_config_equals_reference():
    port, ref = benchmark.bench_config("torch"), jax_bench.bench_config("xla")
    shared = {f.name for f in dataclasses.fields(port)} & {
        f.name for f in dataclasses.fields(ref)}
    assert {"tile_h", "tile_w", "tiers", "sh_degree",
            "background"} <= shared
    for name in shared - {"backend"}:
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.backend, benchmark.bench_config("cuda").backend) == (
        "torch", "cuda")


def test_bench_camera_equals_reference():
    scene, cam = benchmark.bench_scene_camera(300, W, H, device="cpu")
    _, jcam = jax_bench.bench_scene_camera(300, W, H)
    np.testing.assert_array_equal(t2n(cam.view), np.asarray(jcam.view))
    for name in ("fov_x", "fov_y", "znear", "zfar"):
        assert float(getattr(cam, name)) == float(getattr(jcam, name)), name
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (W, H)
    # The reference's distributions, from numpy's generator.
    assert scene.capacity == 300 and scene.sh_degree == 3
    scales = t2n(torch.exp(scene.log_scales))
    assert 0.002 <= scales.min() and scales.max() <= 0.008
    assert np.abs(t2n(scene.means)).max() <= 1.0


def test_tile_counts_and_tiers_equal_reference(bench_case):
    """`scene_tile_counts` and `auto_tiers_for` on the reference's bench
    scene equal the reference's."""
    ref_scene, jcam, _, port_scene, cam, _ = bench_case
    jrc, rcfg = jax_bench.bench_config("xla"), benchmark.bench_config("torch")
    np.testing.assert_array_equal(
        benchmark.scene_tile_counts(port_scene, cam, rcfg),
        np.asarray(jax_bench.scene_tile_counts(ref_scene, jcam, jrc)))
    tiers = benchmark.auto_tiers_for(port_scene, cam, rcfg)
    assert tiers and tiers == jax_bench.auto_tiers_for(ref_scene, jcam, jrc)


def test_bench_step_matches_jax_grad(bench_case):
    """The port's bench step on the reference's bench scene: the five
    gradients of mean(img^2) against `jax.grad` of the reference's step,
    and the forward-only image against the reference's render."""
    ref_scene, jcam, jrc, port_scene, cam, rcfg = bench_case
    assert (rcfg.tile_h, rcfg.tile_w, rcfg.tiers) == (
        jrc.tile_h, jrc.tile_w, jrc.tiers)
    params, mask = split_params(ref_scene)

    def jax_render(p):
        return render_tiled_pallas(merge_params(p, mask).activated(), jcam,
                                   jrc).image

    ref_grads = jax.grad(lambda p: jnp.mean(jax_render(p) ** 2))(params)
    grads = benchmark.bench_step(port_scene, cam, rcfg)
    assert set(grads) == set(SCENE_FIELDS)
    for name, g in grads.items():
        expected = np.asarray(ref_grads[name])
        scale = float(np.abs(expected).max())
        assert scale > 0, f"{name}: reference gradient is zero"
        np.testing.assert_allclose(t2n(g) / scale, expected / scale,
                                   atol=RTOL, err_msg=name)
    img = benchmark.bench_step(port_scene, cam, rcfg, fwd_only=True)
    expected = np.asarray(jax_render(params))
    assert img.shape == (H, W, 3) and not img.requires_grad
    assert float(expected.max()) > 0.05
    np.testing.assert_allclose(t2n(img), expected, atol=ATOL)
    # A second step sets the grads anew rather than adding to them.
    again = benchmark.bench_step(port_scene, cam, rcfg)
    for name, g in again.items():
        np.testing.assert_array_equal(t2n(g), t2n(grads[name]))


@pytest.mark.parametrize("tile,auto_w", [((16, 32), True),
                                         ((16, 32), False),
                                         ((8, 32), False),
                                         ((32, 64), False)])
def test_auto_render_config_base_and_auto_tile_w(tile, auto_w):
    """Big splats (17 tiles per Gaussian at 16x32): the tile grows from
    `base` only where `auto_tile_w`; every field but `backend` equals the
    reference's, the tile, `tiers` and the legacy fallback knobs
    (`max_tiles_per_gaussian` 512, `heavy_fraction` 0.5) included."""
    ref_scene, port_scene = scenes(seeded_arrays(3, 400))
    jcam, cam = front_camera(256, 192, dist=2.5)
    th, tw = tile
    ref = jax_auto_config(ref_scene, jcam, "xla",
                          base=jcfg.RenderConfig(tile_h=th, tile_w=tw),
                          auto_tile_w=auto_w)
    port = gt.auto_render_config(
        port_scene, cam, base=gt.RenderConfig(tile_h=th, tile_w=tw,
                                              backend="cuda"),
        auto_tile_w=auto_w)
    assert (port.tile_h, port.tile_w, port.tiers) == (
        ref.tile_h, ref.tile_w, ref.tiers)
    for field in dataclasses.fields(port):
        if field.name != "backend":
            assert getattr(port, field.name) == getattr(ref, field.name), (
                field.name)
    # The reference's one field more is its compute type, float32 as here.
    assert {f.name for f in dataclasses.fields(ref)} - {
        f.name for f in dataclasses.fields(port)} == {"dtype"}
    assert ref.dtype == "float32"
    assert (port.max_tiles_per_gaussian, port.heavy_fraction) == (512, 0.5)
    assert port.backend == "cuda"  # a given base keeps its backend
    grew = (port.tile_h, port.tile_w) != tile
    assert grew == (auto_w and th * tw < 2048)


def test_auto_render_config_default_base_unchanged():
    """Without `base`, 16x32 grown by the rule, with the device's backend."""
    scene = gt.load_ply(TRAINED_SMALL)
    cam = gt.auto_frame(*scene.bbox(), 96, 64)
    default = gt.auto_render_config(scene, cam)
    based = gt.auto_render_config(scene, cam, base=gt.RenderConfig(
        tile_h=16, tile_w=32, backend="torch"))
    assert default == based and default.backend == "torch"


def test_stage_table_keys_in_order(bench_case):
    _, _, _, scene, cam, rcfg = bench_case
    stages = benchmark.stage_table(scene, cam, rcfg, iters=1)
    assert tuple(stages) == STAGES
    assert all(math.isfinite(v) and v > 0 for v in stages.values()), stages
    table = benchmark.format_stage_table(stages, W, H)
    assert table.splitlines()[1].startswith("prep ")
    assert "Mpixels/s fwd+bwd" in table.splitlines()[-1]


def test_scene_stats_match_the_plan(bench_case):
    """Each statistic against counts taken one slot at a time from the
    plan's arrays."""
    _, _, _, scene, cam, rcfg = bench_case
    stats = benchmark.scene_stats(scene, cam, rcfg)
    gh, gw = rcfg.grid_shape(H, W)
    with torch.no_grad():
        prep = preprocess(scene.activated(), cam, rcfg)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
    per_gauss, per_tile = Counter(), Counter()
    for tile, g in zip(t2n(plan.tile_key).tolist(), t2n(plan.gauss).tolist()):
        if tile != gh * gw:
            per_gauss[g] += 1
            per_tile[tile] += 1
    assert stats == {
        "visible": int(np.sum(t2n(prep.radius) > 0)),
        "total_isect": sum(per_gauss.values()),
        "max_tiles_per_gaussian": max(per_gauss.values()),
        "mean_tiles_per_visible": sum(per_gauss.values()) / len(per_gauss),
        "max_segment": max(per_tile.values()),
        "mean_segment": pytest.approx(sum(per_tile.values()) / (gh * gw)),
        "nonempty_tiles": len(per_tile),
        "overflow_tile_cap": 0,
    }
    assert stats["total_isect"] == int(plan.total) > N // 2
    printed = scene_stats.main(["--n", str(N), "--width", str(W), "--height",
                                str(H), "--device", "cpu"])
    own, own_cam = benchmark.bench_scene_camera(N, W, H, device="cpu")
    assert printed == benchmark.scene_stats(
        own, own_cam, benchmark.bench_render_config(own, own_cam, "torch"))


@pytest.mark.parametrize("mode", ["fwd+bwd", "fwd"])
def test_cli_bench_prints_stats_stages_and_json(mode, capsys):
    argv = ["bench", "--device", "cpu", "--n", str(N), "--width", str(W),
            "--height", str(H), "--iters", "2"]
    if mode == "fwd":
        argv.append("--fwd-only")
    result = cli.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("scene stats: tile 16x32 ")
    assert lines[1].startswith("stage ") and lines[-2].startswith("=> ")
    assert json.loads(lines[-1]) == result
    assert set(result) == BENCH_KEYS
    assert result["mode"] == mode and result["metric"] == (
        "mpixels_per_s_per_chip_fwd_bwd" if mode == "fwd+bwd"
        else "mpixels_per_s_per_chip_fwd")
    assert (result["n"], result["width"], result["height"]) == (N, W, H)
    assert (result["backend"], result["device"], result["iters"]) == (
        "torch", "cpu", 2)
    assert result["chain"] == 1  # one step a call, the default
    assert result["scene"] is None and result["unit"] == "Mpixels/s/chip"
    assert 0 < result["best_ms"] <= result["median_ms"]
    assert result["value"] == pytest.approx(W * H / result["best_ms"] / 1e3)


def test_cli_bench_scene_and_no_stages(capsys):
    result = cli.main(["bench", "--device", "cpu", "--scene", TRAINED_SMALL,
                       "--width", "64", "--height", "48", "--iters", "1",
                       "--no-stages"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("scene stats: ")
    assert result["scene"] == TRAINED_SMALL
    assert result["n"] == gt.load_ply(TRAINED_SMALL).capacity
    assert math.isfinite(result["value"]) and result["value"] > 0


def test_tile_sweep_skips_what_the_kernels_do_not_take(capsys):
    rows = tile_sweep.main(["--device", "cpu", "--n", "500", "--width", "64",
                            "--height", "32", "--iters", "1", "--shapes",
                            "4x32,8x32,16x24"])
    out = capsys.readouterr().out
    assert rows["4x32"] == rows["16x24"] == {"status": "skipped"}
    assert "  4x32: skipped (kernel footprint)" in out
    assert rows["8x32"]["status"] == "ok" and rows["8x32"]["mpix_s"] > 0
    every = {f"{h}x{w}" for h in range(1, 2049) for w in range(1, 2049)
             if 256 <= h * w <= 2048 and tile_sweep.kernels_take(h, w)}
    assert set(tile_sweep.SHAPES) == every and len(every) == 14
    assert {"8x32", "16x16", "8x64", "16x32", "32x16", "16x64", "32x32",
            "8x128", "16x128", "32x64"} < every


def test_make_trained_fixture_small(tmp_path, monkeypatch, capsys):
    """`--small` through a size table cut to 300/400 Gaussians, 2 views of
    32x32: the trained .ply and its 5x jittered copy load."""
    monkeypatch.setitem(make_trained_fixture.SIZES, "small",
                        (300, 400, 500, 2, 32))
    out = make_trained_fixture.main(["--small", "--steps", "2", "--out",
                                     str(tmp_path), "--device", "cpu"])
    assert out == {"trained": str(tmp_path / "trained_0k.ply"),
                   "stats_5m": str(tmp_path / "trained_stats_5m.ply")}
    assert "wrote 2 views" in capsys.readouterr().out
    trained = gt.load_ply(out["trained"])
    big = gt.load_ply(out["stats_5m"])
    assert big.capacity == 5 * trained.capacity
    assert bool(torch.isfinite(big.means).all())
    np.testing.assert_array_equal(t2n(big.sh[:trained.capacity]),
                                  t2n(trained.sh))
    jitter = t2n(big.means[:trained.capacity] - trained.means)
    assert 0 < np.abs(jitter).max() < 0.2


@pytest.mark.slow
def test_bench_step_matches_jax_grad_on_trained_116k():
    """The bench step's gradients on the trained 116k-Gaussian fixture at
    64x48 against `jax.grad` of the reference's step, at RTOL."""
    path = f"{FIXTURES}/trained_116k.ply"
    ref_scene = gs.load_ply(path)
    jcam = gs.auto_frame(*ref_scene.bbox(), 64, 48)
    jrc = jax_auto_config(ref_scene, jcam, backend="pallas",
                          base=jax_bench.bench_config("pallas"))
    port_scene = gt.load_ply(path)
    cam = camera_to_torch(jcam)
    rcfg = benchmark.bench_render_config(port_scene, cam, "torch")
    assert (rcfg.tile_h, rcfg.tile_w, rcfg.tiers) == (
        jrc.tile_h, jrc.tile_w, jrc.tiers)
    params, mask = split_params(ref_scene)
    ref_grads = jax.grad(lambda p: jnp.mean(render_tiled_pallas(
        merge_params(p, mask).activated(), jcam, jrc).image ** 2))(params)
    for name, g in benchmark.bench_step(port_scene, cam, rcfg).items():
        expected = np.asarray(ref_grads[name])
        scale = float(np.abs(expected).max())
        assert scale > 0, name
        np.testing.assert_allclose(t2n(g) / scale, expected / scale,
                                   atol=RTOL, err_msg=name)
