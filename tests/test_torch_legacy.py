"""The reference's default render path in `gsrast_tpu_torch` against
`gsrast_tpu`: the legacy two-tier binning (`tiers=()`: `build_binning`,
`expand_intersections`, `pack_features`) through the blend's plain version,
and the 'autograd' backend, the capped closed-form oracle that is the
reference's 'xla' (`render_tiled_xla`), on both of its plans. The reference
runs as its own tests run it on the CPU: plain XLA, and the Pallas blend in
interpret mode. Integer structure is compared exactly on the reference's own
`Preprocessed` (through numpy); images within 3e-6, gradients within
2e-4 + 1e-4 |g| (the reference's sharded tests' rule)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.ops import binning as jax_binning
from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
from gsrast_tpu.render.api import render as jax_render
from gsrast_tpu.render.pallas_pipeline import render_tiled_pallas
from gsrast_tpu.render.tiled import render_tiled_xla as jax_render_xla
from gsrast_tpu.scene.gaussians import merge_params, split_params
from gsrast_tpu_torch import benchmark, cli
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.render.tiled import render_tiled_xla

from torch_parity import (SCENE_FIELDS, TRAINED_SMALL, front_camera, prep_to_torch, scenes, seeded_arrays,
                          t2n)

torch.set_num_threads(2)

IMAGE_ATOL = 3e-6
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)
BACKGROUND = (0.1, 0.2, 0.3)
BINNING_FIELDS = ("sorted_tile", "sorted_gauss", "sorted_slot", "heavy_idx",
                  "tile_starts", "num_intersections", "overflow_capacity",
                  "overflow_tile_cap")
STATS = ("num_intersections", "overflow_capacity", "overflow_tile_cap",
         "overflow_per_tile", "num_visible")

# build_binning's cases: RenderConfig overrides, local rows (num_local_rows,
# row0, row_stride) or None, and the counter each must make nonzero.
BINNING_CASES = {
    "no_cap": (dict(max_tiles_per_gaussian=96, base_tiles_per_gaussian=8,
                    heavy_fraction=1.0, intersect_capacity_factor=64.0),
               None, None),
    "k2_cap": (dict(max_tiles_per_gaussian=4, base_tiles_per_gaussian=2,
                    heavy_fraction=1.0, intersect_capacity_factor=16.0),
               None, "overflow_tile_cap"),
    "heavy_budget": (dict(max_tiles_per_gaussian=64,
                          base_tiles_per_gaussian=1, heavy_fraction=0.01,
                          intersect_capacity_factor=16.0),
                     None, "overflow_tile_cap"),
    "capacity": (dict(max_tiles_per_gaussian=64, intersect_capacity_factor=0.5),
                 None, "overflow_capacity"),
    "local_contiguous": (dict(max_tiles_per_gaussian=16,
                              base_tiles_per_gaussian=2), (3, 3, 1), None),
    "local_interleaved": (dict(max_tiles_per_gaussian=16,
                               base_tiles_per_gaussian=2), (3, 1, 4), None),
}


def _binning_setup():
    """600 anisotropic Gaussians at 128x96 with 8x16 tiles (12 x 8 tiles),
    the reference's Preprocessed and the port's copy of it."""
    ref_scene, _ = scenes(seeded_arrays(5, 600, extent=1.5))
    jcam, _ = front_camera(128, 96, dist=3.0)
    jcfg = gs.RenderConfig(tile_h=8, tile_w=16)
    prep = jax.jit(lambda a: jax_preprocess(a, jcam, jcfg))(
        ref_scene.activated())
    return prep, prep_to_torch(prep), jcfg.grid_shape(96, 128)


@pytest.mark.parametrize("case", sorted(BINNING_CASES))
def test_build_binning_exact(case):
    over, local, counter = BINNING_CASES[case]
    p_ref, prep, (gh, gw) = _binning_setup()
    jcfg = gs.RenderConfig(tile_h=8, tile_w=16, **over)
    pcfg = gt.RenderConfig(tile_h=8, tile_w=16, **over)
    n = prep.depth.shape[0]
    kw = {} if local is None else dict(zip(
        ("num_local_rows", "row0", "row_stride"), local))
    ref = jax.jit(lambda p: jax_binning.build_binning(
        p, gh, gw, jcfg, jcfg.capacity(n), **kw))(p_ref)
    port = binning.build_binning(prep, gh, gw, pcfg, pcfg.capacity(n), **kw)
    for name in BINNING_FIELDS:
        got = t2n(getattr(port, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(ref.num_intersections) > 100
    if counter is not None:
        assert int(getattr(ref, counter)) > 0, counter
    if case == "no_cap":
        assert int(ref.overflow_tile_cap) == int(ref.overflow_capacity) == 0
        assert len(ref.heavy_idx) > 0


def test_build_binning_depth_bits_assert():
    """Too many local tiles for 12 depth bits raise, as the reference
    asserts."""
    _, prep, _ = _binning_setup()
    with pytest.raises(ValueError, match="depth bits"):
        binning.build_binning(prep, 1 << 10, 1 << 9, gt.RenderConfig(),
                              1024)


@pytest.mark.parametrize("cap_factor", [0.5, 8.0])
def test_expand_intersections_exact(cap_factor):
    p_ref, _, _ = _binning_setup()
    counts = np.array(p_ref.tiles_touched)
    capacity = max(128, int(counts.sum() * cap_factor))
    ref = jax_binning.expand_intersections(jnp.asarray(counts), capacity)
    port = binning.expand_intersections(torch.from_numpy(counts), capacity)
    for name, a, b in zip(("i", "k", "offsets", "total"), port, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(t2n(a), np.asarray(b), err_msg=name)


def _legacy_case(case="aniso_8x128"):
    """(reference scene, port scene, reference camera, port camera, the
    legacy RenderConfig fields): 120 Gaussians at 256x32 on 8x128 tiles,
    K1 1 and K2 3, so that tier 2 and the K2 cap both bind."""
    ref_scene, port_scene = scenes(seeded_arrays(21, 120, sh_degree=2))
    jcam, cam = front_camera(256, 32)
    return ref_scene, port_scene, jcam, cam, dict(
        background=BACKGROUND, max_tiles_per_gaussian=3,
        base_tiles_per_gaussian=1)


def _stats(stats, names=STATS) -> np.ndarray:
    return np.array([int(stats[k]) for k in names])


def test_legacy_render_matches_reference_pallas():
    """The legacy path through the blend's plain version against the
    reference's `render_tiled_pallas` with tiers=()."""
    ref_scene, port_scene, jcam, cam, fields = _legacy_case()
    jcfg = gs.RenderConfig(backend="pallas", **fields)
    ref = jax.jit(lambda a: render_tiled_pallas(a, jcam, jcfg))(
        ref_scene.activated())
    with torch.no_grad():
        out = gt.render(port_scene, cam,
                        gt.RenderConfig(backend="torch", **fields))
    np.testing.assert_allclose(t2n(out.image), np.asarray(ref.image),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(t2n(out.final_t), np.asarray(ref.final_t),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(t2n(out.n_contrib),
                                  np.asarray(ref.n_contrib))
    np.testing.assert_array_equal(_stats(out.stats), _stats(ref.stats))
    assert int(ref.stats["overflow_tile_cap"]) > 0


def _grads_against_jax(jax_render_fn, jcfg, port_render_fn):
    """The five groups' gradients of mean(img^2) + 0.1 mean(final_t), the
    port's against jax.grad of the reference's."""
    ref_scene, port_scene, jcam, cam, _ = _legacy_case()
    params, mask = split_params(ref_scene)

    def jax_loss(p):
        out = jax_render_fn(merge_params(p, mask).activated(), jcam, jcfg)
        return jnp.mean(out.image ** 2) + 0.1 * jnp.mean(out.final_t)

    ref = jax.jit(jax.grad(jax_loss))(params)
    out = port_render_fn(port_scene, cam)
    (torch.mean(out.image ** 2) + 0.1 * torch.mean(out.final_t)).backward()
    for field in SCENE_FIELDS:
        expected = np.asarray(ref[field])
        got = getattr(port_scene, field).grad
        assert float(np.abs(expected).max()) > 0, field
        np.testing.assert_allclose(t2n(got).reshape(expected.shape), expected,
                                   err_msg=field, **GRAD_TOL)


def test_legacy_render_gradients_match_jax():
    fields = _legacy_case()[-1]
    _grads_against_jax(
        render_tiled_pallas, gs.RenderConfig(backend="pallas", **fields),
        lambda s, c: gt.render(s, c, gt.RenderConfig(backend="torch",
                                                     **fields)))


# The oracle's cases: its legacy branch, its tier branch, and the reference
# test_heavy_oracle.py's heavy scene, whose hot tile is past the cap.
ORACLE_TIERS = ((2, 1.0), (6, 0.5), (16, 0.25))


def _heavy_case():
    arrays = seeded_arrays(7, 2560, sh_degree=1, scale_range=(0.01, 0.05))
    arrays["means"] = (arrays["means"] * np.float32([0.15, 0.15, 1.0])
                       ).astype(np.float32)
    ref_scene, port_scene = scenes(arrays)
    jcam, cam = front_camera(64, 32, dist=3.0)
    # Its config, on the legacy binning (the tier plan's oracle is held on
    # the other cases).
    fields = dict(tile_h=8, tile_w=16, max_per_tile=256,
                  intersect_capacity_factor=64.0, tile_chunk=2,
                  background=(0.1, 0.2, 0.3))
    return ref_scene, port_scene, jcam, cam, fields


@pytest.mark.parametrize("case", ["legacy", "tiers", "heavy"])
def test_oracle_matches_reference_xla(case):
    if case == "heavy":
        ref_scene, port_scene, jcam, cam, fields = _heavy_case()
    else:
        ref_scene, port_scene, jcam, cam, fields = _legacy_case()
        fields = dict(fields, tile_chunk=3, max_per_tile=64,
                      tiers=ORACLE_TIERS if case == "tiers" else ())
    jcfg = gs.RenderConfig(backend="xla", **fields)
    ref = jax.jit(lambda a: jax_render_xla(a, jcam, jcfg))(
        ref_scene.activated())
    with torch.no_grad():
        out = gt.render(port_scene, cam,
                        gt.RenderConfig(backend="autograd", **fields))
    np.testing.assert_allclose(t2n(out.image), np.asarray(ref.image),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(t2n(out.final_t), np.asarray(ref.final_t),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(t2n(out.n_contrib),
                                  np.asarray(ref.n_contrib))
    np.testing.assert_array_equal(_stats(out.stats), _stats(ref.stats))
    if case == "heavy":
        assert int(ref.stats["overflow_per_tile"]) > 0


@pytest.mark.parametrize("tiers", [(), ORACLE_TIERS])
def test_oracle_gradients_match_jax(tiers):
    fields = dict(_legacy_case()[-1], tile_chunk=3, max_per_tile=64,
                  tiers=tiers)
    _grads_against_jax(
        jax_render_xla, gs.RenderConfig(backend="xla", **fields),
        lambda s, c: render_tiled_xla(s.activated(), c, gt.RenderConfig(
            backend="autograd", **fields)))


def test_render_default_config_is_the_reference_default():
    """`render(scene, camera)` with no config: the reference's RenderConfig()
    (8x128, tiers=()), on the CPU its default backend, the oracle."""
    ref_scene, port_scene = scenes(seeded_arrays(21, 120, sh_degree=2))
    jcam, cam = front_camera(256, 32)
    ref = jax.jit(lambda a: jax_render(a, jcam))(ref_scene.activated())
    with torch.no_grad():
        out = gt.render(port_scene, cam)
    np.testing.assert_allclose(t2n(out.image), np.asarray(ref.image),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(t2n(out.n_contrib),
                                  np.asarray(ref.n_contrib))
    np.testing.assert_array_equal(_stats(out.stats), _stats(ref.stats))
    default = gt.default_render_config(port_scene, cam)
    assert default == gt.RenderConfig(backend="autograd")
    assert not default.tiers and (default.tile_h, default.tile_w) == (8, 128)


def test_stage_table_legacy():
    """The stage table on a tiers=() config: the legacy binning and pack."""
    scene, cam = benchmark.bench_scene_camera(1000, 64, 32, device="cpu")
    rcfg = benchmark.bench_render_config(scene, cam, "torch", tiers=())
    assert rcfg.tiers == () and rcfg.max_tiles_per_gaussian == 16
    stages = benchmark.stage_table(scene, cam, rcfg, iters=1)
    assert tuple(stages) == ("prep", "binning_fwd", "pack", "pack_blend",
                             "full", "blend_fwd", "blend_bwd", "full_fwd")
    assert all(np.isfinite(v) and v > 0 for v in stages.values()), stages
    best, median, mpix = benchmark.run_bench(scene, cam, rcfg, iters=1)
    assert 0 < best <= median and mpix > 0


def test_cli_backend_autograd(tmp_path, capsys):
    """`render --backend autograd` against the port's oracle, and `bench
    --backend autograd` on the CPU."""
    ply = TRAINED_SMALL
    img = cli.main(["render", ply, "--width", "64", "--height", "48",
                    "--backend", "autograd", "--device", "cpu", "--out",
                    str(tmp_path / "out.png")])
    scene = gt.load_ply(ply)
    cam = gt.auto_frame(*scene.bbox(), 64, 48)
    rcfg = gt.auto_render_config(scene, cam).replace(backend="autograd")
    with torch.no_grad():
        expect = render_tiled_xla(scene.activated(), cam, rcfg).image
    np.testing.assert_array_equal(t2n(img), t2n(expect))
    out = cli.main(["bench", "--n", "1500", "--width", "64", "--height",
                    "48", "--iters", "1", "--no-stages", "--backend",
                    "autograd", "--device", "cpu"])
    assert out["backend"] == "autograd" and out["value"] > 0
    capsys.readouterr()


def test_render_synthetic_dataset_default_matches_reference(monkeypatch,
                                                            tmp_path):
    """Its default config, the reference's RenderConfig(): on the CPU the
    oracle, whose images equal the reference's within 3e-6."""
    import gsrast_tpu.scene.dataset as jax_dataset
    import gsrast_tpu_torch.scene.dataset as port_dataset

    saved = {}

    def keep(name, module):
        real = module.save_dataset

        def save(path, cams, images):
            saved[name] = [np.asarray(t2n(i) if isinstance(i, torch.Tensor)
                                      else i) for i in images]
            return real(path, cams, images)
        monkeypatch.setattr(module, "save_dataset", save)

    keep("ref", jax_dataset)
    keep("port", port_dataset)
    ref_scene, port_scene = scenes(seeded_arrays(3, 200, sh_degree=1))
    jax_dataset.render_synthetic_dataset(ref_scene, str(tmp_path / "ref"),
                                         n_views=2, width=64, height=48)
    port_dataset.render_synthetic_dataset(port_scene, str(tmp_path / "port"),
                                          n_views=2, width=64, height=48)
    assert len(saved["port"]) == 2
    for got, ref in zip(saved["port"], saved["ref"]):
        assert float(np.abs(ref).max()) > 0.05
        np.testing.assert_allclose(got, ref, atol=IMAGE_ATOL)


def test_cov3d_to_matrix_and_sh_dc_match_reference():
    from gsrast_tpu.ops.covariance import cov3d_to_matrix as jax_cov
    from gsrast_tpu.ops.sh import eval_sh_dc_reference as jax_dc
    from gsrast_tpu_torch.ops.covariance import cov3d_to_matrix
    from gsrast_tpu_torch.ops.sh import eval_sh_dc_reference

    rng = np.random.default_rng(4)
    cov6 = rng.standard_normal((5, 7, 6)).astype(np.float32)
    np.testing.assert_array_equal(t2n(cov3d_to_matrix(torch.from_numpy(cov6))),
                                  np.asarray(jax_cov(jnp.asarray(cov6))))
    dc = rng.standard_normal((9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t2n(eval_sh_dc_reference(torch.from_numpy(dc))),
        np.asarray(jax_dc(jnp.asarray(dc))))
