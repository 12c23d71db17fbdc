"""The sharded paths of `gsrast_tpu_torch.parallel` against
`gsrast_tpu.parallel` on the same arrays: 4 gloo CPU ranks, launched once for
the module (`torch_parity.sharded_rank_cases`, which runs every case), and
the reference on 4 of the conftest's 8 virtual CPU devices with its `xla`
backend. Tolerances are the reference's own sharded tests': images 2e-5,
gradients 2e-4 absolute / 1e-4 relative; stats exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsrast_tpu import RenderConfig
from gsrast_tpu.parallel.mesh import make_mesh
from gsrast_tpu.parallel.sharded import (make_sharded_train_step,
                                         pad_gaussians,
                                         render_primitive_sharded,
                                         render_tile_sharded)
from gsrast_tpu.scene.gaussians import split_params
import gsrast_tpu_torch as gt
from gsrast_tpu_torch.parallel import sharded as ps

from torch_parity import (PRIM_STATS, SCENE_FIELDS, TILE_STATS,
                          camera_batch_to_torch, front_camera, launch_ranks,
                          scenes, seeded_arrays)

# The reference's test_sharded_fused.py configuration; a per-tile cap of
# 1,024 keeps its xla blend's overflow_per_tile at 0 on the skewed scene,
# where the port walks true ranges.
TIERS = ((2, 1.0), (4, 1.0), (8, 0.5), (32, 0.25))
BACKGROUND = (0.05, 0.1, 0.15)
JCFG = RenderConfig(max_per_tile=1024, tile_chunk=2,
                    intersect_capacity_factor=16.0, background=BACKGROUND,
                    tiers=TIERS, backend="xla")
W, H = 256, 64
# The legacy branches' configuration: the reference test_sharded.py's CFG
# (8x128 tiles, no tiers), its per-tile cap 256 above this scene's longest
# segment, so that its xla blend drops nothing the port's blends walk.
LEGACY = RenderConfig(max_per_tile=256, tile_chunk=2,
                      intersect_capacity_factor=16.0, background=BACKGROUND,
                      backend="xla")
IMAGE_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)


def _arrays():
    scene = seeded_arrays(11, 512, sh_degree=1, scale_range=(0.02, 0.1))
    skew = dict(scene, means=(scene["means"] * 0.12 + np.float32(
        [-0.9, -0.35, 0.0])).astype(np.float32))
    return scene, skew


def _cameras():
    """The front camera, and a batch of it and a second view for the
    train step, as reference cameras."""
    from gsrast_tpu.camera import Camera, look_at

    jcam, _ = front_camera(W, H, dist=3.0)
    side = Camera(view=look_at(jnp.array([0.6, -0.2, -2.9]), jnp.zeros(3)),
                  fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0), width=W,
                  height=H)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), jcam, side)
    return jcam, batch


def _targets():
    return np.random.default_rng(3).uniform(
        0.0, 1.0, (2, H, W, 3)).astype(np.float32)


def _camera_arrays(prefix, cam) -> dict:
    out = {f"{prefix}_{f}": np.asarray(getattr(cam, f), np.float32)
           for f in ("view", "fov_x", "fov_y", "znear", "zfar")}
    out[f"{prefix}_size"] = np.array([cam.width, cam.height])
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's outputs of `sharded_rank_cases`."""
    scene, skew = _arrays()
    jcam, batch = _cameras()
    arrays = {f"scene_{f}": scene[f] for f in SCENE_FIELDS}
    arrays.update({f"skew_{f}": skew[f] for f in SCENE_FIELDS})
    arrays.update(_camera_arrays("cam", jcam))
    port_batch = camera_batch_to_torch(batch)
    arrays.update(_camera_arrays("batch", port_batch))
    arrays.update(tiers=np.array(TIERS), background=np.array(BACKGROUND),
                  targets=_targets(),
                  legacy_max_per_tile=np.array(LEGACY.max_per_tile))
    return launch_ranks(4, "sharded_rank_cases", arrays,
                        tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def ref_scene():
    scene, _ = _arrays()
    return scenes(scene)[0]


def _assert_replicated(port, key):
    """Every rank holds the same result."""
    for r in range(1, 4):
        np.testing.assert_array_equal(port[r][key], port[0][key],
                                      err_msg=f"{key} on rank {r}")


def _stats(stats, names):
    return np.array([int(stats[k]) for k in names])


@pytest.mark.parametrize("exchange", [True, False])
@pytest.mark.parametrize("interleave", [True, False])
def test_tile_sharded_matches_reference(port, ref_scene, interleave,
                                        exchange):
    """render_tile_sharded: image, stats and the gradient of sum(image)
    with respect to the means."""
    jcam, _ = _cameras()
    mesh = make_mesh((1, 4), jax.devices()[:4])
    act = ref_scene.activated()

    def loss(means):
        out = render_tile_sharded(act.replace(means=means), jcam, JCFG, mesh,
                                  interleave=interleave, backend="xla",
                                  prep_exchange=exchange)
        return jnp.sum(out.image), (out.image, out.stats)

    (_, (image, stats)), grad = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(act.means)
    key = f"tile_{int(interleave)}{int(exchange)}"
    for part in ("image", "stats", "grad"):
        _assert_replicated(port, f"{key}_{part}")
    got = port[0]
    np.testing.assert_allclose(got[f"{key}_image"], np.asarray(image),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got[f"{key}_stats"],
                                  _stats(stats, TILE_STATS))
    assert int(stats["overflow_tile_cap"]) == 0
    assert int(stats["overflow_per_tile"]) == 0
    np.testing.assert_allclose(got[f"{key}_grad"], np.asarray(grad),
                               **GRAD_TOL)
    assert float(np.abs(np.asarray(grad)).max()) > 0


def test_primitive_sharded_matches_reference(port, ref_scene):
    """render_primitive_sharded with 4,096-row send buffers: image, stats
    (nothing dropped) and the gradient of sum(image) with respect to the
    (padded) means, gathered from the ranks' shards."""
    jcam, _ = _cameras()
    mesh = make_mesh((1, 4), jax.devices()[:4])
    act = pad_gaussians(ref_scene.activated(), 4)

    def loss(means):
        out = render_primitive_sharded(act.replace(means=means), jcam, JCFG,
                                       mesh, backend="xla",
                                       send_capacity=4096)
        return jnp.sum(out.image), (out.image, out.stats)

    (_, (image, stats)), grad = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(act.means)
    _assert_replicated(port, "prim_image")
    got = port[0]
    np.testing.assert_allclose(got["prim_image"], np.asarray(image),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got["prim_stats"],
                                  _stats(stats, PRIM_STATS))
    assert int(stats["overflow_send"]) == 0
    np.testing.assert_allclose(got["prim_grad"], np.asarray(grad),
                               **GRAD_TOL)


def test_skewed_send_overflow_counted(port):
    """The corner-concentrated scene: with 8,192-row send buffers the
    exchange is exact; with 128 it counts its drops, as the reference
    does."""
    _, skew = _arrays()
    jcam, _ = _cameras()
    mesh = make_mesh((1, 4), jax.devices()[:4])
    act = pad_gaussians(scenes(skew)[0].activated(), 4)
    for cap in (8192, 128):
        out = jax.jit(lambda a, c=cap: render_primitive_sharded(
            a, jcam, JCFG, mesh, backend="xla", send_capacity=c))(act)
        np.testing.assert_array_equal(port[0][f"skew{cap}_stats"],
                                      _stats(out.stats, PRIM_STATS))
        if cap == 8192:
            assert int(out.stats["overflow_send"]) == 0
            np.testing.assert_allclose(port[0]["skew8192_image"],
                                       np.asarray(out.image),
                                       atol=IMAGE_ATOL)
    assert int(out.stats["overflow_send"]) > 0


@pytest.mark.parametrize("prefix", ["train", "legacy_train"])
def test_train_step_matches_reference(port, ref_scene, prefix):
    """make_sharded_train_step on a (2, 2) mesh, one camera a data rank, on
    the tier plan and on the legacy branch: loss (1e-5 relative) and the
    five groups' gradients against `jax.grad` of the reference step, the
    same on every rank."""
    _, batch = _cameras()
    mesh = make_mesh((2, 2), jax.devices()[:4])
    params, mask = split_params(ref_scene)
    step = make_sharded_train_step(JCFG if prefix == "train" else LEGACY,
                                   mesh, H, W, cameras_per_device=1,
                                   optimizer=None, backend="xla")
    _, _, loss, grads = jax.jit(step)(params, mask, None, batch,
                                      jnp.asarray(_targets()))
    got = port[0]
    np.testing.assert_allclose(float(got[f"{prefix}_loss"]), float(loss),
                               rtol=1e-5)
    for field in SCENE_FIELDS:
        key = f"{prefix}_grad_{field}"
        _assert_replicated(port, key)
        ref = np.asarray(grads[field])
        np.testing.assert_allclose(got[key].reshape(ref.shape), ref,
                                   err_msg=field, **GRAD_TOL)
        assert float(np.abs(ref).max()) > 0, field


def test_collective_transports(port):
    """On CPU tensors every collective ran on gloo itself."""
    kinds = dict(port[0]["transports"])
    assert set(kinds) == {"all_to_all", "all_gather", "all_reduce"}, kinds
    assert set(kinds.values()) == {"gloo on cpu tensors"}, kinds


@pytest.mark.parametrize("n_pad,n_dev,cap", [
    (512, 4, None), (1_000_000, 4, None), (1_000_000, 2, None),
    (999_936, 8, None), (4096, 16, None), (512, 4, 100), (8192, 4, 5000),
])
def test_exchange_budget_matches_reference_formula(n_pad, n_dev, cap):
    """`exchange_budget` against the reference's inline expressions
    (sharded.py:158-161 with :333-337, and the tier rescale at :343-344)."""
    nl = n_pad // n_dev
    c_send = cap if cap is not None else min(nl, -(-6 * nl // n_dev))
    c_send = max(128, -(-c_send // 128) * 128)
    from gsrast_tpu.ops.binning import shard_tiers

    for interleave in (True, False):
        tiers_d = shard_tiers(TIERS, n_dev if interleave else 1)
        tiers_d = tuple((k, min(1.0, f * n_pad / (n_dev * c_send)))
                        for k, f in tiers_d)
        assert ps.exchange_budget(TIERS, n_pad, n_dev, interleave, cap) == (
            c_send, tiers_d)


def test_default_send_capacity_matches_reference_formula():
    for n, d, f in ((2048, 4, 16.0), (1_000_000, 4, 4.0), (512, 2, 4.0),
                    (10_000, 8, 5.5)):
        expect = max(256, -(-int(n * f) // (d * d) * 4 // 128) * 128)
        cfg = gt.RenderConfig(intersect_capacity_factor=f)
        assert ps.default_send_capacity(n, d, cfg) == expect
    assert gt.RenderConfig().intersect_capacity_factor == (
        RenderConfig().intersect_capacity_factor)


@pytest.mark.parametrize("interleave,backend", [
    (True, "torch"), (False, "torch"), (True, "autograd")])
def test_legacy_tile_sharded_matches_reference(port, ref_scene, interleave,
                                               backend):
    """render_tile_sharded's legacy branch (tiers=(): every rank bins its
    rows with build_binning) against the reference's, its xla backend:
    image, stats and the gradient of sum(image) with respect to the
    means; the port's blend's plain version and its oracle alike."""
    jcam, _ = _cameras()
    mesh = make_mesh((1, 4), jax.devices()[:4])
    act = ref_scene.activated()

    def loss(means):
        out = render_tile_sharded(act.replace(means=means), jcam, LEGACY,
                                  mesh, interleave=interleave)
        return jnp.sum(out.image), (out.image, out.stats)

    (_, (image, stats)), grad = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(act.means)
    key = f"legacy_tile_{int(interleave)}{backend}"
    for part in ("image", "stats", "grad"):
        _assert_replicated(port, f"{key}_{part}")
    got = port[0]
    assert int(stats["overflow_per_tile"]) == 0
    assert int(stats["overflow_capacity"]) == 0
    np.testing.assert_allclose(got[f"{key}_image"], np.asarray(image),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got[f"{key}_stats"],
                                  _stats(stats, TILE_STATS))
    np.testing.assert_allclose(got[f"{key}_grad"], np.asarray(grad),
                               **GRAD_TOL)


def test_legacy_primitive_sharded_matches_reference(port, ref_scene):
    """render_primitive_sharded's legacy branch (tiers=(): the exact
    expansion, expand_intersections) against the reference's: image, stats
    and the gradient of sum(image) with respect to the padded means."""
    jcam, _ = _cameras()
    mesh = make_mesh((1, 4), jax.devices()[:4])
    act = pad_gaussians(ref_scene.activated(), 4)

    def loss(means):
        out = render_primitive_sharded(act.replace(means=means), jcam,
                                       LEGACY, mesh, send_capacity=4096)
        return jnp.sum(out.image), (out.image, out.stats)

    (_, (image, stats)), grad = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(act.means)
    _assert_replicated(port, "legacy_prim_image")
    got = port[0]
    assert int(stats["overflow_send"]) == int(stats["overflow_capacity"]) == 0
    np.testing.assert_allclose(got["legacy_prim_image"], np.asarray(image),
                               atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got["legacy_prim_stats"],
                                  _stats(stats, PRIM_STATS))
    np.testing.assert_allclose(got["legacy_prim_grad"], np.asarray(grad),
                               **GRAD_TOL)


def test_legacy_tiers_raise():
    """With tiers=() the sharded functions take the legacy branch; they
    raise only for a backend they cannot blend with ('dense'), before
    touching a process group."""
    rcfg = gt.RenderConfig(backend="dense")
    for call in (lambda: ps.render_tile_sharded(None, None, rcfg, None),
                 lambda: ps.render_primitive_sharded(None, None, rcfg, None),
                 lambda: ps.make_sharded_train_step(rcfg, None, H, W)):
        with pytest.raises(ValueError, match="blend with"):
            call()


def test_pad_gaussians_matches_reference(ref_scene):
    from torch_parity import t2n

    _, port_scene = scenes(_arrays()[0])
    padded = ps.pad_gaussians(port_scene.activated(), 3)
    ref = pad_gaussians(ref_scene.activated(), 3)
    assert padded.means.shape[0] == 513
    for f in dataclasses.fields(padded):
        np.testing.assert_allclose(t2n(getattr(padded, f.name)),
                                   np.asarray(getattr(ref, f.name)),
                                   atol=1e-6, err_msg=f.name)
