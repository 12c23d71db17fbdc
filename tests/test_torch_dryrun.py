"""The port's entry point, multi-rank dry run and scaling harness
(`gsrast_tpu_torch.diag.dryrun`, `diag.scaling_bench`) against the
reference's `__graft_entry__.py` and `scripts/scaling_bench.py`: `entry`'s
image against the reference's `render` with the same config on the
reference's scene; `dryrun_multichip` on 2 and 4 gloo CPU ranks against the
reference's sharded train step, tile-sharded audit and primitive-sharded
loss on the same arrays and a mesh of the same shape on virtual devices;
the harness's JSON against `SCALING_r05.json`'s keys, and its one-rank tile
step's gradient against `render`'s."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch.diag import dryrun, scaling_bench
from gsrast_tpu_torch.parallel import sharded as ps

from torch_parity import REPO, jax_scene_arrays, launch_ranks

torch.set_num_threads(2)

# The entry image: the reference's oracle against the kernels' plain
# versions, which sum the blend in the same order (the sharded and render
# tests' image tolerance).
IMAGE_ATOL = 2e-5
# The dry run's losses: the same sums in another order.
LOSS_RTOL = 1e-5
# Its gradient norm: per-element gradients agree to 1e-4 relative (the
# reference's sharded tests' tolerance).
GNORM_RTOL = 1e-4
DRYRUN_SIZE = (512, 64)  # width, height: 8 x 4 tiles of 8 x 128
DRYRUN_N = 2048
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def test_entry_matches_reference():
    """`entry`'s fn on the reference entry's scene (at 2,000 Gaussians and
    128x96) and camera gives the reference's image; the entry's own camera
    is the reference's, and its own scene renders a finite image."""
    import __graft_entry__ as graft
    from gsrast_tpu import RenderConfig
    from gsrast_tpu.render.api import render

    jscene, jcam = graft._example_scene_and_camera(2000, 128, 96)
    jcfg = RenderConfig(backend="xla", intersect_capacity_factor=8.0,
                        tiers=dryrun.ENTRY_TIERS)
    ref = np.asarray(jax.jit(lambda a: render(a, jcam, jcfg).image)(
        jscene.activated()))
    fn, (act, view) = dryrun.entry(2000, 128, 96, device="cpu")
    np.testing.assert_allclose(view.numpy(), np.asarray(jcam.view),
                               atol=1e-7)
    with torch.no_grad():
        got = fn(gt.from_numpy(jax_scene_arrays(jscene)).activated(),
                 torch.from_numpy(np.array(jcam.view)))
        own = fn(act, view)
    assert got.shape == own.shape == (96, 128, 3)
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, atol=IMAGE_ATOL)
    assert bool(torch.isfinite(own).all()) and float(own.max()) > 0


def _reference_dryrun(jscene, world: int) -> dict:
    """The reference's `dryrun_multichip` steps at the test's size on
    `world` virtual devices, with its oracle ('xla') for the blend."""
    import optax
    from gsrast_tpu import RenderConfig
    from gsrast_tpu.camera import Camera, look_at
    from gsrast_tpu.parallel.mesh import make_mesh
    from gsrast_tpu.parallel.sharded import (make_sharded_train_step,
                                             pad_gaussians,
                                             render_primitive_sharded,
                                             render_tile_sharded)
    from gsrast_tpu.scene.gaussians import split_params

    width, height = DRYRUN_SIZE
    shape = dryrun.mesh_shape(world)
    devices = jax.devices()[:world]
    mesh = make_mesh(shape, devices)
    cfg = RenderConfig(backend="xla", max_per_tile=2048, tile_chunk=4,
                       intersect_capacity_factor=16.0,
                       tiers=dryrun.DRYRUN_TIERS)
    base = Camera(view=look_at(jnp.array([0.0, 0.0, -3.0]), jnp.zeros(3)),
                  fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
                  width=width, height=height)
    cams = jax.tree.map(lambda x: jnp.broadcast_to(x, (shape[0],) + x.shape),
                        base)
    targets = jnp.zeros((shape[0], height, width, 3), jnp.float32)
    params, mask = split_params(jscene)
    optimizer = optax.adam(1e-3)
    step = make_sharded_train_step(cfg, mesh, height, width,
                                   cameras_per_device=1, optimizer=optimizer)
    _, _, loss, grads = jax.jit(step)(params, mask, optimizer.init(params),
                                      cams, targets)
    gnorm = jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)))
    stats = jax.jit(lambda a: render_tile_sharded(a, base, cfg, mesh).stats)(
        jscene.activated())
    act = pad_gaussians(jscene.activated(), shape[1])
    tile_mesh = make_mesh((1, shape[1]), devices[:shape[1]])
    out = jax.jit(lambda a: render_primitive_sharded(
        a, base, cfg, tile_mesh, backend="xla"))(act)
    return {"loss": float(loss), "grad_norm": float(gnorm),
            "tile_intersections": int(stats["num_intersections"]),
            "prim_loss": float(jnp.mean(out.image)),
            "prim_intersections": int(out.stats["num_intersections"])}


@pytest.fixture(scope="module")
def dryrun_scene():
    from gsrast_tpu import random_scene

    return random_scene(jax.random.PRNGKey(1), DRYRUN_N, sh_degree=1,
                        scale_range=(0.01, 0.05))


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_matches_reference(dryrun_scene, world, tmp_path):
    """On (1, 2) and (2, 2) meshes of gloo ranks: every overflow counter 0,
    the train step's loss and gradient norm, the tile-sharded intersections
    and the primitive-sharded loss and intersections of the reference on
    the same arrays; every rank holds the same numbers."""
    arrays = {f"scene_{k}": v for k, v in jax_scene_arrays(
        dryrun_scene).items()}
    arrays.update(size=np.array(DRYRUN_SIZE), min_intersections=np.array(0))
    ranks = launch_ranks(world, "dryrun_rank", arrays, tmp_path)
    for r in ranks[1:]:
        for key in ("loss", "grad_norm", "tile_intersections",
                    "prim_intersections"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
    got = ranks[0]
    assert list(got["mesh"]) == list(dryrun.mesh_shape(world))
    for key in ("overflow_capacity", "overflow_tile_cap",
                "overflow_per_tile"):
        assert int(got[key]) == 0, key
    ref = _reference_dryrun(dryrun_scene, world)
    assert ref["tile_intersections"] > 1000
    assert int(got["tile_intersections"]) == ref["tile_intersections"]
    assert int(got["prim_intersections"]) == ref["prim_intersections"]
    for key in ("loss", "prim_loss"):
        np.testing.assert_allclose(float(got[key]), ref[key], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]), ref["grad_norm"],
                               rtol=GNORM_RTOL)


def test_dryrun_command_on_cpu_ranks():
    """`python -m gsrast_tpu_torch.diag.dryrun --device cpu --n 2` at a
    small size: the entry line, then rank 0's summary on the (1, 2) mesh
    of gloo CPU ranks; `--device cuda` exits nonzero without a card."""
    cmd = [sys.executable, "-m", "gsrast_tpu_torch.diag.dryrun", "--n", "2",
           "--entry-gaussians", "1000", "--entry-width", "128",
           "--entry-height", "96", "--gaussians", "1024", "--width", "512",
           "--height", "64", "--min-intersections", "1000"]
    proc = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                          text=True, env=ENV, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry ok: (96, 128, 3) "), lines
    summary = [ln for ln in lines if ln.startswith("dryrun_multichip ok:")]
    assert len(summary) == 1, lines
    assert "mesh={'data': 1, 'tiles': 2} 512x64/1024g backend=torch" in (
        summary[0])
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, capture_output=True, text=True, env=ENV,
                              cwd=REPO, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_exchange_budget_matches_reference_scaling_setup(n_dev):
    """`exchange_budget` gives the budgets of the reference harness's
    `_exchange_setup` (scripts/scaling_bench.py:61-74), one rank included,
    which the harness takes from it."""
    from gsrast_tpu.ops.binning import shard_tiers

    tiers, n_pad = dryrun.ENTRY_TIERS, 200_000
    tiers_d = shard_tiers(tiers, n_dev)
    c_send = None
    if n_dev > 1:
        nl = n_pad // n_dev
        c_send = max(128, -(-min(nl, -(-6 * nl // n_dev)) // 128) * 128)
        tiers_d = tuple((k, min(1.0, f * n_pad / (n_dev * c_send)))
                        for k, f in tiers_d)
    assert ps.exchange_budget(tiers, n_pad, n_dev, True) == (c_send,
                                                              tiers_d)


def test_scaling_bench_json_has_reference_keys(tmp_path):
    """The harness on D = 1, 2 gloo CPU ranks at a tiny size: the keys of
    `SCALING_r05.json` and more, one entry per D in every list."""
    out = tmp_path / "scaling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gsrast_tpu_torch.diag.scaling_bench",
         "--device", "cpu", "--ranks", "2", "--n", "600", "--width", "128",
         "--height", "64", "--iters", "1", "--out", str(out)],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(out.read_text())
    with open(os.path.join(REPO, "SCALING_r05.json")) as f:
        ref = json.load(f)
    assert set(ref) <= set(got)
    assert got["device_counts"] == [1, 2]
    assert got["pixels"] == 128 * 64 and got["n_gaussians"] == 600
    for mode in ("tile", "primitive"):
        assert set(ref["modes"][mode]) <= set(got["modes"][mode])
        for key, values in got["modes"][mode].items():
            assert len(values) == 2, (mode, key)
            assert all(v > 0 for v in values), (mode, key)
    for d in ("1", "2"):
        assert set(got["stages_tile_fwd_ms"][d]) == set(
            ref["stages_tile_fwd_ms"][d])
        assert got["share_control_ms"][d] > 0
    assert got["transport"] == ["gloo", "gloo"] and got["cards"] == [0, 0]
    assert got["name"] is None and got["device"] == "cpu"


# The harness's one-rank gradient against the reference's: the test_torch_grad
# tolerance (float32 sums over pixels and intersections in other orders).
REF_GRAD_RTOL = 1e-4
SCALING_SIZE = (800, 128, 64)  # N, width, height


def _reference_mean_image_grad(scene, camera, cfg) -> np.ndarray:
    """jax.grad of the reference's mean(render(...).image) with respect to
    the activated means, on the port scene's arrays and camera, with the
    port config's fields and the reference's oracle ('xla')."""
    import dataclasses

    from gsrast_tpu import RenderConfig
    from gsrast_tpu.camera import Camera
    from gsrast_tpu.render.api import render
    from gsrast_tpu.scene.gaussians import from_arrays

    from torch_parity import SCENE_FIELDS, t2n

    act = from_arrays(*(t2n(getattr(scene, f)) for f in SCENE_FIELDS)
                      ).activated()
    jcam = Camera(view=jnp.asarray(t2n(camera.view)),
                  fov_x=jnp.float32(float(camera.fov_x)),
                  fov_y=jnp.float32(float(camera.fov_y)),
                  znear=jnp.float32(float(camera.znear)),
                  zfar=jnp.float32(float(camera.zfar)),
                  width=camera.width, height=camera.height)
    jcfg = RenderConfig(**dict(dataclasses.asdict(cfg), backend="xla"))
    grad = jax.jit(jax.grad(lambda m: jnp.mean(render(
        act.replace(means=m), jcam, jcfg).image)))(act.means)
    return np.asarray(grad)


def test_scaling_tile_step_gradient_matches_render(tmp_path):
    """The harness's tile-mode step on one rank: the gradient of
    mean(image) with respect to the means is the port `render`'s, within
    1e-6 of its largest magnitude, and jax.grad's of the reference's
    `render` on the same arrays, within REF_GRAD_RTOL; its `blend` stage
    prefix assembles to `render_tile_sharded`'s image."""
    n, width, height = SCALING_SIZE
    (rank,) = launch_ranks(1, "scaling_tile_grad",
                           {"size": np.array(SCALING_SIZE)}, tmp_path)
    scene, camera = scaling_bench.scene_camera(n, width, height, "cpu")
    cfg = scaling_bench.bench_config(scene, camera)
    with torch.no_grad():
        act = scene.activated()
    means = act.means.detach().clone().requires_grad_(True)
    image = gt.render(type(act)(**dict(vars(act), means=means)), camera,
                      cfg).image
    torch.mean(image).backward()
    ref = means.grad.numpy()
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(rank["grad"] - ref).max()) <= 1e-6 * scale
    jref = _reference_mean_image_grad(scene, camera, cfg)
    jscale = float(np.abs(jref).max())
    assert jscale > 0
    np.testing.assert_allclose(rank["grad"] / jscale, jref / jscale,
                               atol=REF_GRAD_RTOL)
    np.testing.assert_array_equal(rank["blend_prefix_image"], rank["image"])


def test_scaling_tile_prefix_matches_render_tile_sharded(tmp_path):
    """On 2 gloo ranks, through the relevance exchange: the tiles of the
    harness's `blend` stage prefix assemble to `render_tile_sharded`'s
    image on every rank, bit for bit, and the ranks' step gradients
    agree."""
    ranks = launch_ranks(2, "scaling_tile_grad",
                         {"size": np.array(SCALING_SIZE)}, tmp_path)
    for r in ranks:
        assert float(np.abs(r["image"]).max()) > 0.1
        np.testing.assert_array_equal(r["blend_prefix_image"], r["image"])
    np.testing.assert_array_equal(ranks[1]["grad"], ranks[0]["grad"])
