"""Helpers for the parity tests of `gsrast_tpu_torch` against `gsrast_tpu`:
the same inputs, made with numpy from a seed or loaded from the fixtures,
cross between the two packages as numpy arrays.

`gsrast_tpu` is imported inside the helpers that need it: it depends on
flax, which a machine with a GPU may lack, and the `cuda`-marked tests must
still import this module there."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.ops import preprocess as tp
from gsrast_tpu_torch.ops.projection import TileRect
from gsrast_tpu_torch.render.api import scene_tile_counts
from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED_SMALL = os.path.join(FIXTURES, "trained_small.ply")
GOLDEN = os.path.join(FIXTURES, "trained_small_golden.png")

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def seeded_arrays(seed: int, n: int, sh_degree: int = 3,
                  scale_range=(0.05, 0.3), extent: float = 1.0) -> dict:
    """An anisotropic scene's raw parameters drawn with numpy."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0] = rng.uniform(-1.0, 1.0, (n, 3))
    sh[:, 1:] = 0.1 * rng.standard_normal((n, k - 1, 3))
    lo, hi = np.log(scale_range[0] * extent), np.log(scale_range[1] * extent)
    return dict(
        means=rng.uniform(-extent, extent, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(lo, hi, (n, 3)).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-1.0, 3.0, (n,)).astype(np.float32),
        sh=sh,
    )


def scenes(arrays: dict):
    """(reference scene, port scene) from the same raw arrays."""
    from gsrast_tpu.scene.gaussians import from_arrays

    return (from_arrays(*(arrays[f] for f in SCENE_FIELDS)),
            gt.from_numpy(arrays))


def jax_scene_arrays(scene) -> dict:
    return {f: np.asarray(getattr(scene, f)) for f in SCENE_FIELDS + ("mask",)}


def front_camera(width: int, height: int, dist: float = 4.0):
    """(reference camera, port camera) with identical arrays."""
    import jax.numpy as jnp
    from gsrast_tpu.camera import Camera as JaxCamera
    from gsrast_tpu.camera import look_at as jax_look_at

    jcam = JaxCamera(view=jax_look_at(jnp.array([0.0, 0.0, -dist]),
                                      jnp.zeros(3)),
                     fov_x=jnp.float32(1.2), fov_y=jnp.float32(1.0),
                     width=width, height=height)
    return jcam, camera_to_torch(jcam)


def port_front_camera(width: int, height: int, dist: float = 4.0,
                      device="cpu") -> gt.Camera:
    """The port's camera of `front_camera`, built by the port alone."""
    return gt.make_camera(gt.look_at([0.0, 0.0, -dist], [0.0, 0.0, 0.0],
                                     device=device),
                          1.2, 1.0, width, height, device=device)


def camera_to_torch(jcam) -> gt.Camera:
    return gt.make_camera(np.asarray(jcam.view), float(jcam.fov_x),
                          float(jcam.fov_y), jcam.width, jcam.height,
                          znear=float(jcam.znear), zfar=float(jcam.zfar))


def t2n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def camera_batch_to_torch(jcams) -> gt.Camera:
    """The reference's camera batch (`Dataset.batch_cameras`: one Camera
    pytree whose leaves have a leading batch dim) as the port's batched
    Camera."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return gt.Camera(view=t(jcams.view), fov_x=t(jcams.fov_x),
                     fov_y=t(jcams.fov_y), znear=t(jcams.znear),
                     zfar=t(jcams.zfar), width=int(jcams.width),
                     height=int(jcams.height))


def prep_to_torch(prep) -> tp.Preprocessed:
    """A reference `Preprocessed` as the port's, through numpy."""
    def t(x):
        return torch.from_numpy(np.array(x))

    return tp.Preprocessed(
        mean2d=t(prep.mean2d), depth=t(prep.depth), conic=t(prep.conic),
        color=t(prep.color), opacity=t(prep.opacity), radius=t(prep.radius),
        rect=TileRect(*(t(r) for r in prep.rect)))


# Blend cases shared by the forward and backward blend tests.
BLEND_CASES = ("trained_small_16x32", "aniso_32x64", "saturated_stack")


def _saturated_stack() -> dict:
    """64 near-opaque splats stacked along the view axis at the centre."""
    n = 64
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(0.0, 0.5, n, dtype=np.float32)
    sh = np.zeros((n, 1, 3), np.float32)
    sh[:, 0] = np.random.default_rng(1).uniform(-1.0, 1.0, (n, 3))
    return dict(means=means,
                log_scales=np.log(np.full((n, 3), 0.3, np.float32)),
                quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
                opacity_logits=np.full((n,), 4.0, np.float32), sh=sh)


def _case_setup(case):
    """(scene arrays or None for trained_small, (width, height), tiles)."""
    if case == "trained_small_16x32":
        return None, (128, 128), (16, 32)
    if case == "aniso_32x64":
        return seeded_arrays(9, 150), (128, 64), (32, 64)
    return _saturated_stack(), (128, 16), (8, 32)


def packed_reference(case):
    """Reference-packed features of one blend case: (feat_packed (16, S),
    tile_starts, grid_h, grid_w, tile_h, tile_w), as JAX arrays."""
    import gsrast_tpu as gs
    from gsrast_tpu.ops import binning as jax_binning
    from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
    from gsrast_tpu.render import pallas_pipeline as jax_pp
    from gsrast_tpu.render.api import scene_tile_counts as jax_tile_counts
    from gsrast_tpu.scene.gaussians import from_arrays

    arrays, (w, h), (th, tw) = _case_setup(case)
    if arrays is None:
        scene = gs.load_ply(TRAINED_SMALL)
        cam = gs.auto_frame(*scene.bbox(), w, h)
    else:
        scene = from_arrays(*(arrays[f] for f in SCENE_FIELDS))
        cam, _ = front_camera(w, h)
    rcfg = gs.RenderConfig(tile_h=th, tile_w=tw)
    rcfg = rcfg.replace(tiers=jax_binning.auto_tiers(
        jax_tile_counts(scene, cam, rcfg)))
    prep = jax_preprocess(scene.activated(), cam, rcfg)
    gh, gw = rcfg.grid_shape(cam.height, cam.width)
    plan = jax_binning.plan_tiers(prep, gh, gw, rcfg)
    assert int(plan.overflow_tile_cap) == 0
    feat, starts = jax_pp.fused_pack(
        jax_pp.feature_rows(prep), plan.tile_key, plan.depth_key, plan.slot,
        plan.gauss, plan.order, rcfg.tiers, prep.depth.shape[0], gh * gw)
    return feat, starts, gh, gw, th, tw


# Local tiles (the tile-sharded path's blend input): rows {1, 3} of the 4x4
# grid of 16x32 tiles over a 128x64 view, tile_map (row0 1, row step 2).
LOCAL_ROWS, LOCAL_TILE_MAP = 2, (1, 2)


def _local_setup():
    """(scene arrays, (width, height), tiles) of the local-tiles case."""
    return seeded_arrays(9, 150), (128, 64), (16, 32)


def packed_reference_local():
    """Reference-packed features of the local rows: (feat_packed (16, S),
    tile_starts, grid_h, grid_w, tile_h, tile_w), as JAX arrays, from its
    row-local `plan_tiers` and `fused_pack` at the local tile count."""
    import gsrast_tpu as gs
    from gsrast_tpu.ops import binning as jax_binning
    from gsrast_tpu.ops.preprocess import preprocess as jax_preprocess
    from gsrast_tpu.render import pallas_pipeline as jax_pp
    from gsrast_tpu.render.api import scene_tile_counts as jax_tile_counts
    from gsrast_tpu.scene.gaussians import from_arrays

    arrays, (w, h), (th, tw) = _local_setup()
    scene = from_arrays(*(arrays[f] for f in SCENE_FIELDS))
    cam, _ = front_camera(w, h)
    rcfg = gs.RenderConfig(tile_h=th, tile_w=tw)
    rcfg = rcfg.replace(tiers=jax_binning.auto_tiers(
        jax_tile_counts(scene, cam, rcfg)))
    prep = jax_preprocess(scene.activated(), cam, rcfg)
    gh, gw = rcfg.grid_shape(h, w)
    row0, step = LOCAL_TILE_MAP
    plan = jax_binning.plan_tiers(prep, gh, gw, rcfg,
                                  num_local_rows=LOCAL_ROWS, row0=row0,
                                  row_stride=step)
    feat, starts = jax_pp.fused_pack(
        jax_pp.feature_rows(prep), plan.tile_key, plan.depth_key, plan.slot,
        plan.gauss, plan.order, rcfg.tiers, prep.depth.shape[0],
        LOCAL_ROWS * gw)
    return feat, starts, gh, gw, th, tw


def packed_port_local(device, whole_grid: bool = False):
    """The local-tiles case packed by the port alone, on `device` (its
    whole grid where `whole_grid`)."""
    arrays, (w, h), (th, tw) = _local_setup()
    scene = gt.from_numpy(arrays, device=device)
    cam = port_front_camera(w, h, device=device)
    rcfg = gt.RenderConfig(tile_h=th, tile_w=tw)
    rcfg = rcfg.replace(tiers=binning.auto_tiers(
        scene_tile_counts(scene, cam, rcfg)))
    gh, gw = rcfg.grid_shape(h, w)
    row0, step = LOCAL_TILE_MAP
    with torch.no_grad():
        prep = tp.preprocess(scene.activated(), cam, rcfg)
        if whole_grid:
            plan = binning.plan_tiers(prep, gh, gw, rcfg)
        else:
            plan = binning.plan_tiers(prep, gh, gw, rcfg,
                                      num_local_rows=LOCAL_ROWS, row0=row0,
                                      row_stride=step)
        feat, starts = sort_pack(feature_rows(prep), plan,
                                 (gh if whole_grid else LOCAL_ROWS) * gw)
    return feat, starts, gh, gw, th, tw


# A packed blend input built directly (no scene): tile 0 of a 1x3 grid of
# 8x32 tiles holds LONG_SEGMENT faint splats, and its pixels saturate
# after 950-1350 positions, most of them past four staged batches of
# either kernel (256 positions a batch in the forward, 64 in the
# backward); tile 1 is empty; tile 2 holds 300 near-opaque splats that
# saturate early; and 77 dead columns past tile_starts[-1] carry features
# too.
LONG_SEGMENT = 2000


def long_segment_case(device="cpu", seed=5):
    """(feat (10, S), tile_starts, grid_h, grid_w, tile_h, tile_w)."""
    rng = np.random.default_rng(seed)
    th, tw, counts, dead = 8, 32, (LONG_SEGMENT, 0, 300), 77
    cols = []
    for t, (n, op) in enumerate(zip(counts, ((0.05, 0.1), None,
                                             (0.3, 0.9)))):
        if n == 0:
            continue
        sx, sy = rng.uniform(1.5, 6.0, n), rng.uniform(1.5, 6.0, n)
        rho = rng.uniform(-0.5, 0.5, n)
        det = 1.0 - rho * rho
        cols.append(np.stack([
            t * tw + rng.uniform(-4.0, tw + 4.0, n),
            rng.uniform(-4.0, th + 4.0, n),
            1.0 / (sx * sx * det), -rho / (sx * sy * det),
            1.0 / (sy * sy * det), rng.uniform(*op, n),
            *rng.uniform(0.0, 1.0, (3, n)), np.full(n, t)]))
    cols.append(np.concatenate([rng.uniform(0.0, 1.0, (9, dead)),
                                np.full((1, dead), len(counts))]))
    feat = torch.from_numpy(np.concatenate(cols, axis=1).astype(np.float32))
    starts = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int32)
    return feat.to(device), starts.to(device), 1, len(counts), th, tw


def to_reference_layout(feat, starts):
    """A port-packed (10, S) input as the reference kernels take it: (16, C)
    float32 with rows 10-15 zero and C a whole number of 128-column chunks
    with one chunk to spare, as JAX arrays."""
    import jax.numpy as jnp

    s = feat.shape[1]
    packed = np.zeros((16, -(-s // 128) * 128 + 128), np.float32)
    packed[:10, :s] = t2n(feat)
    return jnp.asarray(packed), jnp.asarray(t2n(starts))


def packed_port(case, device):
    """The same case packed by the port alone, on `device`."""
    arrays, (w, h), (th, tw) = _case_setup(case)
    if arrays is None:
        scene = gt.load_ply(TRAINED_SMALL, device=device)
        cam = gt.auto_frame(*scene.bbox(), w, h, device=device)
    else:
        scene = gt.from_numpy(arrays, device=device)
        cam = port_front_camera(w, h, device=device)
    rcfg = gt.RenderConfig(tile_h=th, tile_w=tw)
    rcfg = rcfg.replace(tiers=binning.auto_tiers(
        scene_tile_counts(scene, cam, rcfg)))
    with torch.no_grad():
        prep = tp.preprocess(scene.activated(), cam, rcfg)
        gh, gw = rcfg.grid_shape(h, w)
        plan = binning.plan_tiers(prep, gh, gw, rcfg)
        feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
    return feat, starts, gh, gw, th, tw


# Optimizer and densify state, carried from the reference into the port.
# The reference's optax.multi_transform labels of the five groups.
OPTAX_LABELS = {"means": "means", "log_scales": "scales", "quats": "quats",
                "opacity_logits": "opacity", "sh": "sh"}


def densify_state_to_torch(state):
    """A reference `DensifyState` as the port's, through numpy."""
    from gsrast_tpu_torch.train.densify import DensifyState

    return DensifyState(*(torch.from_numpy(np.array(x)) for x in state))


def adam_state_arrays(opt_state) -> dict:
    """{field: (count, mu, nu)} of a reference optimizer state (the
    `make_optimizer` multi_transform of one optax.adam per group)."""
    import jax
    import optax

    out = {}
    for field, label in OPTAX_LABELS.items():
        inner = opt_state.inner_states[label]
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        out[field] = (int(adam.count), np.array(adam.mu[field]),
                      np.array(adam.nu[field]))
    return out


def load_adam_state(optimizer, arrays: dict) -> None:
    """Set the port's Adam state (per-group moments and update count) from
    `adam_state_arrays`."""
    for group in optimizer.param_groups:
        (param,) = group["params"]
        count, mu, nu = arrays[group["name"]]
        optimizer.state[param] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(mu).to(param.device),
            "exp_avg_sq": torch.from_numpy(nu).to(param.device)}


# A COLMAP scene written by the reference package.
def _orbit_pose(theta: float, radius: float = 2.5):
    """(qvec (w, x, y, z), tvec, view) of a reference look_at camera on a
    horizontal orbit, the pose convention of `tests/test_colmap.py`."""
    import jax.numpy as jnp
    from gsrast_tpu.camera import look_at as jax_look_at

    eye = np.array([radius * np.sin(theta), 0.3, -radius * np.cos(theta)])
    view = np.asarray(jax_look_at(jnp.asarray(eye), jnp.zeros(3)))
    rot = view[:3, :3]
    w = np.sqrt(max(0.0, 1 + rot[0, 0] + rot[1, 1] + rot[2, 2])) / 2
    q = np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w),
                  (rot[0, 2] - rot[2, 0]) / (4 * w),
                  (rot[1, 0] - rot[0, 1]) / (4 * w)])
    return q, view[:3, 3], view


def reference_colmap_fixture(path, n_views: int = 3, wh=(96, 64),
                             ext: str = ".png") -> dict:
    """Render a 400-Gaussian SH-1 scene with the reference (XLA backend)
    from `n_views` orbit poses, and write it with the reference's own
    `save_png` (PIL, adaptive scanline filters; `ext` ".jpg" makes PIL
    write JPEG photographs) and `write_colmap_bin` (PINHOLE, fx = fy = 80,
    the first 200 means as SfM points in grey). Returns the scene's
    arrays."""
    import jax
    import jax.numpy as jnp
    from gsrast_tpu import config as jcfg
    from gsrast_tpu.camera import Camera as JaxCamera
    from gsrast_tpu.render.api import render as jax_render
    from gsrast_tpu.scene import colmap as jax_colmap
    from gsrast_tpu.scene.gaussians import random_scene as jax_random_scene
    from gsrast_tpu.utils.image import save_png as jax_save_png

    w, h = wh
    scene = jax_random_scene(jax.random.PRNGKey(7), 400, sh_degree=1)
    fx = fy = 80.0
    rcfg = jcfg.RenderConfig(backend="xla")
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    images = []
    for i in range(n_views):
        q, t, view = _orbit_pose(0.5 * i)
        cam = JaxCamera(view=jnp.asarray(view),
                        fov_x=jnp.float32(2 * np.arctan(w / (2 * fx))),
                        fov_y=jnp.float32(2 * np.arctan(h / (2 * fy))),
                        width=w, height=h)
        name = f"v{i:02d}{ext}"
        jax_save_png(jax_render(scene.activated(), cam, rcfg).image,
                     os.path.join(path, "images", name))
        images.append(jax_colmap.ColmapImage(name, q, t, 1))
    jax_colmap.write_colmap_bin(
        str(path), {1: jax_colmap.ColmapCamera("PINHOLE", w, h, fx, fy,
                                               w / 2, h / 2)},
        images, xyz=np.asarray(scene.means)[:200],
        rgb=np.full((200, 3), 0.6, np.float32))
    return jax_scene_arrays(scene)


# Ranks of torch.distributed for the sharded paths' tests: gloo CPU
# processes, each running one of the rank functions below on arrays that
# the test hands over in an .npz.
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(world: int, entry: str, arrays: dict, tmp_path,
                 timeout: float = 400.0) -> list:
    """Run `entry` (a function of this module: rank arrays -> dict of
    arrays) on `world` gloo ranks, one CPU process each, all given
    `arrays`; returns each rank's outputs as a dict of numpy arrays.
    Raises with the output of any rank that failed."""
    inputs = os.path.join(tmp_path, "rank_inputs.npz")
    np.savez(inputs, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, TESTS_DIR] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_parity", entry, str(world), str(port),
         str(r), inputs, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=TESTS_DIR, env=env) for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    failed = [(r, log) for r, (proc, log) in enumerate(zip(procs, logs))
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(f"rank {r} failed:\n{log[-4000:]}"
                                     for r, log in failed))
    return [dict(np.load(os.path.join(tmp_path, f"rank{r}.npz")))
            for r in range(world)]


def _rank_main(argv) -> None:
    import torch.distributed as dist

    entry, world, port, rank, inputs, out_dir = argv
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        out = globals()[entry](dict(np.load(inputs)))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: t2n(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()})


def _rank_scene(arrays: dict, prefix: str) -> gt.GaussianScene:
    return gt.from_numpy({f: arrays[f"{prefix}_{f}"] for f in SCENE_FIELDS})


def _rank_camera(arrays: dict, prefix: str = "cam") -> gt.Camera:
    fields = ("view", "fov_x", "fov_y", "znear", "zfar")
    width, height = (int(v) for v in arrays[f"{prefix}_size"])
    return gt.Camera(**{f: torch.from_numpy(arrays[f"{prefix}_{f}"])
                        for f in fields}, width=width, height=height)


def _stats_vector(stats: dict, names) -> torch.Tensor:
    return torch.stack([stats[k] for k in names])


def sharded_rank_cases(arrays: dict) -> dict:
    """The sharded tests' cases on this rank (4 ranks): the tile-sharded
    render in its four modes and the primitive-sharded render on the (1, 4)
    mesh, each image with its stats and the gradient of sum(image) with
    respect to the means; the skewed scene's send overflow; the legacy
    branches (tiers=()) of both renders, the tile-sharded one also on the
    'autograd' oracle; and on the (2, 2) mesh the train step's loss and
    gradients, on both plans."""
    import dataclasses

    from gsrast_tpu_torch.parallel import comm
    from gsrast_tpu_torch.parallel import sharded as ps
    from gsrast_tpu_torch.parallel.mesh import TILE_AXIS, make_mesh

    tiers = tuple((int(k), float(f)) for k, f in arrays["tiers"])
    rcfg = gt.RenderConfig(tiers=tiers, background=tuple(
        float(v) for v in arrays["background"]), backend="torch")
    cam = _rank_camera(arrays)
    mesh = make_mesh((1, 4))
    out = {}
    for interleave in (True, False):
        for exchange in (True, False):
            act = _rank_scene(arrays, "scene").activated()
            means = act.means.detach().requires_grad_(True)
            res = ps.render_tile_sharded(
                dataclasses.replace(act, means=means), cam, rcfg, mesh,
                interleave=interleave, prep_exchange=exchange)
            res.image.sum().backward()
            key = f"tile_{int(interleave)}{int(exchange)}"
            out[f"{key}_image"] = res.image
            out[f"{key}_stats"] = _stats_vector(res.stats, TILE_STATS)
            out[f"{key}_grad"] = means.grad

    d = mesh.get_local_rank(TILE_AXIS)

    def shard(prefix, with_grad=False):
        act = ps.pad_gaussians(_rank_scene(arrays, prefix).activated(), 4)
        nl = act.means.shape[0] // 4
        local = {f.name: getattr(act, f.name)[d * nl:(d + 1) * nl].detach()
                 for f in dataclasses.fields(act)}
        if with_grad:
            local["means"].requires_grad_(True)
        return type(act)(**local)

    g = shard("scene", with_grad=True)
    res = ps.render_primitive_sharded(g, cam, rcfg, mesh, send_capacity=4096)
    res.image.sum().backward()
    out["prim_image"] = res.image
    out["prim_stats"] = _stats_vector(res.stats, PRIM_STATS)
    out["prim_grad"] = comm.all_gather(g.means.grad, mesh, TILE_AXIS)
    with torch.no_grad():
        for cap in (8192, 128):
            res = ps.render_primitive_sharded(shard("skew"), cam, rcfg, mesh,
                                              send_capacity=cap)
            out[f"skew{cap}_image"] = res.image
            out[f"skew{cap}_stats"] = _stats_vector(res.stats, PRIM_STATS)

    # The legacy branches (tiers=()), the reference test_sharded.py's CFG.
    legacy = gt.RenderConfig(
        max_per_tile=int(arrays["legacy_max_per_tile"]), tile_chunk=2,
        intersect_capacity_factor=16.0, background=rcfg.background,
        backend="torch")
    for interleave, backend in ((True, "torch"), (False, "torch"),
                                (True, "autograd")):
        act = _rank_scene(arrays, "scene").activated()
        means = act.means.detach().requires_grad_(True)
        res = ps.render_tile_sharded(
            dataclasses.replace(act, means=means), cam, legacy, mesh,
            interleave=interleave, backend=backend)
        res.image.sum().backward()
        key = f"legacy_tile_{int(interleave)}{backend}"
        out[f"{key}_image"] = res.image
        out[f"{key}_stats"] = _stats_vector(res.stats, TILE_STATS)
        out[f"{key}_grad"] = means.grad
    g = shard("scene", with_grad=True)
    res = ps.render_primitive_sharded(g, cam, legacy, mesh,
                                      send_capacity=4096)
    res.image.sum().backward()
    out["legacy_prim_image"] = res.image
    out["legacy_prim_stats"] = _stats_vector(res.stats, PRIM_STATS)
    out["legacy_prim_grad"] = comm.all_gather(g.means.grad, mesh, TILE_AXIS)

    mesh22 = make_mesh((2, 2))
    for prefix, config in (("train", rcfg), ("legacy_train", legacy)):
        scene = _rank_scene(arrays, "scene")
        step = ps.make_sharded_train_step(config, mesh22, cam.height,
                                          cam.width, cameras_per_device=1)
        loss, grads = step(scene, _rank_camera(arrays, "batch"),
                           torch.from_numpy(arrays["targets"]))
        out[f"{prefix}_loss"] = loss
        out.update({f"{prefix}_grad_{k}": v for k, v in grads.items()})
    out["transports"] = np.array(sorted(comm.transports.items()))
    return out


def dryrun_rank(arrays: dict) -> dict:
    """`diag.dryrun.dryrun_multichip` on this rank, on the scene's arrays at
    the test's size (`size`: width, height)."""
    import torch.distributed as dist

    from gsrast_tpu_torch.diag import dryrun

    width, height = (int(v) for v in arrays["size"])
    res = dryrun.dryrun_multichip(
        dist.get_world_size(), scene=_rank_scene(arrays, "scene"),
        width=width, height=height, device=torch.device("cpu"),
        min_intersections=int(arrays["min_intersections"]))
    mesh = res.pop("mesh")
    return dict(res, mesh=np.array(list(mesh.values())))


def scaling_tile_grad(arrays: dict) -> dict:
    """The scaling harness's tile mode on a (1, D) mesh of this rank's
    group, at its scene of `size` (N, width, height): the gradient of
    mean(image) with respect to the means from its step, and the image of
    `render_tile_sharded` beside the one assembled from its `blend`
    prefix's tiles."""
    import torch.distributed as dist

    from gsrast_tpu_torch.diag import scaling_bench
    from gsrast_tpu_torch.parallel import sharded as ps
    from gsrast_tpu_torch.parallel.mesh import make_mesh

    n, width, height = (int(v) for v in arrays["size"])
    world = dist.get_world_size()
    scene, camera = scaling_bench.scene_camera(n, width, height, "cpu")
    cfg = scaling_bench.bench_config(scene, camera)
    with torch.no_grad():
        act = scene.activated()
    mesh = make_mesh((1, world))
    step, means = scaling_bench.tile_step(act, camera, cfg, mesh)
    step()
    grid_h, grid_w = cfg.grid_shape(height, width)
    with torch.no_grad():
        image = ps.render_tile_sharded(act, camera, cfg, mesh).image
        rgb, ft, nc, _, _ = scaling_bench.tile_prefix(act, camera, cfg,
                                                      mesh)("blend")
        staged = ps._assemble(rgb, ft, nc, mesh, grid_h, grid_w,
                              ps._rows_per_device(grid_h, world), True, cfg,
                              height, width)[0]
    return {"grad": means.grad, "image": image, "blend_prefix_image": staged}


TILE_STATS = ("num_intersections", "overflow_capacity", "overflow_tile_cap",
              "overflow_per_tile")
PRIM_STATS = ("num_intersections", "overflow_send", "overflow_capacity",
              "overflow_per_tile")


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
