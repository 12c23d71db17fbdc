"""Helpers for the parity tests of `gsrast_tpu_torch` against `gsrast_tpu`:
the same inputs, made with numpy from a seed or loaded from the fixtures,
cross between the two packages as numpy arrays.

`gsrast_tpu` is imported inside the helpers that need it: it depends on
flax, which a machine with a GPU may lack, and the `cuda`-marked tests must
still import this module there."""

import os

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
