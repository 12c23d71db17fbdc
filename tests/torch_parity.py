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
from gsrast_tpu_torch.ops import preprocess as tp
from gsrast_tpu_torch.ops.projection import TileRect

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
