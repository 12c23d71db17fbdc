"""The preprocess's radius and tile rectangles, and the tier plan built on
them, against the reference at scale, on the CPU: the anisotropic scene of
`torch_parity.seeded_arrays(seed, n, extent=1.5)` before the front camera
at 1920x1080 with 16x32 tiles, each package computing its own preprocess
and then its own tier plan from it.

The reference's preprocess runs op by op (jitted, XLA fuses products and
sums into FMAs on the CPU, and its own bits change).

- From the same activated Gaussians (the reference's scales, rotations and
  opacities), the port's preprocess is the reference's bit for bit: conic,
  radius and rect, and every `TierPlan` field of the plans built on them.
  (The focal length was an ulp off before the camera divided the image
  size by 2 tan(fov / 2) as the reference does: PyTorch takes a number
  divided by a tensor as the tensor's reciprocal times the number.)
- From each package's own activation, the inputs already differ: XLA's
  float32 exp on the CPU is a polynomial an ulp or two from the correctly
  rounded value at about a tenth of the log-scales (torch's differs at a
  hundredth), and the quaternion norms' sums round differently. The conic
  then differs in its last bits at most Gaussians, and a few integer radii
  cross an integer: each such flip is by 1 between two positive radii, and
  the flips, the rect fields and the plans' slots that differ are held at
  or under what was measured (`MEASURED`).

The 20,000-Gaussian cases run in tier 1; the 200,000-Gaussian ones, with
seeds 0-3, are `slow`."""

import functools

import jax
import numpy as np
import pytest
import torch

import gsrast_tpu as gs
import gsrast_tpu_torch as gt
from gsrast_tpu.ops import binning as jax_binning
from gsrast_tpu.ops import preprocess as jax_preprocess
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.ops import preprocess as port_preprocess
from gsrast_tpu_torch.scene.gaussians import ActivatedGaussians

from torch_parity import front_camera, scenes, seeded_arrays, t2n

torch.set_num_threads(2)
TILE = (16, 32)
# k_last 512 x grid_w 60 stays under the planner's bound of 4e6.
TIERS = ((2, 1.0), (8, 0.5), (32, 0.2), (128, 0.05), (512, 0.01))
FIELDS = ("tile_key", "depth_key", "gauss", "order", "total",
          "overflow_tile_cap")
RECT = ("x_min", "y_min", "x_max", "y_max")
# (n, seed) -> (radius flips, rect fields that differ, plan slots whose
# tile_key differs) from each package's own activation, as measured.
MEASURED = {
    (20_000, 0): (0, 0, 0), (20_000, 1): (0, 0, 0), (20_000, 2): (0, 0, 0),
    (20_000, 3): (0, 0, 0),
    # seed 2: one y_max a tile lower moves a count, and the ranks behind it
    (200_000, 0): (4, 0, 0), (200_000, 1): (1, 0, 0),
    (200_000, 2): (1, 1, 10_216), (200_000, 3): (1, 0, 0),
}


@functools.cache
def _jax_plan():
    return jax.jit(jax_binning.plan_tiers, static_argnums=(1, 2, 3))


def _both(n: int, seed: int) -> dict:
    """Each package's preprocess of the scene, the port's also from the
    reference's activated Gaussians, and the grid."""
    jscene, tscene = scenes(seeded_arrays(seed, n, extent=1.5))
    jcam, tcam = front_camera(1920, 1080)
    jcfg = gs.RenderConfig(tile_h=TILE[0], tile_w=TILE[1], tiers=TIERS)
    tcfg = gt.RenderConfig(tile_h=TILE[0], tile_w=TILE[1], tiers=TIERS,
                           backend="torch")
    jact = jscene.activated()
    with torch.no_grad():
        own = port_preprocess.preprocess_torch(tscene.activated(), tcam, tcfg)
        same = port_preprocess.preprocess_torch(ActivatedGaussians(**{
            f: torch.from_numpy(np.array(getattr(jact, f))) for f in (
                "means", "scales", "quats", "opacities", "sh", "mask")}),
            tcam, tcfg)
    return dict(ref=jax_preprocess.preprocess(jact, jcam, jcfg), own=own,
                same=same, jcfg=jcfg,
                tcfg=tcfg, grid=tcfg.grid_shape(1080, 1920))


def _plans(prep_ref, prep_port, case: dict):
    gh, gw = case["grid"]
    return (_jax_plan()(prep_ref, gh, gw, case["jcfg"]),
            binning.plan_tiers_torch(prep_port, gh, gw, case["tcfg"]))


def _check(n: int, seed: int) -> dict:
    case = _both(n, seed)
    ref, same, own = case["ref"], case["same"], case["own"]
    # The same activated inputs: every output and the plan exactly.
    for name in ("mean2d", "depth", "conic", "opacity", "radius"):
        np.testing.assert_array_equal(t2n(getattr(same, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name, a, b in zip(RECT, same.rect, ref.rect):
        np.testing.assert_array_equal(t2n(a), np.asarray(b), err_msg=name)
    jplan, tplan = _plans(ref, same, case)
    for name in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(tplan, name)),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    # Each package's own activation: the flips, counted and bounded.
    r_ref, r_own = np.asarray(ref.radius), t2n(own.radius)
    flipped = np.nonzero(r_ref != r_own)[0]
    assert np.all(np.abs(r_ref[flipped] - r_own[flipped]) == 1)
    assert np.all((r_ref[flipped] > 0) & (r_own[flipped] > 0))
    rects = sum(int((t2n(a) != np.asarray(b)).sum())
                for a, b in zip(own.rect, ref.rect))
    jplan, tplan = _plans(ref, own, case)
    slots = int((t2n(tplan.tile_key) != np.asarray(jplan.tile_key)).sum())
    got = (len(flipped), rects, slots)
    print(f"n={n} seed={seed}: radius flips {len(flipped)} "
          f"{list(zip(r_ref[flipped].tolist(), r_own[flipped].tolist()))}, "
          f"rect fields differing {rects}, plan slots differing {slots}")
    want = MEASURED[(n, seed)]
    assert all(g <= w for g, w in zip(got, want)), (got, want)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_preprocess_parity_scale(seed):
    _check(20_000, seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_preprocess_parity_scale_slow(seed):
    _check(200_000, seed)
