"""The tile blend of `gsrast_tpu_torch` against the reference's Pallas blend
kernel (`gsrast_tpu.render.pallas_blend.blend_forward`, run in interpret mode
on the CPU), on the same packed features; and the hand-written CUDA kernel
against the plain version on the card (`-m cuda`, which imports only the
port, so it also runs where the reference's dependencies are missing)."""

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.ops.preprocess import preprocess
from gsrast_tpu_torch.render.api import scene_tile_counts
from gsrast_tpu_torch.render.blend import (blend_forward, blend_forward_cuda,
                                           blend_forward_torch)
from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack

from torch_parity import (SCENE_FIELDS, TRAINED_SMALL, front_camera,
                          port_front_camera, seeded_arrays, t2n)

torch.set_num_threads(2)

# The plain version and the Pallas kernel take the same cumulative-product
# closed form; their colour sums run in another order (and the kernel's on
# the MXU), so rgb/final_t agree to a few float32 ulps of the accumulated
# values: atol 3e-6, as the reference's own kernel-vs-XLA tests use.
ATOL = 3e-6


CASES = ("trained_small_16x32", "aniso_32x64", "saturated_stack")


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


def _packed(case):
    """Reference-packed features of one case: (feat_packed (16, S),
    tile_starts, grid_h, grid_w, tile_h, tile_w)."""
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


def _packed_port(case, device):
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
    prep = preprocess(scene.activated(), cam, rcfg)
    gh, gw = rcfg.grid_shape(h, w)
    plan = binning.plan_tiers(prep, gh, gw, rcfg)
    feat, starts = sort_pack(feature_rows(prep), plan, gh * gw)
    return feat, starts, gh, gw, th, tw


@pytest.mark.parametrize("case", CASES)
def test_plain_blend_matches_pallas(case):
    from gsrast_tpu.render import pallas_blend as pb

    feat, starts, gh, gw, th, tw = _packed(case)
    out = np.asarray(pb.blend_forward(feat, starts, gh, gw, th, tw,
                                      interpret=True))
    rgb, ft, nc = blend_forward_torch(torch.from_numpy(np.array(feat[:10])),
                                      torch.from_numpy(np.array(starts)),
                                      gh, gw, th, tw)
    np.testing.assert_allclose(t2n(rgb), out[:, pb.OC_R:pb.OC_B + 1],
                               atol=ATOL)
    np.testing.assert_allclose(t2n(ft), out[:, pb.OC_FT], atol=ATOL)
    np.testing.assert_array_equal(t2n(nc), out[:, pb.OC_NC].astype(np.int32))
    if case == "saturated_stack":
        # Early termination: the centre pixel (row 8, column 64) saturates
        # well before the end of its 64-splat segment.
        t, p = (8 // th) * gw + 64 // tw, (8 % th) * tw + 64 % tw
        assert 0 < int(nc[t, p]) < 32
        assert float(ft[t, p]) < 1e-3


def test_plain_blend_small_budget_carries_transmittance():
    """A budget smaller than one tile's segment walks it in position blocks
    with T carried between them; results must not change."""
    feat, starts, gh, gw, th, tw = _packed("saturated_stack")
    f = torch.from_numpy(np.array(feat[:10]))
    s = torch.from_numpy(np.array(starts))
    full = blend_forward_torch(f, s, gh, gw, th, tw)
    blocked = blend_forward_torch(f, s, gh, gw, th, tw, budget=3 * th * tw)
    for a, b in zip(full, blocked):
        np.testing.assert_allclose(t2n(b), t2n(a), atol=ATOL)
    np.testing.assert_array_equal(t2n(blocked[2]), t2n(full[2]))


def test_backend_device_mismatch_raises():
    """The 'cuda' backend on CPU tensors raises: nothing falls back to the
    plain version."""
    feat = torch.zeros((10, 128))
    starts = torch.zeros((5,), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot run"):
        blend_forward(feat, starts, 2, 2, 8, 16, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        blend_forward_cuda(feat, starts, 2, 2, 8, 16)
    before = dict(_kernels.launch_counts)
    rgb, ft, nc = blend_forward(feat, starts, 2, 2, 8, 16, backend="torch")
    assert _kernels.launch_counts == before
    assert rgb.shape == (4, 3, 128) and float(ft.min()) == 1.0
    assert int(nc.max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case):
    """The kernel against the plain version on the same card inputs:
    rgb/final_t within 1e-5 where n_contrib agrees; n_contrib may differ
    only on rare pixels whose transmittance lands within rounding of
    T_min."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    with torch.inference_mode():
        args = _packed_port(case, torch.device("cuda"))
        rgb, ft, nc = blend_forward_cuda(*args)
        rgb_p, ft_p, nc_p = blend_forward_torch(*args)
    torch.cuda.synchronize()
    agree = nc == nc_p
    assert float((~agree).float().mean()) <= 1e-4
    assert float(torch.where(agree[:, None], rgb - rgb_p, 0.0).abs().max()
                 ) <= 1e-5
    assert float(torch.where(agree, ft - ft_p, 0.0).abs().max()) <= 1e-5
    assert int(nc.max()) > 0
