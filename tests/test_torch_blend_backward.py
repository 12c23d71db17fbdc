"""The tile-blend backward of `gsrast_tpu_torch`: the plain version against
the reference's Pallas backward kernel (`pallas_blend.blend_backward`, in
interpret mode on the CPU) and against autograd through the plain forward;
its chunking, its dead columns and the autograd node; and the hand-written
CUDA kernel against the plain version on the card (`-m cuda`, which imports
only the port)."""

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.render import blend
from gsrast_tpu_torch.render.blend import (BlendFunction, blend_backward,
                                           blend_backward_cuda,
                                           blend_backward_torch,
                                           blend_forward_torch)

from torch_parity import (BLEND_CASES, LOCAL_ROWS, LOCAL_TILE_MAP,
                          long_segment_case, packed_port, packed_port_local,
                          packed_reference, packed_reference_local, t2n,
                          to_reference_layout)

torch.set_num_threads(2)

# Per gradient row, |port - reference| <= ATOL * max |reference| of that
# row: the reference's own gradcheck bound (tests/test_pallas_blend.py).
# The versions replay T and sum over pixels in different orders.
ATOL = 2e-5


def cotangents(num_tiles: int, p: int, seed: int = 0, device="cpu"):
    """Seeded d_rgb (T, 3, P) and d_final_t (T, P)."""
    rng = np.random.default_rng(seed)
    d_rgb = rng.standard_normal((num_tiles, 3, p)).astype(np.float32)
    d_ft = rng.standard_normal((num_tiles, p)).astype(np.float32)
    return (torch.from_numpy(d_rgb).to(device),
            torch.from_numpy(d_ft).to(device))


def assert_rows_close(actual, expected, atol=ATOL):
    """Rows 0:9, each scaled by its largest reference magnitude."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    for r in range(9):
        scale = max(float(np.abs(expected[r]).max()), 1e-12)
        np.testing.assert_allclose(actual[r] / scale, expected[r] / scale,
                                   atol=atol, err_msg=f"gradient row {r}")


def _port_backward(case, seed=0, **kw):
    """(feat, starts, geometry, forward outputs, cotangents, d_feat) of the
    plain versions on the port's own packing of `case`."""
    feat, starts, gh, gw, th, tw = packed_port(case, "cpu")
    rgb, ft, nc = blend_forward_torch(feat, starts, gh, gw, th, tw)
    d_rgb, d_ft = cotangents(gh * gw, th * tw, seed)
    d_feat = blend_backward_torch(feat, starts, d_rgb, d_ft, ft, nc, gh, gw,
                                  th, tw, **kw)
    return feat, starts, (gh, gw, th, tw), (rgb, ft, nc), (d_rgb, d_ft), d_feat


@pytest.mark.parametrize("case", BLEND_CASES)
def test_plain_backward_matches_pallas(case):
    """Same packed features, the reference forward's final_T/n_contrib and
    the same cotangents through both backwards: rows 0:9 agree on the live
    columns [0, tile_starts[-1])."""
    import jax.numpy as jnp
    from gsrast_tpu.render import pallas_blend as pb

    feat, starts, gh, gw, th, tw = packed_reference(case)
    out = pb.blend_forward(feat, starts, gh, gw, th, tw, interpret=True)
    ft, nc = out[:, pb.OC_FT], out[:, pb.OC_NC]
    num_tiles, p = gh * gw, th * tw
    d_rgb, d_ft = cotangents(num_tiles, p)
    aux = jnp.concatenate(
        [jnp.asarray(t2n(d_rgb)), jnp.asarray(t2n(d_ft))[:, None],
         ft[:, None], nc[:, None], jnp.zeros((num_tiles, 2, p))], axis=1)
    ref = np.asarray(pb.blend_backward(feat, starts, aux, gh, gw, th, tw,
                                       interpret=True))
    d_feat = blend_backward_torch(
        torch.from_numpy(np.array(feat[:10])),
        torch.from_numpy(np.array(starts)), d_rgb, d_ft,
        torch.from_numpy(np.array(ft)),
        torch.from_numpy(np.array(nc).astype(np.int32)), gh, gw, th, tw)
    live = int(starts[-1])
    assert_rows_close(t2n(d_feat)[:, :live], ref[:, :live])
    assert np.abs(ref[:9, :live]).max(axis=1).min() > 0  # every row moves


@pytest.mark.parametrize("case", BLEND_CASES)
def test_plain_backward_matches_autograd(case):
    """An independent oracle: autograd through the plain forward, with the
    loss sum(rgb d_rgb) + sum(final_t d_final_t)."""
    feat, starts, geom, _, (d_rgb, d_ft), d_feat = _port_backward(case)
    leaf = feat.clone().requires_grad_(True)
    rgb, ft, _ = blend_forward_torch(leaf, starts, *geom)
    (grad,) = torch.autograd.grad((rgb * d_rgb).sum() + (ft * d_ft).sum(),
                                  leaf)
    assert_rows_close(t2n(d_feat), t2n(grad))
    assert float(grad[9].abs().max()) == 0.0


def test_plain_backward_long_segment_matches_pallas():
    """The long-segment case (2,000 positions in tile 0, an empty tile,
    dead columns) through the plain backward and the reference kernel, on
    the reference forward's final_T and n_contrib; the dead columns and
    row 9 stay 0."""
    import jax.numpy as jnp
    from gsrast_tpu.render import pallas_blend as pb

    feat, starts, gh, gw, th, tw = long_segment_case()
    packed, jstarts = to_reference_layout(feat, starts)
    out = pb.blend_forward(packed, jstarts, gh, gw, th, tw, interpret=True)
    ft, nc = out[:, pb.OC_FT], out[:, pb.OC_NC]
    num_tiles, p = gh * gw, th * tw
    d_rgb, d_ft = cotangents(num_tiles, p, seed=2)
    aux = jnp.concatenate(
        [jnp.asarray(t2n(d_rgb)), jnp.asarray(t2n(d_ft))[:, None],
         ft[:, None], nc[:, None], jnp.zeros((num_tiles, 2, p))], axis=1)
    ref = np.asarray(pb.blend_backward(packed, jstarts, aux, gh, gw, th, tw,
                                       interpret=True))
    d_feat = blend_backward_torch(
        feat, starts, d_rgb, d_ft, torch.from_numpy(np.array(ft)),
        torch.from_numpy(np.array(nc).astype(np.int32)), gh, gw, th, tw)
    live = int(starts[-1])
    assert_rows_close(t2n(d_feat)[:, :live], ref[:, :live])
    assert float(d_feat[:, live:].abs().max()) == 0.0
    assert float(d_feat[9].abs().max()) == 0.0


def test_plain_backward_local_tiles_matches_pallas():
    """Local tiles, rows {1, 3} of a 4-row grid (tile_map (1, 2)): the plain
    backward against the reference kernel with the same num_tiles/tile_map,
    on the reference forward's final_T and n_contrib; and against autograd
    through the plain forward on the same local tiles."""
    import jax.numpy as jnp
    from gsrast_tpu.render import pallas_blend as pb

    feat, starts, gh, gw, th, tw = packed_reference_local()
    num_tiles, p = LOCAL_ROWS * gw, th * tw
    tmap = jnp.asarray(LOCAL_TILE_MAP, jnp.int32)
    out = pb.blend_forward(feat, starts, gh, gw, th, tw, interpret=True,
                           num_tiles=num_tiles, tile_map=tmap)
    ft, nc = out[:, pb.OC_FT], out[:, pb.OC_NC]
    d_rgb, d_ft = cotangents(num_tiles, p, seed=4)
    aux = jnp.concatenate(
        [jnp.asarray(t2n(d_rgb)), jnp.asarray(t2n(d_ft))[:, None],
         ft[:, None], nc[:, None], jnp.zeros((num_tiles, 2, p))], axis=1)
    ref = np.asarray(pb.blend_backward(feat, starts, aux, gh, gw, th, tw,
                                       interpret=True, num_tiles=num_tiles,
                                       tile_map=tmap))
    local = dict(num_tiles=num_tiles, tile_map=LOCAL_TILE_MAP)
    f = torch.from_numpy(np.array(feat[:10]))
    s = torch.from_numpy(np.array(starts))
    d_feat = blend_backward_torch(
        f, s, d_rgb, d_ft, torch.from_numpy(np.array(ft)),
        torch.from_numpy(np.array(nc).astype(np.int32)), gh, gw, th, tw,
        **local)
    live = int(starts[-1])
    assert_rows_close(t2n(d_feat)[:, :live], ref[:, :live])
    assert np.abs(ref[:9, :live]).max(axis=1).min() > 0
    leaf = f.clone().requires_grad_(True)
    rgb, ft_t, nc_t = blend_forward_torch(leaf, s, gh, gw, th, tw, **local)
    (grad,) = torch.autograd.grad((rgb * d_rgb).sum() + (ft_t * d_ft).sum(),
                                  leaf)
    mine = blend_backward_torch(f, s, d_rgb, d_ft, ft_t.detach(), nc_t, gh,
                                gw, th, tw, **local)
    assert_rows_close(t2n(mine), t2n(grad))


def test_plain_backward_small_budget_carries_suffix():
    """A budget smaller than one tile's segment walks it in position blocks,
    newest first, with T and the suffix sum carried: same gradients."""
    feat, starts, geom, (_, ft, nc), (d_rgb, d_ft), full = _port_backward(
        "saturated_stack")
    th, tw = geom[2:]
    blocked = blend_backward_torch(feat, starts, d_rgb, d_ft, ft, nc, *geom,
                                   budget=3 * th * tw)
    assert_rows_close(t2n(blocked), t2n(full), atol=1e-6)


@pytest.mark.parametrize("case", BLEND_CASES)
def test_dead_columns_stay_zero(case):
    """Row 9 and every column past tile_starts[-1] are exactly 0, and so is
    every segment position past its tile's largest n_contrib."""
    _, starts, geom, (_, _, nc), _, d_feat = _port_backward(case)
    live = int(starts[-1])
    assert float(d_feat[:, live:].abs().sum()) == 0.0
    assert float(d_feat[9].abs().max()) == 0.0
    ncmax = nc.amax(dim=1)
    for t in range(geom[0] * geom[1]):
        lo, hi = int(starts[t]), int(starts[t + 1])
        assert float(d_feat[:, lo + int(ncmax[t]):hi].abs().sum()) == 0.0


def test_gaussian_gradients_ignore_dead_slots():
    """Through sort-pack and BlendFunction, autograd's index-add by Gaussian
    id gives every Gaussian exactly the sum of its live columns, though the
    dead slots gather Gaussians too."""
    from gsrast_tpu_torch import RenderConfig
    from gsrast_tpu_torch.ops import binning
    from gsrast_tpu_torch.ops.preprocess import preprocess
    from gsrast_tpu_torch.render.api import scene_tile_counts
    from gsrast_tpu_torch.render.pipeline import feature_rows, sort_pack

    import gsrast_tpu_torch as gt
    from torch_parity import port_front_camera, seeded_arrays

    scene = gt.from_numpy(seeded_arrays(9, 150))
    cam = port_front_camera(128, 64)
    rcfg = RenderConfig(tile_h=32, tile_w=64, backend="torch")
    rcfg = rcfg.replace(tiers=binning.auto_tiers(
        scene_tile_counts(scene, cam, rcfg)))
    gh, gw = rcfg.grid_shape(64, 128)
    with torch.no_grad():
        prep = preprocess(scene.activated(), cam, rcfg)
    plan = binning.plan_tiers(prep, gh, gw, rcfg)
    feat_nt = feature_rows(prep).requires_grad_(True)
    feat, starts = sort_pack(feat_nt, plan, gh * gw)
    rgb, ft, nc = BlendFunction.apply(feat, starts, gh, gw, 32, 64, "torch")
    d_rgb, d_ft = cotangents(gh * gw, 32 * 64, seed=3)
    ((rgb * d_rgb).sum() + (ft * d_ft).sum()).backward()

    key = (plan.tile_key.long() << 32) | (plan.depth_key.long() & 0xFFFFFFFF)
    gauss = plan.gauss[torch.sort(key, stable=True).indices].long()
    live = int(starts[-1])
    assert bool((gauss[live:] < 0).all()) and live < gauss.shape[0]
    with torch.no_grad():
        d_feat = blend_backward_torch(feat, starts, d_rgb, d_ft, ft, nc, gh,
                                      gw, 32, 64)
    expected = torch.zeros_like(feat_nt).index_add_(
        1, gauss[:live], d_feat[:9, :live])
    np.testing.assert_allclose(t2n(feat_nt.grad), t2n(expected), rtol=1e-6,
                               atol=1e-9)
    assert float(expected[:, 0].abs().max()) > 0  # Gaussian 0 is live


def test_backward_backend_device_mismatch_raises():
    """The 'cuda' backend on CPU tensors raises for the backward as for the
    forward; the 'torch' backend counts no launch."""
    feat = torch.zeros((10, 128))
    starts = torch.zeros((5,), dtype=torch.int32)
    d_rgb, d_ft = torch.zeros((4, 3, 128)), torch.zeros((4, 128))
    ft, nc = torch.ones((4, 128)), torch.zeros((4, 128), dtype=torch.int32)
    args = (feat, starts, d_rgb, d_ft, ft, nc, 2, 2, 8, 16)
    with pytest.raises(ValueError, match="cannot run"):
        blend_backward(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        blend_backward_cuda(*args)
    with pytest.raises(ValueError, match="cannot run"):
        BlendFunction.apply(feat.requires_grad_(True), starts, 2, 2, 8, 16,
                            "cuda")
    before = dict(_kernels.launch_counts)
    d_feat = blend_backward(*args, backend="torch")
    assert _kernels.launch_counts == before
    assert d_feat.shape == (10, 128) and float(d_feat.abs().max()) == 0.0
    assert blend.FEATURE_ROWS == 10


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLEND_CASES)
def test_cuda_backward_matches_plain(case):
    """The kernel against the plain backward on the same card inputs (the
    kernel forward's final_t and n_contrib), per-row scaled 1e-4; dead
    columns and row 9 exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    feat, starts, gh, gw, th, tw = packed_port(case, dev)
    _, ft, nc = blend.blend_forward_cuda(feat, starts, gh, gw, th, tw)
    d_rgb, d_ft = cotangents(gh * gw, th * tw, device=dev)
    args = (feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw)
    kernel = blend_backward_cuda(*args)
    plain = blend_backward_torch(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kernel).all())
    assert_rows_close(t2n(kernel), t2n(plain), atol=1e-4)
    live = int(starts[-1])
    assert float(kernel[:, live:].abs().sum()) == 0.0
    assert float(kernel[9].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_backward_local_tiles_matches_plain():
    """The kernel on local tiles (rows {1, 3}, tile_map (1, 2)) against the
    plain backward, rows 1e-4 of their scale, dead columns exactly 0, and
    two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    feat, starts, gh, gw, th, tw = packed_port_local(dev)
    local = dict(num_tiles=LOCAL_ROWS * gw, tile_map=LOCAL_TILE_MAP)
    _, ft, nc = blend.blend_forward_cuda(feat, starts, gh, gw, th, tw,
                                         **local)
    d_rgb, d_ft = cotangents(LOCAL_ROWS * gw, th * tw, device=dev)
    args = (feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw)
    kernel = blend_backward_cuda(*args, **local)
    again = blend_backward_cuda(*args, **local)
    plain = blend_backward_torch(*args, **local)
    torch.cuda.synchronize()
    assert torch.equal(kernel, again)
    assert_rows_close(t2n(kernel), t2n(plain), atol=1e-4)
    live = int(starts[-1])
    assert float(kernel[:, live:].abs().sum()) == 0.0
    assert float(kernel[9].abs().max()) == 0.0


def _cuda_backward_args(case):
    """The kernel forward's outputs and seeded cotangents of a case, on the
    card: the backward's inputs."""
    dev = torch.device("cuda")
    if case == "long_segment":
        feat, starts, gh, gw, th, tw = long_segment_case(dev)
    else:
        feat, starts, gh, gw, th, tw = packed_port(case, dev)
    _, ft, nc = blend.blend_forward_cuda(feat, starts, gh, gw, th, tw)
    d_rgb, d_ft = cotangents(gh * gw, th * tw, device=dev)
    return (feat, starts, d_rgb, d_ft, ft, nc, gh, gw, th, tw)


@pytest.mark.cuda
def test_cuda_backward_long_segment_and_empty_tile():
    """The kernel against the plain backward where a segment spans more
    than four staged batches and a tile is empty: rows within 1e-4 of
    their scale; the empty tile, row 9 and the dead columns exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _cuda_backward_args("long_segment")
    kernel = blend_backward_cuda(*args)
    plain = blend_backward_torch(*args)
    torch.cuda.synchronize()
    assert int(args[5][0].max()) > 4 * 64
    assert_rows_close(t2n(kernel), t2n(plain), atol=1e-4)
    live = int(args[1][-1])
    assert float(kernel[:, live:].abs().sum()) == 0.0
    assert float(kernel[9].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLEND_CASES + ("long_segment",))
def test_cuda_backward_is_deterministic(case):
    """Two launches on the same inputs give identical bits: every sum runs
    in a fixed order and nothing is added atomically."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = _cuda_backward_args(case)
    first = blend_backward_cuda(*args)
    second = blend_backward_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert float(first[:9].abs().max()) > 0
