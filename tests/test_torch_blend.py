"""The tile blend of `gsrast_tpu_torch` against the reference's Pallas blend
kernel (`gsrast_tpu.render.pallas_blend.blend_forward`, run in interpret mode
on the CPU), on the same packed features; the backends' dispatch; and on the
card the hand-written CUDA kernel against the plain version, and the plain
version's render against the CPU's (`-m cuda`, which imports only the port,
so it also runs where the reference's dependencies are missing)."""

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels, cli
from gsrast_tpu_torch.render.blend import (_dispatch, blend_forward,
                                           blend_forward_cuda,
                                           blend_forward_torch)

from torch_parity import BLEND_CASES as CASES
from torch_parity import LONG_SEGMENT, TRAINED_SMALL, long_segment_case
from torch_parity import packed_port as _packed_port
from torch_parity import packed_reference as _packed
from torch_parity import t2n, to_reference_layout

torch.set_num_threads(2)

# The plain version and the Pallas kernel take the same cumulative-product
# closed form; their colour sums run in another order (and the kernel's on
# the MXU), so rgb/final_t agree to a few float32 ulps of the accumulated
# values: atol 3e-6, as the reference's own kernel-vs-XLA tests use.
ATOL = 3e-6


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


def test_plain_blend_long_segment_matches_pallas():
    """The long-segment case (tile 0's pixels saturate after 950-1,350 of
    its 2,000 positions, tile 1 empty, dead columns past the end) through
    the plain version and the reference kernel."""
    from gsrast_tpu.render import pallas_blend as pb

    feat, starts, gh, gw, th, tw = long_segment_case()
    out = np.asarray(pb.blend_forward(*to_reference_layout(feat, starts), gh,
                                      gw, th, tw, interpret=True))
    rgb, ft, nc = blend_forward_torch(feat, starts, gh, gw, th, tw)
    np.testing.assert_allclose(t2n(rgb), out[:, pb.OC_R:pb.OC_B + 1],
                               atol=ATOL)
    np.testing.assert_allclose(t2n(ft), out[:, pb.OC_FT], atol=ATOL)
    np.testing.assert_array_equal(t2n(nc), out[:, pb.OC_NC].astype(np.int32))
    assert int((nc[0] > 4 * 256).sum()) > th * tw // 2  # past 4 batches
    assert int(nc[0].max()) < LONG_SEGMENT  # all saturate inside it
    assert int(nc[1].max()) == 0 and float(ft[1].min()) == 1.0  # empty


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


@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
def test_torch_backend_runs_on_any_device(device):
    """'torch' is the caller's explicit choice of the plain version, on
    tensors of any device; 'cuda' takes only CUDA tensors."""
    def cuda_fn():
        pass

    def torch_fn():
        pass

    assert _dispatch("torch", torch.device(device), cuda_fn,
                     torch_fn) is torch_fn
    if device != "cuda":
        with pytest.raises(ValueError, match="cannot run"):
            _dispatch("cuda", torch.device(device), cuda_fn, torch_fn)
    else:
        assert _dispatch("cuda", torch.device(device), cuda_fn,
                         torch_fn) is cuda_fn
    with pytest.raises(ValueError, match="cannot run"):
        _dispatch("dense", torch.device(device), cuda_fn, torch_fn)


@pytest.mark.cuda
def test_cuda_torch_backend_matches_cpu(tmp_path):
    """`render --backend torch` on the card runs the plain version (no
    kernel launch), and its image is the CPU's: within 1e-5 where
    n_contrib agrees, n_contrib differing at no more than 0.1% of pixels
    (transmittance within rounding of T_min)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kernels.reset_launch_counts()
    img = cli.main(["render", TRAINED_SMALL, "--backend", "torch", "--width",
                    "128", "--height", "128", "--out",
                    str(tmp_path / "torch.png")])
    torch.cuda.synchronize()
    assert not any(_kernels.launch_counts.values()), _kernels.launch_counts
    assert img.device.type == "cuda" and img.shape == (128, 128, 3)
    scene = gt.load_ply(TRAINED_SMALL)
    card_scene = gt.load_ply(TRAINED_SMALL, device="cuda")
    cam = gt.auto_frame(*scene.bbox(), 128, 128)
    card_cam = cam.to("cuda")
    # On the card the default is the kernels; 'torch' is asked for.
    assert gt.auto_render_config(card_scene, card_cam).backend == "cuda"
    rcfg = gt.auto_render_config(scene, cam).replace(backend="torch")
    with torch.no_grad():
        cpu = gt.render(scene, cam, rcfg)
        card = gt.render(card_scene, card_cam, rcfg)
    agree = card.n_contrib.cpu() == cpu.n_contrib
    assert float((~agree).float().mean()) <= 1e-3
    err = torch.where(agree[..., None], card.image.cpu() - cpu.image, 0.0)
    assert float(err.abs().max()) <= 1e-5
    assert float(cpu.image.max()) > 0.1


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


@pytest.mark.cuda
def test_cuda_kernel_long_segment_and_empty_tile():
    """The kernel against the plain version where a segment spans more than
    four staged batches and a tile is empty: n_contrib equal, rgb and
    final_t within 1e-5; the empty tile blends nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = long_segment_case(torch.device("cuda"))
    rgb, ft, nc = blend_forward_cuda(*args)
    rgb_p, ft_p, nc_p = blend_forward_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(nc, nc_p) and int(nc[0].max()) > 4 * 256
    assert float((rgb - rgb_p).abs().max()) <= 1e-5
    assert float((ft - ft_p).abs().max()) <= 1e-5
    assert int(nc[1].max()) == 0 and float(rgb[1].abs().max()) == 0.0
