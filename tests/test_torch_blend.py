"""The tile blend of `gsrast_tpu_torch` against the reference's Pallas blend
kernel (`gsrast_tpu.render.pallas_blend.blend_forward`, run in interpret mode
on the CPU), on the same packed features; and the hand-written CUDA kernel
against the plain version on the card (`-m cuda`, which imports only the
port, so it also runs where the reference's dependencies are missing)."""

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.render.blend import (blend_forward, blend_forward_cuda,
                                           blend_forward_torch)

from torch_parity import BLEND_CASES as CASES
from torch_parity import packed_port as _packed_port
from torch_parity import packed_reference as _packed
from torch_parity import t2n

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
