"""The fault-bisection kernels of `gsrast_tpu_torch.diag.bisect_bwd` against
the reference's `scripts/bisect_bwd.py`: the script runs unchanged, with
`pallas_call` patched inside the test to interpret its four TPU kernels on
the CPU and record their outputs; and, on the card (`-m cuda`), each CUDA
kernel against its plain version."""

import os
import runpy

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.diag import bisect_bwd as bb

torch.set_num_threads(2)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "bisect_bwd.py")
# C and D sum 1,024 carry elements per step, in another order in each
# version, and their carries decay into float32's denormal range, which
# XLA's CPU runtime flushes to 0 and PyTorch and CUDA keep: compare within
# 1e-5 of the output's largest magnitude.
RTOL_OF_MAX = 1e-5


@pytest.fixture(scope="module")
def reference_outputs():
    """The script's four outputs, in its order A, B, C, D, interpreted."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    outputs = []
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        call = original(*args, interpret=pltpu.InterpretParams(), **kwargs)

        def run(*operands):
            out = call(*operands)
            outputs.append(np.asarray(out[0]))
            return out

        return run

    pl.pallas_call = interpreted
    try:
        runpy.run_path(SCRIPT, run_name="bisect_bwd")
    finally:
        pl.pallas_call = original
    assert len(outputs) == 4, "a reference kernel failed to run"
    return dict(zip("abcd", outputs))


def _close_to_max(got, ref, name):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert scale > 0 and err <= RTOL_OF_MAX * scale, (name, err, scale)


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_plain_matches_reference_script(reference_outputs, name):
    """A and B exactly; C and D within 1e-5 of the largest magnitude."""
    ref = reference_outputs[name]
    inputs = bb.script_inputs()
    got = bb.KERNELS[name][1](*bb.kernel_args(name, inputs)).numpy()
    assert got.shape == ref.shape == (64, 128)
    if name in "ab":
        np.testing.assert_array_equal(got, ref)
    else:
        _close_to_max(got, ref, name)
        # The lanes each version wrote are the same: 16 j of every row.
        assert np.array_equal(np.flatnonzero(ref.any(0)) % 16, [0] * 8)


def test_main_cpu_prints_the_script_lines(capsys):
    outs = bb.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "plain PyTorch versions" in lines[0]
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "A-readwrite", "B-scalars", "C-carries", "D-blocked-ins"]
    assert lines[1] == "A-readwrite: OK 67100672.0"
    assert lines[2] == "B-scalars: OK 6279168.0"
    assert abs(float(lines[3].split()[-1]) - 3072000.25) <= 1.0
    assert abs(float(lines[4].split()[-1]) - 510658.25) <= 1.0
    assert set(outs) == set("abcd")


def test_uncovered_rows_stay_zero_and_d_gates():
    """A tile whose segment is not a multiple of 128 leaves its remainder
    rows at 0; D with nc = 0 everywhere never divides, so its sums are
    those of ones."""
    starts = torch.tensor([0, 200, 328], dtype=torch.int32)
    feat = torch.arange(41 * 128, dtype=torch.float32).reshape(41, 128) / 64
    a = bb.bisect_a_torch(starts, feat)
    assert torch.equal(a[:16], 2 * feat[:16]) and not a[16:25].any()
    assert torch.equal(a[25:41], 2 * feat[25:41])
    t = 2
    ft = torch.full((t, 8, 128), 0.5)
    d = bb.bisect_d_torch(starts, feat, ft, torch.zeros((t, 8, 128),
                                                        dtype=torch.int32),
                          torch.ones((t, 3, 8, 128)))
    written = d[:, ::16][torch.cat([torch.arange(16), torch.arange(25, 41)])]
    assert torch.all(written == 512.0)


def test_wrappers_reject_cpu_and_bad_inputs():
    inputs = bb.script_inputs()
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="CUDA device"):
        bb.bisect_c_cuda(inputs["starts"], inputs["feat"])
    with pytest.raises(ValueError, match="outside feat"):
        bb.bisect_a_torch(inputs["starts"], inputs["feat"][:40])
    with pytest.raises(ValueError, match="nc must be"):
        bb.bisect_d_torch(inputs["starts"], inputs["feat"], inputs["ft"],
                          inputs["nc"].float(), inputs["drgb"])
    assert _kernels.launch_counts == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_cuda_kernel_matches_plain(name):
    """Each kernel against its plain version on the card, at the script's
    inputs and on 64 seeded tiles of up to 6 chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    counts = 128 * rng.integers(0, 7, 64)
    counts[rng.integers(0, 64, 8)] += rng.integers(1, 128, 8)  # remainders
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seeded = {
        "starts": torch.tensor(starts, device=dev),
        "feat": torch.tensor(rng.uniform(0, 2, (int(starts[-1]) // 8 + 1, 128)),
                             dtype=torch.float32, device=dev),
        "ft": torch.tensor(rng.uniform(0, 1, (64, 8, 128)),
                           dtype=torch.float32, device=dev),
        "nc": torch.tensor(rng.integers(0, 800, (64, 8, 128)),
                           dtype=torch.int32, device=dev),
        "drgb": torch.tensor(rng.standard_normal((64, 3, 8, 128)),
                             dtype=torch.float32, device=dev),
    }
    cuda_fn, torch_fn = bb.KERNELS[name]
    for inputs in (bb.script_inputs(dev), seeded):
        args = bb.kernel_args(name, inputs)
        got = cuda_fn(*args)
        torch.cuda.synchronize()
        ref = torch_fn(*args)
        _close_to_max(got.cpu().numpy(), ref.cpu().numpy(), name)
