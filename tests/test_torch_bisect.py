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


def test_timing_refuses_trees_outside_the_checkout(tmp_path, capsys):
    """`diag.bisect_timing` builds and runs each tree it times in place, so
    it takes only trees inside this checkout."""
    from gsrast_tpu_torch.diag import bisect_timing

    assert bisect_timing.main(["--tree", str(tmp_path)]) == 2
    assert "outside" in capsys.readouterr().err


def _seeded(dev, counts, feat, nc, rng, ft=None, drgb=None) -> dict:
    """Inputs of the kernels: tiles of `counts` positions, `feat` rows (as
    many as the last tile needs, or more), `nc` (T, 8, 128); ft and drgb
    seeded where not given."""
    t = len(counts)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    assert feat.shape[0] >= int(starts[-1]) // 8
    if ft is None:
        ft = rng.uniform(0, 1, (t, 8, 128))
    if drgb is None:
        drgb = rng.standard_normal((t, 3, 8, 128))
    f32 = dict(dtype=torch.float32, device=dev)
    return {"starts": torch.tensor(starts, device=dev),
            "feat": torch.tensor(feat, **f32),
            "ft": torch.tensor(ft, **f32),
            "nc": torch.tensor(nc, dtype=torch.int32, device=dev),
            "drgb": torch.tensor(drgb, **f32)}


def _carried_cases(dev) -> dict:
    """C's and D's harder inputs: a tile of 16 chunks, longer than the
    longest of phase 11's 1080p plan (15); carries driven under 2^-100 and
    through float32's subnormal range to 0 by v up to 400, so that both of
    the kernels' division paths run; and D's gate cut mid-chunk, with nc
    spread over each tile's whole index range."""
    rng = np.random.default_rng(1)
    n = 16 * 128
    long_tile = _seeded(dev, [n], rng.uniform(0, 2, (n // 8, 128)),
                        rng.integers(0, 800, (1, 8, 128)), rng)
    counts = np.full(8, 6 * 128)
    underflow = _seeded(dev, counts, rng.uniform(0, 400, (8 * 96, 128)),
                        rng.integers(0, 6 * 128 + 1, (8, 8, 128)), rng)
    counts = 128 * rng.integers(1, 9, 16)
    gate = _seeded(dev, counts, rng.uniform(0, 2, (counts.sum() // 8, 128)),
                   (rng.random((16, 8, 128)) * (counts[:, None, None] + 1)
                    ).astype(np.int64), rng)
    return {"tile_of_16_chunks": long_tile, "carries_underflow": underflow,
            "gate_mid_chunk": gate}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_cuda_kernel_matches_plain(name):
    """Each kernel against its plain version on the card, at the script's
    inputs and on 64 seeded tiles of up to 6 chunks; C and D also on
    `_carried_cases`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    counts = 128 * rng.integers(0, 7, 64)
    counts[rng.integers(0, 64, 8)] += rng.integers(1, 128, 8)  # remainders
    feat = rng.uniform(0, 2, (int(counts.sum()) // 8 + 1, 128))
    ft = rng.uniform(0, 1, (64, 8, 128))
    nc = rng.integers(0, 800, (64, 8, 128))
    seeded = _seeded(dev, counts, feat, nc, rng, ft=ft,
                     drgb=rng.standard_normal((64, 3, 8, 128)))
    cases = {"script": bb.script_inputs(dev), "seeded": seeded}
    if name in bb.CARRIED:
        cases.update(_carried_cases(dev))
    cuda_fn, torch_fn = bb.KERNELS[name]
    for case, inputs in cases.items():
        args = bb.kernel_args(name, inputs)
        got = cuda_fn(*args)
        torch.cuda.synchronize()
        ref = torch_fn(*args)
        _close_to_max(got.cpu().numpy(), ref.cpu().numpy(), (name, case))


@pytest.mark.cuda
@pytest.mark.parametrize("name", bb.CARRIED)
def test_cuda_carried_same_bits_twice(name):
    """C and D take every sum in a fixed order: two launches on the same
    inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    for case, inputs in _carried_cases(dev).items():
        args = bb.kernel_args(name, inputs)
        first = bb.KERNELS[name][0](*args)
        assert torch.equal(first, bb.KERNELS[name][0](*args)), (name, case)


def _lanes_cases(dev) -> dict:
    """B's inputs: 64 seeded tiles of 0 to 9 chunks (every place of a
    chunk in the kernel's register ring, and tiles it skips), 8 of them
    with a partial chunk whose rows stay uncovered, and -0 on a tenth of
    the values; and the same tiles with NaN, inf and -0 on the lanes that
    B does not read, on the uncovered rows, and -0 and inf on some lanes
    it does read."""
    rng = np.random.default_rng(4)
    counts = 128 * rng.integers(0, 10, 64)
    counts[rng.integers(0, 64, 8)] += rng.integers(1, 128, 8)  # remainders
    rows = int(counts.sum()) // 8 + 1
    feat = rng.uniform(-2, 2, (rows, 128)).astype(np.float32)
    feat[rng.random(feat.shape) < 0.1] = -0.0
    nonfinite = feat.copy()
    unread = np.arange(128) % 16 != 0
    special = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32)
    nonfinite[:, unread] = special[rng.integers(0, 4, (rows,
                                                       int(unread.sum())))]
    read = rng.random((rows, 8)) < 0.05
    nonfinite[:, ::16][read] = special[rng.integers(1, 4, int(read.sum()))]
    nc = np.zeros((64, 8, 128), np.int64)
    return {"seeded": _seeded(dev, counts, feat, nc, rng),
            "nonfinite": _seeded(dev, counts, nonfinite, nc, rng)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seeded", "nonfinite"])
def test_cuda_b_bits_match_plain(case):
    """B reads only lanes 16 j: its output has the plain version's bits
    (3 v by one rounding there, +0 on the other lanes of every covered
    row, whatever feat holds on them, and on uncovered rows), and two
    launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = bb.kernel_args("b", _lanes_cases(torch.device("cuda"))[case])
    got = bb.bisect_b_cuda(*args)
    torch.cuda.synchronize()
    ref = bb.bisect_b_torch(*args)
    bits = got.view(torch.int32)
    assert torch.equal(bits, ref.view(torch.int32)), case
    assert not bool(bits[:, torch.arange(128, device=bits.device) % 16 != 0]
                    .any()), case
    assert torch.equal(bits, bb.bisect_b_cuda(*args).view(torch.int32))


@pytest.mark.cuda
def test_cuda_division_bits_match_plain():
    """D with one live element a tile (ft and drgb channel 0 one there, ft
    0 elsewhere, nc 0 elsewhere) writes that element's carry itself at every
    step, so the kernel's divisions must give the plain version's bits
    (PyTorch's IEEE division on the card) at each one: 64 tiles of 2,048
    steps, v from 0.5 to 400 and just below 1000 (2^m - 1) (divisors just
    below 2, 4 and 8), a tenth of the steps gated off by v <= 0.1, the live
    element's nc anywhere in its tile; the carries cross 2^-100 and reach
    the subnormal range and 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    t, n = 64, 16 * 128
    vmax = np.geomspace(0.5, 400, 48)
    scaled = rng.uniform(0, 1, (48, n // 8, 128)) * vmax[:, None, None]
    below_pow2 = (1000 * (2.0 ** rng.integers(1, 4, (16, 1, 1)) - 1)
                  - rng.uniform(0, 0.05, (16, n // 8, 128)))
    feat = np.concatenate([scaled, below_pow2])
    off = rng.random(feat.shape) < 0.1
    feat[off] = rng.uniform(0, 0.1, int(off.sum()))
    live = (37 * np.arange(t)) % 1024
    nc = np.zeros((t, 1024), np.int64)
    nc[np.arange(t), live] = rng.integers(0, n + 1, t)
    ft = np.zeros((t, 1024))
    ft[np.arange(t), live] = 1.0
    drgb = rng.standard_normal((t, 3, 8, 128))
    drgb[:, 0] = 1.0
    inputs = _seeded(dev, np.full(t, n), feat.reshape(-1, 128),
                     nc.reshape(t, 8, 128), rng, ft=ft.reshape(t, 8, 128),
                     drgb=drgb)
    args = bb.kernel_args("d", inputs)
    got = bb.bisect_d_cuda(*args)
    ref = bb.bisect_d_torch(*args)
    assert torch.equal(got, ref)
    carries = ref[:, ::16]
    assert bool(((carries > 0) & (carries < 2.0 ** -126)).any())
    assert bool(((carries >= 2.0 ** -126) & (carries < 2.0 ** -100)).any())
    assert bool((carries == 0).any()) and bool((carries == 1).any())


def _fma32(a, b, c):
    """float32 fma(a, b, c), correctly rounded: a b is exact in float64, the
    sum is float64 plus its exact error (TwoSum), and where the float64 sum
    is a float32 midpoint the error decides the rounding."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    f = s.astype(np.float32)
    f64 = f.astype(np.float64)
    nb = np.nextafter(f, np.where(s > f64, np.inf, -np.inf).astype(np.float32))
    mid = (s != f64) & (s == (f64 + nb.astype(np.float64)) / 2) & (err != 0)
    beyond = np.sign(err) == np.sign(nb.astype(np.float64) - f64)
    return np.where(mid & beyond, nb, f)


def _corrected_division(t, d):
    """`div_corrected` of csrc/bisect_bwd.cu in numpy: r = RN(1/d),
    q = RN(t r), e = fma(-q, d, t), t' = fma(e, r, q)."""
    with np.errstate(all="ignore"):
        r = (np.float32(1) / d).astype(np.float32)
        q = (t * r).astype(np.float32)
        return _fma32(_fma32(-q, d, t), r, q)


def test_fma_model_is_exact():
    """The numpy fma above against exact rational arithmetic, near
    cancellation (the residual's case) included."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    for i in range(3000):
        a = np.float32(rng.uniform(-2, 2) * 2.0 ** rng.integers(-60, 60))
        b = np.float32(rng.uniform(-2, 2) * 2.0 ** rng.integers(-60, 60))
        c = (-np.float32(a * b) if i % 2 else
             np.float32(rng.uniform(-2, 2) * 2.0 ** rng.integers(-120, 120)))
        exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        got = _fma32(np.array([a]), np.array([b]), np.array([c]))[0]
        near = [np.nextafter(got, np.float32(-np.inf)), got,
                np.nextafter(got, np.float32(np.inf))]
        dist = [abs(Fraction(float(x)) - exact) for x in near]
        assert dist[1] <= min(dist), (a, b, c)
        if dist[1] == min(dist[0], dist[2]):  # a tie goes to the even one
            assert np.array(got).view(np.int32) % 2 == 0, (a, b, c)


def _divisors(rng, regime, n):
    if regime == "below_powers_of_two":  # 1/d's rounding error at its worst
        top = 2.0 ** rng.integers(1, 4, n)
        v = (top * (1 - rng.uniform(0, 2e-4, n)) - 1) / 0.001
    else:
        v = rng.uniform(0, {"v_0_2": 2, "v_0_8192": 8192}[regime], n)
    v = v.astype(np.float32)
    return (np.float32(1) + (np.float32(0.001) * v).astype(np.float32)).astype(
        np.float32)


@pytest.mark.parametrize("regime", ["v_0_2", "v_0_8192",
                                    "below_powers_of_two"])
def test_corrected_division_is_ieee_division(regime):
    """The carry kernels' division by one correction of the reciprocal
    gives RN(t / d) (numpy's float32 division, IEEE) on 2^21 draws of
    d = 1 + 0.001 v and t in [2^-100, 1), t's significand uniform or
    just below 2 (where RN(t r) is furthest from t / d)."""
    rng = np.random.default_rng(4)
    n = 1 << 20
    d = _divisors(rng, regime, 2 * n)
    sig = np.concatenate([rng.uniform(1, 2, n), 2 - rng.uniform(0, 1e-3, n)])
    t = (sig * 2.0 ** rng.integers(-100, 0, 2 * n)).astype(np.float32)
    got = _corrected_division(t, d)
    assert np.array_equal(got, (t / d).astype(np.float32))


def test_corrected_division_every_significand():
    """Every float32 significand of t, at the divisors just below 2, 4 and
    8 and at 1 + 2^-23: RN(t / d) each time."""
    t = (1 + np.arange(1 << 23) / (1 << 23)).astype(np.float32)
    for d in (np.nextafter(np.float32(x), np.float32(0)) for x in (2, 4, 8)):
        d = np.full_like(t, d)
        assert np.array_equal(_corrected_division(t, d),
                              (t / d).astype(np.float32)), d[0]
    d = np.full_like(t, np.nextafter(np.float32(1), np.float32(2)))
    assert np.array_equal(_corrected_division(t, d), (t / d).astype(np.float32))


def test_corrected_division_needs_its_guard():
    """Under 2^-100 the residual can be subnormal and the correction off:
    some draws with t in [2^-149, 2^-101) differ from RN(t / d), which is
    why the kernels divide such carries by __fdiv_rn."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    d = _divisors(rng, "v_0_8192", n)
    t = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-149, -101, n)).astype(
        np.float32)
    assert not np.array_equal(_corrected_division(t, d),
                              (t / d).astype(np.float32))
