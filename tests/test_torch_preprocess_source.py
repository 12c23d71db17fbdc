"""The preprocess kernels' CUDA source (`csrc/preprocess.cu`) run on the
CPU: compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (each block's threads real threads at a barrier, each
warp's at one of its own, blocks one after another, cp.async a plain copy,
the _rn intrinsics plain float operations built without contraction), its
C entry points called through ctypes with the wrappers' own arguments
(`ops.preprocess.forward_args`, `backward_args`) on CPU tensors.

The forward is held to the plain version (`preprocess_torch`) with phase
20's tolerances (`chip_smoke.compare_preprocess`: float outputs within
PRE_RTOL / PRE_ATOL, radius, rect and visibility equal but where a float64
recomputation puts the Gaussian within PRE_TIE of a tie: the host's logf is
not the card's), the backward to the plain VJP (`preprocess_vjp_torch`)
within PRE_GRAD_RTOL of each group's largest magnitude. The forward's grid
is one wave of warps walking chunks of 32 Gaussians with the next chunk's
copies in flight: counts that leave a chunk 1, 31 or 32 lanes, and counts
that make each warp walk several chunks on a host card of 1 and 2 SMs;
SH degrees 0-3 at their own row width and degrees 0-2 of rows of 16
coefficients (only the used floats staged); SH rows 4 bytes into their
storage, and each other input array (the 16-byte copies' 4-byte
fallback); with and without mean2d_delta; n = 0 launches nothing."""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.camera import device_camera
from gsrast_tpu_torch.ops import preprocess as pp

from torch_parity import port_front_camera, seeded_arrays

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "preprocess.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
# The kernels' dynamic shared arrays, as host arrays of an SM's shared
# memory (blocks run one after another).
SHARED = {"extern __shared__ float4 fwd_shared[];":
          "alignas(16) static float4 fwd_shared[kHostSharedPerSm / 16];",
          "extern __shared__ float staged[];":
          "alignas(16) static float staged[kHostSharedPerSm / 4];"}
WIDTH, HEIGHT = 64, 48

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`preprocess.cu` built for the host: each launch rewritten to the
    shim's `launch(grid, block, kernel, ...)`, the dynamic shared arrays
    host arrays."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("preprocess_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    for old, new in SHARED.items():
        assert old in src, old
        src = src.replace(old, new)
    src += ('extern "C" void host_set_multiprocessors(int n) '
            '{ host_multiprocessors = n; }\n'
            'extern "C" int host_launch_count() { return host_launches; }\n')
    cpp, so = out / "preprocess_host.cpp", out / "libpreprocess_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    _kernels.set_preprocess_argtypes(dll)
    dll.host_set_multiprocessors.argtypes = [ctypes.c_int]
    dll.host_launch_count.restype = ctypes.c_int
    return dll


def _cell(n: int, scene_degree: int, degree: int, seed: int,
          sh_offset: int = 0):
    """(activated Gaussians, camera, config) of a drawn scene of n
    Gaussians, SH rows of `scene_degree` evaluated at `degree`, seen in part
    by the front camera (some behind it, some beyond the NDC margin, some
    masked out); the SH rows `sh_offset` floats into their storage."""
    arrays = seeded_arrays(seed, n, sh_degree=scene_degree, extent=4.0)
    scene = gt.from_numpy(arrays)
    with torch.no_grad():
        act = scene.activated()
    mask = torch.from_numpy(np.random.default_rng(seed + 1).random(n) > 0.1)
    act = dataclasses.replace(act, mask=mask)
    if sh_offset:
        sh = torch.empty(act.sh.numel() + sh_offset)
        act = dataclasses.replace(
            act, sh=sh[sh_offset:].view_as(act.sh).copy_(act.sh))
    cam = port_front_camera(WIDTH, HEIGHT)
    rcfg = gt.RenderConfig(tile_h=16, tile_w=32, sh_degree=degree)
    return act, cam, rcfg


def _forward(lib, act, cam, rcfg, delta=None):
    args, out, _held = pp.forward_args(act, device_camera(cam), rcfg, delta,
                                       cuda=False)
    for x in (*out[:6], *out.rect):
        x.fill_(-7 if not x.is_floating_point() else 1234.5)
    assert lib.gsrast_preprocess_forward(*args) == 0
    return out


def _check_forward(lib, act, cam, rcfg, delta=None):
    got = _forward(lib, act, cam, rcfg, delta)
    ref = pp.preprocess_torch(act, cam, rcfg, delta)
    res = chip_smoke.compare_preprocess(got, ref, act, cam, rcfg)
    assert all(res[name]["beyond"] == 0 for name in chip_smoke.PRE_OUTPUTS), \
        res
    assert res["flip_margin"] <= chip_smoke.PRE_TIE, res
    return ref


@pytest.mark.parametrize("n", [1, 31, 33, 257, chip_smoke.EDGE_N])
def test_forward_matches_plain_at_counts(lib, n):
    """Chunks of 1, 31 and 32 lanes; the edge cell's 1,013 leaves the last
    chunk 21 lanes."""
    lib.host_set_multiprocessors(132)
    act, cam, rcfg = _cell(n, 3, 3, seed=n)
    ref = _check_forward(lib, act, cam, rcfg)
    if n >= 257:  # the scene has culled and visible Gaussians
        assert 0 < int((ref.radius > 0).sum()) < n


@pytest.mark.parametrize("sms", [1, 2])
def test_forward_walks_chunks(lib, sms):
    """2,000 Gaussians are 63 chunks: on a host card of one SM (3 blocks of
    4 warps at SH degree 3) each warp walks 5-6 of them, on two 2-3, each
    computed from one stage while the next one's copies are issued into the
    other."""
    lib.host_set_multiprocessors(sms)
    act, cam, rcfg = _cell(2_000, 3, 3, seed=2_000 + sms)
    try:
        _check_forward(lib, act, cam, rcfg)
        occ = _occupancy(lib, 2_000, 16, 3)
        assert occ["grid"] == occ["blocks_per_sm"] * sms < 63 / 4
    finally:
        lib.host_set_multiprocessors(132)


@pytest.mark.parametrize("scene_degree,degree", [
    (0, 0), (1, 1), (2, 2), (3, 3), (3, 0), (3, 1), (3, 2)])
def test_forward_matches_plain_at_degrees(lib, scene_degree, degree):
    """Each degree at its own row width, and rows of 16 coefficients read
    only as far as a lower degree evaluates."""
    act, cam, rcfg = _cell(300, scene_degree, degree, seed=40 + degree)
    _check_forward(lib, act, cam, rcfg)


@pytest.mark.parametrize("n,degree", [(chip_smoke.EDGE_N, 1), (257, 3)])
def test_forward_sh_rows_off_alignment(lib, n, degree):
    """SH rows 4 bytes into their storage, as phase 20's edge cell puts
    them: the other arrays' 16-byte copies and the SH's 4-byte ones."""
    act, cam, rcfg = _cell(n, 3, degree, seed=7, sh_offset=1)
    assert act.sh.data_ptr() % 16 == 4
    _check_forward(lib, act, cam, rcfg)


@pytest.mark.parametrize("field", ["means", "scales", "quats", "opacities"])
def test_forward_inputs_off_alignment(lib, field):
    """One input array 4 bytes into its storage: its whole chunks go 4 bytes
    a lane, the other arrays' 16."""
    act, cam, rcfg = _cell(1_000, 3, 3, seed=60)
    x = getattr(act, field)
    store = torch.empty(x.numel() + 1)
    act = dataclasses.replace(act, **{field: store[1:].view_as(x).copy_(x)})
    assert getattr(act, field).data_ptr() % 16 == 4
    _check_forward(lib, act, cam, rcfg)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [33, 1_000])
def test_forward_with_mean2d_delta(lib, n, offset):
    """mean2d_delta added to the screen positions before the rect, its run
    16-byte aligned (offset 0) or 4 bytes off (1)."""
    act, cam, rcfg = _cell(n, 3, 3, seed=90 + n)
    rng = np.random.default_rng(n)
    store = torch.from_numpy(rng.standard_normal(2 * n + offset).astype(
        np.float32))
    delta = store[offset:].view(n, 2)
    _check_forward(lib, act, cam, rcfg, delta)


def test_forward_of_nothing_launches_nothing(lib):
    """n = 0: the entry point returns success without a launch."""
    act, cam, rcfg = _cell(5, 3, 3, seed=1)
    act = dataclasses.replace(act, **{
        f: getattr(act, f)[:0] for f in (*pp.INPUT_FIELDS, "mask")})
    args, _out, _held = pp.forward_args(act, device_camera(cam), rcfg,
                                        cuda=False)
    before = lib.host_launch_count()
    assert lib.gsrast_preprocess_forward(*args) == 0
    assert lib.host_launch_count() == before


def test_forward_refuses_a_bad_degree(lib):
    """A degree outside 0-3, or rows shorter than the degree reads: an
    error before any launch, the outputs untouched."""
    act, cam, rcfg = _cell(40, 1, 1, seed=3)
    args, out, _held = pp.forward_args(act, device_camera(cam), rcfg,
                                       cuda=False)
    out.depth.fill_(-3.0)
    for degree in (-1, 2, 4):
        args = list(args)
        args[10] = degree
        assert lib.gsrast_preprocess_forward(*args) != 0
    assert bool((out.depth == -3.0).all())


def _occupancy(lib, n: int, k: int, degree: int) -> dict:
    keys = ("threads", "dynamic_shared", "blocks_per_sm", "grid",
            "registers", "local_bytes", "static_shared")
    vals = [ctypes.c_int(-1) for _ in keys]
    assert lib.gsrast_preprocess_forward_occupancy(
        n, k, degree, *(ctypes.byref(v) for v in vals)) == 0
    return dict(zip(keys, (v.value for v in vals)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_forward_reports_its_launch(lib, degree):
    """Threads, the two stages of each warp in shared memory (the SH rows'
    used floats at an odd stride), and a grid of one wave at most: fewer
    blocks where the chunks run out."""
    used = 3 * (degree + 1) ** 2
    stage = 4 * (96 + 96 + 128 + 32 + 64 + 32 * (used | 1)) + 32
    stage = -(-stage // 16) * 16
    occ = _occupancy(lib, 1_000_000, 16, degree)
    assert occ["threads"] == 128
    assert occ["dynamic_shared"] == 4 * 2 * stage
    assert occ["grid"] == 132 * occ["blocks_per_sm"]
    assert _occupancy(lib, 200, 16, degree)["grid"] == 2  # 7 chunks
    assert _occupancy(lib, 1, 16, degree)["grid"] == 1


def _cotangents(n: int, seed: int) -> pp.Cotangents:
    rng = np.random.default_rng(seed)
    return pp.Cotangents(*(torch.from_numpy(
        rng.standard_normal((n, *shape)).astype(np.float32))
        for shape in ((2,), (), (3,), (3,), ())))


@pytest.mark.parametrize("n,scene_degree,degree,sh_offset", [
    (1, 3, 3, 0), (33, 0, 0, 0), (257, 3, 1, 1), (chip_smoke.EDGE_N, 3, 3,
                                                   0)])
def test_backward_matches_plain(lib, n, scene_degree, degree, sh_offset):
    """The backward (unchanged: a warp's SH rows staged in shared memory)
    against the plain VJP, every group within PRE_GRAD_RTOL of its largest
    magnitude, non-finite where the plain VJP is."""
    act, cam, rcfg = _cell(n, scene_degree, degree, seed=300 + n,
                           sh_offset=sh_offset)
    cot = _cotangents(n, n)
    args, grads, _held = pp.backward_args(act, device_camera(cam), rcfg, cot,
                                          cuda=False)
    assert lib.gsrast_preprocess_backward(*args) == 0
    plain = pp.preprocess_vjp_torch(act, cam, rcfg, cot)
    for name in chip_smoke.PRE_GRADS:
        a, b = grads[name], getattr(plain, name)
        finite = torch.isfinite(b)
        assert torch.equal(finite, torch.isfinite(a)), name
        scale = float(torch.where(finite, b, 0.0).abs().max())
        err = float(torch.where(finite, a - b, 0.0).abs().max())
        assert err <= chip_smoke.PRE_GRAD_RTOL * max(scale, 1e-30), (
            name, err, scale)
