"""The tile plan kernel's CUDA source (`csrc/plan.cu`) run on the CPU:
compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (each block's threads real threads at a barrier, blocks
one after another, the warp's match and vote intrinsics through slots of
its own, the _rn intrinsics plain float operations built without
contraction, the dynamic shared memory a host array), its C entry points
called through ctypes by the wrapper's
own launcher (`binning.plan_tiers_launch`: the rank launch, then the
slots), and every `TierPlan` field held, slot for slot, to the plain
version (`plan_tiers_torch`) and to the reference's `plan_tiers` on the
same arrays: the whole grid, row-local plans (4 devices, rows 0 + 4 r and
3 + 4 r) and routed plans (4 destinations); on the scenes of
`test_torch_binning.py` and on drawn states (`plan_cases.py`: a budgeted
plan that drops tiles, ten tiers over a skewed scene, every splat culled,
no Gaussian, one Gaussian, a grid that needs padding, one count over
several blocks, k_last 255, 256 and 460 over blocks of several rounds, and
wide bucket tables, k_last 32,767 and 32,768, whose warp counts lie in
scratch). The rank launch's ranks are held to the stable ranking on their
own."""

import ctypes
import functools
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsrast_tpu.ops import binning as jax_binning
from gsrast_tpu.ops import projection as jax_projection
from gsrast_tpu.ops.preprocess import Preprocessed as JaxPreprocessed
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.diag import plan_timing
from gsrast_tpu_torch.diag.plan_timing import FIELDS, differing
from gsrast_tpu_torch.ops import binning

import plan_cases
from test_torch_binning import CASES as SCENES
from test_torch_binning import D, SHARD_TIERS, _setup, _shard_setup
from torch_parity import prep_to_torch, t2n

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "plan.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
SHARED = "extern __shared__ int rank_shared[];"  # a host array in the build

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`plan.cu` built for the host: each launch rewritten to the shim's
    `launch(grid, block, kernel, ...)`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("plan_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    assert SHARED in src
    src = src.replace(SHARED, "alignas(16) int rank_shared"
                              "[kHostSharedPerSm / 4];")
    cpp, so = out / "plan_host.cpp", out / "libplan_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", os.path.join(HERE,
                                                              "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    _kernels.set_plan_argtypes(dll)
    return dll


# The reference's plan compiled once a case (op by op it takes ~30 s on the
# 10-tier case).
_jax_plan = functools.partial(jax.jit, static_argnums=(1, 2, 3),
                              static_argnames=("num_local_rows", "row0",
                                               "row_stride", "dest_rows",
                                               "n_dest"))(
    jax_binning.plan_tiers)


def _jax_prep(a: dict) -> JaxPreprocessed:
    n = a["depth"].shape[0]
    return JaxPreprocessed(
        mean2d=jnp.asarray(a["mean2d"]), depth=jnp.asarray(a["depth"]),
        conic=jnp.asarray(a["conic"]), color=jnp.asarray(a["color"]),
        opacity=jnp.asarray(a["opacity"]), radius=jnp.asarray(a["radius"]),
        rect=jax_projection.TileRect(*(jnp.asarray(x) for x in a["rect"])),
        tiles_touched=jnp.zeros((n,), jnp.int32))


def _check(lib, prep, ref, gh, gw, pcfg, **mode):
    """The host build's plan against the plain version's and the
    reference's (`ref`), every field exactly."""
    got = binning.plan_tiers_launch(lib, prep, gh, gw, pcfg, **mode)
    plain = binning.plan_tiers_torch(prep, gh, gw, pcfg, **mode)
    assert differing(got, plain) == dict.fromkeys(
        FIELDS, 0)
    for name in FIELDS:
        np.testing.assert_array_equal(t2n(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("case", sorted(SCENES))
def test_source_matches_plain_and_reference_on_scenes(lib, case):
    *_, jcfg, pcfg, p_ref, (gh, gw) = _setup(case)
    got = _check(lib, prep_to_torch(p_ref), _jax_plan(
        p_ref, gh, gw, jcfg), gh, gw, pcfg)
    assert int(got.total) > 100


@pytest.mark.parametrize("row0", [0, 1, 2, 3])
def test_source_row_local_on_a_scene(lib, row0):
    """The tile-sharded mode on the sharded scene of test_torch_binning:
    rows {row0 + 4 r} with the device-scaled tiers."""
    jcfg, pcfg, p_ref, gh, gw = _shard_setup()
    tiers = binning.shard_tiers(SHARD_TIERS, D)
    rpd = -(-gh // D)
    mode = dict(num_local_rows=rpd, row0=row0, row_stride=D)
    _check(lib, prep_to_torch(p_ref), _jax_plan(
        p_ref, gh, gw, jcfg.replace(tiers=tiers), **mode), gh, gw,
        pcfg.replace(tiers=tiers), **mode)


def test_source_routed_on_a_scene(lib):
    jcfg, pcfg, p_ref, gh, gw = _shard_setup()
    mode = dict(dest_rows=-(-gh // D), n_dest=D)
    got = _check(lib, prep_to_torch(p_ref), _jax_plan(
        p_ref, gh, gw, jcfg, **mode), gh, gw, pcfg, **mode)
    bits = binning.route_bits(mode["dest_rows"], gw, D)
    live = t2n(got.tile_key)[t2n(got.gauss) >= 0]
    assert set(np.unique(live >> bits)) == set(range(D))


@pytest.mark.parametrize("mode", ["whole", "rows_0", "rows_3", "routed"])
@pytest.mark.parametrize("case", sorted(plan_cases.CASES))
def test_source_matches_plain_and_reference(lib, case, mode):
    import gsrast_tpu as gs
    import gsrast_tpu_torch as gt

    a = plan_cases.arrays(case)
    gh, gw = a["grid"]
    _, _, _, (th, tw), *_ = plan_cases.CASES[case]
    tiers, kw = plan_cases.modes(case, gh)[mode]
    ref = _jax_plan(
        _jax_prep(a), gh, gw, gs.RenderConfig(tile_h=th, tile_w=tw,
                                              tiers=tiers), **kw)
    got = _check(lib, plan_cases.prep(a), ref, gh, gw, gt.RenderConfig(
        tile_h=th, tile_w=tw, tiers=tiers, backend="torch"), **kw)
    total = int(got.total)
    if case in ("culled", "empty"):
        assert total == 0 and int(got.overflow_tile_cap) == 0
    elif mode == "whole":
        assert total > 0
        if case == "budgeted":
            assert int(got.overflow_tile_cap) > 0
        if case == "padded":
            assert binning.plan_layout(300, gh, gw, gt.RenderConfig(
                tile_h=th, tile_w=tw, tiers=tiers)).pad > 0


def _cull_bounds_rounded(conic, opacity) -> tuple:
    """`cull_bounds` with every float32 operation correctly rounded (each
    taken in float64 and rounded once, which for +, -, x and the square
    root gives the float32 result), the logarithm too: the host build's
    arithmetic. (torch's vectorized float32 sqrt and log on the CPU can be
    an ulp off; on the card both sides use the CUDA library, which
    `test_torch_plan_kernel.py` checks bit for bit.)"""
    def f(x):
        return np.asarray(x, np.float64).astype(np.float32)

    a, b, c = (f(conic[:, i]) for i in range(3))
    amc = f(a.astype(np.float64) - c)
    disc = f(f(0.25 * f(amc.astype(np.float64) * amc))
             + f(b.astype(np.float64) * b))
    disc = np.where(disc < 0, np.float32(0), disc)
    lam = f(f(0.5 * f(a.astype(np.float64) + c))
            - f(np.sqrt(disc.astype(np.float64))))
    lam = np.where(lam < 0, np.float32(0), lam)
    op = np.maximum(opacity, np.float32(1e-12)).astype(np.float64)
    thr = f(2.0 * f(np.log(f(op / np.float32(binning.ALPHA_FLOOR))
                           .astype(np.float64))))
    return lam, thr


@pytest.mark.parametrize("case", sorted(plan_cases.CASES))
def test_source_prologue_records(lib, case):
    """The rank launch's records, Gaussian by Gaussian: its bucket's
    first rank in its block (the table) plus its rank there (`local`) is
    its place in the stable ranking by count, descending (`tile_counts`
    clamped to k_last, ties in index order); its four counts are zeroed and
    the ticket is back to 0. And the slots launch's cull values
    (`binning.plan_cull`): lam_min and cull_thresh with every float32
    operation correctly rounded (`_cull_bounds_rounded`; the logarithm
    within an ulp)."""
    import gsrast_tpu_torch as gt

    a = plan_cases.arrays(case)
    gh, gw = a["grid"]
    _, _, _, (th, tw), tiers, *_ = plan_cases.CASES[case]
    prep = plan_cases.prep(a)
    n, k_last = prep.depth.shape[0], tiers[-1][0]
    lay = binning.plan_layout(n, gh, gw, gt.RenderConfig(
        tile_h=th, tile_w=tw, tiers=tiers))
    ticket = binning.plan_ticket(prep.depth.device)
    ranks = binning.plan_rank(lib, prep, lay, k_last)
    shape = binning.plan_shape(lib, n, k_last)
    assert ranks.table.shape == (k_last + 1, shape.blocks)
    assert shape.table == ranks.table.numel()
    assert (shape.warp_counts > 0) == (k_last + 1 > 1024)
    counts = torch.clamp(binning.tile_counts(prep, gh)[0], max=k_last)
    block = torch.arange(n) // (256 * shape.rounds)
    rank = ranks.table[k_last - counts.long(), block] + ranks.local
    want = torch.empty(n, dtype=torch.int32)
    want[torch.sort(-counts, stable=True).indices] = torch.arange(
        n, dtype=torch.int32)
    assert torch.equal(rank, want)
    assert ranks.counters.tolist() == [0, 0, 0, 0] and int(ticket) == 0
    cull = binning.plan_cull(lib, prep)
    lam, thr = _cull_bounds_rounded(a["conic"], a["opacity"])
    np.testing.assert_array_equal(cull[:, 0].numpy(), lam)
    ulps = np.abs(cull[:, 1].numpy().view(np.int32).astype(np.int64)
                  - thr.view(np.int32).astype(np.int64))
    assert ulps.max(initial=0) <= 1


@pytest.mark.parametrize("n, k_last, rounds", [
    (100_000, 12, 1), (1_000_000, 12, 7), (116_000, 460, 26),
    (1_000_000, 32_768, 64)])
def test_source_rank_shape(lib, n, k_last, rounds):
    """The rank launch's shape: the fewest rounds of 256 Gaussians a block
    that keep the bucket table (blocks x (k_last + 1)) near 8,192 entries,
    at most 64; one block at least (N = 0 still zeroes the counts)."""
    shape = binning.plan_shape(lib, n, k_last)
    assert shape.rounds == rounds
    assert shape.blocks == -(-n // (256 * rounds))
    assert shape.table == shape.blocks * (k_last + 1)
    empty = binning.plan_shape(lib, 0, k_last)
    assert (empty.rounds, empty.blocks) == (1, 1)


def test_source_refuses_a_bad_table(lib):
    """Too many tiers for the kernel's table: the launcher raises before
    any launch; a bad table reaching the entry point returns an error."""
    import gsrast_tpu_torch as gt

    a = plan_cases.arrays("padded")
    gh, gw = a["grid"]
    tiers = tuple((k + 1, 1.0) for k in range(binning.PLAN_MAX_TIERS + 1))
    with pytest.raises(ValueError, match="at most"):
        binning.plan_tiers_launch(lib, plan_cases.prep(a), gh, gw,
                                  gt.RenderConfig(tile_h=8, tile_w=8,
                                                  tiers=tiers))
    with pytest.raises(RuntimeError, match="slots launch failed"):
        binning.plan_tiers_launch(
            lib, plan_cases.prep(a), gh, gw,
            gt.RenderConfig(tile_h=8, tile_w=8, tiers=((3, 1.0),)),
            dest_rows=0, n_dest=1)
