"""The tile plan kernel's CUDA source (`csrc/plan.cu`) run on the CPU:
compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (each block's threads real threads at a barrier, blocks
one after another, the _rn intrinsics plain float operations built without
contraction), its C entry points called through ctypes by the wrapper's
own launcher (`binning.plan_tiers_launch`: the prologue, torch.sort of its
keys, the slots), and every `TierPlan` field held, slot for slot, to the
plain version (`plan_tiers_torch`) and to the reference's `plan_tiers` on
the same arrays: the whole grid, row-local plans (4 devices, rows 0 + 4 r
and 3 + 4 r) and routed plans (4 destinations); on the scenes of
`test_torch_binning.py` and on drawn states (`plan_cases.py`: a budgeted
plan that drops tiles, ten tiers over a skewed scene, every splat culled,
one Gaussian, a grid that needs padding); and with each width of sort
key."""

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
    if case == "culled":
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
    thr = f(2.0 * f(np.log(f(op / np.float32(binning.ALPHA_FLOOR)))))
    return lam, thr


@pytest.mark.parametrize("case", sorted(plan_cases.CASES))
def test_source_prologue_records(lib, case):
    """The prologue's records, Gaussian by Gaussian: the key k_last -
    count, the rect's x_min, rw_safe and first row, the whole grid's
    count clamped to k_last (`tile_counts`), the depth's bits, the mean,
    and `cull_bounds`' lam_min and cull_thresh, each operation correctly
    rounded (`_cull_bounds_rounded`; the logarithm within an ulp)."""
    import gsrast_tpu_torch as gt

    a = plan_cases.arrays(case)
    gh, gw = a["grid"]
    _, _, _, (th, tw), tiers, *_ = plan_cases.CASES[case]
    prep = plan_cases.prep(a)
    k_last = tiers[-1][0]
    rec = binning.plan_prologue(lib, prep, binning.plan_layout(
        prep.depth.shape[0], gh, gw, gt.RenderConfig(tile_h=th, tile_w=tw,
                                                     tiers=tiers)), k_last)
    counts, y0, rw = binning.tile_counts(prep, gh)
    counts = torch.clamp(counts, max=k_last)
    assert torch.equal(rec.key.long(), k_last - counts.long())
    assert torch.equal(rec.rec_a, torch.stack(
        [prep.rect.x_min, torch.clamp(rw, min=1), y0, counts], 1))
    assert torch.equal(rec.rec_depth, prep.depth.view(torch.int32))
    assert torch.equal(rec.rec_cull[:, :2], prep.mean2d)
    lam, thr = _cull_bounds_rounded(a["conic"], a["opacity"])
    np.testing.assert_array_equal(rec.rec_cull[:, 2].numpy(), lam)
    ulps = np.abs(rec.rec_cull[:, 3].numpy().view(np.int32).astype(np.int64)
                  - thr.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    dropped = int((binning.tile_counts(prep, gh)[0] - counts).sum())
    assert int(rec.counters[1]) == dropped


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_source_every_key_width(lib, monkeypatch, dtype):
    """The ranking is the same stable sort whatever the key's width: the
    skewed 10-tier case (k_last 512) with its key forced to each type
    that can hold k_last - count (uint8 only where k_last fits)."""
    import gsrast_tpu_torch as gt

    case = "skewed_10" if dtype != torch.uint8 else "budgeted"
    a = plan_cases.arrays(case)
    gh, gw = a["grid"]
    _, _, _, (th, tw), tiers, *_ = plan_cases.CASES[case]
    monkeypatch.setattr(binning, "plan_key_dtype", lambda k_last: dtype)
    pcfg = gt.RenderConfig(tile_h=th, tile_w=tw, tiers=tiers, backend="torch")
    prep = plan_cases.prep(a)
    got = binning.plan_tiers_launch(lib, prep, gh, gw, pcfg)
    assert differing(got, binning.plan_tiers_torch(
        prep, gh, gw, pcfg)) == dict.fromkeys(FIELDS, 0)
    assert got.tile_key.numel() > 0


def test_key_widths():
    assert binning.plan_key_dtype(12) == torch.uint8
    assert binning.plan_key_dtype(255) == torch.uint8
    assert binning.plan_key_dtype(256) == torch.int16
    assert binning.plan_key_dtype(32_767) == torch.int16
    assert binning.plan_key_dtype(32_768) == torch.int32


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
