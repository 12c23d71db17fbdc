"""The tile order kernel's CUDA source (`csrc/tile_order.cu`) run on the CPU:
compiled by g++ against the host stand-in of the CUDA runtime in
`tests/cuda_host/` (a block's 1,024 threads real threads at a barrier,
blocks one after another in the order they take their tickets, the warp's
vote and shuffle intrinsics through slots of its own), its C entry point
called through ctypes with the wrapper's arguments (`order_args`: the
table and the device's counters where the tiles take several slices), and
its order held equal, element for element, to the plain version
(`render/blend.py::tile_order`, a stable torch.sort of the buckets): tile
counts from one to 4K's 16,200 tiles of 16x32 (one round of 1,024 tiles,
one more tile, the most one block takes alone, one more in two slices,
four slices, a last slice of one tile, a last warp's run cut short),
every tile in one bucket, empty segments, segments past the last bucket,
and lengths that only rise or only fall; and `chip_smoke.py`'s 4K cell
(the bench scene at 3840x2160, cut to 20,000 Gaussians)."""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.render.blend import (ORDER_BUCKET_POSITIONS,
                                           ORDER_BUCKETS, ORDER_COUNTERS,
                                           order_args, tile_order)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(HERE), "gsrast_tpu_torch", "csrc",
                      "tile_order.cu")
LAUNCH = re.compile(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\(")
LAST = ORDER_BUCKETS * ORDER_BUCKET_POSITIONS  # the last bucket's first length


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """`tile_order.cu` built for the host: its launch rewritten to the
    shim's `launch(grid, block, kernel, ...)`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("tile_order_host")
    with open(SOURCE) as f:
        src = LAUNCH.sub(r"launch(\2, \3, \1, ", f.read())
    cpp, so = out / "tile_order_host.cpp", out / "libtile_order_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-I", os.path.join(HERE, "cuda_host"),
                    "-o", str(so), str(cpp)], check=True)
    dll = ctypes.CDLL(str(so))
    _kernels.set_order_argtypes(dll)
    return dll


def _starts(lengths) -> torch.Tensor:
    lengths = np.asarray(lengths, np.int64)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                            .astype(np.int32))


def _kernel_order(lib, starts: torch.Tensor) -> torch.Tensor:
    """The kernel's order through the wrapper's arguments (`order_args`):
    where the tiles take several slices, the table and the counters, which
    are back at 0 after the launch."""
    num_tiles = starts.numel() - 1
    order = torch.full((num_tiles,), -1, dtype=torch.int32)
    args, _table = order_args(lib, starts, order, None)
    assert lib.gsrast_tile_order(*args) == 0
    assert not _kernels.device_counters("tile_order", starts.device,
                                        ORDER_COUNTERS).any()
    return order


def _drawn(num_tiles: int, seed: int) -> np.ndarray:
    """Segment lengths as a scene gives them: most near a mean, a few
    several times longer, some empty."""
    rng = np.random.default_rng(seed)
    lengths = rng.gamma(2.0, 350.0, num_tiles).astype(np.int64)
    lengths[rng.random(num_tiles) < 0.05] = 0
    return lengths


CASES = {
    **{f"drawn_{n}": (lambda n=n: _drawn(n, n))
       for n in (1, 31, 1_024, 1_025, 4_080, 4_096, 4_097, 12_289, 16_200)},
    "one_bucket": lambda: np.random.default_rng(1).integers(
        64, 96, 3_000),
    "empty_segments": lambda: np.where(
        np.arange(2_500) % 3 == 0, 0,
        np.random.default_rng(2).integers(0, 200, 2_500)),
    "all_empty": lambda: np.zeros(1_500, np.int64),
    "past_last_bucket": lambda: np.random.default_rng(3).integers(
        LAST - 64, 4 * LAST, 2_100),
    "rising": lambda: np.arange(5_000) * 3,
    "falling": lambda: (5_000 - np.arange(5_000)) * 3,
}


@pytest.mark.parametrize("case", list(CASES))
def test_source_matches_plain(lib, case):
    lengths = CASES[case]()
    starts = _starts(lengths)
    plain = tile_order(starts)
    kernel = _kernel_order(lib, starts)
    assert torch.equal(kernel, plain), case
    bucket = np.minimum(lengths // ORDER_BUCKET_POSITIONS,
                        ORDER_BUCKETS - 1)[kernel.numpy()]
    assert (np.diff(bucket) <= 0).all()


def test_source_matches_plain_on_the_4k_cell(lib):
    """`chip_smoke.py`'s 4K order cell, at 20,000 of the bench scene's 1M
    Gaussians (the tile shape and count do not depend on how many): the
    bench config's 16,200 tiles of 16x32, the kernel's order the plain
    version's, and the chip run's bound following from the tile count."""
    starts = chip_smoke.order_4k_starts(torch.device("cpu"), n=20_000)
    assert starts.shape == (chip_smoke.ORDER_4K_TILES + 1,)
    assert int(starts[-1]) > 0
    kernel = _kernel_order(lib, starts)
    assert torch.equal(kernel, tile_order(starts))
    assert chip_smoke.order_err(kernel, starts) == 0.0
    ms, by = chip_smoke.order_bound(chip_smoke.ORDER_4K_TILES)
    assert by == "bytes" and ms == pytest.approx(
        4 * (2 * 16_200 + 1) / chip_smoke.HBM_BPS * 1e3)


@pytest.mark.parametrize("num_tiles,slices", [
    (1, 1), (4_080, 1), (4_096, 1), (4_097, 2), (8_192, 2), (8_193, 3),
    (16_200, 4)])
def test_source_slices(lib, num_tiles, slices):
    """Up to 4,096 tiles one block takes them all, with no table; past it
    slices of 4,096 tiles, two blocks a slice and a table of 256 ints a
    slice."""
    assert lib.gsrast_tile_order_table(num_tiles) == (
        0 if slices == 1 else ORDER_BUCKETS * slices)


def test_source_writes_nothing_for_no_tile(lib):
    assert lib.gsrast_tile_order(_starts([]).data_ptr(), 0, None, None,
                                 None, None) == 0


def test_source_refuses_slices_without_their_table(lib):
    """Tiles of several slices without a table or counters: the entry
    point returns an error before any launch."""
    starts = _starts(_drawn(5_000, 5))
    order = torch.empty(5_000, dtype=torch.int32)
    args, table = order_args(lib, starts, order, None)
    for missing in (3, 4):
        bad = list(args)
        bad[missing] = None
        assert lib.gsrast_tile_order(*bad) != 0
