"""The arithmetic around the blend kernels that runs in Python: the map from
threads to pixels (`kernel_footprint`, `footprint_pixels`), the launch
order of the tiles (`tile_order`), and the work counts and bounds that
`chip_smoke.py` prints beside the kernels' times (`blend_work`,
`bisect_bound`), each against a brute-force count."""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

from gsrast_tpu_torch import config as cfg
from gsrast_tpu_torch.render import blend
from gsrast_tpu_torch.render.blend import (Footprint, blend_forward_torch,
                                           footprint_pixels, kernel_footprint,
                                           tile_order)

from torch_parity import BLEND_CASES, long_segment_case, packed_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

TILE_SHAPES = [(8, 32), (16, 16), (16, 32), (32, 16), (16, 64), (8, 128),
               (32, 64), (64, 32), (8, 256), (16, 128)]
WORK_CASES = BLEND_CASES + ("long_segment",)


def _case(case):
    if case == "long_segment":
        return long_segment_case()
    return packed_port(case, "cpu")


def _pixel(fp: Footprint, warp: int, i: int, lane: int):
    """(row, column) of warp `warp`'s pixel i at `lane`, as
    csrc/blend_common.cuh's footprint_pixel computes it."""
    across = fp.k // 2
    y = (warp // fp.wx) * 8 + (i // across) * 4 + lane // 8
    x = (warp % fp.wx) * 4 * fp.k + (i % across) * 8 + lane % 8
    return y, x


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_footprint_covers_each_pixel_once(kernel, shape):
    """Every pixel of the tile belongs to exactly one (warp, i, lane), each
    warp's pixels lie in its 8 x 4k patch and each sub-patch's in a 4 x 8
    rectangle; the block has P / 32k warps."""
    th, tw = shape
    fp = kernel_footprint(kernel, th, tw)
    assert fp.k == blend.PIXELS_PER_THREAD[kernel]
    assert 32 * fp.k * fp.warps == th * tw and fp.wx * 4 * fp.k == tw
    px = footprint_pixels(fp, tw)
    assert px.shape == (fp.warps, fp.k, 32)
    seen = []
    for w, i, lane in itertools.product(range(fp.warps), range(fp.k),
                                        range(32)):
        y, x = _pixel(fp, w, i, lane)
        assert y < th and x < tw and int(px[w, i, lane]) == y * tw + x
        seen.append(y * tw + x)
    assert sorted(seen) == list(range(th * tw))
    for w in range(fp.warps):
        ys, xs = zip(*(_pixel(fp, w, i, lane) for i in range(fp.k)
                       for lane in range(32)))
        assert max(ys) - min(ys) < 8 and max(xs) - min(xs) < 4 * fp.k
        for i in range(fp.k):
            ys, xs = zip(*(_pixel(fp, w, i, lane) for lane in range(32)))
            assert max(ys) - min(ys) < 4 and max(xs) - min(xs) < 8


def test_kernel_shapes_of_the_main_paths():
    """The blocks of the paths' tiles: the forward 2 pixels a thread on 8 x
    8 patches, the backward 4 on 8 x 16."""
    expect = {(8, 32): (4, 2), (16, 32): (8, 4), (16, 64): (16, 8),
              (32, 64): (32, 16)}
    for (th, tw), (fwd, bwd) in expect.items():
        assert kernel_footprint("forward", th, tw) == Footprint(2, fwd,
                                                                tw // 8)
        assert kernel_footprint("backward", th, tw) == Footprint(4, bwd,
                                                                 tw // 16)


@pytest.mark.parametrize("kernel,shape", [
    ("forward", (64, 64)), ("backward", (8, 16)), ("forward", (4, 64)),
    ("backward", (32, 8)), ("forward", (24, 72)), ("backward", (3, 17))])
def test_unsupported_tiles_raise(kernel, shape):
    """Too many or too few pixels, or sides the patches do not tile."""
    with pytest.raises(ValueError, match="takes tiles of"):
        kernel_footprint(kernel, *shape)


def test_tile_order_longest_bucket_first():
    """A permutation of the tiles whose buckets of 32 positions never grow
    along it (segments of 8,160 or more share the last bucket), ties in
    tile order: what the card's stable counting sort gives, element for
    element (`chip_smoke.order_err` compares the two exactly)."""
    rng = np.random.default_rng(3)
    lengths = np.concatenate([rng.integers(0, 900, 500), [9000, 8160, 0]])
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                          dtype=torch.int32)
    order = tile_order(starts)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(len(lengths)))
    bucket = np.minimum(lengths // 32, 255)[order.numpy()]
    assert (np.diff(bucket) <= 0).all()
    for b in np.unique(bucket):
        tiles = order.numpy()[bucket == b]
        assert (np.diff(tiles) > 0).all()
    assert set(order[:2].tolist()) == {500, 501}
    assert chip_smoke.order_err(order, starts) == 0.0
    assert chip_smoke.order_err(order.flip(0), starts) > 0.0
    assert chip_smoke.order_err(torch.zeros_like(order), starts) == float(
        "inf")


def _brute_work(feat, starts, nc, gw, th, tw, tile_map=(0, 1)):
    """blend_work's pair and patch counts, by loops over tiles, warps,
    pixels and lanes, and its blended pairs by the gate in numpy float32,
    one tile at a time (local tile t at global row tile_map[0] + (t // gw)
    * tile_map[1])."""
    f = feat.numpy()
    starts, nc = starts.tolist(), nc.numpy()
    out = dict(fwd_pairs=0, bwd_pairs=0, fwd_blended=0, bwd_blended=0,
               fwd_evaluated=0, bwd_evaluated=0, bwd_warp_steps=0,
               fwd_strips=0)
    rows, cols = np.divmod(np.arange(th * tw), tw)
    for t in range(len(starts) - 1):
        seg = starts[t + 1] - starts[t]
        stop = np.minimum(nc[t] + 1, seg)
        out["fwd_pairs"] += int(stop.sum())
        out["bwd_pairs"] += int(nc[t].sum())
        out["fwd_strips"] += sum(32 * int(stop[s:s + 32].max())
                                 for s in range(0, th * tw, 32))
        if seg:
            c = f[:, starts[t]:starts[t + 1], None]
            dx = c[0] - (cols + (t % gw) * tw).astype(np.float32)
            dy = c[1] - (rows + (tile_map[0] + (t // gw) * tile_map[1])
                         * th).astype(np.float32)
            power = (np.float32(-0.5) * (c[2] * (dx * dx) + c[4] * (dy * dy))
                     - c[3] * (dx * dy))
            alpha = np.minimum(c[5] * np.exp(power), np.float32(cfg.ALPHA_MAX))
            blends = (power <= 0) & (alpha >= np.float32(cfg.ALPHA_MIN))
            pos = np.arange(seg)[:, None]
            out["fwd_blended"] += int((blends & (pos < stop)).sum())
            out["bwd_blended"] += int((blends & (pos < nc[t])).sum())
        for kernel, d in (("forward", "fwd"), ("backward", "bwd")):
            fp = kernel_footprint(kernel, th, tw)
            for w in range(fp.warps):
                warp_max = 0
                for i in range(fp.k):
                    need = 0
                    for lane in range(32):
                        y, x = _pixel(fp, w, i, lane)
                        p = y * tw + x
                        need = max(need, int(stop[p] if d == "fwd"
                                             else nc[t][p]))
                    out[f"{d}_evaluated"] += 32 * need
                    warp_max = max(warp_max, need)
                if d == "bwd":
                    out["bwd_warp_steps"] += warp_max
    return out


@pytest.mark.parametrize("case", WORK_CASES)
def test_blend_work_matches_brute_force(case):
    """chip_smoke.blend_work against loops over every pixel, on the plain
    forward's n_contrib; bytes and bounds from the shapes. The blended
    pairs may differ where alpha lands within an ulp of ALPHA_MIN, as
    torch and numpy may round exp differently."""
    feat, starts, gh, gw, th, tw = _case(case)
    _, _, nc = blend_forward_torch(feat, starts, gh, gw, th, tw)
    work = chip_smoke.blend_work(feat, starts, nc, gw, th, tw)
    for key, value in _brute_work(feat, starts, nc, gw, th, tw).items():
        if key.endswith("_blended"):
            assert abs(work[key] - value) <= 2 + 1e-4 * value, key
            assert 0 < work[key] <= work[key.replace("blended", "pairs")]
        else:
            assert work[key] == value, key
    t, p, live = gh * gw, th * tw, int(starts[-1])
    assert work["fwd_bytes"] == 4 * (9 * live + 5 * t * p + t + 1)
    assert work["bwd_bytes"] == 4 * (9 * live + 10 * feat.shape[1]
                                     + 6 * t * p + t + 1)
    assert work["fwd_pairs"] <= work["fwd_evaluated"]
    assert work["bwd_pairs"] <= work["bwd_evaluated"]
    for d, flops in (("fwd", chip_smoke.FWD_FLOPS),
                     ("bwd", chip_smoke.BWD_FLOPS)):
        blended = work[f"{d}_blended"]
        ops = blended * flops + (work[f"{d}_pairs"] - blended) * (
            chip_smoke.SKIP_FLOPS)
        ms_flops = ops / chip_smoke.FP32_FLOPS * 1e3
        ms_bytes = work[f"{d}_bytes"] / chip_smoke.HBM_BPS * 1e3
        assert work[f"{d}_bound_ms"] == pytest.approx(max(ms_flops,
                                                          ms_bytes))
        assert work[f"{d}_bound_by"] == ("operations" if ms_flops > ms_bytes
                                         else "bytes")


def test_blend_work_local_tiles_matches_brute_force():
    """blend_work on local tiles (rows {1, 3} of a 4-row grid, the
    tile-sharded path's blend input): the pixels sit at the global rows."""
    from torch_parity import LOCAL_ROWS, LOCAL_TILE_MAP, packed_port_local

    feat, starts, gh, gw, th, tw = packed_port_local("cpu")
    local = dict(num_tiles=LOCAL_ROWS * gw, tile_map=LOCAL_TILE_MAP)
    _, _, nc = blend_forward_torch(feat, starts, gh, gw, th, tw, **local)
    work = chip_smoke.blend_work(feat, starts, nc, gw, th, tw,
                                 tile_map=LOCAL_TILE_MAP)
    brute = _brute_work(feat, starts, nc, gw, th, tw, LOCAL_TILE_MAP)
    for key, value in brute.items():
        if key.endswith("_blended"):
            assert abs(work[key] - value) <= 2 + 1e-4 * value, key
            assert value > 0
        else:
            assert work[key] == value, key
    # At the whole grid's pixel rows the same splats blend elsewhere.
    assert chip_smoke.blended_pairs(feat, starts, nc, gw, th, tw) != (
        work["fwd_blended"], work["bwd_blended"])


def test_blended_pairs_chunks_agree():
    """blended_pairs gives the same counts whatever runs of tiles its
    budget cuts the tiles into."""
    feat, starts, gh, gw, th, tw = packed_port("trained_small_16x32", "cpu")
    _, _, nc = blend_forward_torch(feat, starts, gh, gw, th, tw)
    whole = chip_smoke.blended_pairs(feat, starts, nc, gw, th, tw)
    assert chip_smoke.blended_pairs(feat, starts, nc, gw, th, tw,
                                    budget=th * tw) == whole


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_bisect_bound_counts(name):
    """The bisection bounds at trained_116k's 1080p plan (107,280 rows of
    128, 2,040 tiles): A moves 110 MB, so its bound is set by bytes; C and
    D by their flops."""
    rows, tiles = 107_280, 2_040
    ms, by = chip_smoke.bisect_bound(name, rows, tiles)
    if name == "a":
        assert ms == pytest.approx(2 * rows * 512 / chip_smoke.HBM_BPS * 1e3)
        assert by == "bytes" and 0.032 < ms < 0.034
    elif name == "b":
        assert by == "bytes" and ms < chip_smoke.bisect_bound("a", rows,
                                                              tiles)[0]
    else:
        per = 3 if name == "c" else 5
        assert by == "operations"
        assert ms == pytest.approx(rows * 8 * 1024 * per
                                   / chip_smoke.FP32_FLOPS * 1e3)


@pytest.mark.cuda
@pytest.mark.parametrize("num_tiles", [1_020, 4_080, 16_200])
def test_cuda_tile_order_in_a_graph(num_tiles):
    """The order kernel captured in a CUDA graph is one device operation
    (one slice or several), and each replay writes the plain order again:
    its counters go back to zero at the end of every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from gsrast_tpu_torch.diag.adam_timing import graph_nodes
    from gsrast_tpu_torch.render.blend import tile_order_cuda

    dev = torch.device("cuda")
    starts = chip_smoke.order_4k_starts(dev)[:num_tiles + 1].contiguous()
    plain = tile_order(starts)
    assert torch.equal(tile_order_cuda(starts), plain)  # eager, first
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        order = tile_order_cuda(starts)
    assert graph_nodes(graph) == 1
    graph.instantiate()
    for _ in range(3):
        order.fill_(-1)
        graph.replay()
        assert torch.equal(order, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WORK_CASES)
def test_cuda_tile_order_matches_plain(case):
    """The order kernel gives the plain `tile_order`'s order element for
    element, and the blend kernels' outputs do not depend on the order
    their blocks take the tiles in: index order and longest first give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from gsrast_tpu_torch.render.blend import (blend_backward_cuda,
                                               blend_forward_cuda,
                                               tile_order_cuda)

    dev = torch.device("cuda")
    feat, starts, gh, gw, th, tw = (long_segment_case(dev)
                                    if case == "long_segment"
                                    else packed_port(case, dev))
    order = tile_order_cuda(starts)
    index = torch.arange(gh * gw, dtype=torch.int32, device=dev)
    assert chip_smoke.order_err(order, starts) == 0.0
    fwd = blend_forward_cuda(feat, starts, gh, gw, th, tw, order)
    fwd_index = blend_forward_cuda(feat, starts, gh, gw, th, tw, index)
    for a, b in zip(fwd, fwd_index):
        assert torch.equal(a, b)
    gen = torch.Generator(device=dev).manual_seed(4)
    d_rgb = torch.randn((gh * gw, 3, th * tw), generator=gen, device=dev)
    d_ft = torch.randn((gh * gw, th * tw), generator=gen, device=dev)
    args = (feat, starts, d_rgb, d_ft, fwd[1], fwd[2], gh, gw, th, tw)
    assert torch.equal(blend_backward_cuda(*args, order),
                       blend_backward_cuda(*args, index))
