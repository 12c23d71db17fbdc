"""The tile plan's dispatch and, on the card, its kernel (`csrc/plan.cu`)
against its plain version. This file imports no JAX: its `cuda` cases run
on the card (`python3 -m pytest tests/test_torch_plan_kernel.py -m cuda`),
the others here. The kernel's arithmetic is held to the plain version and
the reference on the CPU by `test_torch_plan_source.py`."""

import pytest
import torch

import gsrast_tpu_torch as gt
from gsrast_tpu_torch import _kernels
from gsrast_tpu_torch.diag import plan_timing
from gsrast_tpu_torch.diag.plan_timing import FIELDS, differing
from gsrast_tpu_torch.ops import binning

import plan_cases

torch.set_num_threads(2)
ZERO = dict.fromkeys(FIELDS, 0)


def _case(case: str, device="cpu", backend="cuda"):
    a = plan_cases.arrays(case)
    _, _, _, (th, tw), tiers, *_ = plan_cases.CASES[case]
    return (plan_cases.prep(a, device), *a["grid"],
            gt.RenderConfig(tile_h=th, tile_w=tw, tiers=tiers,
                            backend=backend))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_plan_dispatch_on_cpu_tensors(backend):
    """CPU tensors take the plain version whatever the backend (the rule
    of `_kernels.uses_kernel`), and launch nothing; the kernel's wrapper
    refuses them."""
    prep, gh, gw, rcfg = _case("budgeted", backend=backend)
    assert not _kernels.uses_kernel(backend, prep.depth.device)
    _kernels.reset_launch_counts()
    got = binning.plan_tiers(prep, gh, gw, rcfg)
    assert not any(_kernels.launch_counts.values())
    assert differing(got, binning.plan_tiers_torch(
        prep, gh, gw, rcfg)) == ZERO
    with pytest.raises(ValueError, match="CUDA tensors"):
        binning.plan_tiers_cuda(prep, gh, gw, rcfg)


def test_plan_inputs_are_checked():
    """The launcher's inputs: float32 and int32 fields of the scene's
    length; a strided view is made contiguous (the sharded exchange's
    columns are)."""
    prep, gh, gw, rcfg = _case("padded")
    bad = prep._replace(rect=prep.rect._replace(
        x_min=prep.rect.x_min.long()))
    with pytest.raises(ValueError, match="rect.x_min"):
        binning.plan_inputs(bad)
    with pytest.raises(ValueError, match="conic"):
        binning.plan_inputs(prep._replace(conic=prep.conic[:-1]))
    packed = torch.cat([prep.mean2d, prep.conic], 1)
    views = binning.plan_inputs(prep._replace(mean2d=packed[:, :2],
                                              conic=packed[:, 2:]))
    assert all(t.is_contiguous() for t in views)
    assert torch.equal(views[2], prep.conic)


def test_plan_layout_matches_the_plain_version():
    """The static structure both versions share: slots and padding of
    `tier_dims`, the sentinels, and the mode checks; and the kernel's
    layout, by rank where a tier is PLAN_WIDE_TIER wide."""
    lay = binning.plan_layout(300, 8, 8, gt.RenderConfig(
        tile_h=8, tile_w=8, tiers=((3, 1.0),)))
    assert (lay.s0, lay.pad, lay.sentinel) == (900, 124, 64)
    routed = binning.plan_layout(300, 11, 8, gt.RenderConfig(
        tile_h=8, tile_w=8, tiers=((3, 1.0),)), dest_rows=3, n_dest=4)
    assert routed.sentinel == 4 << binning.route_bits(3, 8, 4)
    rows = binning.plan_layout(300, 11, 8, gt.RenderConfig(
        tile_h=8, tile_w=8, tiers=((3, 1.0),)), num_local_rows=3, row0=3,
        row_stride=4)
    assert (rows.num_rows, rows.row0, rows.sentinel) == (3, 3, 24)
    assert not binning.plan_by_rank(lay)
    assert binning.plan_by_rank(binning.plan_layout(300, 8, 8, gt.RenderConfig(
        tile_h=8, tile_w=8, tiers=((1, 1.0), (33, 0.5)))))
    with pytest.raises(ValueError, match="whole grid"):
        binning.plan_layout(300, 11, 8, gt.RenderConfig(
            tile_h=8, tile_w=8, tiers=((3, 1.0),)), num_local_rows=3,
            dest_rows=3, n_dest=4)
    with pytest.raises(ValueError, match="requires"):
        binning.plan_layout(300, 11, 8, gt.RenderConfig(tile_h=8, tile_w=8))


# -- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["whole", "rows_0", "rows_3", "routed"])
@pytest.mark.parametrize("case", sorted(plan_cases.CASES))
def test_cuda_kernel_matches_plain(case, mode):
    """The kernel against the plain version on the same card inputs,
    every field exactly, in each mode; two launches equal; one count a
    plan; the dispatch takes the kernel under backend 'cuda' and the
    plain version under 'torch'."""
    dev = _card()
    prep, gh, gw, rcfg = _case(case, dev)
    tiers, kw = plan_cases.modes(case, gh)[mode]
    rcfg = rcfg.replace(tiers=tiers)
    _kernels.reset_launch_counts()
    first = binning.plan_tiers(prep, gh, gw, rcfg, **kw)
    again = binning.plan_tiers_cuda(prep, gh, gw, rcfg, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["plan_tiers"] == 2
    plain = binning.plan_tiers(prep, gh, gw, rcfg.replace(backend="torch"),
                               **kw)
    assert _kernels.launch_counts["plan_tiers"] == 2
    assert differing(first, plain) == ZERO
    assert differing(first, again) == ZERO


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(plan_cases.CASES))
def test_cuda_prologue_matches_cull_bounds(case):
    """The slots launch's lam_min and cull_thresh on the card (its
    arithmetic run alone, `binning.plan_cull`) equal the plain version's
    `cull_bounds` there, value for value: torch's (a - c) ** 2 is a
    product, its sqrt and log are the CUDA library's, and its division by
    0.98 ALPHA_MIN a true one by the float32 constant."""
    dev = _card()
    prep, gh, gw, rcfg = _case(case, dev)
    cull = binning.plan_cull(_kernels.load().lib, prep,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert plan_timing.cull_differ(prep, cull) == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k460", "k32768"])
def test_cuda_ranks_across_blocks(case):
    """The rank launch on the card: each Gaussian's rank (its bucket's
    first rank in its block plus its rank there) is its place in the
    plain version's stable ranking, over blocks of several rounds and a
    wide table whose warp counts lie in scratch; the ticket is back to 0
    and the counts zero."""
    dev = _card()
    prep, gh, gw, rcfg = _case(case, dev)
    lay = binning.plan_layout(prep.depth.shape[0], gh, gw, rcfg)
    k_last = rcfg.tiers[-1][0]
    lib = _kernels.load().lib
    ranks = binning.plan_rank(lib, prep, lay, k_last,
                              torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    shape = binning.plan_shape(lib, lay.n, k_last)
    assert shape.blocks > 1 and shape.rounds > 1
    counts = torch.clamp(binning.tile_counts(prep, gh)[0], max=k_last)
    block = torch.arange(lay.n, device=dev) // (256 * shape.rounds)
    rank = ranks.table[k_last - counts.long(), block] + ranks.local
    want = torch.empty_like(rank)
    want[torch.sort(-counts, stable=True).indices] = torch.arange(
        lay.n, dtype=rank.dtype, device=dev)
    assert torch.equal(rank, want)
    assert int(binning.plan_ticket(dev)) == 0
    assert ranks.counters.tolist() == [0, 0, 0, 0]


@pytest.mark.cuda
def test_cuda_plan_in_a_graph():
    """The plan captured in a CUDA graph and replayed on new inputs
    copied into the captured ones: the replay's plan is the plain
    version's of the new inputs."""
    dev = _card()
    prep, gh, gw, rcfg = _case("skewed_10", dev)
    moved = prep._replace(mean2d=prep.mean2d + 3.0,
                          depth=torch.flip(prep.depth, (0,)))
    static = prep._replace(mean2d=prep.mean2d.clone(),
                           depth=prep.depth.clone())
    _kernels.on_side_stream(lambda: binning.plan_tiers_cuda(
        static, gh, gw, rcfg), dev)
    graph, plan, launches = _kernels.capture(
        lambda: binning.plan_tiers_cuda(static, gh, gw, rcfg), "the plan")
    assert launches["plan_tiers"] == 1
    static.mean2d.copy_(moved.mean2d)
    static.depth.copy_(moved.depth)
    _kernels.replay(graph, launches)
    torch.cuda.synchronize()
    assert differing(plan, binning.plan_tiers_torch(
        moved, gh, gw, rcfg)) == ZERO
