"""Per-tile front-to-back alpha blend over depth-sorted intersections.

Input layout (`render.pipeline.sort_pack` builds it): `feat` (10, S) float32,
row f holding feature f of every intersection in (tile, depth) order:
  rows [mx, my, conic A, B, C, opacity, r, g, b, tile id]
and `tile_starts` (T+1,) int32, tile t owning columns
[tile_starts[t], tile_starts[t+1]). Outputs, per tile of P = tile_h*tile_w
pixels in row-major order: rgb (T, 3, P), final_t (T, P) and n_contrib
(T, P) int32, the reference's `_blend` outputs (gsrast_tpu
`render/pallas_pipeline.py`) without the TPU's row padding.

The tiles are the whole grid, or (the tile-sharded path, `parallel/`) a
device's `num_tiles` local tiles, whole rows of `grid_w`: local tile t covers
the pixels of global tile row `tile_map[0] + (t // grid_w) * tile_map[1]`,
column `t % grid_w`, the reference's `num_tiles`/`tile_map`
(`pallas_blend.py:201-206`). `tile_starts`, `tile_order` and row 9 of `feat`
index the local tiles; only the pixels' origin moves.

Blend semantics (the reference's):
  power = -1/2 (A dx^2 + C dy^2) - B dx dy        (dx = mean - pixel)
  alpha = min(ALPHA_MAX, opacity e^power); skipped (alpha = 0) when
          power > 0 or alpha < ALPHA_MIN
  include_i = T_i (1 - alpha_i) >= TRANSMITTANCE_MIN, monotone along i
  rgb = sum of c alpha T over included positions; final_t = the last
  included T (1 - alpha), 1 when none; n_contrib = the number of included
  positions, skipped ones counted.

Backward (the reference's `_backward_kernel`, `pallas_blend.py:350`): with
u = d_rgb . c and w = alpha T per (pixel, position), and T replayed back to
front from the saved final_t, every position that blended (`applied`: not
skipped and before n_contrib) gets
  d alpha = T u - (sum of u w over later positions + final_t d_final_t)
            / (1 - alpha),  0 where opacity e^power >= ALPHA_MAX
  d power = d alpha * opacity e^power
and the 9 gradient rows sum over the tile's pixels:
  d mx = -(A Sx + B Sy), d my = -(C Sy + B Sx)   (Sx = sum dpower dx, ...)
  d A = -1/2 sum dpower dx^2, d B = -sum dpower dx dy, d C = -1/2 sum dpower dy^2
  d opacity = sum d alpha e^power, d rgb = sum w d_rgb.
Row 9 (tile id) and every column outside the tiles' segments stay 0: the
sort-pack gather's backward adds every column into a real Gaussian.

Each direction has two versions: the hand-written kernels of
`csrc/blend_forward.cu` and `csrc/blend_backward.cu` (`*_cuda`, CUDA tensors
only; their blocks take the tiles in the order `tile_order_cuda` gives, from
`csrc/tile_order.cu`), and the plain closed-form versions (`*_torch`:
cumulative products and sums along each tile's segment) that the CPU runs
and that the kernels are checked against. `BlendFunction` pairs the forward
with its backward for autograd.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from .. import _kernels
from .. import config as cfg

FEATURE_ROWS = 10
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_TID = range(FEATURE_ROWS)

# The kernels' block and pixel map (csrc/blend_common.cuh): k pixels a
# thread on P / 32k warps, each warp an 8 x 4k patch of k sub-patches of
# 4 x 8 pixels. The backward sums each position over a warp's lanes once for
# all of its pixels, so it takes more pixels a thread.
PIXELS_PER_THREAD = {"forward": 2, "backward": 4}
TILE_PIXELS = (256, 512, 1024, 2048)
# `tile_order`'s buckets (csrc/tile_order.cu).
ORDER_BUCKETS = 256
ORDER_BUCKET_POSITIONS = 32

# Elements of one (tiles, positions, pixels) intermediate of the plain
# version: 2^24 float32 is 64 MiB, and about a dozen are live at once, so a
# chunk stays under 1 GiB.
PLAIN_CHUNK_ELEMENTS = 1 << 24

BlendOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
WHOLE_GRID = (0, 1)  # tile_map of the whole grid: row0 0, row step 1


class Footprint(NamedTuple):
    """A blend kernel's block and its map from threads to pixels: warp w
    owns the 8 x 4k patch at (w // wx, w % wx) of the grid of patches that
    tiles the tile; lane l's pixel i is (l // 8, l % 8) of the patch's
    4 x 8 sub-patch i, sub-patches row-major, k // 2 across."""
    k: int      # pixels a thread
    warps: int  # warps a block
    wx: int     # patches across the tile


def kernel_footprint(kernel: str, tile_h: int, tile_w: int) -> Footprint:
    """The footprint the 'forward' or 'backward' kernel launches with on a
    tile. The kernels take tiles of 256 to 2048 pixels whose height is a
    multiple of 8 and width a multiple of 4k; others raise."""
    k = PIXELS_PER_THREAD[kernel]
    p = tile_h * tile_w
    if p not in TILE_PIXELS or tile_h % 8 or tile_w % (4 * k):
        raise ValueError(
            f"the blend {kernel} kernel takes tiles of {TILE_PIXELS} pixels "
            f"whose height is a multiple of 8 and width a multiple of "
            f"{4 * k}, got {tile_h}x{tile_w}")
    return Footprint(k, p // (32 * k), tile_w // (4 * k))


def footprint_pixels(fp: Footprint, tile_w: int) -> torch.Tensor:
    """(warps, k, 32) int64: the tile pixel (row-major) of warp w's pixel i
    at lane l; `footprint_pixel` of csrc/blend_common.cuh."""
    w = torch.arange(fp.warps)[:, None, None]
    i = torch.arange(fp.k)[None, :, None]
    lane = torch.arange(32)
    across = fp.k // 2
    y = (w // fp.wx) * 8 + (i // across) * 4 + lane // 8
    x = (w % fp.wx) * 4 * fp.k + (i % across) * 8 + lane % 8
    return y * tile_w + x


def tile_order(tile_starts: torch.Tensor) -> torch.Tensor:
    """(T,) int32: the tiles by segment length, longest first, in buckets of
    ORDER_BUCKET_POSITIONS positions (the last of ORDER_BUCKETS buckets takes
    every longer segment), ties in tile order. The plain version of
    `tile_order_cuda`, whose kernel leaves the tiles of one bucket in no
    fixed order."""
    lengths = tile_starts[1:] - tile_starts[:-1]
    bucket = torch.clamp(lengths // ORDER_BUCKET_POSITIONS,
                         max=ORDER_BUCKETS - 1)
    return torch.sort(bucket, descending=True, stable=True).indices.to(
        torch.int32)


def tile_order_cuda(tile_starts: torch.Tensor) -> torch.Tensor:
    """The order in which the blend kernels' blocks take the tiles, by the
    hand-written kernel (`csrc/tile_order.cu`) on a CUDA tensor: (T,) int32,
    longest segment first (`tile_order`). Runs on the current stream
    without synchronising."""
    if tile_starts.device.type != "cuda" or tile_starts.dtype != (
            torch.int32) or tile_starts.dim() != 1:
        raise ValueError(f"tile_order_cuda needs (T+1,) int32 CUDA "
                         f"tile_starts, got {tuple(tile_starts.shape)} "
                         f"{tile_starts.dtype} on {tile_starts.device}")
    num_tiles = tile_starts.shape[0] - 1
    order = torch.empty((num_tiles,), dtype=torch.int32,
                        device=tile_starts.device)
    if num_tiles == 0:
        return order
    tile_starts = tile_starts.contiguous()
    fn = _kernels.load().lib.gsrast_tile_order
    with torch.cuda.device(tile_starts.device):
        stream = torch.cuda.current_stream(tile_starts.device).cuda_stream
        code = fn(tile_starts.data_ptr(), num_tiles, order.data_ptr(), stream)
    _kernels.launch_counts["tile_order"] += 1
    if code != 0:
        raise RuntimeError(f"tile_order kernel launch failed: CUDA error "
                           f"{code}")
    return order


def _launch_order(order, tile_starts: torch.Tensor,
                  num_tiles: int) -> torch.Tensor:
    """`order` checked as the kernels' launch order, or `tile_order_cuda`'s
    where it is None."""
    if order is None:
        return tile_order_cuda(tile_starts)
    if order.dtype != torch.int32 or tuple(order.shape) != (num_tiles,) or (
            order.device != tile_starts.device):
        raise ValueError(f"order must be ({num_tiles},) int32 on "
                         f"{tile_starts.device}, got {tuple(order.shape)} "
                         f"{order.dtype} on {order.device}")
    return order.contiguous()


def _check_inputs(feat: torch.Tensor, tile_starts: torch.Tensor,
                  num_tiles: int) -> None:
    if feat.dtype != torch.float32 or feat.dim() != 2 or (
            feat.shape[0] != FEATURE_ROWS):
        raise ValueError(f"feat must be ({FEATURE_ROWS}, S) float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (
            num_tiles + 1,):
        raise ValueError(f"tile_starts must be ({num_tiles + 1},) int32, got "
                         f"{tuple(tile_starts.shape)} {tile_starts.dtype}")
    if tile_starts.device != feat.device:
        raise ValueError("feat and tile_starts must share a device")


def local_tiles(grid_h: int, grid_w: int, num_tiles, tile_map) -> tuple:
    """(num_tiles, row0, tile_row_step) checked: num_tiles (the whole grid
    where None) whole rows of grid_w tiles, row0 >= 0 and a row step >= 1.
    A local row past grid_h is allowed: its tiles lie outside the image,
    their segments are empty, and reassembly drops them."""
    num_tiles = grid_h * grid_w if num_tiles is None else int(num_tiles)
    row0, step = (int(v) for v in tile_map)
    if num_tiles < 0 or num_tiles % grid_w or row0 < 0 or step < 1:
        raise ValueError(
            f"local tiles must be whole rows of grid_w={grid_w} tiles with "
            f"tile_map (row0 >= 0, row step >= 1), got num_tiles={num_tiles}"
            f", tile_map={tuple(tile_map)}")
    return num_tiles, row0, step


def _pixel_origins(t0: int, t1: int, grid_w: int, tile_h: int, tile_w: int,
                   row0: int, step: int, device) -> tuple:
    """(x, y) pixel origins, each (t1 - t0, 1), of local tiles [t0, t1)."""
    tids = torch.arange(t0, t1, device=device)
    ox = (tids % grid_w) * tile_w
    oy = (row0 + (tids // grid_w) * step) * tile_h
    return ox[:, None], oy[:, None]


def _check_pixel_inputs(num_tiles: int, p: int, **tensors) -> None:
    """Per-pixel inputs of the backward: d_rgb (T, 3, P) float32; d_final_t
    and final_t (T, P) float32; n_contrib (T, P) int32."""
    for name, x in tensors.items():
        shape = (num_tiles, 3, p) if name == "d_rgb" else (num_tiles, p)
        dtype = torch.int32 if name == "n_contrib" else torch.float32
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")


def _dispatch(backend: str, device: torch.device, cuda_fn, torch_fn):
    """backend 'cuda' launches the kernel and needs CUDA tensors; backend
    'torch' runs the plain version on tensors of any device, as the
    caller's explicit choice. 'cuda' on other tensors raises: nothing falls
    back."""
    if backend == "cuda" and device.type == "cuda":
        return cuda_fn
    if backend == "torch":
        return torch_fn
    raise ValueError(
        f"blend backend {backend!r} cannot run on {device} tensors: 'cuda' "
        "needs CUDA tensors ('torch' runs the plain version anywhere)")


def blend_forward(feat: torch.Tensor, tile_starts: torch.Tensor, grid_h: int,
                  grid_w: int, tile_h: int, tile_w: int, backend: str = "cuda",
                  order=None, num_tiles=None,
                  tile_map=WHOLE_GRID) -> BlendOut:
    """Blend every tile with the kernel or the plain version (`_dispatch`);
    `order` is the kernel's launch order (`blend_forward_cuda`);
    `num_tiles`/`tile_map`: the local tiles (module docstring)."""
    fn = _dispatch(backend, feat.device,
                   functools.partial(blend_forward_cuda, order=order),
                   blend_forward_torch)
    return fn(feat, tile_starts, grid_h, grid_w, tile_h, tile_w,
              num_tiles=num_tiles, tile_map=tile_map)


def blend_backward(feat: torch.Tensor, tile_starts: torch.Tensor,
                   d_rgb: torch.Tensor, d_final_t: torch.Tensor,
                   final_t: torch.Tensor, n_contrib: torch.Tensor,
                   grid_h: int, grid_w: int, tile_h: int, tile_w: int,
                   backend: str = "cuda", order=None, num_tiles=None,
                   tile_map=WHOLE_GRID) -> torch.Tensor:
    """d_feat (10, S) with the kernel or the plain version (`_dispatch`);
    `order` is the kernel's launch order (`blend_backward_cuda`);
    `num_tiles`/`tile_map`: the local tiles (module docstring)."""
    fn = _dispatch(backend, feat.device,
                   functools.partial(blend_backward_cuda, order=order),
                   blend_backward_torch)
    return fn(feat, tile_starts, d_rgb, d_final_t, final_t, n_contrib,
              grid_h, grid_w, tile_h, tile_w, num_tiles=num_tiles,
              tile_map=tile_map)


class BlendFunction(torch.autograd.Function):
    """The blend as an autograd node: (feat, tile_starts, grid_h, grid_w,
    tile_h, tile_w, backend[, num_tiles, tile_map]) -> (rgb, final_t,
    n_contrib), on the whole grid or on local tiles. The backward
    runs the same backend's backward on the saved final_t and n_contrib, so
    its gate is the forward's; n_contrib is not differentiable. Autograd
    hands an output the loss does not use a zero cotangent (materialized
    grads, the default). On the kernels, the tiles' launch order is made
    once and serves both directions."""

    @staticmethod
    def forward(ctx, feat, tile_starts, grid_h, grid_w, tile_h, tile_w,
                backend, num_tiles=None, tile_map=WHOLE_GRID):
        order = None
        if backend == "cuda" and tile_starts.device.type == "cuda":
            order = tile_order_cuda(tile_starts)
        local = dict(num_tiles=num_tiles, tile_map=tile_map)
        rgb, final_t, n_contrib = blend_forward(
            feat, tile_starts, grid_h, grid_w, tile_h, tile_w, backend, order,
            **local)
        ctx.save_for_backward(feat, tile_starts, final_t, n_contrib)
        ctx.mark_non_differentiable(n_contrib)
        ctx.geometry = (grid_h, grid_w, tile_h, tile_w, backend)
        ctx.order = order
        ctx.local = local
        return rgb, final_t, n_contrib

    @staticmethod
    def backward(ctx, d_rgb, d_final_t, _d_n_contrib):
        feat, tile_starts, final_t, n_contrib = ctx.saved_tensors
        d_feat = blend_backward(feat, tile_starts, d_rgb, d_final_t, final_t,
                                n_contrib, *ctx.geometry, order=ctx.order,
                                **ctx.local)
        return d_feat, None, None, None, None, None, None, None, None


def blend_forward_cuda(feat: torch.Tensor, tile_starts: torch.Tensor,
                       grid_h: int, grid_w: int, tile_h: int, tile_w: int,
                       order=None, num_tiles=None,
                       tile_map=WHOLE_GRID) -> BlendOut:
    """The hand-written kernel (`csrc/blend_forward.cu`) on CUDA tensors,
    its blocks taking the tiles in `order` ((T,) int32; `tile_order_cuda`
    where None), which changes no output; `num_tiles`/`tile_map`: the local
    tiles (module docstring). Runs on the current stream without
    synchronising."""
    num_tiles, row0, step = local_tiles(grid_h, grid_w, num_tiles, tile_map)
    p = tile_h * tile_w
    _check_inputs(feat, tile_starts, num_tiles)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_forward_cuda needs CUDA tensors, got "
                         f"{feat.device}")
    if feat.shape[1] >= 2**31:
        raise ValueError(
            f"{feat.shape[1]} intersections exceed int32 indexing")
    kernel_footprint("forward", tile_h, tile_w)  # raises for other tiles
    feat = feat.contiguous()
    tile_starts = tile_starts.contiguous()
    order = _launch_order(order, tile_starts, num_tiles)
    dev = feat.device
    rgb = torch.empty((num_tiles, 3, p), dtype=torch.float32, device=dev)
    final_t = torch.empty((num_tiles, p), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((num_tiles, p), dtype=torch.int32, device=dev)
    fn = _kernels.load().lib.gsrast_blend_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(feat.data_ptr(), feat.shape[1], tile_starts.data_ptr(),
                  order.data_ptr(), num_tiles, grid_w, row0, step, tile_h,
                  tile_w, cfg.ALPHA_MIN, cfg.ALPHA_MAX, cfg.TRANSMITTANCE_MIN,
                  rgb.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
                  stream)
    _kernels.launch_counts["blend_forward"] += 1
    if code != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: CUDA error "
                           f"{code}")
    return rgb, final_t, n_contrib


def _tile_chunks(counts, p: int,
                 budget: int) -> Iterator[Tuple[int, int, int]]:
    """Runs [t0, t1) of consecutive tiles whose (tiles x longest segment x P)
    padded block fits `budget` elements, with that longest segment."""
    t0, num = 0, len(counts)
    while t0 < num:
        kmax, t1 = counts[t0], t0 + 1
        while t1 < num:
            k = max(kmax, counts[t1])
            if (t1 - t0 + 1) * max(k, 1) * p > budget:
                break
            kmax, t1 = k, t1 + 1
        yield t0, t1, kmax
        t0 = t1


def blend_forward_torch(feat: torch.Tensor, tile_starts: torch.Tensor,
                        grid_h: int, grid_w: int, tile_h: int, tile_w: int,
                        budget: int = PLAIN_CHUNK_ELEMENTS, num_tiles=None,
                        tile_map=WHOLE_GRID) -> BlendOut:
    """The plain version, on any device. Tiles run in chunks padded to the
    chunk's longest true segment (no cap on segment length); a segment
    longer than the budget allows is walked in blocks of positions with the
    transmittance carried between blocks. `num_tiles`/`tile_map`: the local
    tiles (module docstring)."""
    num_tiles, row0, step = local_tiles(grid_h, grid_w, num_tiles, tile_map)
    p = tile_h * tile_w
    _check_inputs(feat, tile_starts, num_tiles)
    dev = feat.device
    s = feat.shape[1]
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    counts = (ends - starts).tolist()
    pix = torch.arange(p, device=dev)
    pcol, prow = pix % tile_w, pix // tile_w

    rgb = torch.zeros((num_tiles, 3, p), dtype=torch.float32, device=dev)
    final_t = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((num_tiles, p), dtype=torch.int32, device=dev)
    for t0, t1, kmax in _tile_chunks(counts, p, budget):
        if kmax == 0:
            continue
        nt = t1 - t0
        ox, oy = _pixel_origins(t0, t1, grid_w, tile_h, tile_w, row0, step,
                                dev)
        px, py = ox + pcol, oy + prow
        px, py = px[:, None, :].float(), py[:, None, :].float()  # (nt, 1, P)
        kb = max(1, min(kmax, budget // (nt * p)))
        trans = torch.ones((nt, 1, p), dtype=torch.float32, device=dev)
        acc = [torch.zeros((nt, p), dtype=torch.float32, device=dev)
               for _ in range(3)]
        ft = torch.ones((nt, p), dtype=torch.float32, device=dev)
        nc = torch.zeros((nt, p), dtype=torch.int32, device=dev)
        for k0 in range(0, kmax, kb):
            take = starts[t0:t1, None] + k0 + torch.arange(kb, device=dev)
            in_range = (take < ends[t0:t1, None])[..., None]  # (nt, kb, 1)
            f = feat[:, take.clamp(max=s - 1)][..., None]  # (10, nt, kb, 1)
            dx = f[F_MX] - px
            dy = f[F_MY] - py
            power = (-0.5 * (f[F_CA] * (dx * dx) + f[F_CC] * (dy * dy))
                     - f[F_CB] * (dx * dy))
            alpha = torch.clamp(f[F_OP] * torch.exp(power),
                                max=cfg.ALPHA_MAX)
            ok = in_range & (power <= 0.0) & (alpha >= cfg.ALPHA_MIN)
            a = torch.where(ok, alpha, 0.0)
            cum = torch.cumprod(1.0 - a, dim=1)  # (nt, kb, P)
            test = trans * cum
            t_before = trans * torch.cat([torch.ones_like(cum[:, :1]),
                                          cum[:, :-1]], dim=1)
            include = (test >= cfg.TRANSMITTANCE_MIN) & in_range
            w = torch.where(include, a * t_before, 0.0)
            for c in range(3):
                acc[c] = acc[c] + torch.sum(w * f[F_R + c], dim=1)
            ft = torch.minimum(
                ft, torch.amin(torch.where(include, test, 2.0), dim=1))
            nc = nc + torch.sum(include, dim=1, dtype=torch.int32)
            trans = trans * cum[:, -1:]
        rgb[t0:t1] = torch.stack(acc, dim=1)
        final_t[t0:t1] = ft
        n_contrib[t0:t1] = nc
    return rgb, final_t, n_contrib


def blend_backward_cuda(feat: torch.Tensor, tile_starts: torch.Tensor,
                        d_rgb: torch.Tensor, d_final_t: torch.Tensor,
                        final_t: torch.Tensor, n_contrib: torch.Tensor,
                        grid_h: int, grid_w: int, tile_h: int, tile_w: int,
                        order=None, num_tiles=None,
                        tile_map=WHOLE_GRID) -> torch.Tensor:
    """The hand-written kernel (`csrc/blend_backward.cu`) on CUDA tensors:
    d_feat (10, S), zero outside the applied positions, every element
    written by the kernel, its blocks taking the tiles in `order` as in
    `blend_forward_cuda`, on the local tiles `num_tiles`/`tile_map`. Runs
    on the current stream without synchronising; its sums run in a fixed
    order, so two launches on the same inputs give identical bits, whatever
    the order."""
    num_tiles, row0, step = local_tiles(grid_h, grid_w, num_tiles, tile_map)
    p = tile_h * tile_w
    _check_inputs(feat, tile_starts, num_tiles)
    _check_pixel_inputs(num_tiles, p, d_rgb=d_rgb, d_final_t=d_final_t,
                        final_t=final_t, n_contrib=n_contrib)
    tensors = (feat, tile_starts, d_rgb, d_final_t, final_t, n_contrib)
    if any(x.device != feat.device for x in tensors) or (
            feat.device.type != "cuda"):
        raise ValueError("blend_backward_cuda needs all inputs on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    if feat.shape[1] >= 2**31:
        raise ValueError(
            f"{feat.shape[1]} intersections exceed int32 indexing")
    kernel_footprint("backward", tile_h, tile_w)  # raises for other tiles
    feat, tile_starts, d_rgb, d_final_t, final_t, n_contrib = (
        x.contiguous() for x in tensors)
    order = _launch_order(order, tile_starts, num_tiles)
    d_feat = torch.empty_like(feat)
    fn = _kernels.load().lib.gsrast_blend_backward
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        code = fn(feat.data_ptr(), feat.shape[1], tile_starts.data_ptr(),
                  order.data_ptr(), num_tiles, grid_w, row0, step, tile_h,
                  tile_w, cfg.ALPHA_MIN, cfg.ALPHA_MAX, d_rgb.data_ptr(),
                  d_final_t.data_ptr(), final_t.data_ptr(),
                  n_contrib.data_ptr(), d_feat.data_ptr(), stream)
    _kernels.launch_counts["blend_backward"] += 1
    if code != 0:
        raise RuntimeError(f"blend_backward kernel launch failed: CUDA error "
                           f"{code}")
    return d_feat


def blend_backward_torch(feat: torch.Tensor, tile_starts: torch.Tensor,
                         d_rgb: torch.Tensor, d_final_t: torch.Tensor,
                         final_t: torch.Tensor, n_contrib: torch.Tensor,
                         grid_h: int, grid_w: int, tile_h: int, tile_w: int,
                         budget: int = PLAIN_CHUNK_ELEMENTS, num_tiles=None,
                         tile_map=WHOLE_GRID) -> torch.Tensor:
    """The plain backward, on any device: d_feat (10, S). Tiles run in
    chunks as in `blend_forward_torch`, over each segment's first
    max(n_contrib) positions only (later ones carry no gradient); a segment
    longer than the budget allows is walked in blocks of positions, newest
    block first, with T and the suffix sum of u w carried between blocks.
    `num_tiles`/`tile_map`: the local tiles (module docstring)."""
    num_tiles, row0, step = local_tiles(grid_h, grid_w, num_tiles, tile_map)
    p = tile_h * tile_w
    _check_inputs(feat, tile_starts, num_tiles)
    _check_pixel_inputs(num_tiles, p, d_rgb=d_rgb, d_final_t=d_final_t,
                        final_t=final_t, n_contrib=n_contrib)
    dev = feat.device
    s = feat.shape[1]
    starts = tile_starts[:-1].long()
    live = torch.minimum(tile_starts[1:] - tile_starts[:-1],
                         n_contrib.amax(dim=1)).long()
    counts = live.tolist()
    ends = starts + live
    pix = torch.arange(p, device=dev)
    pcol, prow = pix % tile_w, pix // tile_w

    d_feat = torch.zeros((FEATURE_ROWS, s), dtype=torch.float32, device=dev)
    for t0, t1, kmax in _tile_chunks(counts, p, budget):
        if kmax == 0:
            continue
        nt = t1 - t0
        ox, oy = _pixel_origins(t0, t1, grid_w, tile_h, tile_w, row0, step,
                                dev)
        px, py = ox + pcol, oy + prow
        px, py = px[:, None, :].float(), py[:, None, :].float()  # (nt, 1, P)
        kb = max(1, min(kmax, budget // (nt * p)))
        nc = n_contrib[t0:t1, None, :]
        dc = d_rgb[t0:t1, :, None, :]  # (nt, 3, 1, P)
        ft_dft = (final_t[t0:t1] * d_final_t[t0:t1])[:, None, :]
        t_after = final_t[t0:t1, None, :]  # T after the block, (nt, 1, P)
        q = torch.zeros((nt, 1, p), dtype=torch.float32, device=dev)
        for k0 in reversed(range(0, kmax, kb)):
            pos = k0 + torch.arange(kb, device=dev)
            take = starts[t0:t1, None] + pos  # (nt, kb)
            in_range = take < ends[t0:t1, None]
            f = feat[:, take.clamp(max=s - 1)][..., None]  # (10, nt, kb, 1)
            dx = f[F_MX] - px
            dy = f[F_MY] - py
            power = (-0.5 * (f[F_CA] * (dx * dx) + f[F_CC] * (dy * dy))
                     - f[F_CB] * (dx * dy))
            gauss = torch.exp(power)
            og = f[F_OP] * gauss
            alpha = torch.clamp(og, max=cfg.ALPHA_MAX)
            applied = (in_range[..., None] & (power <= 0.0)
                       & (alpha >= cfg.ALPHA_MIN) & (pos[:, None] < nc))
            a = torch.where(applied, alpha, 0.0)
            om = 1.0 - a
            cum = torch.cumprod(om, dim=1)  # (nt, kb, P)
            t_start = t_after / cum[:, -1:]
            t_g = t_start * torch.cat([torch.ones_like(cum[:, :1]),
                                       cum[:, :-1]], dim=1)
            w = a * t_g
            u = (dc[:, 0] * f[F_R] + dc[:, 1] * f[F_G]) + dc[:, 2] * f[F_B]
            uw = u * w
            later = torch.cumsum(uw.flip(1), dim=1).flip(1)  # inclusive
            later = torch.cat([later[:, 1:], torch.zeros_like(later[:, :1])],
                              dim=1)
            dalpha = t_g * u - (later + q + ft_dft) / om
            grads = applied & (og < cfg.ALPHA_MAX)
            dpower = torch.where(grads, dalpha * og, 0.0)
            dpx, dpy = dpower * dx, dpower * dy
            sx, sy = dpx.sum(2), dpy.sum(2)  # (nt, kb)
            ca, cb, cc = f[F_CA, ..., 0], f[F_CB, ..., 0], f[F_CC, ..., 0]
            rows = torch.stack([
                -(ca * sx + cb * sy),
                -(cc * sy + cb * sx),
                -0.5 * (dpx * dx).sum(2),
                -(dpx * dy).sum(2),
                -0.5 * (dpy * dy).sum(2),
                torch.where(grads, dalpha * gauss, 0.0).sum(2),
                *((w * dc[:, c]).sum(2) for c in range(3)),
            ])  # (9, nt, kb)
            d_feat[:F_TID, take[in_range]] = rows[:, in_range]
            q = q + uw.sum(1, keepdim=True)
            t_after = t_start
    return d_feat
