"""Image assembly from per-tile blend outputs, the render result, and the
'autograd' backend: the reference's capped closed-form oracle.

The oracle is the reference's `render_tiled_xla` (`gsrast_tpu/render/
tiled.py`) in plain PyTorch: preprocess, the tile plan (the legacy
`build_binning` for `tiers=()`, else `plan_tiers` and one stable (tile,
depth) sort), then per chunk of `tile_chunk` tiles the first `max_per_tile`
positions of every tile blended in closed form: a cumulative product of
1 - alpha along the positions gives the transmittance, `include = T >=
TRANSMITTANCE_MIN`, n_contrib the count of positions before saturation.
Autograd differentiates it, so it is the gradient oracle the hand-derived
blend backward is held against. Positions past the cap are dropped and
counted in `overflow_per_tile`; the other backends walk true ranges.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import config as cfg
from ..camera import Camera, no_tf32
from ..ops import binning as binning_ops
from ..ops.preprocess import Preprocessed, preprocess
from ..scene.gaussians import ActivatedGaussians


class RenderOutput(NamedTuple):
    image: torch.Tensor      # (H, W, 3)
    final_t: torch.Tensor    # (H, W) residual transmittance
    n_contrib: torch.Tensor  # (H, W) int32 positions blended before saturation
    stats: dict


def background_rgb(render_cfg: cfg.RenderConfig, device) -> torch.Tensor:
    """(3,) float32 `render_cfg.background` on `device`, written there by
    fill kernels rather than copied from host memory, which a CUDA graph
    capture forbids (`benchmark.StepChain`); the same float32 values."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device)
                        for v in render_cfg.background])


def untile(tiles: torch.Tensor, grid_h: int, grid_w: int,
           render_cfg: cfg.RenderConfig, height: int,
           width: int) -> torch.Tensor:
    """(T, P, ...) tile-major -> (height, width, ...) image, cropped."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    trailing = tuple(tiles.shape[2:])
    img = tiles.reshape((grid_h, grid_w, th, tw) + trailing)
    img = img.transpose(1, 2)  # (gh, th, gw, tw, ...)
    img = img.reshape((grid_h * th, grid_w * tw) + trailing)
    return img[:height, :width]


def untile_cf(tiles: torch.Tensor, grid_h: int, grid_w: int,
              render_cfg: cfg.RenderConfig, height: int,
              width: int) -> torch.Tensor:
    """(T, ch, P) channel-first tiles -> (ch, height, width)."""
    th, tw = render_cfg.tile_h, render_cfg.tile_w
    ch = tiles.shape[1]
    img = tiles.reshape(grid_h, grid_w, ch, th, tw).permute(2, 0, 3, 1, 4)
    img = img.reshape(ch, grid_h * th, grid_w * tw)
    return img[:, :height, :width]


def tile_pixel_coords(render_cfg: cfg.RenderConfig,
                      device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-tile pixel offsets (x, y), each (P,) float32, row-major."""
    pix = torch.arange(render_cfg.tile_h * render_cfg.tile_w, device=device)
    return ((pix % render_cfg.tile_w).to(torch.float32),
            (pix // render_cfg.tile_w).to(torch.float32))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 by `index_select` on the flat indices, whose
    backward is an index-add (`x[idx]` differentiates into `index_put_`,
    a sort of the indices; `render/pipeline.py`)."""
    return x.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(x.shape[1:]))


def blend_sorted_xla(s_mean2d: torch.Tensor, s_conic: torch.Tensor,
                     s_color: torch.Tensor, s_opacity: torch.Tensor,
                     tile_starts: torch.Tensor, grid_h: int, grid_w: int,
                     render_cfg: cfg.RenderConfig,
                     num_local_rows: int | None = None, row0: int = 0,
                     row_stride: int = 1) -> tuple:
    """The oracle's blend over per-intersection features in (tile, depth)
    order: s_mean2d (C, 2), s_conic (C, 3), s_color (C, 3), s_opacity (C,)
    (0 on dead slots), tile_starts (T+1,). Returns (tiles_rgb (T, P, 3)
    over the background, final_t (T, P), n_contrib (T, P) int32,
    overflow_per_tile ()). Local tiles (the tile-sharded path): local tile
    t lies at global tile row row0 + (t // grid_w) row_stride."""
    num_tiles = (grid_h if num_local_rows is None else num_local_rows) * grid_w
    k_tile, tile_chunk = render_cfg.max_per_tile, render_cfg.tile_chunk
    dev = s_opacity.device
    background = background_rgb(render_cfg, dev)
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    overflow = torch.clamp(ends - starts - k_tile, min=0).sum()
    px_off, py_off = tile_pixel_coords(render_cfg, dev)
    capacity = s_opacity.shape[0]
    ks = torch.arange(k_tile, device=dev)
    rgbs, fts, ncs = [], [], []
    for t0 in range(0, num_tiles, tile_chunk):
        tids = torch.arange(t0, min(t0 + tile_chunk, num_tiles), device=dev)
        ty = row0 + (tids // grid_w) * row_stride
        tx = tids % grid_w
        pix_x = (tx[:, None] * render_cfg.tile_w) + px_off[None, :]  # (TC, P)
        pix_y = (ty[:, None] * render_cfg.tile_h) + py_off[None, :]
        take = starts[tids][:, None] + ks[None, :]  # (TC, K)
        in_range = take < ends[tids][:, None]
        take_c = torch.clamp(take, max=capacity - 1)
        mean2d = _rows(s_mean2d, take_c)  # (TC, K, 2)
        conic = _rows(s_conic, take_c)
        color = _rows(s_color, take_c)
        opacity = torch.where(in_range, _rows(s_opacity, take_c), 0.0)

        dx = mean2d[..., 0:1] - pix_x[:, None, :]  # (TC, K, P)
        dy = mean2d[..., 1:2] - pix_y[:, None, :]
        ca, cb, cc = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
        # Rounded as the blend kernels and the reference's Pallas kernel
        # round it (`pallas_blend.py:172`), so that the ALPHA_MIN threshold
        # sees their alpha: the reference's oracle writes ca * dx * dx,
        # an ulp away, which at 1080p flips the threshold at some pairs.
        power = (-0.5 * (ca * (dx * dx) + cc * (dy * dy))
                 - cb * (dx * dy))
        alpha = torch.clamp(opacity[..., None] * torch.exp(power),
                            max=cfg.ALPHA_MAX)
        valid = (in_range[..., None] & (power <= 0.0)
                 & (alpha >= cfg.ALPHA_MIN))
        alpha_eff = torch.where(valid, alpha, 0.0)
        p_cum = torch.cumprod(1.0 - alpha_eff, dim=1)  # along K
        t_before = torch.cat([torch.ones_like(p_cum[:, :1]), p_cum[:, :-1]],
                             dim=1)
        include = p_cum >= cfg.TRANSMITTANCE_MIN
        w = torch.where(include & valid, alpha_eff * t_before, 0.0)
        with no_tf32():  # the reference pins this sum to HIGHEST precision
            rgb = torch.einsum("tkp,tkc->tpc", w, color)
        final_t = torch.clamp(torch.amin(
            torch.where(include, p_cum, torch.inf), dim=1), max=1.0)
        rgbs.append(rgb + final_t[..., None] * background)
        fts.append(final_t)
        # The positions before saturation within the real segment.
        ncs.append(torch.sum(include & in_range[..., None], dim=1,
                             dtype=torch.int32))
    return torch.cat(rgbs), torch.cat(fts), torch.cat(ncs), overflow


def gather_sorted(x: torch.Tensor, sorted_gauss: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """The N slices of x along `dim` in a binning's sorted order: C slices,
    zero at dead slots (sorted_gauss < 0), by `index_select`. A dead slot
    gathers slice `slot mod N`, so that the backward's index-add spreads
    its (zero) cotangent over distinct rows instead of queueing atomics on
    one."""
    sg = sorted_gauss.long()
    live = sg >= 0
    gidx = torch.where(live, sg, torch.arange(sg.shape[0], device=sg.device)
                       % x.shape[dim])
    shape = [1] * x.dim()
    shape[dim] = -1
    return torch.where(live.reshape(shape), x.index_select(dim, gidx), 0.0)


def blend_tiles_xla(prep: Preprocessed, binning: binning_ops.Binning,
                    grid_h: int, grid_w: int, render_cfg: cfg.RenderConfig,
                    num_local_rows: int | None = None, row0: int = 0,
                    row_stride: int = 1) -> tuple:
    """`blend_sorted_xla` on the features of `prep` gathered in the
    binning's order (`gather_sorted`)."""
    def gather(x):
        return gather_sorted(x, binning.sorted_gauss)

    return blend_sorted_xla(gather(prep.mean2d), gather(prep.conic),
                            gather(prep.color), gather(prep.opacity),
                            binning.tile_starts, grid_h, grid_w, render_cfg,
                            num_local_rows, row0, row_stride)


def render_tiled_xla(gaussians: ActivatedGaussians, camera: Camera,
                     render_cfg: cfg.RenderConfig = cfg.RenderConfig(
                         backend="autograd"),
                     mean2d_delta: torch.Tensor | None = None
                     ) -> RenderOutput:
    """The 'autograd' backend's render: the legacy binning for `tiers=()`
    (capacity `render_cfg.capacity(N)`), else the multi-tier plan in one
    stable (tile, depth) sort; then `blend_tiles_xla` and the image.
    Stats: num_visible, num_intersections, overflow_capacity,
    overflow_tile_cap, overflow_per_tile, radii."""
    grid_h, grid_w = render_cfg.grid_shape(camera.height, camera.width)
    prep = preprocess(gaussians, camera, render_cfg, mean2d_delta)
    if render_cfg.tiers:
        binning = binning_ops.binning_from_plan(binning_ops.plan_tiers(
            prep.detach(), grid_h, grid_w, render_cfg), grid_h * grid_w)
    else:
        binning = binning_ops.build_binning(
            prep.detach(), grid_h, grid_w, render_cfg,
            render_cfg.capacity(gaussians.means.shape[0]))
    tiles_rgb, final_t, n_contrib, overflow = blend_tiles_xla(
        prep, binning, grid_h, grid_w, render_cfg)
    size = (grid_h, grid_w, render_cfg, camera.height, camera.width)
    stats = {
        "num_visible": torch.sum(prep.radius > 0),
        "num_intersections": binning.num_intersections,
        "overflow_capacity": binning.overflow_capacity,
        "overflow_tile_cap": binning.overflow_tile_cap,
        "overflow_per_tile": overflow,
        "radii": prep.radius,
    }
    return RenderOutput(image=untile(tiles_rgb, *size),
                        final_t=untile(final_t, *size),
                        n_contrib=untile(n_contrib, *size), stats=stats)
