"""Analytic-ellipsoid ray-trace debug renderer.

Each Gaussian is an opaque ellipsoid at 2x scale, hit by each pixel's ray
through an exact quadratic solve, culled below opacity 0.3 and z-tested by a
minimum over Gaussians, as the reference (`gsrast_tpu/viz/ellipsoids.py`)
defines it: a pixel shows the colour of the lowest-index Gaussian at the
smallest hit distance (within one of the reference's chunks the first
minimum wins, across chunks only a strictly nearer hit replaces the kept
one).

The reference solves every (Gaussian, pixel) pair. Most pairs miss, so
here the rays are grouped in 16x16-pixel tiles and each Gaussian is solved
only on the tiles its bounding sphere (radius: the largest semi-axis) can
project to, a rectangle widened by 2 pixels, the whole image where the
sphere crosses the camera's plane, none where it lies behind. A pair
outside them cannot hit, so this changes no pixel. The solve is the reference's, term for term: the ray
(o, d) in the ellipsoid's unit-sphere frame is (oo, dd) with
oo = S^-1 R^T (o - mu) and dd = S^-1 R^T d, a = dd.dd, b = 2 oo.dd,
c = oo.oo - 1, t the nearest root beyond 1e-4. Each pixel keeps the least
(t, Gaussian index) over its pairs, taken as one 64-bit key by
`scatter_reduce` (a positive float's bits order as an integer).
"""

from __future__ import annotations

import torch

from ..camera import Camera, camera_rays, no_tf32
from ..ops.covariance import quat_to_rotmat
from ..ops.projection import to_camera
from ..scene.gaussians import ActivatedGaussians

ALPHA_CULL = 0.3  # drawn at opacity >= 0.3
SCALE_MULT = 2.0  # ellipsoid semi-axes: 2x the Gaussian's scales
T_MIN = 1e-4      # nearest root beyond this distance
TILE = 16         # rays are grouped in TILE x TILE pixel tiles
MARGIN_PX = 2.0   # pixels added on each side of a projected sphere's box
_NO_HIT = torch.iinfo(torch.int64).max
# Bytes per (Gaussian, tile) pair alive at once in a chunk: the gathered
# directions and dd (3 x 256 floats each), eight 256-float work rows, the
# 64-bit keys and pixel indices.
_PAIR_BYTES = 4 * TILE * TILE * 18


def _chunk_size(device: torch.device) -> int:
    """Pairs per chunk: 4,096 off the card, on the card as many as half the
    free memory holds."""
    if device.type != "cuda":
        return 4096
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(1, free // 2 // _PAIR_BYTES))


def _tile_span(lo_c, hi_c, z_lo, z_hi, tan_half, n: int, grid: int):
    """[first, end) tiles along one image axis whose pixel rays can pass
    through the box [lo_c, hi_c] x [z_lo, z_hi] (camera space, z_lo > 0):
    the ray of pixel i has slope ((i + 0.5) / n * 2 - 1) tan_half, and a
    slope over the box is extreme at a corner."""
    slopes = torch.stack([lo_c / z_lo, lo_c / z_hi, hi_c / z_lo,
                          hi_c / z_hi])
    to_pix = lambda s: (s / tan_half + 1.0) * 0.5 * n - 0.5  # noqa: E731
    p_lo = to_pix(slopes.amin(0)) - MARGIN_PX
    p_hi = to_pix(slopes.amax(0)) + MARGIN_PX
    # A NaN bound (a non-finite mean, which never hits) gives no tiles.
    p_lo = torch.nan_to_num(p_lo, nan=float(n)).clamp(0.0, n - 1.0)
    p_hi = torch.nan_to_num(p_hi, nan=-1.0).clamp(-1.0, n - 1.0)
    first = torch.floor(p_lo / TILE).long()
    end = torch.where(p_hi >= p_lo, torch.floor(p_hi / TILE).long() + 1,
                      first)
    return first.clamp(max=grid), end.clamp(max=grid)


def _pairs(mu_cam, radius, camera, grid_h: int, grid_w: int):
    """(Gaussian, tile) pairs, as two index vectors, of every tile a
    Gaussian's bounding sphere can project to."""
    cx, cy, cz = mu_cam.unbind(-1)
    z_lo, z_hi = cz - radius, cz + radius
    x0, x1 = _tile_span(cx - radius, cx + radius, z_lo, z_hi,
                        camera.tan_fov_x, camera.width, grid_w)
    y0, y1 = _tile_span(cy - radius, cy + radius, z_lo, z_hi,
                        camera.tan_fov_y, camera.height, grid_h)
    # A sphere across the camera's plane can project anywhere; one behind
    # it meets no ray (every pixel's ray heads into +z).
    whole = ~(z_lo > 0.0) & (z_hi > 0.0)
    x0, y0 = torch.where(whole, 0, x0), torch.where(whole, 0, y0)
    x1, y1 = torch.where(whole, grid_w, x1), torch.where(whole, grid_h, y1)
    x1 = torch.where(z_hi > 0.0, x1, x0)
    span_x = x1 - x0
    counts = span_x * (y1 - y0)
    gauss = torch.repeat_interleave(
        torch.arange(len(counts), device=counts.device), counts)
    local = (torch.arange(len(gauss), device=counts.device)
             - (torch.cumsum(counts, 0) - counts)[gauss])
    tile = ((y0[gauss] + local // span_x[gauss]) * grid_w
            + x0[gauss] + local % span_x[gauss])
    return gauss, tile


def render_ellipsoids(gaussians: ActivatedGaussians, camera: Camera,
                      background=(0.0, 0.0, 0.0),
                      pair_chunk: int | None = None) -> torch.Tensor:
    """Returns the (H, W, 3) image. `pair_chunk`: (Gaussian, tile) pairs
    solved at once (default: see `_chunk_size`); it changes memory and
    time, not the image."""
    h, w, dev = camera.height, camera.width, camera.device
    grid_h, grid_w = -(-h // TILE), -(-w // TILE)
    origin, direction = camera_rays(camera)
    o = origin[0, 0]  # every ray starts at the camera centre
    # Ray directions by tile, (tiles, 3, TILE * TILE); the padding past the
    # image's edge is dropped at the end.
    pad = torch.zeros((grid_h * TILE, grid_w * TILE, 3), device=dev)
    pad[:h, :w] = direction
    dirs = (pad.reshape(grid_h, TILE, grid_w, TILE, 3)
            .permute(0, 2, 4, 1, 3).reshape(grid_h * grid_w, 3, TILE * TILE))

    # Gaussians below the cull never hit.
    idx = ((gaussians.opacities >= ALPHA_CULL)
           & gaussians.mask).nonzero().squeeze(1)
    mu = gaussians.means[idx]
    rot_t = quat_to_rotmat(gaussians.quats[idx]).transpose(1, 2)  # R^T
    isc = 1.0 / torch.clamp(gaussians.scales[idx] * SCALE_MULT, min=1e-8)
    oo = ((rot_t * o).sum(-1) - (rot_t * mu[:, None, :]).sum(-1)) * isc
    c = (oo * oo).sum(-1) - 1.0
    # The bounding sphere, widened for the rounding of its camera-space
    # centre.
    mu_cam = to_camera(mu, camera.view)
    radius = ((1.0 / isc).amax(-1) * 1.001
              + 1e-6 * (mu_cam.abs().amax(-1) + 1.0))
    gauss, tile = _pairs(mu_cam, radius, camera, grid_h, grid_w)

    best = torch.full((grid_h * grid_w * TILE * TILE,), _NO_HIT,
                      dtype=torch.long, device=dev)
    lane = torch.arange(TILE * TILE, device=dev)
    chunk = pair_chunk or _chunk_size(dev)
    with no_tf32():
        for k0 in range(0, len(gauss), chunk):
            g, t_id = gauss[k0:k0 + chunk], tile[k0:k0 + chunk]
            dd = torch.bmm(rot_t[g], dirs[t_id]) * isc[g][:, :, None]
            a = (dd * dd).sum(1)  # (K, TILE * TILE)
            b = 2.0 * (oo[g][:, :, None] * dd).sum(1)
            del dd
            disc = b * b - 4.0 * a * c[g][:, None]
            hit = disc >= 0.0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            a2 = 2.0 * a
            del a, disc
            t0 = (-b - sq) / a2
            t1 = (-b + sq) / a2
            del b, sq, a2
            t = torch.where(t0 > T_MIN, t0, t1)
            hit &= (t > T_MIN) & (t < float("inf"))
            del t0, t1
            key = torch.where(hit, (t.view(torch.int32).long() << 32)
                              | g[:, None], _NO_HIT)
            del t, hit
            best.scatter_reduce_(0, (t_id[:, None] * TILE * TILE
                                     + lane).reshape(-1),
                                 key.reshape(-1), "amin")

    best = (best.reshape(grid_h, grid_w, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(grid_h * TILE, grid_w * TILE)[:h, :w].reshape(-1))
    # Colours of the live Gaussians, then the background for no hit.
    color = torch.cat([0.2 * gaussians.sh[idx, 0, :] + 0.5,
                       torch.tensor([background], dtype=torch.float32,
                                    device=dev)])
    winner = torch.where(best == _NO_HIT, len(idx), best & 0xFFFFFFFF)
    return torch.clamp(color[winner].reshape(h, w, 3), 0.0, 1.0)
