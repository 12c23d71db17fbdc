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
(t, Gaussian index) over its pairs, taken as one 64-bit key (a positive
float's bits order as an integer). Every 3-term product is written out,
summed left to right, so that the kernel repeats it bit for bit.

`render_ellipsoids_torch`, the plain version: `ellipsoid_terms` (the
prologue over all N Gaussians with static shapes: each one's solve terms
and span of tiles, empty where culled), the rays of `camera_rays`, then
the (Gaussian, tile) pairs solved in chunks with `scatter_reduce`.
`render_ellipsoids_cuda`: the hand-written kernel of `csrc/ellipsoids.cu`,
which computes the same prologue, rays and keys from the activated
Gaussians and the camera in its own launches, reads nothing on the host
and allocates only its output and scratch, so a CUDA graph captures it.
`render_ellipsoids` dispatches by `_kernels.uses_kernel`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from ..camera import Camera, camera_rays
from ..ops.covariance import quat_to_rotmat
from ..scene.gaussians import ActivatedGaussians
from .pointcloud import background_row

ALPHA_CULL = 0.3  # drawn at opacity >= 0.3
SCALE_MULT = 2.0  # ellipsoid semi-axes: 2x the Gaussian's scales
T_MIN = 1e-4      # nearest root beyond this distance
TILE = 16         # rays are grouped in TILE x TILE pixel tiles
MARGIN_PX = 2.0   # pixels added on each side of a projected sphere's box
TERMS = 16        # floats of a Gaussian's terms: R^T (9), 1/s (3), oo (3), c
_NO_HIT = torch.iinfo(torch.int64).max
# Bytes per (Gaussian, tile) pair alive at once in a chunk of the plain
# version: the gathered directions, three (3, 256) product rows and their
# sums, dd, eight 256-float work rows, the 64-bit keys and pixel indices.
_PAIR_BYTES = 4 * TILE * TILE * 30


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


def _dot3(x: torch.Tensor, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x.y over a dimension of size 3, summed left to right, each product
    and sum rounded alone on every device."""
    return (x.select(dim, 0) * y.select(dim, 0) + x.select(dim, 1)
            * y.select(dim, 1) + x.select(dim, 2) * y.select(dim, 2))


def _spans(mu_cam, radius, camera, grid_h: int, grid_w: int):
    """First and end tiles along x, then y, of every tile a Gaussian's
    bounding sphere can project to."""
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
    return x0, x1, y0, y1


class Terms(NamedTuple):
    """The prologue's output, one row a Gaussian."""

    terms: torch.Tensor  # (N, TERMS) float32: R^T row-major, 1/s, oo, c
    spans: torch.Tensor  # (N, 4) int32: x0, x1, y0, y1 in tiles, [x0, x1)
    color: torch.Tensor  # (N, 3) float32: 0.2 SH-DC + 0.5, not clamped


def ellipsoid_terms(gaussians: ActivatedGaussians, camera: Camera) -> Terms:
    """Each Gaussian's solve terms, its span of tiles and its colour, by
    torch ops of static shapes over all N (both versions take them). A
    Gaussian below the cull, masked out or non-finite gets an empty span."""
    grid_h, grid_w = -(-camera.height // TILE), -(-camera.width // TILE)
    o = camera.position  # every ray starts at the camera centre
    mu = gaussians.means
    rot_t = quat_to_rotmat(gaussians.quats).transpose(1, 2)  # R^T
    isc = 1.0 / torch.clamp(gaussians.scales * SCALE_MULT, min=1e-8)
    oo = (_dot3(rot_t, o) - _dot3(rot_t, mu[:, None, :])) * isc
    c = _dot3(oo, oo) - 1.0
    # The bounding sphere, widened for the rounding of its camera-space
    # centre (`to_camera`'s product written out left to right).
    mu_cam = _dot3(mu[:, None, :], camera.view[:3, :3]) + camera.view[:3, 3]
    radius = ((1.0 / isc).amax(-1) * 1.001
              + 1e-6 * (mu_cam.abs().amax(-1) + 1.0))
    x0, x1, y0, y1 = _spans(mu_cam, radius, camera, grid_h, grid_w)
    live = (gaussians.opacities >= ALPHA_CULL) & gaussians.mask
    x1 = torch.where(live, x1, x0)
    return Terms(torch.cat([rot_t.reshape(-1, 9), isc, oo, c[:, None]], 1),
                 torch.stack([x0, x1, y0, y1], 1).int(),
                 0.2 * gaussians.sh[:, 0, :] + 0.5)


def _pairs(spans: torch.Tensor, grid_w: int):
    """(Gaussian, tile) pairs, as two index vectors, of every tile in a
    Gaussian's span."""
    x0, x1, y0, y1 = spans.long().unbind(-1)
    span_x = x1 - x0
    counts = span_x * (y1 - y0)
    gauss = torch.repeat_interleave(
        torch.arange(len(counts), device=counts.device), counts)
    local = (torch.arange(len(gauss), device=counts.device)
             - (torch.cumsum(counts, 0) - counts)[gauss])
    tile = ((y0[gauss] + local // span_x[gauss]) * grid_w
            + x0[gauss] + local % span_x[gauss])
    return gauss, tile


def hit_distance(terms: torch.Tensor, dirs: torch.Tensor) -> tuple:
    """(t, hit), each (K, P): the ray solve of K Gaussians' `terms` (K,
    TERMS) against (K, 3, P) unit directions, t the nearest root beyond
    T_MIN where `hit`."""
    rot_t = terms[:, :9].reshape(-1, 3, 3)
    isc, oo, c = terms[:, 9:12], terms[:, 12:15], terms[:, 15]
    dd = _dot3(rot_t[:, :, :, None], dirs[:, None], dim=2) * isc[:, :, None]
    a = _dot3(dd, dd, dim=1)  # (K, P)
    b = 2.0 * _dot3(oo[:, :, None], dd, dim=1)
    del dd
    disc = b * b - 4.0 * a * c[:, None]
    hit = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a2 = 2.0 * a
    del a, disc
    t0 = (-b - sq) / a2
    t1 = (-b + sq) / a2
    del b, sq, a2
    t = torch.where(t0 > T_MIN, t0, t1)
    hit &= (t > T_MIN) & (t < float("inf"))
    return t, hit


def render_ellipsoids_torch(gaussians: ActivatedGaussians, camera: Camera,
                            background=(0.0, 0.0, 0.0),
                            pair_chunk: int | None = None) -> torch.Tensor:
    """The plain version: returns the (H, W, 3) image. `pair_chunk`:
    (Gaussian, tile) pairs solved at once (default: see `_chunk_size`); it
    changes memory and time, not the image."""
    h, w, dev = camera.height, camera.width, camera.device
    grid_h, grid_w = -(-h // TILE), -(-w // TILE)
    pre = ellipsoid_terms(gaussians, camera)
    _, direction = camera_rays(camera)
    # Ray directions by tile, (tiles, 3, TILE * TILE); the padding past the
    # image's edge is dropped at the end.
    pad = torch.zeros((grid_h * TILE, grid_w * TILE, 3), device=dev)
    pad[:h, :w] = direction
    dirs = (pad.reshape(grid_h, TILE, grid_w, TILE, 3)
            .permute(0, 2, 4, 1, 3).reshape(grid_h * grid_w, 3, TILE * TILE))
    gauss, tile = _pairs(pre.spans, grid_w)

    best = torch.full((grid_h * grid_w * TILE * TILE,), _NO_HIT,
                      dtype=torch.long, device=dev)
    lane = torch.arange(TILE * TILE, device=dev)
    chunk = pair_chunk or _chunk_size(dev)
    for k0 in range(0, len(gauss), chunk):
        g, t_id = gauss[k0:k0 + chunk], tile[k0:k0 + chunk]
        t, hit = hit_distance(pre.terms[g], dirs[t_id])
        key = torch.where(hit, (t.view(torch.int32).long() << 32)
                          | g[:, None], _NO_HIT)
        del t, hit
        best.scatter_reduce_(0, (t_id[:, None] * TILE * TILE
                                 + lane).reshape(-1),
                             key.reshape(-1), "amin")

    best = (best.reshape(grid_h, grid_w, TILE, TILE).permute(0, 2, 1, 3)
            .reshape(grid_h * TILE, grid_w * TILE)[:h, :w].reshape(-1))
    # The Gaussians' colours, then the background for no hit.
    bg = background_row(tuple(float(v) for v in background), dev)
    color = torch.cat([pre.color, bg[None]])
    winner = torch.where(best == _NO_HIT, len(pre.color), best & 0xFFFFFFFF)
    return torch.clamp(color[winner].reshape(h, w, 3), 0.0, 1.0)


def frame_inputs(gaussians: ActivatedGaussians, camera: Camera) -> dict:
    """The kernel's inputs, in the C entry points' order: the activated
    Gaussians, made contiguous, and the camera (its position and tan(fov /
    2) each a few torch ops of its tensors)."""
    return {"means": gaussians.means, "scales": gaussians.scales,
            "quats": gaussians.quats, "opacities": gaussians.opacities,
            "sh": gaussians.sh, "mask": gaussians.mask, "view": camera.view,
            "position": camera.position, "tan_x": camera.tan_fov_x,
            "tan_y": camera.tan_fov_y}


def _check(inputs: dict, cuda: bool = True) -> torch.device:
    """The kernel's inputs: one device (CUDA where `cuda`), contiguous,
    float32 but the bool mask, of matching shapes; raises on anything
    else."""
    n = inputs["means"].shape[0]
    k = inputs["sh"].shape[1] if inputs["sh"].dim() == 3 else 0
    shapes = {"means": (n, 3), "scales": (n, 3), "quats": (n, 4),
              "opacities": (n,), "sh": (n, max(k, 1), 3), "mask": (n,),
              "view": (4, 4), "position": (3,), "tan_x": (), "tan_y": ()}
    dev = inputs["means"].device
    for name, shape in shapes.items():
        x = inputs[name]
        dtype = torch.bool if name == "mask" else torch.float32
        if (tuple(x.shape) != shape or x.dtype != dtype
                or not x.is_contiguous() or x.device != dev):
            raise ValueError(
                f"{name} must be a contiguous {shape} {dtype} tensor on "
                f"{dev}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if cuda and dev.type != "cuda":
        raise ValueError(f"the ellipsoid kernel needs CUDA tensors, got {dev}")
    return dev


def frame_args(inputs: dict, height: int, width: int, *tail) -> tuple:
    """The C entry points' arguments: the inputs' pointers, the SH row's
    floats, N, height, width, then `tail` (pointers)."""
    ptr = {name: x.data_ptr() for name, x in inputs.items()}
    n, sh = inputs["means"].shape[0], inputs["sh"]
    return (ptr["means"], ptr["scales"], ptr["quats"], ptr["opacities"],
            ptr["sh"], sh.shape[1] * 3, ptr["mask"], ptr["view"],
            ptr["position"], ptr["tan_x"], ptr["tan_y"], n, height, width,
            *tail)


def scratch_offsets(lib, n: int, height: int, width: int) -> list:
    """The kernel's scratch for a frame as byte offsets: terms, spans,
    packed regions, colours, regions' pairs, queue, items, keys, then the
    total bytes (`gsrast_ellipsoids_scratch`)."""
    offsets = (ctypes.c_longlong * 9)()
    code = lib.gsrast_ellipsoids_scratch(n, height, width, offsets)
    if code != 0:
        raise RuntimeError(f"ellipsoid scratch layout failed: CUDA error {code}")
    return list(offsets)


def scratch_terms(scratch: torch.Tensor, offsets: list, n: int) -> Terms:
    """The first launch's terms, spans and colours: views of the scratch."""
    def part(i, count, dtype, shape):
        return scratch[offsets[i]:offsets[i] + 4 * count].view(dtype).view(shape)

    return Terms(part(0, n * TERMS, torch.float32, (n, TERMS)),
                 part(1, n * 4, torch.int32, (n, 4)),
                 part(3, n * 3, torch.float32, (n, 3)))


def ellipsoids_launch(gaussians: ActivatedGaussians, camera: Camera,
                      background: torch.Tensor) -> _kernels.Launch:
    """The kernel's launch on checked inputs; `out` is the (height, width,
    3) image it writes; `held["scratch"]` its scratch (sized from N and the
    image: the terms, spans, colours and packed regions of the first launch,
    the plan's items, the key image)."""
    inputs = {k: v.contiguous() for k, v in
              frame_inputs(gaussians, camera).items()}
    dev = _check(inputs)
    if (tuple(background.shape) != (3,) or background.dtype != torch.float32
            or background.device != dev):
        raise ValueError("background must be a (3,) float32 tensor on "
                         f"{dev}")
    h, w, n = camera.height, camera.width, inputs["means"].shape[0]
    lib = _kernels.load().lib
    offsets = scratch_offsets(lib, n, h, w)
    scratch = torch.empty((offsets[8],), dtype=torch.uint8, device=dev)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = frame_args(inputs, h, w, background.data_ptr(), scratch.data_ptr(),
                      out.data_ptr(), stream)
    return _kernels.Launch(lib.gsrast_ellipsoids, args, out,
                           dict(inputs=inputs, background=background,
                                scratch=scratch, offsets=offsets), dev)


def ellipsoid_terms_cuda(gaussians: ActivatedGaussians,
                         camera: Camera) -> Terms:
    """The debug entry: the kernel's first launch alone on CUDA tensors,
    its terms, spans and colours (bit-equal to `ellipsoid_terms`). Not
    counted as a frame's launch."""
    inputs = {k: v.contiguous() for k, v in
              frame_inputs(gaussians, camera).items()}
    dev = _check(inputs)
    h, w, n = camera.height, camera.width, inputs["means"].shape[0]
    lib = _kernels.load().lib
    offsets = scratch_offsets(lib, n, h, w)
    scratch = torch.empty((offsets[8],), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.gsrast_ellipsoids_terms(*frame_args(
            inputs, h, w, scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        raise RuntimeError(f"ellipsoid terms launch failed: CUDA error {code}")
    return scratch_terms(scratch, offsets, n)


def render_ellipsoids_cuda(gaussians: ActivatedGaussians, camera: Camera,
                           background=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """The hand-written kernel (`csrc/ellipsoids.cu`) on CUDA tensors:
    `render_ellipsoids_torch`'s image, the prologue and the rays computed
    in the kernel's own launches (a frame counted as one launch). Allocates
    only its output and scratch and reads nothing on the host, so a CUDA
    graph captures it."""
    bg = background_row(tuple(float(v) for v in background), camera.device)
    launch = ellipsoids_launch(gaussians, camera, bg)
    _kernels.run(launch, "ellipsoids")
    return launch.out


def render_ellipsoids(gaussians: ActivatedGaussians, camera: Camera,
                      background=(0.0, 0.0, 0.0),
                      pair_chunk: int | None = None,
                      backend: str = "cuda") -> torch.Tensor:
    """Returns the (H, W, 3) image: the kernel where
    `_kernels.uses_kernel(backend, device)`, else the plain version (with
    `pair_chunk`). A failed build or launch raises; nothing falls back to
    the plain version on CUDA tensors."""
    if _kernels.uses_kernel(backend, gaussians.means.device):
        return render_ellipsoids_cuda(gaussians, camera, background)
    return render_ellipsoids_torch(gaussians, camera, background, pair_chunk)
