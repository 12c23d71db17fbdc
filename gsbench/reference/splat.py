"""The plain reference of a 3D Gaussian splat render, in PyTorch ops.

It follows the 3DGS rasterizer (Kerbl et al. 2023) as the measured program
states it: EWA projection with a 0.3 pixel dilation, SH colour up to degree
3 with the +0.5 offset clamped at 0, an opacity-aware 3-sigma extent, tiles
covered by that extent, a per-tile depth order, and front-to-back blending
that skips alpha below 1/255, clamps alpha at 0.99 and stops before the
transmittance falls below 1e-4. Pixel (x, y) samples the splat at integer
coordinates. A tier plan of the program's form decides which (splat, tile)
pairs get a slot, and its slot order breaks depth ties. Nothing here imports
the program: every plan, order and count is worked out again from the
scene and the camera.

Everything computes in the floating type of its inputs (`camera` casts to
a given one): float32 for the reference, bfloat16 for the lower-precision
control. The blend runs in blocks of tiles (`BLOCK_ELEMENTS` (tile,
position, pixel) elements a block), so that it fits at 1920x1080 with a
million splats; given the image's cotangent it computes each block again
under autograd and pulls the cotangent back to the per-splat features.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_MIN = 1e-4
DILATION = 0.3
NEAR_DEPTH = 0.2
NDC_MARGIN = 1.3
EXTENT_SIGMA = 3.0
# The tile cull's alpha: a tile whose nearest pixel is bounded under this
# cannot reach ALPHA_MIN, with room for float32 rounding.
ALPHA_FLOOR = 0.98 * ALPHA_MIN
BLOCK_ELEMENTS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.45704579946446572,
         0.3731763325901154, -0.45704579946446572, 1.445305721320277,
         -0.5900435899266435)

# The per-splat feature columns the blend reads.
FEATURES = ("mx", "my", "ca", "cb", "cc", "op", "r", "g", "b")


class Camera(NamedTuple):
    """A pinhole camera's terms, as tensors of one type on one device."""

    view: torch.Tensor       # (4, 4) world -> camera, +z into the screen
    full_proj: torch.Tensor  # (4, 4) world -> clip
    position: torch.Tensor   # (3,)
    focal_x: torch.Tensor
    focal_y: torch.Tensor
    tan_x: torch.Tensor
    tan_y: torch.Tensor
    width: int
    height: int


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as products and sums, never on the tensor cores."""
    return (a.unsqueeze(-1) * b).sum(-2)


def camera(view, fov_x: float, fov_y: float, znear: float, zfar: float,
           width: int, height: int, device, dtype=torch.float32) -> Camera:
    """The terms of a camera given by its view matrix and field of view."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    view = t(view)
    tan_x, tan_y = torch.tan(t(fov_x) * 0.5), torch.tan(t(fov_y) * 0.5)
    zn, zf = t(znear), t(zfar)
    proj = torch.zeros((4, 4), dtype=torch.float32, device=device)
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[2, 2] = zf / (zf - zn)
    proj[2, 3] = -(zf * zn) / (zf - zn)
    proj[3, 2] = 1.0
    cast = lambda x: x.to(dtype)  # noqa: E731
    return Camera(
        view=cast(view), full_proj=cast(_mm(proj, view)),
        position=cast(-_mm(view[:3, 3], view[:3, :3])),
        focal_x=cast(torch.full_like(tan_x, float(width)) / (2.0 * tan_x)),
        focal_y=cast(torch.full_like(tan_y, float(height)) / (2.0 * tan_y)),
        tan_x=cast(tan_x), tan_y=cast(tan_y), width=int(width),
        height=int(height))


def activate(params: dict) -> dict:
    """Render-ready splats from raw parameters: exp scales, unit
    quaternions, sigmoid opacity (0 where the mask is off)."""
    q = params["quats"]
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return {"means": params["means"],
            "scales": torch.exp(params["log_scales"]),
            "quats": q / (norm + 1e-12),
            "opacities": torch.where(params["mask"],
                                     torch.sigmoid(params["opacity_logits"]),
                                     0.0),
            "sh": params["sh"], "mask": params["mask"]}


def eval_sh(sh: torch.Tensor, d: torch.Tensor, degree: int) -> torch.Tensor:
    """RGB of SH coefficients (N, K, 3) seen along unit directions (N, 3),
    offset by 0.5 and clamped at 0."""
    out = SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        out = (out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
               - SH_C1 * x * sh[:, 3])
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


class Splats(NamedTuple):
    """Screen-space splats: the features the blend reads, differentiable,
    and the integer structure of their tiles, not."""

    features: torch.Tensor  # (N, 9), FEATURES
    depth: torch.Tensor     # (N,) camera-space z
    x0: torch.Tensor        # covered tile rectangle, int64; x1, y1 exclusive
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    visible: torch.Tensor   # (N,) bool: radius > 0


def project(act: dict, cam: Camera, sh_degree: int, tile_h: int,
            tile_w: int) -> Splats:
    """Cull, project and shade every splat; bound each by the tiles its
    extent covers."""
    means, view = act["means"], cam.view
    rot, trans = view[..., :3, :3], view[..., :3, 3]
    mv = _mm(means, rot.transpose(-1, -2)) + trans
    depth = mv[..., 2]
    hom = _mm(torch.cat([means, torch.ones_like(means[:, :1])], dim=-1),
              cam.full_proj.transpose(-1, -2))
    ndc = hom[..., :3] * (1.0 / (hom[..., 3:4] + 1e-7))
    mx = ((ndc[..., 0] + 1.0) * cam.width - 1.0) * 0.5
    my = ((ndc[..., 1] + 1.0) * cam.height - 1.0) * 0.5
    visible = ((depth > NEAR_DEPTH) & (ndc[..., 0].abs() < NDC_MARGIN)
               & (ndc[..., 1].abs() < NDC_MARGIN) & act["mask"])

    # Sigma = M M^T with M = R(q) diag(s).
    w, x, y, z = act["quats"].unbind(-1)
    r = ((1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
          2.0 * (x * z + w * y)),
         (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
          2.0 * (y * z - w * x)),
         (2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
          1.0 - 2.0 * (x * x + y * y)))
    s = act["scales"].unbind(-1)
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]
    sig = [[sum(m[i][k] * m[j][k] for k in range(3)) for j in range(3)]
           for i in range(3)]

    # EWA: J W Sigma W^T J^T + dilation, the tangent clamped at 1.3 fov.
    tz = torch.where(visible, depth, torch.ones_like(depth))
    lim_x, lim_y = 1.3 * cam.tan_x, 1.3 * cam.tan_y
    tx = torch.clamp(mv[..., 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(mv[..., 1] / tz, -lim_y, lim_y) * tz
    iz = 1.0 / tz
    jx, jy = cam.focal_x * iz, cam.focal_y * iz
    jxz, jyz = -cam.focal_x * tx * iz * iz, -cam.focal_y * ty * iz * iz
    t0 = [jx * rot[..., 0, k] + jxz * rot[..., 2, k] for k in range(3)]
    t1 = [jy * rot[..., 1, k] + jyz * rot[..., 2, k] for k in range(3)]
    v0 = [sum(sig[k][j] * t0[j] for j in range(3)) for k in range(3)]
    v1 = [sum(sig[k][j] * t1[j] for j in range(3)) for k in range(3)]
    a = sum(t0[k] * v0[k] for k in range(3)) + DILATION
    b = sum(t1[k] * v0[k] for k in range(3))
    c = sum(t1[k] * v1[k] for k in range(3)) + DILATION
    det = a * c - b * b
    visible = visible & (det > 0.0)
    inv = 1.0 / torch.where(det > 0.0, det, torch.ones_like(det))

    d = means - cam.position
    d = d / (torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)) + 1e-12)
    color = eval_sh(act["sh"], d, sh_degree)

    # The extent: the ellipse on which alpha falls to ALPHA_MIN, at most
    # 3 sigma, bounded along each axis.
    op = act["opacities"]
    with torch.no_grad():
        cfac = torch.clamp(2.0 * torch.log(op / ALPHA_FLOOR), 0.0,
                           EXTENT_SIGMA ** 2)
        ex = torch.ceil(torch.sqrt(cfac * torch.clamp(a, min=0.0)))
        ey = torch.ceil(torch.sqrt(cfac * torch.clamp(c, min=0.0)))
        visible = visible & (torch.maximum(ex, ey) > 0)
        gw = -(-cam.width // tile_w)
        gh = -(-cam.height // tile_h)

        def tile(v, hi):
            v = torch.nan_to_num(v.float(), nan=0.0, posinf=hi, neginf=0.0)
            return torch.clamp(v, 0, hi).long()

        x0 = tile((mx - ex) / tile_w, gw)
        y0 = tile((my - ey) / tile_h, gh)
        x1 = tile(torch.ceil((mx + ex + 1.0) / tile_w), gw)
        y1 = tile(torch.ceil((my + ey + 1.0) / tile_h), gh)
    feats = torch.stack(torch.broadcast_tensors(
        mx, my, c * inv, -b * inv, a * inv,
        torch.where(visible, op, torch.zeros_like(op)), *color.unbind(-1)),
        dim=-1)
    return Splats(feats, depth, x0, y0, x1, y1, visible)


def tile_counts(sp: Splats) -> torch.Tensor:
    """Tiles of each splat's rectangle (0 where it is not visible)."""
    n = (sp.x1 - sp.x0).clamp(min=0) * (sp.y1 - sp.y0).clamp(min=0)
    return torch.where(sp.visible, n, 0)


def tier_dims(n: int, tiers) -> list:
    """(first ordinal, last ordinal, rows, slot offset) of each tier of a
    tier plan ((k_j, budget fraction_j), ...): tier j gives the top rows of
    the count ranking slots for tile ordinals k_{j-1}..k_j, budgets rounded
    up to 128 rows and never growing; tier 0 with a fraction >= 1 covers
    every splat."""
    dims, off, prev_b, prev_k = [], 0, n, 0
    for j, (k, frac) in enumerate(tiers):
        b = n if (j == 0 and frac >= 1.0) else min(
            n, max(128, -(-int(n * frac) // 128) * 128), prev_b)
        dims.append((prev_k, k, b, off))
        off += (k - prev_k) * b
        prev_b, prev_k = b, k
    return dims


def count_rank(counts: torch.Tensor, tiers) -> torch.Tensor:
    """Each splat's rank in the tier plan's ranking (along the last
    dimension): by tile count, at most k_last (the last tier's bound),
    descending; ties by index."""
    order = torch.sort(-counts.clamp(max=tiers[-1][0]), dim=-1,
                       stable=True).indices
    return torch.empty_like(order).scatter_(
        -1, order, torch.arange(counts.shape[-1],
                                device=counts.device).expand_as(order))


def plan_drops(counts: torch.Tensor, tiers) -> torch.Tensor:
    """The (splat, tile) pairs that the tier plan `tiers` grants no slot,
    of splats with `counts` tiles (one view a row of the last dimension):
    tier j grants its top B_j ranks the ordinals k_{j-1}..k_j of their
    rectangle, and no tier grants an ordinal past k_last. `pairs` drops the
    same pairs, one by one."""
    rank = count_rank(counts, tiers)
    granted = torch.zeros_like(counts)
    for k0, k1, b, _ in tier_dims(counts.shape[-1], tiers):
        span = (counts.clamp(max=k1) - k0).clamp(min=0)
        granted += torch.where(rank < b, span, 0)
    return counts.sum(-1) - granted.sum(-1)


def cameras(cams: list) -> Camera:
    """Cameras of one image size as one whose terms have a leading view
    dimension, so that `project` sees them all at once (its per-splat
    terms then have the shape (views, splats))."""
    def stack(field, trail):
        return torch.stack([getattr(c, field) for c in cams]).reshape(
            len(cams), 1, *trail)

    (width,), (height,) = {c.width for c in cams}, {c.height for c in cams}
    return Camera(stack("view", (4, 4)), stack("full_proj", (4, 4)),
                  stack("position", (3,)), stack("focal_x", ()),
                  stack("focal_y", ()), stack("tan_x", ()),
                  stack("tan_y", ()), width, height)


def view_drops(params: dict, cams: list, tile_h: int, tile_w: int, tiers,
               batch: int = 24) -> int:
    """The most pairs that `tiers` drops on any of the cameras `cams`, for
    the raw parameters `params`, `batch` cameras at a time."""
    worst = torch.zeros((), dtype=torch.long, device=params["means"].device)
    with torch.no_grad():
        act = activate(params)
        for i in range(0, len(cams), batch):
            sp = project(act, cameras(cams[i:i + batch]), 0, tile_h, tile_w)
            worst = torch.maximum(worst, plan_drops(tile_counts(sp),
                                                    tiers).max())
    return int(worst)


class Pairs(NamedTuple):
    """(splat, tile) pairs in blend order: by tile, then depth."""

    splat: torch.Tensor        # (S,) int64
    tile_starts: torch.Tensor  # (T + 1,) int64
    grid_h: int
    grid_w: int
    dropped: int               # pairs a tier plan of this size would drop


def pairs(sp: Splats, cam: Camera, tile_h: int, tile_w: int,
          tiers) -> Pairs:
    """The (splat, tile) pairs that the tier plan `tiers` grants a slot
    and whose tile the splat can reach at alpha >= ALPHA_MIN, ordered by
    tile and depth. The plan ranks the splats by tile count (at most
    k_last, the last tier's bound; ties by index) and gives tier j's top
    B_j ranks slots for the tile ordinals k_{j-1}..k_j of their rectangle
    (row-major): a pair outside its splat's grant is dropped and counted.
    Equal depths keep the order of the plan's slots, in which a stable sort
    of the slots leaves them."""
    dev = sp.depth.device
    gh, gw = -(-cam.height // tile_h), -(-cam.width // tile_w)
    n = sp.depth.shape[0]
    counts = tile_counts(sp)
    rank = count_rank(counts, tiers)
    splat = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    ordinal = torch.arange(splat.shape[0], device=dev) - first[splat]
    rw = (sp.x1 - sp.x0)[splat]
    gy = sp.y0[splat] + ordinal // rw
    gx = sp.x0[splat] + ordinal % rw

    # Slot of each pair in the tier plan, and the pairs such a plan drops.
    slot = torch.zeros_like(ordinal)
    granted = torch.zeros_like(ordinal, dtype=torch.bool)
    r = rank[splat]
    for k0, k1, b, off in tier_dims(n, tiers):
        inside = (ordinal >= k0) & (ordinal < k1)
        slot = torch.where(inside, off + (ordinal - k0) * b + r, slot)
        granted |= inside & (r < b)
    dropped = int((~granted).sum())

    # The tile cull: the nearest pixel of the tile, at distance d from the
    # centre, bounds alpha by opacity exp(-lam_min d^2 / 2).
    f = sp.features.detach()[splat]
    a, b, c = f[:, 2], f[:, 3], f[:, 4]
    lam = torch.clamp(0.5 * (a + c) - torch.sqrt(torch.clamp(
        0.25 * (a - c) ** 2 + b * b, min=0.0)), min=0.0)
    thr = 2.0 * torch.log(torch.clamp(f[:, 5], min=1e-12) / ALPHA_FLOOR)
    px, py = (gx * tile_w).to(f.dtype), (gy * tile_h).to(f.dtype)
    dx = torch.clamp(torch.maximum(px - f[:, 0], f[:, 0] - (px + tile_w - 1)),
                     min=0.0)
    dy = torch.clamp(torch.maximum(py - f[:, 1], f[:, 1] - (py + tile_h - 1)),
                     min=0.0)
    keep = ((dx * dx + dy * dy) * lam <= thr) & granted
    splat, tile, slot = splat[keep], (gy * gw + gx)[keep], slot[keep]

    depth_bits = sp.depth.detach().float().view(torch.int32).long()[splat]
    order = torch.sort(slot, stable=True).indices
    order = order[torch.sort(depth_bits[order], stable=True).indices]
    order = order[torch.sort(tile[order], stable=True).indices]
    starts = torch.searchsorted(tile[order],
                                torch.arange(gh * gw + 1, device=dev))
    return Pairs(splat[order], starts, gh, gw, dropped)


class Blend(NamedTuple):
    image: torch.Tensor      # (H, W, 3)
    n_contrib: torch.Tensor  # (T, P) positions each pixel walked
    fwd_pairs: int           # sum of min(n_contrib + 1, segment)
    fwd_blended: int         # of those, the pairs at which a splat blends
    bwd_pairs: int           # sum of n_contrib
    bwd_blended: int


def _blocks(seg: torch.Tensor, pixels: int, budget: int):
    """Tiles in runs of similar segment length, each run's tiles x its
    longest segment x pixels at most `budget` (one tile at least)."""
    order = torch.sort(seg, descending=True, stable=True).indices
    lengths = seg[order].tolist()
    i = 0
    while i < len(lengths) and lengths[i] > 0:
        nt = max(1, budget // (lengths[i] * pixels))
        j = min(i + nt, len(lengths))
        yield order[i:j], lengths[i]
        i = j


def _tile_block(feats: torch.Tensor, pr: Pairs, tiles: torch.Tensor,
                length: int, tile_h: int, tile_w: int):
    """One block's colours (nt, 3, P), its walk's masks and its blend mask
    (nt, L, P) for the tiles `tiles`."""
    dev = feats.device
    starts = pr.tile_starts[tiles]
    seg = pr.tile_starts[tiles + 1] - starts
    k = torch.arange(length, device=dev)
    valid = k[None, :] < seg[:, None]                      # (nt, L)
    idx = (starts[:, None] + k[None, :]).clamp(max=max(pr.splat.shape[0] - 1,
                                                       0))
    f = feats.index_select(0, pr.splat[idx.reshape(-1)]).reshape(
        tiles.shape[0], length, len(FEATURES))
    pix = torch.arange(tile_h * tile_w, device=dev)
    px = ((tiles % pr.grid_w) * tile_w)[:, None] + pix % tile_w   # (nt, P)
    py = ((tiles // pr.grid_w) * tile_h)[:, None] + pix // tile_w
    dx = f[..., 0:1] - px[:, None, :].to(f.dtype)                 # (nt, L, P)
    dy = f[..., 1:2] - py[:, None, :].to(f.dtype)
    power = (-0.5 * (f[..., 2:3] * (dx * dx) + f[..., 4:5] * (dy * dy))
             - f[..., 3:4] * (dx * dy))
    alpha = torch.clamp(f[..., 5:6] * torch.exp(power), max=ALPHA_MAX)
    blends = valid[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(blends, alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - a, dim=1)
    include = (cum >= TRANSMITTANCE_MIN) & valid[..., None]
    before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    wt = torch.where(include, a * before, torch.zeros_like(a))
    rgb = torch.einsum("nlp,nlc->ncp", wt, f[..., 6:9])
    return rgb, include, blends, seg


def blend(feats: torch.Tensor, pr: Pairs, cam: Camera, tile_h: int,
          tile_w: int, d_image: Optional[torch.Tensor] = None,
          budget: int = BLOCK_ELEMENTS) -> Blend:
    """The image of the ordered pairs, and the counts of the blend's work.
    With `d_image` (H, W, 3), the cotangent of the image, each block is
    computed again under autograd and its share of `feats`' gradient is
    added to `feats.grad` (`feats` a leaf that requires grad)."""
    dev, dtype = feats.device, feats.dtype
    gh, gw, p = pr.grid_h, pr.grid_w, tile_h * tile_w
    num_tiles = gh * gw
    seg = pr.tile_starts[1:] - pr.tile_starts[:-1]
    tiles_rgb = torch.zeros((num_tiles, 3, p), dtype=dtype, device=dev)
    n_contrib = torch.zeros((num_tiles, p), dtype=torch.long, device=dev)
    d_tiles = None
    if d_image is not None:
        pad = torch.zeros((gh * tile_h, gw * tile_w, 3), dtype=dtype,
                          device=dev)
        pad[:cam.height, :cam.width] = d_image
        d_tiles = pad.reshape(gh, tile_h, gw, tile_w, 3).permute(
            0, 2, 4, 1, 3).reshape(num_tiles, 3, p)
    counts = torch.zeros(4, dtype=torch.long, device=dev)
    for tiles, length in _blocks(seg, p, budget):
        with torch.no_grad():
            rgb, include, blends, s = _tile_block(feats.detach(), pr, tiles,
                                                  length, tile_h, tile_w)
            nc = include.sum(1)
            tiles_rgb[tiles] = rgb
            n_contrib[tiles] = nc
            k = torch.arange(length, device=dev)[None, :, None]
            stop = torch.minimum(nc + 1, s[:, None])[:, None, :]
            counts += torch.stack([stop.sum(), (blends & (k < stop)).sum(),
                                   nc.sum(),
                                   (blends & (k < nc[:, None, :])).sum()])
            del include, blends
        if d_tiles is not None:
            with torch.enable_grad():
                rgb = _tile_block(feats, pr, tiles, length, tile_h, tile_w)[0]
                torch.autograd.backward(rgb, d_tiles[tiles])
    image = tiles_rgb.reshape(gh, gw, 3, tile_h, tile_w).permute(
        0, 3, 1, 4, 2).reshape(gh * tile_h, gw * tile_w, 3)
    return Blend(image[:cam.height, :cam.width], n_contrib,
                 *counts.tolist())


def render(params: dict, cam: Camera, sh_degree: int, tile_h: int,
           tile_w: int, tiers) -> tuple:
    """(Blend, Splats, Pairs) of the raw parameters `params` seen by `cam`,
    computed without gradients in the parameters' type."""
    with torch.no_grad():
        sp = project(activate(params), cam, sh_degree, tile_h, tile_w)
        pr = pairs(sp, cam, tile_h, tile_w, tiers)
        return blend(sp.features, pr, cam, tile_h, tile_w), sp, pr
