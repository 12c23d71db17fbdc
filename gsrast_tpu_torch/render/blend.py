"""Per-tile front-to-back alpha blend over depth-sorted intersections.

Input layout (`render.pipeline.sort_pack` builds it): `feat` (10, S) float32,
row f holding feature f of every intersection in (tile, depth) order:
  rows [mx, my, conic A, B, C, opacity, r, g, b, tile id]
and `tile_starts` (T+1,) int32, tile t owning columns
[tile_starts[t], tile_starts[t+1]). Outputs, per tile of P = tile_h*tile_w
pixels in row-major order: rgb (T, 3, P), final_t (T, P) and n_contrib
(T, P) int32, the reference's `_blend` outputs (gsrast_tpu
`render/pallas_pipeline.py`) without the TPU's row padding.

Blend semantics (the reference's):
  power = -1/2 (A dx^2 + C dy^2) - B dx dy        (dx = mean - pixel)
  alpha = min(ALPHA_MAX, opacity e^power); skipped (alpha = 0) when
          power > 0 or alpha < ALPHA_MIN
  include_i = T_i (1 - alpha_i) >= TRANSMITTANCE_MIN, monotone along i
  rgb = sum of c alpha T over included positions; final_t = the last
  included T (1 - alpha), 1 when none; n_contrib = the number of included
  positions, skipped ones counted.

Two versions: `blend_forward_cuda`, the hand-written kernel of
`csrc/blend_forward.cu`, and `blend_forward_torch`, the plain closed-form
version (cumulative products along each tile's segment) that the CPU runs
and that the kernel is checked against.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from .. import _kernels
from .. import config as cfg

FEATURE_ROWS = 10
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_TID = range(FEATURE_ROWS)

# Elements of one (tiles, positions, pixels) intermediate of the plain
# version: 2^24 float32 is 64 MiB, and about a dozen are live at once, so a
# chunk stays under 1 GiB.
PLAIN_CHUNK_ELEMENTS = 1 << 24

BlendOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def blend_forward(feat: torch.Tensor, tile_starts: torch.Tensor, grid_h: int,
                  grid_w: int, tile_h: int, tile_w: int,
                  backend: str = "cuda") -> BlendOut:
    """Blend every tile. backend 'cuda' launches the kernel and needs CUDA
    tensors; backend 'torch' runs the plain version and needs CPU tensors.
    Any other pairing raises: nothing falls back."""
    if backend == "cuda" and feat.device.type == "cuda":
        return blend_forward_cuda(feat, tile_starts, grid_h, grid_w, tile_h,
                                  tile_w)
    if backend == "torch" and feat.device.type == "cpu":
        return blend_forward_torch(feat, tile_starts, grid_h, grid_w, tile_h,
                                   tile_w)
    raise ValueError(
        f"blend backend {backend!r} cannot run on {feat.device} tensors: "
        "'cuda' needs CUDA tensors, 'torch' needs CPU tensors")


def blend_forward_cuda(feat: torch.Tensor, tile_starts: torch.Tensor,
                       grid_h: int, grid_w: int, tile_h: int,
                       tile_w: int) -> BlendOut:
    """The hand-written kernel (`csrc/blend_forward.cu`) on CUDA tensors.
    Runs on the current stream without synchronising."""
    num_tiles, p = grid_h * grid_w, tile_h * tile_w
    _check_inputs(feat, tile_starts, num_tiles)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_forward_cuda needs CUDA tensors, got "
                         f"{feat.device}")
    if feat.requires_grad:
        raise ValueError("blend_forward_cuda is forward-only: feat requires "
                         "grad (render under torch.inference_mode())")
    if feat.shape[1] >= 2**31:
        raise ValueError(
            f"{feat.shape[1]} intersections exceed int32 indexing")
    feat = feat.contiguous()
    tile_starts = tile_starts.contiguous()
    dev = feat.device
    rgb = torch.empty((num_tiles, 3, p), dtype=torch.float32, device=dev)
    final_t = torch.empty((num_tiles, p), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((num_tiles, p), dtype=torch.int32, device=dev)
    fn = _kernels.load().lib.gsrast_blend_forward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(feat.data_ptr(), feat.shape[1], tile_starts.data_ptr(),
                  num_tiles, grid_w, tile_h, tile_w, cfg.ALPHA_MIN,
                  cfg.ALPHA_MAX, cfg.TRANSMITTANCE_MIN, rgb.data_ptr(),
                  final_t.data_ptr(), n_contrib.data_ptr(), stream)
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
                        budget: int = PLAIN_CHUNK_ELEMENTS) -> BlendOut:
    """The plain version, on any device. Tiles run in chunks padded to the
    chunk's longest true segment (no cap on segment length); a segment
    longer than the budget allows is walked in blocks of positions with the
    transmittance carried between blocks."""
    num_tiles, p = grid_h * grid_w, tile_h * tile_w
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
        tids = torch.arange(t0, t1, device=dev)
        px = ((tids % grid_w) * tile_w)[:, None] + pcol
        py = ((tids // grid_w) * tile_h)[:, None] + prow
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
