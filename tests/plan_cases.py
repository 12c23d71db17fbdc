"""Synthetic screen-space states for the tile plan's kernel tests, drawn
with numpy (no JAX, so the card's tests can import it): splat centres in
and around the image, radii from a log-normal (skewed: a few splats cover
hundreds of tiles), anisotropic conics, opacities, depths, and the tile
rectangles as `ops.projection.tile_rect` computes them."""

import math

import numpy as np
import torch

from gsrast_tpu_torch.ops import binning
from gsrast_tpu_torch.ops.preprocess import Preprocessed
from gsrast_tpu_torch.ops.projection import TileRect

# name -> (seed, N, (height, width), (tile_h, tile_w), tiers, culled share,
# log-normal sigma of the radius)
CASES = {
    # tiers >= 1 cull; k_last = 12 and small budgets drop tiles
    "budgeted": (1, 1_500, (96, 128), (8, 16),
                 ((2, 1.0), (6, 0.3), (12, 0.05)), 0.3, 1.0),
    # ten tiers over a skewed scene: k_last 512
    "skewed_10": (2, 3_000, (256, 256), (8, 8),
                  ((1, 1.0), (2, 0.9), (4, 0.7), (8, 0.5), (16, 0.3),
                   (32, 0.2), (64, 0.1), (128, 0.05), (256, 0.03),
                   (512, 0.02)), 0.2, 1.4),
    # every splat culled: no live slot
    "culled": (3, 700, (64, 96), (8, 16), ((2, 1.0), (8, 0.5)), 1.0, 1.0),
    # one Gaussian
    "one": (4, 1, (64, 64), (8, 8), ((3, 1.0), (20, 1.0)), 0.0, 1.5),
    # 900 grid slots, padded to 1,024
    "padded": (5, 300, (64, 64), (8, 8), ((3, 1.0),), 0.1, 0.8),
    # no Gaussian
    "empty": (6, 0, (64, 64), (8, 8), ((2, 1.0), (6, 0.5)), 0.1, 1.0),
    # every Gaussian on 2 tiles (`FIXED_RECTS`): one bucket over 8 blocks
    "one_count": (7, 2_000, (128, 128), (8, 8), ((1, 1.0), (4, 0.5)), 0.0,
                  1.0),
    # k_last 255 and 256: the last bucket counts of a 1-byte key and the
    # first of a 2-byte one
    "k255": (8, 2_500, (256, 256), (8, 8), ((1, 1.0), (4, 0.3), (255, 0.05)),
             0.2, 1.6),
    "k256": (9, 2_500, (256, 256), (8, 8), ((1, 1.0), (4, 0.3), (256, 0.05)),
             0.2, 1.6),
    # trained_116k's k_last 460 over 20,000 Gaussians: 3 rounds a block, the
    # last block ragged
    "k460": (10, 20_000, (256, 512), (8, 8),
             ((1, 1.0), (2, 0.5), (4, 0.3), (16, 0.1), (64, 0.03),
              (460, 0.01)), 0.2, 1.5),
    # wide tables, warp counts in scratch: k_last 32,767 in one block, and
    # 32,768 over two blocks of 64 rounds (k_last x grid_w under 4e6)
    "k32767": (11, 4_000, (2_200, 960), (8, 8), ((1, 1.0), (32_767, 0.01)),
               0.2, 2.5),
    "k32768": (12, 20_000, (2_200, 960), (8, 8), ((1, 1.0), (32_768, 0.005)),
               0.2, 2.5),
}
# Cases whose every rectangle is (width, height) tiles, at a drawn tile.
FIXED_RECTS = {"one_count": (2, 1)}
D = 4  # devices of the row-local and routed modes


def arrays(case: str) -> dict:
    """The case's Preprocessed fields as numpy arrays, and its grid."""
    seed, n, (h, w), (th, tw), _, culled, sigma = CASES[case]
    rng = np.random.default_rng(seed)
    gh, gw = -(-h // th), -(-w // tw)
    mean2d = np.stack([rng.uniform(-0.1 * w, 1.1 * w, n),
                       rng.uniform(-0.1 * h, 1.1 * h, n)], -1).astype(
                           np.float32)
    radius = np.minimum(np.ceil(np.exp(rng.normal(math.log(3.0), sigma, n))),
                        2 * max(h, w)).astype(np.int32)
    radius[rng.uniform(0.0, 1.0, n) < culled] = 0
    theta = rng.uniform(0.0, np.pi, n)
    l1 = 1.0 / (radius.astype(np.float64) / 3.0 + 0.3) ** 2
    l2 = l1 * rng.uniform(0.05, 1.0, n)
    cs, sn = np.cos(theta), np.sin(theta)
    conic = np.stack([l1 * cs * cs + l2 * sn * sn, (l1 - l2) * sn * cs,
                      l1 * sn * sn + l2 * cs * cs], -1).astype(np.float32)
    opacity = np.where(radius > 0, rng.uniform(0.002, 1.0, n), 0.0).astype(
        np.float32)
    depth = rng.uniform(0.2, 60.0, n).astype(np.float32)
    r = radius.astype(np.float32)

    def i32(x, hi):
        return np.clip(x, 0, hi).astype(np.int32)

    px, py = mean2d[:, 0], mean2d[:, 1]
    rect = (i32((px - r) / np.float32(tw), gw),
            i32((py - r) / np.float32(th), gh),
            i32(np.ceil((px + r + np.float32(1.0)) / np.float32(tw)), gw),
            i32(np.ceil((py + r + np.float32(1.0)) / np.float32(th)), gh))
    if case in FIXED_RECTS:
        rw, rh = FIXED_RECTS[case]
        x0 = rng.integers(0, gw - rw + 1, n).astype(np.int32)
        y0 = rng.integers(0, gh - rh + 1, n).astype(np.int32)
        rect = (x0, y0, x0 + rw, y0 + rh)
    return dict(mean2d=mean2d, depth=depth, conic=conic,
                color=np.zeros((n, 3), np.float32), opacity=opacity,
                radius=radius, rect=rect, grid=(gh, gw))


def prep(a: dict, device="cpu") -> Preprocessed:
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return Preprocessed(mean2d=t(a["mean2d"]), depth=t(a["depth"]),
                        conic=t(a["conic"]), color=t(a["color"]),
                        opacity=t(a["opacity"]), radius=t(a["radius"]),
                        rect=TileRect(*(t(x) for x in a["rect"])))


def modes(case: str, grid_h: int) -> dict:
    """The plan's three modes for the case: mode -> (tiers, the mode's
    keyword arguments). Row-local: rows {row0 + 4 r} with the tiers
    `shard_tiers` scales for 4 devices, row0 0 and 3; routed: 4
    destinations of contiguous rows."""
    tiers = CASES[case][4]
    rpd = -(-grid_h // D)
    rows = binning.shard_tiers(tiers, D)
    return {
        "whole": (tiers, {}),
        "rows_0": (rows, dict(num_local_rows=rpd, row0=0, row_stride=D)),
        "rows_3": (rows, dict(num_local_rows=rpd, row0=3, row_stride=D)),
        "routed": (tiers, dict(dest_rows=rpd, n_dest=D)),
    }
