"""Global constants and render configuration.

The constants are the reference renderer's (`gsrast_tpu/config.py`) and must
stay equal to them: the blend thresholds decide which positions a pixel
blends, so any drift changes images and `n_contrib`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Math constants.
PI = 3.14159265358979323846
EPSILON = 1e-6

# Default camera parameters.
DEFAULT_NEAR = 0.01
DEFAULT_FAR = 100.0
DEFAULT_FOV_DEG = 45.0

# Default image size.
DEFAULT_WIDTH = 1024
DEFAULT_HEIGHT = 768

NUM_CHANNELS = 3

# Blend thresholds.
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_MIN = 1e-4

# EWA low-pass dilation added to the 2D covariance diagonal.
COV2D_DILATION = 0.3

# Frustum-cull margin (NDC +-1.3) and the near-plane depth cut.
NDC_CULL_MARGIN = 1.3
NEAR_CULL_DEPTH = 0.2

# Gaussian extent cap: 3 sigma.
GAUSSIAN_EXTENT_SIGMA = 3.0

BACKENDS = ("cuda", "torch", "autograd", "dense")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the tile-sorted rasterizer.

    Field names and defaults follow `gsrast_tpu.config.RenderConfig`. The
    backends map onto the reference's: its 'xla' (the differentiable
    oracle) is 'autograd' here, since nothing here runs XLA, and its
    'pallas' (the hand-written kernels) is 'cuda'.

    Attributes:
      tile_h/tile_w: pixel tile shape.
      tiers: multi-tier slot plan, ((k_j, budget_frac_j), ...) with k
        ascending; see `ops.binning.plan_tiers`
        (`render.api.auto_render_config` derives it from the scene). Empty,
        the default, selects the reference's legacy two-tier binning
        (`ops.binning.build_binning`), with the knobs below.
      max_tiles_per_gaussian: legacy binning's cap K2 on the tiles one
        Gaussian is binned into (drops counted in overflow_tile_cap).
      base_tiles_per_gaussian: legacy tier-1 width K1: every Gaussian gets
        K1 slots; the `heavy_fraction` of N with the most tiles get tier-2
        rows for tiles K1..K2.
      intersect_capacity_factor: the legacy intersection list's capacity
        as a multiple of N (`capacity`; drops counted in
        overflow_capacity); the primitive-sharded path sizes its default
        send buffers from it too (`parallel.sharded`).
      tile_chunk: tiles the 'autograd' oracle blends per step (bounds its
        memory).
      max_per_tile: positions per tile the 'autograd' oracle blends (the
        rest are counted in overflow_per_tile); the other backends walk
        true ranges.
      backend: 'cuda' (the hand-written blend kernels, CUDA tensors only),
        'torch' (the kernels' plain PyTorch versions, any device),
        'autograd' (the capped closed-form oracle, `render.tiled`,
        differentiated by autograd, any device) or 'dense' (the tile-free
        oracle, `render.dense`, any device; it ignores `tiers`).
      sh_degree: highest SH degree evaluated.
      background: RGB composited behind the splats with the residual
        transmittance.
    """

    tile_h: int = 8
    tile_w: int = 128
    tiers: Tuple[Tuple[int, float], ...] = ()
    backend: str = "cuda"
    sh_degree: int = 3
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    intersect_capacity_factor: float = 4.0
    max_tiles_per_gaussian: int = 32
    base_tiles_per_gaussian: int = 8
    heavy_fraction: float = 0.125
    tile_chunk: int = 16
    max_per_tile: int = 1024

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def grid_shape(self, height: int, width: int) -> Tuple[int, int]:
        """Number of tiles (rows, cols) covering a height x width image."""
        return -(-height // self.tile_h), -(-width // self.tile_w)

    def padded_shape(self, height: int, width: int) -> Tuple[int, int]:
        ty, tx = self.grid_shape(height, width)
        return ty * self.tile_h, tx * self.tile_w

    def capacity(self, num_gaussians: int) -> int:
        """The legacy intersection list's length: int(N *
        intersect_capacity_factor) rounded up to 128, at least 128."""
        cap = int(num_gaussians * self.intersect_capacity_factor)
        return max(128, -(-cap // 128) * 128)
