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

BACKENDS = ("cuda", "torch", "dense")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the tile-sorted rasterizer.

    Field names and defaults follow `gsrast_tpu.config.RenderConfig`. The
    reference's legacy two-tier binning knobs are not carried: this package
    plans slots from `tiers` only and walks true per-tile ranges.

    Attributes:
      tile_h/tile_w: pixel tile shape.
      tiers: multi-tier slot plan, ((k_j, budget_frac_j), ...) with k
        ascending; see `ops.binning.plan_tiers`. Must be non-empty to render
        (`render.api.auto_render_config` derives it from the scene).
      backend: 'cuda' (the hand-written blend kernel, CUDA tensors only),
        'torch' (the plain PyTorch blend, any device) or 'dense' (the
        tile-free oracle, `render.dense`, any device; it ignores `tiers`).
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

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def grid_shape(self, height: int, width: int) -> Tuple[int, int]:
        """Number of tiles (rows, cols) covering a height x width image."""
        return -(-height // self.tile_h), -(-width // self.tile_w)
