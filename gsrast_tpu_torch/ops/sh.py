"""Spherical-harmonic colour evaluation, degrees 0-3 (the 3DGS real-SH
basis and constants)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.45704579946446572,
    0.3731763325901154,
    -0.45704579946446572,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh: torch.Tensor, direction: torch.Tensor,
            degree: int) -> torch.Tensor:
    """RGB from SH coefficients sh (..., K, 3), K >= (degree+1)^2 with DC
    first, for unit view directions (..., 3). Returns (..., 3) with the
    +0.5 offset applied, clamped to >= 0."""
    if degree < 0 or degree > 3:
        raise ValueError(f"sh degree {degree} out of range")
    result = SH_C0 * sh[..., 0, :]
    if degree >= 1:
        x = direction[..., 0:1]
        y = direction[..., 1:2]
        z = direction[..., 2:3]
        result = (result
                  - SH_C1 * y * sh[..., 1, :]
                  + SH_C1 * z * sh[..., 2, :]
                  - SH_C1 * x * sh[..., 3, :])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + SH_C2[0] * xy * sh[..., 4, :]
                  + SH_C2[1] * yz * sh[..., 5, :]
                  + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                  + SH_C2[3] * xz * sh[..., 7, :]
                  + SH_C2[4] * (xx - yy) * sh[..., 8, :])
    if degree >= 3:
        result = (result
                  + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                  + SH_C3[1] * xy * z * sh[..., 10, :]
                  + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                  + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                  * sh[..., 12, :]
                  + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                  + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                  + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return torch.clamp(result + 0.5, min=0.0)


def eval_sh_dc_reference(sh_dc: torch.Tensor) -> torch.Tensor:
    """The original CUDA renderer's DC-only shading, 0.5 + 0.4 * DC (the
    reference's `eval_sh_dc_reference`); its point-cloud shader uses
    another gain."""
    return 0.5 + 0.4 * sh_dc
