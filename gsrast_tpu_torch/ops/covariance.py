"""3D covariance construction and EWA projection to 2D.

Per-Gaussian float32 math written out per channel, as the reference
(`gsrast_tpu/ops/covariance.py`) writes it, so both round alike:
  * cov3D = R S S^T R^T as its symmetric upper triangle
  * EWA cov2D = J W Sigma W^T J^T + 0.3 I dilation
  * conic = inverse(cov2D), valid = det > 0
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config as cfg


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) as (w, x, y, z) -> rotation (..., 3, 3)."""
    w, x, y, z = quat.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def compute_cov3d(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T as (..., 6): [xx, xy, xz, yy, yz, zz]. `quat` is a
    unit (w, x, y, z)."""
    rot = quat_to_rotmat(quat)
    (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = (
        row.unbind(-1) for row in rot.unbind(-2))
    sx, sy, sz = scale.unbind(-1)
    # M = R diag(s); Sigma = M M^T.
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return torch.stack([
        m00 * m00 + m01 * m01 + m02 * m02,  # xx
        m00 * m10 + m01 * m11 + m02 * m12,  # xy
        m00 * m20 + m01 * m21 + m02 * m22,  # xz
        m10 * m10 + m11 * m11 + m12 * m12,  # yy
        m10 * m20 + m11 * m21 + m12 * m22,  # yz
        m20 * m20 + m21 * m21 + m22 * m22,  # zz
    ], dim=-1)


def cov3d_to_matrix(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) upper triangle [xx, xy, xz, yy, yz, zz] -> the (..., 3, 3)
    symmetric matrix."""
    xx, xy, xz, yy, yz, zz = cov6.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def compute_cov2d(mean_view: torch.Tensor, cov6: torch.Tensor,
                  view_rot: torch.Tensor, focal_x: torch.Tensor,
                  focal_y: torch.Tensor, tan_fov_x: torch.Tensor,
                  tan_fov_y: torch.Tensor) -> torch.Tensor:
    """EWA splatting of a world-space covariance to screen space.

    mean_view (..., 3) is the centre in camera space (z = depth > 0);
    view_rot is view[:3, :3]. Returns (..., 3) [a, b, c] of [[a, b], [b, c]]
    with the +0.3 dilation on the diagonal."""
    tx, ty, tz = mean_view.unbind(-1)
    # Clamp the tangent-plane position to 1.3x the frustum.
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    tx = torch.clamp(tx / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(ty / tz, -lim_y, lim_y) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # T = J W with J the (2, 3) perspective Jacobian
    # [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]] and W = view_rot.
    w = view_rot
    jx = focal_x * inv_z
    jy = focal_y * inv_z
    jxz = -focal_x * tx * inv_z2
    jyz = -focal_y * ty * inv_z2
    t00 = jx * w[0, 0] + jxz * w[2, 0]
    t01 = jx * w[0, 1] + jxz * w[2, 1]
    t02 = jx * w[0, 2] + jxz * w[2, 2]
    t10 = jy * w[1, 0] + jyz * w[2, 0]
    t11 = jy * w[1, 1] + jyz * w[2, 1]
    t12 = jy * w[1, 2] + jyz * w[2, 2]
    s00, s01, s02, s11, s12, s22 = cov6.unbind(-1)
    # Sigma T^T columns: v_i = Sigma @ t_i (t_i = row i of T).
    v00 = s00 * t00 + s01 * t01 + s02 * t02
    v01 = s01 * t00 + s11 * t01 + s12 * t02
    v02 = s02 * t00 + s12 * t01 + s22 * t02
    v10 = s00 * t10 + s01 * t11 + s02 * t12
    v11 = s01 * t10 + s11 * t11 + s12 * t12
    v12 = s02 * t10 + s12 * t11 + s22 * t12
    a = t00 * v00 + t01 * v01 + t02 * v02 + cfg.COV2D_DILATION
    b = t10 * v00 + t11 * v01 + t12 * v02
    c = t10 * v10 + t11 * v11 + t12 * v12 + cfg.COV2D_DILATION
    return torch.stack([a, b, c], dim=-1)


def conic(cov2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of the 2D covariance as (conic [A, B, C] (..., 3), valid),
    valid = det > 0 (degenerate covariances are culled)."""
    a, b, c = cov2d.unbind(-1)
    det = a * c - b * b
    valid = det > 0.0
    inv_det = 1.0 / torch.where(valid, det, 1.0)
    return torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1), valid
