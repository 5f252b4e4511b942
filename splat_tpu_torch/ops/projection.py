"""Perspective EWA projection of 3D Gaussians with screen-space pixel velocities
(port of `splat_tpu/ops/projection.py`; gsplat 0.1.11 semantics plus the
3dgs-deblur fork's per-Gaussian pixel velocity).

World-to-camera (R_cw, t_cw) is OpenCV (+z forward, +y down); quats are
(w, x, y, z); scales are linear; velocities are camera-frame. Plain tensor
code: its backward is autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .se3 import quat_normalize, quat_to_rotmat

COV2D_DILATION = 0.3
DEFAULT_CLIP_THRESH = 0.01


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities consumed by the rasterizer."""

    means2d: torch.Tensor        # (N, 2) pixel-space centers
    depths: torch.Tensor         # (N,) camera z (> 0 in front)
    conics: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # (N,) 3-sigma pixel radius (0 => culled)
    compensations: torch.Tensor  # (N,) antialiasing opacity factor
    pix_vels: torch.Tensor       # (N, 2) screen-space velocity, px/s
    valid: torch.Tensor          # (N,) bool: in front and non-degenerate
    extents: torch.Tensor        # (N, 2) 3-sigma axis-aligned half-extents


def effective_opacity(proj: ProjectedGaussians, opacities: torch.Tensor) -> torch.Tensor:
    """The opacity a binning culls by and the compositor draws with:
    opacities * compensations * valid, in that order."""
    return opacities * proj.compensations * proj.valid.to(opacities.dtype)


def scale_quat_to_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma_3 = R(q) diag(s)^2 R(q)^T: scales (N,3), quats (N,4) -> (N,3,3).
    Quats are normalized here (raw optimizer parameters drift)."""
    R = quat_to_rotmat(quat_normalize(quats))
    M = R * scales[..., None, :]
    return torch.matmul(M, M.transpose(-1, -2))


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    fx, fy, cx, cy,
    img_w: int,
    img_h: int,
    lin_vel: torch.Tensor | None = None,
    ang_vel: torch.Tensor | None = None,
    clip_thresh: float = DEFAULT_CLIP_THRESH,
    lim_img_h: int | None = None,
) -> ProjectedGaussians:
    """Project N Gaussians into one camera; with (lin_vel, ang_vel) also emit
    pixel velocities J @ (-omega x X_cam - v). lim_img_h: height used for the
    EWA frustum clamp (defaults to img_h)."""
    dtype, dev = means3d.dtype, means3d.device
    fx, fy, cx, cy = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (fx, fy, cx, cy))
    p_cam = torch.matmul(means3d, R_cw.T) + t_cw
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    in_front = z > clip_thresh
    zs = torch.where(in_front, z, torch.ones_like(z))

    cov3d_w = scale_quat_to_cov3d(scales, quats)
    cov3d_c = torch.matmul(torch.matmul(R_cw, cov3d_w), R_cw.T)

    lim_x = 1.3 * (0.5 * img_w / fx)
    lim_y = 1.3 * (0.5 * (img_h if lim_img_h is None else lim_img_h) / fy)
    tx = zs * torch.minimum(torch.maximum(x / zs, -lim_x), lim_x)
    ty = zs * torch.minimum(torch.maximum(y / zs, -lim_y), lim_y)

    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    c00, c01, c02 = cov3d_c[..., 0, 0], cov3d_c[..., 0, 1], cov3d_c[..., 0, 2]
    c11, c12, c22 = cov3d_c[..., 1, 1], cov3d_c[..., 1, 2], cov3d_c[..., 2, 2]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = a * c - b * b
    a_d = a + COV2D_DILATION
    c_d = c + COV2D_DILATION
    det = a_d * c_d - b * b
    det_ok = det > 1e-12
    det_safe = torch.where(det_ok, det, torch.ones_like(det))

    compensations = torch.sqrt(torch.clamp(det_orig, min=0.0) / det_safe)

    inv_det = 1.0 / det_safe
    conics = torch.stack([c_d * inv_det, -b * inv_det, a_d * inv_det], dim=-1)

    mid = 0.5 * (a_d + c_d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    extents = torch.ceil(
        3.0 * torch.sqrt(torch.clamp(torch.stack([a_d, c_d], dim=-1), min=0.0))
    )

    means2d = torch.stack([fx * x * inv_z + cx, fy * y * inv_z + cy], dim=-1)

    valid = in_front & det_ok
    zero = torch.zeros((), dtype=dtype, device=dev)
    radii = torch.where(valid, radii, zero)
    extents = torch.where(valid[..., None], extents, zero)

    if lin_vel is None:
        pix_vels = torch.zeros((means3d.shape[0], 2), dtype=dtype, device=dev)
    else:
        xdot = -torch.linalg.cross(ang_vel.expand(p_cam.shape), p_cam, dim=-1) - lin_vel
        pvx = j00 * xdot[..., 0] + j02 * xdot[..., 2]
        pvy = j11 * xdot[..., 1] + j12 * xdot[..., 2]
        pix_vels = torch.where(valid[..., None], torch.stack([pvx, pvy], dim=-1), zero)

    return ProjectedGaussians(
        means2d=means2d,
        depths=z,
        conics=conics,
        radii=radii,
        compensations=torch.where(valid, compensations, zero),
        pix_vels=pix_vels,
        valid=valid,
        extents=extents,
    )
