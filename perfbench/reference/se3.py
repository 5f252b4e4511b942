"""Frozen copy of `splat_tpu_torch/ops/se3.py` at commit 49129b2, the
benchmark's plain reference; the program's copy may change, this one does not.

Quaternion / SO(3) / SE(3) primitives (port of `splat_tpu/ops/se3.py`).

Unit quaternions are (w, x, y, z). Camera-to-world poses are OpenCV
(+z forward). The pose advance is the method's first-order motion model

    R(t) = R0 @ exp([omega]_x * t)          p(t) = p0 + R0 @ (v * t)

with (v, omega) camera-frame velocities. Matrix products here stay full f32:
on CUDA the port requires `torch.backends.cuda.matmul.allow_tf32 == False`.
"""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) (..., 4) to unit norm."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz, w >= 0.

    Branch-free Shepperd's method: all four candidates, keyed by the largest
    diagonal-based magnitude."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]_x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues' formula: axis-angle (..., 3) -> rotation (..., 3, 3),
    with a series branch near theta = 0 so it is differentiable there."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + eps * eps)
    small = theta2 < eps
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=eps * eps))
    K = skew(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * torch.matmul(K, K)


def so3_left_jacobian(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exact SO(3) left Jacobian V(w) = I + (1-cos t)/t^2 [w]x + (t-sin t)/t^3 [w]x^2,
    the translation coupling of the SE(3) exponential. Series branch near 0,
    evaluated at a safe theta so the exact branch's backward stays finite."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta_safe - torch.sin(theta_safe)) / (theta2_safe * theta_safe))
    K = skew(w)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * torch.matmul(K, K)


def so3_log(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    scale = torch.where(theta < eps, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * sin_t, min=eps))
    return v * scale[..., None]


def se3_advance_c2w(
    R0: torch.Tensor, p0: torch.Tensor, v: torch.Tensor, omega: torch.Tensor,
    t: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance a c2w pose (R0 (...,3,3), p0 (...,3)) by camera-frame velocities
    (v, omega (...,3)) over time t (scalar or broadcastable)."""
    t = torch.as_tensor(t, dtype=R0.dtype, device=R0.device)
    Rt = torch.matmul(R0, so3_exp(omega * t[..., None]))
    pt = p0 + torch.einsum("...ij,...j->...i", R0, v * t[..., None])
    return Rt, pt


def pose_delta_so3xr3(
    R: torch.Tensor, p: torch.Tensor, phi: torch.Tensor, dp: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """SO3xR3 pose correction: R' = exp([phi]_x) @ R, p' = p + dp."""
    return torch.matmul(so3_exp(phi), R), p + dp
