"""Spline camera paths for video rendering (port of `splat_tpu/cameras/paths.py`).

Interpolates key camera poses into a smooth path (Kochanek-Bartels curves)
and derives per-frame camera-frame velocities by central finite differences,
so the renderer can simulate motion blur and rolling shutter along the path.

Positions use standard TCB (Kochanek-Bartels) cubic Hermite interpolation;
orientations use component-wise KB on sign-canonicalized quaternions plus
renormalization (a small-angle approximation of the quaternion KB spline that
is indistinguishable for smooth camera paths). The spline is numpy float64;
the rotation <-> quaternion conversions and the SO(3) log go through
`ops/se3.py` on float32 CPU tensors, as the JAX package rounds them through
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import se3


def _se3_f32(fn, a: np.ndarray) -> np.ndarray:
    """fn of `a` rounded to float32, on the CPU, back as numpy."""
    return fn(torch.as_tensor(np.asarray(a), dtype=torch.float32)).numpy()


def _kb_tangents(points: np.ndarray, tension=0.0, continuity=0.0, bias=0.0):
    """Incoming/outgoing tangents for Kochanek-Bartels splines. points (N, D)."""
    pad = np.concatenate([points[:1], points, points[-1:]], axis=0)
    d_prev = pad[1:-1] - pad[:-2]      # P_i - P_{i-1}
    d_next = pad[2:] - pad[1:-1]       # P_{i+1} - P_i
    a = (1 - tension) * (1 + bias) * (1 + continuity) / 2
    b = (1 - tension) * (1 - bias) * (1 - continuity) / 2
    c = (1 - tension) * (1 + bias) * (1 - continuity) / 2
    d = (1 - tension) * (1 - bias) * (1 + continuity) / 2
    incoming = a * d_prev + b * d_next
    outgoing = c * d_prev + d * d_next
    return incoming, outgoing


def _hermite(p0, p1, m0, m1, t):
    t = np.asarray(t)[..., None]
    t2, t3 = t * t, t * t * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1


class KochanekBartelsSpline:
    """Uniform-knot TCB spline over (N, D) control points, domain [0, N-1]."""

    def __init__(self, points: np.ndarray, tension=0.0, continuity=0.0, bias=0.0):
        self.points = np.asarray(points, dtype=np.float64)
        self.inc, self.out = _kb_tangents(self.points, tension, continuity, bias)

    def __call__(self, u: np.ndarray) -> np.ndarray:
        u = np.clip(np.asarray(u, dtype=np.float64), 0.0, len(self.points) - 1 - 1e-9)
        seg = np.floor(u).astype(int)
        t = u - seg
        p0, p1 = self.points[seg], self.points[seg + 1]
        m0, m1 = self.out[seg], self.inc[seg + 1]
        return _hermite(p0, p1, m0, m1, t)


class PoseSpline:
    """Smooth SE(3) path through key c2w poses (4x4, any convention)."""

    def __init__(self, poses: np.ndarray, tension=0.0, continuity=0.0, bias=0.0):
        poses = np.asarray(poses, dtype=np.float64)
        self.pos_spline = KochanekBartelsSpline(poses[:, :3, 3], tension, continuity, bias)
        quats = np.array(_se3_f32(se3.rotmat_to_quat, poses[:, :3, :3]))
        # sign-canonicalize consecutive quats to the same hemisphere
        for i in range(1, len(quats)):
            if np.dot(quats[i], quats[i - 1]) < 0:
                quats[i] = -quats[i]
        self.quat_spline = KochanekBartelsSpline(quats, tension, continuity, bias)
        self.n = len(poses)

    def __call__(self, u) -> np.ndarray:
        """u in [0, n-1] (scalar or (M,)) -> (.., 4, 4) c2w."""
        u = np.atleast_1d(u)
        pos = self.pos_spline(u)
        q = self.quat_spline(u)
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        R = _se3_f32(se3.quat_to_rotmat, q)
        out = np.tile(np.eye(4), (len(u), 1, 1))
        out[:, :3, :3] = R
        out[:, :3, 3] = pos
        return out


def path_velocities_gl(pose_at, u: float, du: float = 1e-3, time_scale: float = 1.0):
    """Camera-frame velocities (GL axes) at path parameter u via central
    differences. time_scale converts path parameter units to seconds
    (du_per_second)."""
    m0 = pose_at(u - du)[0]
    m1 = pose_at(u + du)[0]
    mm = pose_at(u)[0]
    v_world = (m1[:3, 3] - m0[:3, 3]) / (2 * du) * time_scale
    v_cam = mm[:3, :3].T @ v_world
    dR = m0[:3, :3].T @ m1[:3, :3]
    w = _se3_f32(se3.so3_log, dR[None])[0] / (2 * du) * time_scale
    return v_cam, w


def look_at(position: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL c2w look-at."""
    z = position - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, position
    return m
