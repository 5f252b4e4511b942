"""Seed points for a scene with known poses: SIFT matches triangulated pair by pair.

A copy of the JAX package's `data/seedpoints.py`: SIFT keypoints on the
training images, brute-force cross-checked matching over every image pair,
closed-form midpoint triangulation of each pair's matched rays (the whole
pair in one batch), a reprojection gate (10 px by default) and per-point
colours. The triangulation and reprojection are numpy; the features come
from OpenCV (`cv2`), imported where `generate_seed_points` runs, as the JAX
module does. Without `cv2` it raises ImportError; there is no other feature
detector to fall back on.

Conventions: poses are OpenGL c2w (the camera looks along -z); a point
projects to u = x / -z fl_x + cx, v = -y / -z fl_y + cy.
"""
from __future__ import annotations

import numpy as np


def _dirs_from_pixels(pts: np.ndarray, intr: dict) -> np.ndarray:
    """Pixel coordinates (M, 2) -> unit ray directions in the GL camera frame (M, 3)."""
    px = (pts[:, 0] - intr["cx"]) / intr["fl_x"]
    py = -(pts[:, 1] - intr["cy"]) / intr["fl_y"]
    h = np.stack([px, py, -np.ones_like(px)], axis=-1)
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoints of the closest approach of ray pairs. o*: (3,), d*: (M, 3)."""
    # [d1, -d2] [s; t] = o2 - o1 in least squares, the 2x2 normal equations in closed form
    b = (o2 - o1)[None, :]
    a11 = np.sum(d1 * d1, axis=-1)
    a12 = -np.sum(d1 * d2, axis=-1)
    a22 = np.sum(d2 * d2, axis=-1)
    r1 = np.sum(d1 * b, axis=-1)
    r2 = -np.sum(d2 * b, axis=-1)
    det = a11 * a22 - a12 * a12
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    s = (r1 * a22 - r2 * a12) / det
    t = (a11 * r2 - a12 * r1) / det
    p1 = o1[None, :] + s[:, None] * d1
    p2 = o2[None, :] + t[:, None] * d2
    return 0.5 * (p1 + p2)


def reproject_gl(points: np.ndarray, c2w: np.ndarray, intr: dict):
    """(M, 3) world points -> (M, 2) pixels and whether each is in front of the camera."""
    p_cam = (points - c2w[:3, 3]) @ c2w[:3, :3]
    z = -p_cam[:, 2]
    ok = z > 1e-6
    z_safe = np.where(ok, z, 1.0)
    u = p_cam[:, 0] / z_safe * intr["fl_x"] + intr["cx"]
    v = -p_cam[:, 1] / z_safe * intr["fl_y"] + intr["cy"]
    return np.stack([u, v], axis=-1), ok


def triangulate_pair(kp1: np.ndarray, kp2: np.ndarray, c2w1: np.ndarray, c2w2: np.ndarray,
                     intr: dict, max_reproj_px: float = 10.0):
    """Matched pixels (M, 2) in two views -> (the kept points (K, 3), the keep mask (M,))."""
    d1 = _dirs_from_pixels(kp1, intr) @ c2w1[:3, :3].T
    d2 = _dirs_from_pixels(kp2, intr) @ c2w2[:3, :3].T
    pts = triangulate_midpoint(c2w1[:3, 3], d1, c2w2[:3, 3], d2)
    rp1, ok1 = reproject_gl(pts, c2w1, intr)
    rp2, ok2 = reproject_gl(pts, c2w2, intr)
    err = np.maximum(np.linalg.norm(rp1 - kp1, axis=-1), np.linalg.norm(rp2 - kp2, axis=-1))
    keep = ok1 & ok2 & (err <= max_reproj_px)
    return pts[keep], keep


def _import_cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("generate_seed_points needs OpenCV (cv2) for its SIFT features; "
                          "install opencv-python, or give the scene a sparse_pc.ply "
                          "(from COLMAP's points3D.txt)") from e
    return cv2


def generate_seed_points(images: list[np.ndarray], poses_c2w_gl: list[np.ndarray], intr: dict,
                         max_reproj_px: float = 10.0, max_keypoints: int = 4000) -> np.ndarray:
    """Every pair's SIFT matches, triangulated. Returns (N, 6) xyz and rgb (0-255)."""
    cv2 = _import_cv2()
    sift = cv2.SIFT_create(nfeatures=max_keypoints)
    feats = []
    for img in images:
        img8 = img if img.dtype == np.uint8 else (np.clip(img, 0, 1) * 255).astype(np.uint8)
        gray = cv2.cvtColor(img8, cv2.COLOR_RGB2GRAY) if img8.ndim == 3 else img8
        kp, desc = sift.detectAndCompute(gray, None)
        feats.append((kp, desc, img8))

    matcher = cv2.BFMatcher(cv2.NORM_L2, crossCheck=True)
    out = []
    n = len(images)
    for i in range(n):
        kpi, di, imgi = feats[i]
        if di is None:
            continue
        for j in range(i + 1, n):
            kpj, dj, _ = feats[j]
            if dj is None:
                continue
            matches = matcher.match(di, dj)
            if not matches:
                continue
            p1 = np.array([kpi[m.queryIdx].pt for m in matches])
            p2 = np.array([kpj[m.trainIdx].pt for m in matches])
            pts, keep = triangulate_pair(p1, p2, np.asarray(poses_c2w_gl[i]),
                                         np.asarray(poses_c2w_gl[j]), intr, max_reproj_px)
            if len(pts) == 0:
                continue
            cols = []
            for m, k in zip(matches, keep):
                if not k:
                    continue
                x, y = kpi[m.queryIdx].pt
                c = imgi[int(y), int(x)]
                cols.append(c[:3] if c.ndim else [c, c, c])
            out.append(np.concatenate([pts, np.asarray(cols, dtype=np.float64)], axis=1))
    if not out:
        return np.zeros((0, 6))
    return np.concatenate(out, axis=0)
