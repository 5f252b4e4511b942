"""COLMAP text model -> the benchmark's `transforms.json` and `sparse_pc.ply`.

A copy of the JAX package's `data/colmap_io.py` (numpy only): reads a COLMAP
TXT model (`cameras.txt`, `images.txt`, `points3D.txt`), turns each image's
world-to-camera quaternion and translation (OpenCV axes, +z forward) into an
OpenGL camera-to-world `transform_matrix`, writes the intrinsics (with
Brown-Conrady distortion where the camera model has it), the
`applied_transform` it applied to COLMAP's world, and the seed cloud.

`APPLIED_TRANSFORM` is nerfstudio's world change ([0,1,0; 1,0,0; 0,0,-1]: x
and y swapped, z negated); it is recorded in `transforms.json` so that
consumers can undo it.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

APPLIED_TRANSFORM = np.array(
    [[0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0]]
)

# camera axes OpenCV (+z forward, y down) -> OpenGL (-z forward, y up)
_FLIP = np.diag([1.0, -1.0, -1.0])


def _quat_to_R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def parse_cameras_txt(path: Path) -> dict:
    """The first camera's intrinsics (one camera per model, as COLMAP is run
    with a single camera)."""
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        model = parts[1]
        w, h = int(parts[2]), int(parts[3])
        p = [float(v) for v in parts[4:]]
        intr = {"w": w, "h": h, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            intr.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
            if model == "SIMPLE_RADIAL":
                intr["k1"] = p[3]
        elif model == "PINHOLE":
            intr.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
        elif model in ("OPENCV", "FULL_OPENCV"):
            intr.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                        k1=p[4], k2=p[5], p1=p[6], p2=p[7])
        elif model == "RADIAL":
            intr.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
        else:
            raise ValueError(f"unsupported COLMAP camera model {model}")
        return intr
    raise ValueError(f"no camera found in {path}")


def _is_pose_line(parts: list[str]) -> bool:
    """IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME: the name is not a number;
    the 2D-point lines that follow are all numbers (or empty)."""
    if len(parts) < 10:
        return False
    try:
        float(parts[9])
        return False
    except ValueError:
        return True


def parse_images_txt(path: Path) -> list[dict]:
    """Every registered image as a frame with an OpenGL c2w in the applied
    world, sorted by file path."""
    frames = []
    lines = [ln for ln in path.read_text().splitlines() if ln.strip() and not ln.startswith("#")]
    applied = np.vstack([APPLIED_TRANSFORM, [0, 0, 0, 1]])
    for line in lines:
        parts = line.split()
        if not _is_pose_line(parts):
            continue
        q = [float(v) for v in parts[1:5]]
        t = np.array([float(v) for v in parts[5:8]])
        name = parts[9]
        R_c2w = _quat_to_R(q).T
        c2w = np.eye(4)
        c2w[:3, :3] = R_c2w @ _FLIP
        c2w[:3, 3] = -R_c2w @ t
        c2w = applied @ c2w
        frames.append({"file_path": f"./images/{name}", "transform_matrix": c2w.tolist(),
                       "colmap_im_id": int(parts[0])})
    frames.sort(key=lambda f: f["file_path"])
    return frames


def parse_points3d_txt(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) float32 points in the applied world and (N, 3) uint8 colours."""
    xyz, rgb = [], []
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        xyz.append([float(v) for v in parts[1:4]])
        rgb.append([int(v) for v in parts[4:7]])
    xyz = np.asarray(xyz, dtype=np.float64)
    if len(xyz):
        xyz = xyz @ APPLIED_TRANSFORM[:3, :3].T + APPLIED_TRANSFORM[:3, 3]
    return xyz.astype(np.float32), np.asarray(rgb, dtype=np.uint8)


def colmap_text_to_transforms(text_dir: Path, out_dir: Path) -> dict:
    """Write OUT_DIR/transforms.json (and sparse_pc.ply when the model has
    points3D.txt) from the text model in TEXT_DIR; returns the metadata."""
    from .ply import write_ply

    text_dir, out_dir = Path(text_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    intr = parse_cameras_txt(text_dir / "cameras.txt")
    frames = parse_images_txt(text_dir / "images.txt")
    meta = {**intr, "applied_transform": APPLIED_TRANSFORM.tolist(),
            "ply_file_path": "./sparse_pc.ply", "frames": frames}
    pts_path = text_dir / "points3D.txt"
    if pts_path.exists():
        xyz, rgb = parse_points3d_txt(pts_path)
        write_ply(out_dir / "sparse_pc.ply", xyz, rgb)
    (out_dir / "transforms.json").write_text(json.dumps(meta, indent=4))
    return meta
