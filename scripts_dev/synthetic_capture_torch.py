"""What a phone capture's tools would write for a generated scene.

The real-capture pipeline starts from two external tools: the VIO
(`sai-cli process`), which writes a `transforms.json` with poses,
camera-frame velocities and blur scores in its own world frame, and COLMAP,
whose text model (`cameras.txt`, `images.txt`, `points3D.txt`) holds the
same frames' poses in another frame, at another scale. Neither binary ships
with the port, so this module writes both from a scene directory of
`splat_tpu_torch/data/synthetic.py` (whose `transforms.json` is already in the VIO's
layout), with COLMAP's world a similarity transform of the VIO's:

    x_colmap = s R x_vio + t.

`write_vio_dir` writes the VIO's directory, `write_colmap_text` the text
model, and `vio_pose` takes a pose of the merged dataset (COLMAP's world
after `data/colmap_io.APPLIED_TRANSFORM`) back to the VIO's world, for the
checks that the merge kept the geometry.

It is a fixture of `chip_smoke.py`'s capture phase and of
`tests/test_torch_pipelines.py`, imported by its path; no entry point of the
package runs it.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from splat_tpu_torch.data.colmap_io import APPLIED_TRANSFORM

# camera axes OpenGL (-z forward, y up) <-> OpenCV (+z forward, y down)
_FLIP = np.diag([1.0, -1.0, -1.0])


def similarity(seed: int = 0) -> tuple[float, np.ndarray, np.ndarray]:
    """A scale in [0.5, 2], a random rotation and a translation of a few units."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    return float(rng.uniform(0.5, 2.0)), _quat_to_matrix(q), rng.uniform(-3.0, 3.0, 3)


def _quat_to_matrix(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """(w, x, y, z) with w >= 0 of a rotation matrix (Shepperd's method)."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    q /= np.linalg.norm(q)
    return -q if q[0] < 0 else q


def write_vio_dir(scene_dir: Path, vio_dir: Path) -> dict:
    """The VIO's directory: the scene's images and its `transforms.json` with
    `sai-cli`'s relative file paths (`images/NAME`). Returns the metadata."""
    scene_dir, vio_dir = Path(scene_dir), Path(vio_dir)
    meta = json.loads((scene_dir / "transforms.json").read_text())
    for f in meta["frames"]:
        f["file_path"] = "images/" + Path(f["file_path"]).name
        if "motion_blur_score" not in f:
            raise ValueError(f"{scene_dir}: frame {f['file_path']} has no motion_blur_score")
    if vio_dir.exists():
        shutil.rmtree(vio_dir)
    shutil.copytree(scene_dir / "images", vio_dir / "images")
    (vio_dir / "transforms.json").write_text(json.dumps(meta, indent=4))
    return meta


def write_colmap_text(scene_dir: Path, text_dir: Path, xyz: np.ndarray, rgb: np.ndarray,
                      sim: tuple[float, np.ndarray, np.ndarray]) -> None:
    """COLMAP's text model of the scene's frames and the points (xyz in the
    VIO's world, rgb 0-255), all in COLMAP's world x_c = s R x + t: one
    PINHOLE camera, each frame's world-to-camera quaternion (w first, w >= 0)
    and translation in OpenCV axes, and one 2D point per image line."""
    s, R, t = sim
    scene_dir, text_dir = Path(scene_dir), Path(text_dir)
    meta = json.loads((scene_dir / "transforms.json").read_text())
    text_dir.mkdir(parents=True, exist_ok=True)
    (text_dir / "cameras.txt").write_text(
        "# Camera list with one line of data per camera:\n"
        "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
        f"1 PINHOLE {meta['w']} {meta['h']} {meta['fl_x']!r} {meta['fl_y']!r} "
        f"{meta['cx']!r} {meta['cy']!r}\n")
    lines = ["# Image list with two lines of data per image:",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for i, f in enumerate(meta["frames"], start=1):
        c2w = np.asarray(f["transform_matrix"], dtype=np.float64)
        r_c2w = R @ c2w[:3, :3] @ _FLIP               # COLMAP's world, OpenCV axes
        p = s * (R @ c2w[:3, 3]) + t
        r_w2c = r_c2w.T
        q, tr = matrix_to_quat(r_w2c), -r_w2c @ p
        lines.append(f"{i} " + " ".join(repr(float(v)) for v in (*q, *tr))
                     + f" 1 {Path(f['file_path']).name}")
        lines.append(f"{meta['cx']!r} {meta['cy']!r} -1")
    (text_dir / "images.txt").write_text("\n".join(lines) + "\n")
    xc = s * (np.asarray(xyz, np.float64) @ R.T) + t
    rgb = np.asarray(rgb).astype(np.int64)
    body = "\n".join(f"{i} {x!r} {y!r} {z!r} {r} {g} {b} 0.5"
                     for i, ((x, y, z), (r, g, b)) in enumerate(zip(xc.tolist(), rgb.tolist()),
                                                                start=1))
    (text_dir / "points3D.txt").write_text(
        "# 3D point list with one line of data per point:\n"
        "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        + body + "\n")


def vio_pose(c2w: np.ndarray, sim: tuple[float, np.ndarray, np.ndarray]) -> np.ndarray:
    """A c2w of the merged dataset (COLMAP's world after APPLIED_TRANSFORM)
    in the VIO's world."""
    s, R, t = sim
    a = APPLIED_TRANSFORM[:3, :3]
    c2w = np.asarray(c2w, dtype=np.float64)
    out = np.eye(4)
    out[:3, :3] = R.T @ a.T @ c2w[:3, :3]
    out[:3, 3] = R.T @ (a.T @ c2w[:3, 3] - t) / s
    return out


def world_rotation(sim: tuple[float, np.ndarray, np.ndarray]) -> np.ndarray:
    """The rotation from the VIO's world to the merged dataset's."""
    return APPLIED_TRANSFORM[:3, :3] @ sim[1]
