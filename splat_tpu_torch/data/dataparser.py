"""transforms.json dataparser (port of `splat_tpu/data/dataparser.py`): the
reference data contract, exactly. The numpy part is the JAX package's line for
line; the cameras are built on the CPU as this package's `Cameras` (the
trainer moves them to its device), so parsing needs no card.

Equivalent of nerfstudio's `NerfstudioDataParser` plus the 3dgs-deblur fork's
extensions (SURVEY.md §2b row dataparsers, §6b normative contract):

  top-level: w h cx cy fl_x fl_y k1 k2 p1 p2 [k3] aabb_scale exposure_time
             rolling_shutter_time orientation_override ply_file_path
             [applied_transform] frames[]
  per frame: file_path, transform_matrix (4x4 OpenGL c2w),
             camera_linear_velocity / camera_angular_velocity (camera-frame,
             scene-units/s, rad/s), optional motion_blur_score,
             optional per-frame intrinsics / exposure_time overrides.

Handles: eval modes all | interval | filename (reference train.py:164-177),
orientation/centering/auto-scale (with `orientation_override` honored), the
`applied_transform` plumbing and `dataparser_transforms.json` export consumed by
the video renderer (reference render_video.py:134-148), and velocity rescaling
when poses are rescaled — linear only (reference combine.py:96-101).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

import torch

from ..cameras.cameras import Cameras


@dataclasses.dataclass(frozen=True)
class DataParserConfig:
    eval_mode: str = "interval"        # all | interval | filename | fraction
    eval_interval: int = 8
    train_split_fraction: float = 0.9
    orientation_method: str = "up"     # up | pca | none (json orientation_override wins)
    center_method: str = "poses"       # poses | none
    auto_scale_poses: bool = True
    downscale_factor: int = 1


@dataclasses.dataclass
class ParsedScene:
    train_cameras: Cameras
    eval_cameras: Cameras
    train_paths: list[str]
    eval_paths: list[str]
    train_indices: np.ndarray          # indices into the original frame list
    eval_indices: np.ndarray
    points_xyz: np.ndarray | None      # seed cloud (internal/world frame)
    points_rgb: np.ndarray | None
    transform: np.ndarray              # (3,4) dataparser transform (incl. applied_transform)
    scale: float
    metadata: dict


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:  # opposite: rotate around any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return -np.eye(3) + 2 * np.outer(axis, axis)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1 + c)


def auto_orient_and_center(
    poses: np.ndarray, orientation: str, center: str
) -> tuple[np.ndarray, np.ndarray]:
    """poses (N,4,4) OpenGL c2w -> (oriented poses, (3,4) transform applied)."""
    t = np.eye(4)
    if center == "poses":
        t[:3, 3] = -poses[:, :3, 3].mean(axis=0)
    if orientation == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up /= np.linalg.norm(up)
        t[:3, :3] = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
        t[:3, 3] = t[:3, :3] @ t[:3, 3]
    elif orientation == "pca":
        pts = poses[:, :3, 3] + t[:3, 3]
        _, _, vh = np.linalg.svd(pts - pts.mean(axis=0), full_matrices=False)
        rot = vh
        if np.linalg.det(rot) < 0:
            rot[2] *= -1
        t[:3, :3] = rot
        t[:3, 3] = rot @ t[:3, 3]
    elif orientation != "none":
        raise ValueError(f"unknown orientation method {orientation!r}")
    new_poses = np.einsum("ij,njk->nik", t, poses)
    return new_poses, t[:3]


def parse_scene(data_dir: str | Path, config: DataParserConfig = DataParserConfig()) -> ParsedScene:
    data_dir = Path(data_dir)
    meta = json.loads((data_dir / "transforms.json").read_text())
    frames = meta["frames"]
    n = len(frames)
    if n == 0:
        raise ValueError(f"{data_dir}: transforms.json has no frames")

    poses = np.array([f["transform_matrix"] for f in frames], dtype=np.float64)  # GL c2w

    def intr(key, default=None):
        vals = [f.get(key, meta.get(key, default)) for f in frames]
        if any(v is None for v in vals):
            raise ValueError(f"{data_dir}: missing intrinsic {key}")
        return np.array(vals, dtype=np.float64)

    fx, fy = intr("fl_x"), intr("fl_y")
    cx, cy = intr("cx"), intr("cy")
    width = int(frames[0].get("w", meta.get("w")))
    height = int(frames[0].get("h", meta.get("h")))

    lin_vel = np.array(
        [f.get("camera_linear_velocity", [0.0, 0.0, 0.0]) for f in frames], dtype=np.float64
    )
    ang_vel = np.array(
        [f.get("camera_angular_velocity", [0.0, 0.0, 0.0]) for f in frames], dtype=np.float64
    )
    exposure = np.array(
        [f.get("exposure_time", meta.get("exposure_time", 0.0)) for f in frames],
        dtype=np.float64,
    )
    rs_time = np.array(
        [f.get("rolling_shutter_time", meta.get("rolling_shutter_time", 0.0)) for f in frames],
        dtype=np.float64,
    )
    blur_score = np.array([f.get("motion_blur_score", np.nan) for f in frames])

    # Orientation / centering / scaling (orientation_override in the json wins,
    # matching the fork converters that emit e.g. "none").
    orientation = meta.get("orientation_override", config.orientation_method)
    poses, t34 = auto_orient_and_center(poses, orientation, config.center_method)
    scale = 1.0
    if config.auto_scale_poses:
        scale = float(1.0 / max(np.abs(poses[:, :3, 3]).max(), 1e-8))
    poses[:, :3, 3] *= scale
    # Camera-frame linear velocities rescale with the scene; angular do not.
    lin_vel = lin_vel * scale

    # applied_transform: maps ORIGINAL data frame -> the saved json frame; the
    # exported dataparser transform must include it (render_video.py:134-148).
    applied = np.array(meta.get("applied_transform", np.eye(4)[:3].tolist()), dtype=np.float64)
    applied4 = np.eye(4)
    applied4[:3] = applied
    t4 = np.eye(4)
    t4[:3] = t34
    export_transform = (t4 @ applied4)[:3]

    # Train/eval split.
    idx = np.arange(n)
    names = [Path(f["file_path"]).name for f in frames]
    if config.eval_mode == "all":
        train_idx, eval_idx = idx, idx
    elif config.eval_mode == "interval":
        k = config.eval_interval
        eval_idx = idx[idx % k == 0]
        train_idx = idx[idx % k != 0]
    elif config.eval_mode == "filename":
        is_eval = np.array([nm.startswith("eval_") for nm in names])
        eval_idx = idx[is_eval]
        train_idx = idx[~is_eval]
        if len(eval_idx) == 0:
            raise ValueError(f"{data_dir}: eval_mode=filename but no eval_* files")
    elif config.eval_mode == "fraction":
        n_train = int(round(n * config.train_split_fraction))
        train_idx = np.linspace(0, n - 1, n_train, dtype=int)
        eval_idx = np.setdiff1d(idx, train_idx)
    else:
        raise ValueError(f"unknown eval_mode {config.eval_mode!r}")

    # Downscale support (reference num-downscales/progressive res analogue).
    d = config.downscale_factor
    if d != 1:
        fx, fy, cx, cy = fx / d, fy / d, cx / d, cy / d
        width, height = width // d, height // d

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32))

    def build_cameras(sel: np.ndarray) -> Cameras:
        R_cv, p = Cameras.gl_to_cv_c2w(f32(poses[sel]))
        return Cameras(
            R_c2w=R_cv,
            p_c2w=p,
            fx=f32(fx[sel]),
            fy=f32(fy[sel]),
            cx=f32(cx[sel]),
            cy=f32(cy[sel]),
            width=width,
            height=height,
            lin_vel=Cameras.vel_gl_to_cv(f32(lin_vel[sel])),
            ang_vel=Cameras.vel_gl_to_cv(f32(ang_vel[sel])),
            exposure_time=f32(exposure[sel]),
            rolling_shutter_time=f32(rs_time[sel]),
            cam_idx=torch.tensor(np.asarray(sel, dtype=np.int64)),
        )

    # Seed point cloud, transformed into the internal frame.
    points_xyz = points_rgb = None
    ply_rel = meta.get("ply_file_path")
    if ply_rel is not None and (data_dir / ply_rel).exists():
        from . import ply as ply_io

        cloud = ply_io.read_ply(data_dir / ply_rel)
        pts = cloud["xyz"].astype(np.float64)
        pts = pts @ t34[:3, :3].T + t34[:3, 3]
        points_xyz = (pts * scale).astype(np.float32)
        points_rgb = cloud["rgb"]

    paths = [str(data_dir / f["file_path"]) for f in frames]
    return ParsedScene(
        train_cameras=build_cameras(train_idx),
        eval_cameras=build_cameras(eval_idx),
        train_paths=[paths[i] for i in train_idx],
        eval_paths=[paths[i] for i in eval_idx],
        train_indices=train_idx,
        eval_indices=eval_idx,
        points_xyz=points_xyz,
        points_rgb=points_rgb,
        transform=export_transform,
        scale=scale,
        metadata={
            "blur_score": blur_score,
            "distortion": {k: meta.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")},
            "downscale_factor": d,
            "num_frames": n,
        },
    )


def save_dataparser_transforms(path: str | Path, scene: ParsedScene) -> None:
    """Write dataparser_transforms.json (checkpoint-dir contract, SURVEY.md §5)."""
    Path(path).write_text(
        json.dumps({"transform": scene.transform.tolist(), "scale": scene.scale}, indent=2)
    )
