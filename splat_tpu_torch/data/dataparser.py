"""A parsed scene (port of the `ParsedScene` dataclass of
`splat_tpu/data/dataparser.py`).

The trainer reads its cameras, image paths and seed cloud from this. The
parser that builds one from a nerfstudio `transforms.json` or a COLMAP model
comes with the data slice; until then `models.convert.scene_from_numpy`
builds one from arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..cameras.cameras import Cameras


@dataclasses.dataclass
class ParsedScene:
    train_cameras: Cameras
    eval_cameras: Cameras
    train_paths: list[str]
    eval_paths: list[str]
    train_indices: np.ndarray          # indices into the original frame list
    eval_indices: np.ndarray
    points_xyz: np.ndarray | None      # seed cloud (world frame)
    points_rgb: np.ndarray | None
    transform: np.ndarray              # (3, 4) dataparser transform
    scale: float
    metadata: dict
