"""Learnable camera pose and velocity corrections (port of
`splat_tpu/cameras/optimizers.py`).

  * SO3xR3: R' = exp([phi]_x) R,  p' = p + dp            (per camera)
  * SE3:    R' = exp([phi]_x) R,  p' = p + V(phi) dp     (exact left Jacobian)
  * velocity: v' = prior + dv, omega' = prior_omega + dom; with
    `zero_initial_velocities` the prior is dropped and (dv, dom) are absolute.

Parameters are plain dicts of tensors, routed by `Cameras.cam_idx` through a
one-hot weighted sum, whose backward is dense too: no scatter-add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import se3
from .cameras import Cameras

MODES = ("off", "SO3xR3", "SE3")


@dataclasses.dataclass(frozen=True)
class CameraOptConfig:
    mode: str = "off"            # off | SO3xR3 | SE3
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3


@dataclasses.dataclass(frozen=True)
class VelocityOptConfig:
    enabled: bool = False
    zero_initial_velocities: bool = False
    lin_l2_penalty: float = 0.0
    ang_l2_penalty: float = 0.0
    # symmetry-breaking noise for zero-init: at v = 0 with symmetric blur
    # sample times dL/dv vanishes, a saddle a deterministic optimizer never leaves
    init_noise: float = 1e-4


def init_camera_opt_params(num_cameras: int, cfg: CameraOptConfig,
                           device: torch.device | str, dtype=torch.float32) -> dict[str, torch.Tensor]:
    if cfg.mode == "off":
        return {}
    if cfg.mode not in MODES:
        raise ValueError(f"unknown camera optimizer mode {cfg.mode!r}")
    return {
        "phi": torch.zeros((num_cameras, 3), dtype=dtype, device=device),
        "dp": torch.zeros((num_cameras, 3), dtype=dtype, device=device),
    }


def init_velocity_opt_params(num_cameras: int, cfg: VelocityOptConfig,
                             device: torch.device | str, dtype=torch.float32,
                             seed: int = 0) -> dict[str, torch.Tensor]:
    """Zeros, or with zero-init the JAX package's seeded numpy noise (same
    seed, same values)."""
    if not cfg.enabled:
        return {}
    if cfg.zero_initial_velocities and cfg.init_noise > 0:
        rng = np.random.default_rng(seed)
        dv = rng.normal(size=(num_cameras, 3)) * cfg.init_noise
        dom = rng.normal(size=(num_cameras, 3)) * cfg.init_noise
        return {"dv": torch.as_tensor(dv, dtype=dtype, device=device),
                "dom": torch.as_tensor(dom, dtype=dtype, device=device)}
    return {
        "dv": torch.zeros((num_cameras, 3), dtype=dtype, device=device),
        "dom": torch.zeros((num_cameras, 3), dtype=dtype, device=device),
    }


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as a one-hot weighted sum over the table's rows: exact for
    finite tables (no TF32 rounding can enter), and its gradient is a dense
    product rather than an accumulating index_put_."""
    onehot = torch.nn.functional.one_hot(idx.long(), table.shape[0]).to(table.dtype)
    return (onehot[..., None] * table).sum(dim=-2)


def apply_camera_opt(cameras: Cameras, params: dict[str, torch.Tensor],
                     cfg: CameraOptConfig) -> Cameras:
    """Apply per-camera pose corrections, routed by cam_idx."""
    if cfg.mode == "off" or not params:
        return cameras
    phi = _rows(params["phi"], cameras.cam_idx)
    dp = _rows(params["dp"], cameras.cam_idx)
    if cfg.mode == "SO3xR3":
        R, p = se3.pose_delta_so3xr3(cameras.R_c2w, cameras.p_c2w, phi, dp)
    elif cfg.mode == "SE3":
        V = se3.so3_left_jacobian(phi)
        R = torch.matmul(se3.so3_exp(phi), cameras.R_c2w)
        p = cameras.p_c2w + torch.einsum("...ij,...j->...i", V, dp)
    else:
        raise ValueError(cfg.mode)
    return dataclasses.replace(cameras, R_c2w=R, p_c2w=p)


def apply_velocity_opt(cameras: Cameras, params: dict[str, torch.Tensor],
                       cfg: VelocityOptConfig) -> Cameras:
    """Apply per-camera velocity corrections (or absolute learned velocities)."""
    if not cfg.enabled or not params:
        return cameras
    dv = _rows(params["dv"], cameras.cam_idx)
    dom = _rows(params["dom"], cameras.cam_idx)
    if cfg.zero_initial_velocities:
        lin, ang = dv, dom
    else:
        lin, ang = cameras.lin_vel + dv, cameras.ang_vel + dom
    return dataclasses.replace(cameras, lin_vel=lin, ang_vel=ang)


def camera_opt_penalty(params: dict[str, torch.Tensor], cfg: CameraOptConfig,
                       device: torch.device | str | None = None) -> torch.Tensor:
    """L2 penalty on the pose deltas: trans * sum(dp^2) + rot * sum(phi^2)
    (0 on `device` when the optimizer is off)."""
    if cfg.mode == "off" or not params:
        return torch.zeros((), device=device)
    return (cfg.trans_l2_penalty * torch.sum(params["dp"] ** 2)
            + cfg.rot_l2_penalty * torch.sum(params["phi"] ** 2))
