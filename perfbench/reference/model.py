"""Frozen copy of the method's plain model code in `splat_tpu_torch` at commit
49129b2: the configuration and parameter containers and the render path of
`models/splatfacto.py` (camera corrections, sub-frame projection and SH,
fused blur anchors, gamma, the loss), the camera batch and corrections of
`cameras/cameras.py` and `cameras/optimizers.py`, and the densification of
`models/strategy.py`. `render_camera` takes the "torch" route of the
compositor (`compositor.py`), never a kernel. The program's copies may
change, this one does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import compositor, projection, se3, sh, tiling
from .ssim import ssim as ssim_fn


_FLIP_YZ = (1.0, -1.0, -1.0)


def _flip(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_FLIP_YZ, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of N cameras; every tensor has leading dim N.

    R_c2w (N,3,3), p_c2w (N,3): OpenCV camera-to-world pose. fx, fy, cx, cy
    (N,): intrinsics in pixels. width, height: ints shared by the batch.
    lin_vel, ang_vel (N,3): camera-frame velocities. exposure_time,
    rolling_shutter_time (N,): seconds. cam_idx (N,): row of each camera in
    the per-camera optimizer parameters."""

    R_c2w: torch.Tensor
    p_c2w: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    lin_vel: torch.Tensor | None = None
    ang_vel: torch.Tensor | None = None
    exposure_time: torch.Tensor | None = None
    rolling_shutter_time: torch.Tensor | None = None
    cam_idx: torch.Tensor | None = None

    def __post_init__(self):
        n = self.R_c2w.shape[0]
        kw = dict(dtype=self.R_c2w.dtype, device=self.R_c2w.device)
        defaults = {
            "lin_vel": lambda: torch.zeros((n, 3), **kw),
            "ang_vel": lambda: torch.zeros((n, 3), **kw),
            "exposure_time": lambda: torch.zeros((n,), **kw),
            "rolling_shutter_time": lambda: torch.zeros((n,), **kw),
            "cam_idx": lambda: torch.arange(n, dtype=torch.int64, device=self.R_c2w.device),
        }
        for name, make in defaults.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, make())
        object.__setattr__(self, "width", int(self.width))
        object.__setattr__(self, "height", int(self.height))

    _tensor_fields = ("R_c2w", "p_c2w", "fx", "fy", "cx", "cy", "lin_vel",
                      "ang_vel", "exposure_time", "rolling_shutter_time", "cam_idx")

    def __len__(self) -> int:
        return self.R_c2w.shape[0]

    def __getitem__(self, i) -> "Cameras":
        """Index or slice the batch; an int index keeps a leading dim of 1."""
        if isinstance(i, int):
            i = slice(i, i + 1) if i != -1 else slice(-1, None)
        return dataclasses.replace(self, **{k: getattr(self, k)[i] for k in self._tensor_fields})

    def w2c(self) -> tuple[torch.Tensor, torch.Tensor]:
        """World-to-camera (R_cw, t_cw): X_cam = R_cw X_world + t_cw."""
        R_cw = self.R_c2w.transpose(-1, -2)
        t_cw = -torch.einsum("...ij,...j->...i", R_cw, self.p_c2w)
        return R_cw, t_cw

    @staticmethod
    def gl_to_cv_c2w(c2w_gl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """OpenGL c2w (..., 4, 4) or (..., 3, 4) -> OpenCV (R, p): columns y, z negate."""
        R = c2w_gl[..., :3, :3] * _flip(c2w_gl)
        return R, c2w_gl[..., :3, 3]

    @staticmethod
    def cv_to_gl_c2w(R_cv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """OpenCV (R, p) -> OpenGL 4x4 c2w."""
        R_gl = R_cv * _flip(R_cv)
        top = torch.cat([R_gl, p[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R_cv.dtype, device=R_cv.device)
        bottom = bottom.expand(R_cv.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def vel_gl_to_cv(v_gl: torch.Tensor) -> torch.Tensor:
        """Camera-frame velocity from OpenGL axes to OpenCV axes."""
        return v_gl * _flip(v_gl)


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


@dataclasses.dataclass(frozen=True)
class SplatfactoConfig:
    blur_samples: int = 5                      # 0 = motion-blur compensation off
    blur_mode: str = "fused"                   # fused | exact
    # anchor poses for fused mode; 0 = auto (resolve_blur_anchors)
    blur_anchors: int = 0
    rolling_shutter_compensation: bool = True
    gamma: float = 2.2
    min_rgb_level: float = 10.0                # black-level floor, 0..255 scale
    background_color: str = "auto"             # auto (learnable) | black | white | random
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    rasterize_mode: str = "antialiased"        # antialiased | classic
    use_scale_regularization: bool = True
    max_gauss_ratio: float = 10.0
    camera_optimizer: CameraOptConfig = CameraOptConfig()
    camera_velocity_optimizer: VelocityOptConfig = VelocityOptConfig()
    optimize_eval_cameras: bool = False
    optimize_eval_velocities: bool = True
    ssim_lambda: float = 0.2
    scale_reg_weight: float = 0.1
    # progressive resolution: train at 1 / 2^k, stepping up every
    # resolution_schedule steps
    num_downscales: int = 0
    resolution_schedule: int = 3000
    # densification schedule
    warmup_length: int = 500
    refine_every: int = 100
    stop_split_at: int = 15000
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    reset_alpha_every: int = 30                # in refinements
    n_split_samples: int = 2
    tile_size: int | tuple[int, int] = 16      # int (square) or (w, h)
    max_per_tile: int = 256                    # per-tile depth-list capacity
    max_tiles_per_gaussian: int = 16           # footprint cap (span^2 tiles)
    max_total_entries: int = 0                 # sorted-stream cap, 0 = off
    # auto: the CUDA kernels on CUDA tensors, their plain versions on CPU;
    # torch: the plain route on any device (to check the kernels against);
    # cuda: the kernels, raising on CPU tensors
    impl: str = "auto"
    initial_capacity: int = 0                  # 0 = auto from seed points
    # a mesh with a gauss axis (parallel/sharding.py): gather the projected
    # table of every shard, or composite depth slabs and merge them
    gauss_shard_mode: str = "gather"           # gather | slab
    slab_slack: float = 2.0                    # slab bucket capacity headroom


class GaussianParams(NamedTuple):
    """Fixed-capacity Gaussian cloud (leading dim = capacity)."""

    means: torch.Tensor            # (C, 3)
    scales_log: torch.Tensor       # (C, 3) log-scale
    quats: torch.Tensor            # (C, 4)
    opacities_logit: torch.Tensor  # (C,)
    features_dc: torch.Tensor      # (C, 3) SH degree-0 coefficients
    features_rest: torch.Tensor    # (C, B-1, 3) higher SH coefficients
    alive: torch.Tensor            # (C,) float 0/1 mask


class ModelParams(NamedTuple):
    gaussians: GaussianParams
    background_logit: torch.Tensor              # (3,) for background_color "auto"
    camera_opt: dict[str, torch.Tensor]         # train-camera pose deltas
    velocity_opt: dict[str, torch.Tensor]       # train-camera velocity deltas
    eval_camera_opt: dict[str, torch.Tensor]    # eval-camera pose deltas
    eval_velocity_opt: dict[str, torch.Tensor]


def subframe_inputs(params: ModelParams, motion: CameraMotion, config: SplatfactoConfig,
                    sh_degree_active, t_s, means2d_probe: torch.Tensor | None = None,
                    row0: int = 0,
                    ) -> tuple[projection.ProjectedGaussians, torch.Tensor]:
    """Projection and view-dependent colours at the pose of exposure time t_s.
    means2d_probe (C, 2), if given, is added to the projected means. row0:
    the means in the coordinates of a row strip starting at image row row0
    (projected into the full image, then moved up by row0: exact for a row0
    below 2^24, so a strip sees every mean where the full image does)."""
    g = params.gaussians
    cam = motion.camera
    Rt, pt = se3.se3_advance_c2w(motion.R0, motion.p0, motion.lin_vel, motion.ang_vel, t_s)
    R_cw = Rt.T
    t_cw = -torch.matmul(R_cw, pt)
    vel = motion.use_motion
    proj = projection.project_gaussians(
        g.means, torch.exp(g.scales_log), g.quats, R_cw, t_cw,
        cam.fx[0], cam.fy[0], cam.cx[0], cam.cy[0], cam.width, cam.height,
        lin_vel=motion.lin_vel if vel else None,
        ang_vel=motion.ang_vel if vel else None,
    )
    if row0:
        shift = torch.tensor([0.0, float(row0)], dtype=proj.means2d.dtype,
                             device=proj.means2d.device)
        proj = proj._replace(means2d=proj.means2d - shift)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    if config.rasterize_mode == "classic":
        proj = proj._replace(compensations=torch.ones_like(proj.compensations))
    dirs = g.means - pt
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    coeffs = torch.cat([g.features_dc[:, None, :], g.features_rest], dim=1)
    return proj, sh_eval_switch(sh_degree_active, config.sh_degree, dirs, coeffs)


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def active_sh_degree(config: SplatfactoConfig, step):
    if isinstance(step, torch.Tensor):
        return torch.clamp(step // config.sh_degree_interval, max=config.sh_degree)
    return min(int(step) // config.sh_degree_interval, config.sh_degree)


def background_color(params: ModelParams, config: SplatfactoConfig,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    dev = params.background_logit.device
    if config.background_color == "auto":
        return torch.sigmoid(params.background_logit)
    if config.background_color == "white":
        return torch.ones(3, device=dev)
    if config.background_color == "random":
        if generator is None:
            raise ValueError("background_color='random' needs a torch.Generator")
        return torch.rand(3, generator=generator, device=dev)
    return torch.zeros(3, device=dev)


def resolve_blur_anchors(config: SplatfactoConfig, cameras: Cameras) -> int:
    """Anchor count for fused blur when config.blur_anchors == 0: the smallest
    A whose per-group rotation over exposure + readout stays under 3 degrees
    (the calibration the JAX package documents), clipped to [1, S]."""
    if config.blur_anchors > 0:
        return config.blur_anchors
    if config.blur_mode != "fused" or config.blur_samples <= 1:
        return 1
    omega = np.linalg.norm(cameras.ang_vel.detach().cpu().numpy(), axis=-1)
    window = (np.abs(cameras.exposure_time.detach().cpu().numpy())
              + np.abs(cameras.rolling_shutter_time.detach().cpu().numpy()))
    max_rot = float(np.max(omega * window)) if omega.size else 0.0
    a = int(np.ceil(max_rot / np.deg2rad(3.0)))
    return int(np.clip(a, 1, config.blur_samples))


def blur_sample_times(camera_exposure: torch.Tensor, config: SplatfactoConfig) -> torch.Tensor:
    """epsilon_s: `blur_samples` times spanning [-T_exp/2, +T_exp/2]."""
    s = max(config.blur_samples, 1)
    kw = dict(dtype=camera_exposure.dtype, device=camera_exposure.device)
    if s == 1:
        return torch.zeros(1, **kw)
    return torch.linspace(-0.5, 0.5, s, **kw) * camera_exposure


class CameraMotion(NamedTuple):
    """One camera after the pose and velocity corrections, with its sub-frame
    times: what every sub-frame's projection starts from."""

    R0: torch.Tensor       # (3, 3) c2w at mid-exposure
    p0: torch.Tensor       # (3,)
    lin_vel: torch.Tensor  # (3,) camera-frame, zero when motion is off
    ang_vel: torch.Tensor  # (3,)
    eps: torch.Tensor      # (S,) sub-frame times, seconds
    rs_time: torch.Tensor  # () rolling-shutter readout, 0 when off
    use_motion: bool
    camera: Cameras        # the corrected camera (leading dim 1)


def camera_motion(params: ModelParams, camera: Cameras, config: SplatfactoConfig,
                  is_eval_camera: bool = False) -> CameraMotion:
    pose_p, vel_p = ((params.eval_camera_opt, params.eval_velocity_opt) if is_eval_camera
                     else (params.camera_opt, params.velocity_opt))
    camera = apply_camera_opt(camera, pose_p, config.camera_optimizer)
    vel_cfg = config.camera_velocity_optimizer
    if is_eval_camera and not config.optimize_eval_velocities:
        vel_cfg = dataclasses.replace(vel_cfg, enabled=False)
    camera = apply_velocity_opt(camera, vel_p, vel_cfg)

    v, om = camera.lin_vel[0], camera.ang_vel[0]
    rs_time = camera.rolling_shutter_time[0]
    if not config.rolling_shutter_compensation:
        rs_time = torch.zeros_like(rs_time)
    use_motion = config.blur_samples > 0 or config.rolling_shutter_compensation
    if not use_motion:
        v, om = torch.zeros_like(v), torch.zeros_like(om)
    exposure = camera.exposure_time[0]
    eps = (blur_sample_times(exposure, config) if config.blur_samples > 0
           else torch.zeros(1, dtype=exposure.dtype, device=exposure.device))
    return CameraMotion(camera.R_c2w[0], camera.p_c2w[0], v, om, eps, rs_time,
                        use_motion, camera)


def anchor_groups(n_s: int, n_a: int) -> list[tuple[int, int]]:
    """The fused blur mode's n_a anchor groups of n_s sub-frames, as [lo, hi)
    sample ranges of near-equal size (the first n_s % n_a one larger)."""
    sizes = [n_s // n_a + (1 if a < n_s % n_a else 0) for a in range(n_a)]
    offsets = [sum(sizes[:a]) for a in range(n_a)]
    return [(o, o + sz) for o, sz in zip(offsets, sizes)]


def sh_eval_switch(degree_active, max_degree: int, dirs: torch.Tensor,
                   coeffs: torch.Tensor) -> torch.Tensor:
    """SH colour with a runtime active degree: the full basis with the bands
    above the active degree masked out; clip(SH + 0.5, min=0)."""
    basis = sh.eval_sh_basis(max_degree, dirs)
    # basis i is in band floor(sqrt(i)), so the active bands are i < (d + 1)^2
    n_active = (degree_active + 1) ** 2
    mask = (torch.arange(basis.shape[-1], device=dirs.device) < n_active).to(basis.dtype)
    out = torch.einsum("nk,nkc->nc", basis * mask[None, :], coeffs)
    return torch.clamp(out + 0.5, min=0.0)


def gamma_encode(linear_rgb: torch.Tensor, config: SplatfactoConfig) -> torch.Tensor:
    """clip(linear, 1e-6, 1) ** (1 / gamma); gamma == 1 is the identity."""
    if config.gamma == 1.0:
        return linear_rgb
    return torch.clamp(linear_rgb, 1e-6, 1.0) ** (1.0 / config.gamma)


def apply_black_level(img: torch.Tensor, config: SplatfactoConfig) -> torch.Tensor:
    """min-rgb-level floor on the 0..1 scale."""
    m = config.min_rgb_level / 255.0
    if m <= 0:
        return img
    return torch.clamp(img, min=m)


def binning_counts(params: ModelParams, camera: Cameras, config: SplatfactoConfig) -> torch.Tensor:
    """Unclamped per-tile depth-list populations (T,) int32 at the
    mid-exposure pose, with the camera and velocity corrections, the motion
    pad and the conic cull of the render's binning: `counts >
    config.max_per_tile` is the overflow the next step's rasterizer drops."""
    g = params.gaussians
    motion = camera_motion(params, camera, config)
    cam = motion.camera
    R_cw = motion.R0.T
    vel = motion.use_motion
    proj = projection.project_gaussians(
        g.means, torch.exp(g.scales_log), g.quats, R_cw, -torch.matmul(R_cw, motion.p0),
        cam.fx[0], cam.fy[0], cam.cx[0], cam.cy[0], cam.width, cam.height,
        lin_vel=motion.lin_vel if vel else None, ang_vel=motion.ang_vel if vel else None,
    )
    comp = (torch.ones_like(proj.compensations) if config.rasterize_mode == "classic"
            else proj.compensations)
    op_eff = torch.sigmoid(g.opacities_logit) * g.alive * comp * proj.valid.to(comp.dtype)
    t_max = torch.amax(torch.abs(motion.eps)) + 0.5 * torch.abs(motion.rs_time)
    return tiling.tile_population(
        proj.means2d, proj.extents, proj.depths, proj.valid, cam.width, cam.height,
        config.tile_size, config.max_tiles_per_gaussian,
        radius_pad=torch.abs(proj.pix_vels) * t_max, conics=proj.conics, opacities=op_eff,
    )


def scale_regularizer(g: GaussianParams, config: SplatfactoConfig,
                      n_alive: torch.Tensor) -> torch.Tensor:
    """The scale-ratio regulariser: the weighted excess of each alive
    Gaussian's max / min scale over `max_gauss_ratio`, summed over g and
    divided by n_alive (the whole cloud's alive count; g may be a shard)."""
    s = torch.exp(g.scales_log)
    # amax / amin split the gradient evenly between tied scales, as
    # jnp.max / jnp.min do (isotropic seeds tie all three)
    ratio = torch.amax(s, dim=-1) / torch.clamp(torch.amin(s, dim=-1), min=1e-12)
    excess = torch.clamp(ratio, min=config.max_gauss_ratio) - config.max_gauss_ratio
    return config.scale_reg_weight * ((excess * g.alive.detach()).sum() / n_alive)


def compute_losses(pred_rgb: torch.Tensor, gt_rgb: torch.Tensor, params: ModelParams,
                   config: SplatfactoConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(1 - l) L1 + l (1 - SSIM) on the black-levelled images, plus the
    scale-ratio regulariser over alive Gaussians and the camera-optimizer
    penalty. Returns (loss, aux) with aux holding each term and the loss."""
    pred = apply_black_level(pred_rgb, config)
    gt = apply_black_level(gt_rgb, config)
    l1 = torch.abs(pred - gt).mean()
    ssim_val = ssim_fn(pred, gt)
    loss = (1.0 - config.ssim_lambda) * l1 + config.ssim_lambda * (1.0 - ssim_val)
    aux = {"l1": l1, "ssim": ssim_val}
    if config.use_scale_regularization:
        g = params.gaussians
        scale_reg = scale_regularizer(g, config, torch.clamp(g.alive.detach().sum(), min=1.0))
        loss = loss + scale_reg
        aux["scale_reg"] = scale_reg
    pen = camera_opt_penalty(params.camera_opt, config.camera_optimizer,
                                     device=pred.device)
    loss = loss + pen
    aux["camera_opt_penalty"] = pen
    aux["loss"] = loss
    return loss, aux


class StrategyState(NamedTuple):
    grad_accum: torch.Tensor       # (C,) accumulated NDC-scale screen-gradient norms
    grad_count: torch.Tensor       # (C,) int32 steps each Gaussian was visible
    generator: torch.Generator     # split sampling


def accumulate_grads(state: StrategyState, means2d_grad: torch.Tensor,
                     visible: torch.Tensor, img_w: int, img_h: int) -> StrategyState:
    """means2d_grad (C, 2) pixel-space probe gradient; visible (C,) bool."""
    norm = torch.linalg.norm(means2d_grad, dim=-1) * (max(img_w, img_h) * 0.5)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visible, norm, 0.0),
        grad_count=state.grad_count + visible.to(torch.int32),
    )


def _rank_match_scatter(params: GaussianParams, new_vals: GaussianParams,
                        want_new: torch.Tensor) -> tuple[GaussianParams, torch.Tensor]:
    """Write new_vals[i], for each i with want_new[i], into a dead slot: the
    r-th wanted candidate goes to the r-th dead slot, and candidates beyond
    the dead slots are dropped. Returns (params, filled slot mask).

    Accepted candidates have distinct targets; every other row is sent to an
    extra row C that is cut off again, so no write depends on a mask's count
    and nothing accumulates."""
    capacity = params.alive.shape[0]
    alive_b = params.alive > 0.5
    dead_slots = torch.argsort(alive_b.to(torch.uint8), stable=True)    # dead first
    n_dead = capacity - alive_b.sum()
    cand_rank = torch.cumsum(want_new.to(torch.int32), dim=0) - 1
    ok = want_new & (cand_rank < n_dead)
    target = dead_slots[torch.clamp(cand_rank, 0, capacity - 1).long()]
    safe_target = torch.where(ok, target, capacity)

    def scatter(dst, src):
        buf = torch.cat([dst, dst[:1]], dim=0)
        buf[safe_target] = src
        return buf[:capacity]

    out = GaussianParams(*(scatter(getattr(params, f), getattr(new_vals, f))
                           for f in GaussianParams._fields))
    filled = scatter(torch.zeros_like(alive_b), torch.ones_like(alive_b))
    return out, filled


@torch.no_grad()
def refine(params: GaussianParams, state: StrategyState, step: int, config: SplatfactoConfig,
           noise: tuple[torch.Tensor, torch.Tensor]):
    """One cull + densify pass (port of `make_refine`'s `_refine`).

    noise: two (C, 3) standard-normal samples, the split offsets of the new
    copy and of the original. Returns (params, state with the accumulators
    zeroed, changed, info): `changed` marks the slots whose parameters are
    new (filled, split originals, culled), whose Adam moments the trainer
    zeroes; `info` holds n_culled, n_split, n_cloned and n_alive as 0-dim
    tensors (no host sync here)."""
    eps, eps2 = noise
    scales = torch.exp(params.scales_log)
    opac = torch.sigmoid(params.opacities_logit)
    alive_b = params.alive > 0.5
    max_scale = scales.amax(dim=-1)

    cull = alive_b & (opac < config.cull_alpha_thresh)
    if step > config.warmup_length:
        cull = cull | (alive_b & (max_scale > config.cull_scale_thresh))
    alive_b = alive_b & ~cull

    avg_grad = state.grad_accum / torch.clamp(state.grad_count, min=1)
    do_densify = config.warmup_length <= step < config.stop_split_at
    high = alive_b & (avg_grad > config.densify_grad_thresh)
    if not do_densify:
        high = torch.zeros_like(high)
    big = max_scale > config.densify_size_thresh
    split_mask = high & big
    clone_mask = high & ~big

    # trim the candidates to the dead slots up front, so a split whose new
    # copy cannot be placed leaves its original as it is
    want = split_mask | clone_mask
    n_dead = params.alive.shape[0] - alive_b.sum()
    cand_rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    placeable = want & (cand_rank < n_dead)
    split_mask = split_mask & placeable
    clone_mask = clone_mask & placeable

    # split: a new position sampled from the Gaussian, both copies shrunk
    R = se3.quat_to_rotmat(se3.quat_normalize(params.quats))
    shrink = math.log(1.6)
    split_col = split_mask[:, None]
    shrunk = torch.where(split_col, params.scales_log - shrink, params.scales_log)
    offset = torch.einsum("nij,nj->ni", R, eps * scales)
    new_vals = params._replace(
        means=torch.where(split_col, params.means + offset, params.means),
        scales_log=shrunk, alive=torch.ones_like(params.alive))
    offset2 = torch.einsum("nij,nj->ni", R, eps2 * scales)
    params = params._replace(
        means=torch.where(split_col, params.means + offset2, params.means),
        scales_log=shrunk, alive=alive_b.to(params.alive.dtype))

    params, filled = _rank_match_scatter(params, new_vals, split_mask | clone_mask)
    changed = filled | split_mask | cull
    info = {"n_culled": cull.sum(), "n_split": split_mask.sum(),
            "n_cloned": clone_mask.sum(), "n_alive": (params.alive > 0.5).sum()}
    new_state = state._replace(grad_accum=torch.zeros_like(state.grad_accum),
                               grad_count=torch.zeros_like(state.grad_count))
    return params, new_state, changed, info


@torch.no_grad()
def grow_capacity(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """Pad every array to new_capacity with dead Gaussians (scales_log -8,
    identity quaternions, opacities_logit -10, alive 0)."""
    cap = params.alive.shape[0]
    pad = new_capacity - cap
    if pad <= 0:
        return params

    def pad_arr(a, fill=0.0):
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)], dim=0)

    quats = pad_arr(params.quats)
    quats[cap:, 0] = 1.0
    return GaussianParams(
        means=pad_arr(params.means), scales_log=pad_arr(params.scales_log, -8.0), quats=quats,
        opacities_logit=pad_arr(params.opacities_logit, -10.0),
        features_dc=pad_arr(params.features_dc), features_rest=pad_arr(params.features_rest),
        alive=pad_arr(params.alive))


class Render(NamedTuple):
    rgb: torch.Tensor      # (H, W, 3) linear blur average
    alpha: torch.Tensor
    depth: torch.Tensor
    transmittance: torch.Tensor


def render_camera(params: ModelParams, camera: Cameras, config: SplatfactoConfig,
                  sh_degree_active, background: torch.Tensor, is_eval_camera: bool = False,
                  means2d_probe: torch.Tensor | None = None) -> Render:
    """`models/splatfacto.py:render_camera` for one whole camera: one sample
    at mid-exposure, or the fused blur mode's anchor groups (the exact mode
    and the mesh's strips and sample ranges are not copied)."""
    motion = camera_motion(params, camera, config, is_eval_camera)
    g = params.gaussians
    opac = torch.sigmoid(g.opacities_logit) * g.alive.detach()
    w, h = motion.camera.width, motion.camera.height
    raster_kw = dict(rolling_shutter_time=motion.rs_time, tile_size=config.tile_size,
                     max_per_tile=config.max_per_tile,
                     max_tiles_per_gaussian=config.max_tiles_per_gaussian,
                     max_total_entries=config.max_total_entries)
    eps = motion.eps
    n_s = eps.shape[0]

    def inputs(t_s):
        return subframe_inputs(params, motion, config, sh_degree_active, t_s, means2d_probe)

    fused = config.blur_mode == "fused" and n_s > 1
    if n_s == 1 and not fused:
        proj, colors = inputs(eps[0])
        return Render(*compositor.rasterize(proj, colors, opac, w, h, background, **raster_kw))
    if not fused:
        raise ValueError("the reference copies the fused blur mode only")
    n_a = max(min(config.blur_anchors, n_s), 1)
    mid_global = n_s // 2
    per_anchor, counts, mid_anchor = [], [], None
    for a_lo, a_hi in anchor_groups(n_s, n_a):
        t_a = eps[a_lo:a_hi].mean()
        proj, colors = inputs(t_a)
        in_group = a_lo <= mid_global < a_hi
        if in_group:
            mid_anchor = len(per_anchor)
        per_anchor.append(Render(*compositor.rasterize_fused_mean(
            proj, colors, opac, w, h, background, eps[a_lo:a_hi] - t_a,
            mid_index=(mid_global - a_lo) if in_group else None, **raster_kw)))
        counts.append(a_hi - a_lo)
    rgb = sum(c * o.rgb for c, o in zip(counts, per_anchor)) / n_s
    alpha = sum(c * o.alpha for c, o in zip(counts, per_anchor)) / n_s
    T = sum(c * o.transmittance for c, o in zip(counts, per_anchor)) / n_s
    return Render(rgb, alpha, per_anchor[mid_anchor].depth, T)
