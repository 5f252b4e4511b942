"""The 3dgs-deblur method's render path (port of `splat_tpu/models/splatfacto.py`).

`render_camera` renders one camera with the full method: camera-optimizer pose
correction, velocity prior plus learnable delta, `blur_samples` sub-frame
times over the exposure, the SE(3) advance, projection with screen-space
velocities, view-dependent SH colours, tile rasterization with per-scanline
rolling-shutter time, and the linear-space blur average. Three blur modes:

  * fused (default): project and bin at A anchor poses, render each anchor's
    group of sub-frames by the screen-velocity warp (A = 1: one binning);
  * exact: re-project and re-bin at every sub-frame pose;
  * one sample (blur_samples <= 1): a single render at mid-exposure.

`compute_losses` is the training loss (black level, L1, SSIM, the scale-ratio
regulariser and the camera-optimizer penalty) and `binning_counts` the
unclamped per-tile populations the adaptive tile capacity reads.

The config keeps the render, loss, progressive-resolution and densification
fields of the JAX config, with its defaults (splatfacto 1.1.0's schedule);
the TPU tuning knob `chunk` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..cameras import optimizers as cam_opt
from ..cameras.cameras import Cameras
from ..device import resolve_device, use_kernel
from ..ops import projection, rasterize, se3, sh
from ..ops.cuda.project_sh import project_sh
from ..ops.reference import RenderOutput
from ..ops.ssim import ssim as ssim_fn
from ..utils.profiling import span


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
    camera_optimizer: cam_opt.CameraOptConfig = cam_opt.CameraOptConfig()
    camera_velocity_optimizer: cam_opt.VelocityOptConfig = cam_opt.VelocityOptConfig()
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


def _logit(p: float) -> float:
    return float(np.log(p / (1 - p)))


def init_model(
    points_xyz: np.ndarray | None,
    points_rgb: np.ndarray | None,
    num_train_cameras: int,
    num_eval_cameras: int,
    config: SplatfactoConfig,
    capacity: int | None = None,
    seed: int = 0,
    scene_scale: float = 1.0,
    device: str | torch.device | None = None,
) -> ModelParams:
    """Seed Gaussians from a sparse point cloud. The numpy draws are the JAX
    package's, so the same seed gives the same parameters."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if points_xyz is None or len(points_xyz) == 0:
        points_xyz = rng.uniform(-1.0, 1.0, size=(5000, 3)).astype(np.float32) * scene_scale
        points_rgb = None
    n = points_xyz.shape[0]
    if capacity is None:
        capacity = config.initial_capacity or max(1 << int(np.ceil(np.log2(max(n * 4, 512)))), 512)

    # initial scale: mean distance to the 3 nearest of a 2048-point subsample
    sub = points_xyz[rng.choice(n, size=min(n, 2048), replace=False)]
    d2 = ((points_xyz[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    d2.sort(axis=1)
    k = min(4, d2.shape[1])
    nn_dist = np.sqrt(np.maximum(d2[:, 1:k].mean(axis=1), 1e-12))
    nn_dist = np.maximum(nn_dist, 1e-5)
    nn_dist = np.minimum(nn_dist, 2.0 * np.median(nn_dist))

    means = np.zeros((capacity, 3), np.float32)
    means[:n] = points_xyz
    scales_log = np.full((capacity, 3), -8.0, np.float32)
    scales_log[:n] = np.log(nn_dist)[:, None]
    quats = np.zeros((capacity, 4), np.float32)
    q = rng.normal(size=(capacity, 4))
    quats[:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = np.full((capacity,), _logit(0.1), np.float32)
    fdc = np.zeros((capacity, 3), np.float32)
    if points_rgb is not None:
        fdc[:n] = (points_rgb.astype(np.float32) / 255.0 - 0.5) / 0.28209479177387814
    else:
        fdc[:n] = rng.uniform(-0.5, 0.5, size=(n, 3))
    frest = np.zeros((capacity, sh.num_sh_bases(config.sh_degree) - 1, 3), np.float32)
    alive = np.zeros((capacity,), np.float32)
    alive[:n] = 1.0

    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    gauss = GaussianParams(means=t(means), scales_log=t(scales_log), quats=t(quats),
                           opacities_logit=t(opac), features_dc=t(fdc),
                           features_rest=t(frest), alive=t(alive))
    eval_opt = config.optimize_eval_cameras
    return ModelParams(
        gaussians=gauss,
        background_logit=torch.zeros(3, device=dev),
        camera_opt=cam_opt.init_camera_opt_params(num_train_cameras, config.camera_optimizer, dev),
        velocity_opt=cam_opt.init_velocity_opt_params(
            num_train_cameras, config.camera_velocity_optimizer, dev),
        eval_camera_opt=cam_opt.init_camera_opt_params(
            num_eval_cameras, config.camera_optimizer, dev) if eval_opt else {},
        eval_velocity_opt=cam_opt.init_velocity_opt_params(
            num_eval_cameras, config.camera_velocity_optimizer, dev) if eval_opt else {},
    )


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
    camera = cam_opt.apply_camera_opt(camera, pose_p, config.camera_optimizer)
    vel_cfg = config.camera_velocity_optimizer
    if is_eval_camera and not config.optimize_eval_velocities:
        vel_cfg = dataclasses.replace(vel_cfg, enabled=False)
    camera = cam_opt.apply_velocity_opt(camera, vel_p, vel_cfg)

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
    vel = motion.use_motion
    if use_kernel(config.impl, g.means):
        proj, colors = project_sh(
            g.means, g.scales_log, g.quats, g.features_dc, g.features_rest, Rt, pt,
            cam.fx[0], cam.fy[0], cam.cx[0], cam.cy[0], cam.width, cam.height,
            sh_degree_active, lin_vel=motion.lin_vel if vel else None,
            ang_vel=motion.ang_vel if vel else None)
        return _shift_means(proj, config, means2d_probe, row0), colors
    R_cw = Rt.T
    t_cw = -torch.matmul(R_cw, pt)
    proj = projection.project_gaussians(
        g.means, torch.exp(g.scales_log), g.quats, R_cw, t_cw,
        cam.fx[0], cam.fy[0], cam.cx[0], cam.cy[0], cam.width, cam.height,
        lin_vel=motion.lin_vel if vel else None,
        ang_vel=motion.ang_vel if vel else None,
    )
    dirs = g.means - pt
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    coeffs = torch.cat([g.features_dc[:, None, :], g.features_rest], dim=1)
    return (_shift_means(proj, config, means2d_probe, row0),
            sh_eval_switch(sh_degree_active, config.sh_degree, dirs, coeffs))


def _shift_means(proj: projection.ProjectedGaussians, config: SplatfactoConfig,
                 means2d_probe: torch.Tensor | None, row0: int) -> projection.ProjectedGaussians:
    """The row strip's shift, the probe and classic mode's compensations,
    applied to either route's projection."""
    if row0:
        shift = proj.means2d.new_zeros(2)
        shift[1] = float(row0)          # a fill: no copy from the host, no wait
        proj = proj._replace(means2d=proj.means2d - shift)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    if config.rasterize_mode == "classic":
        proj = proj._replace(compensations=torch.ones_like(proj.compensations))
    return proj


def anchor_groups(n_s: int, n_a: int) -> list[tuple[int, int]]:
    """The fused blur mode's n_a anchor groups of n_s sub-frames, as [lo, hi)
    sample ranges of near-equal size (the first n_s % n_a one larger)."""
    sizes = [n_s // n_a + (1 if a < n_s % n_a else 0) for a in range(n_a)]
    offsets = [sum(sizes[:a]) for a in range(n_a)]
    return [(o, o + sz) for o, sz in zip(offsets, sizes)]


def render_camera(
    params: ModelParams,
    camera: Cameras,
    config: SplatfactoConfig,
    sh_degree_active,
    background: torch.Tensor,
    is_eval_camera: bool = False,
    means2d_probe: torch.Tensor | None = None,
    rows: tuple[int, int] | None = None,
    samples: tuple[int, int] | None = None,
    rasterize_group=None,
) -> RenderOutput:
    """Render one camera (leading dim 1) with the full method; returns the
    linear-space blur average and the mid-exposure depth.

    means2d_probe: optional (C, 2) zeros added to every sub-frame's projected
    means; its gradient is the accumulated screen-space positional gradient
    the densification statistics read.

    The mesh renders a part of this (`parallel.sharding`): rows = (row0, h)
    renders the row strip [row0, row0 + h) with scanline times over the full
    height; samples = (lo, hi) renders only those sub-frames of the S, each
    output then their share of the blur average (sum / S, depth None unless
    the mid-exposure sample is among them); rasterize_group, with the
    signature of `rasterize.rasterize_fused`, composites each anchor group in
    its place (the Gaussian exchanges hook in here) and forces the fused
    route."""
    with span("splat.project"):
        motion = camera_motion(params, camera, config, is_eval_camera)
        g = params.gaussians
        opac = torch.sigmoid(g.opacities_logit) * g.alive.detach()
    w, h = motion.camera.width, motion.camera.height
    row0 = 0
    raster_kw = dict(
        rolling_shutter_time=motion.rs_time, tile_size=config.tile_size,
        max_per_tile=config.max_per_tile, max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        impl=config.impl, max_total_entries=config.max_total_entries,
    )
    if rows is not None:
        row0, raster_kw["rs_full_height"], h = rows[0], h, rows[1]
        raster_kw["rs_row_offset"] = row0
    eps = motion.eps
    n_s = eps.shape[0]
    lo, hi = samples if samples is not None else (0, n_s)

    def inputs(t_s):
        with span("splat.project"):
            return subframe_inputs(params, motion, config, sh_degree_active, t_s,
                                   means2d_probe, row0=row0)

    def render_subframe(t_s):
        proj, colors = inputs(t_s)
        return rasterize.rasterize(proj, colors, opac, w, h, background, **raster_kw)

    fused = rasterize_group is not None or (config.blur_mode == "fused" and n_s > 1)
    if n_s == 1 and not fused:
        return render_subframe(eps[0])
    if fused:
        rasterize_group = rasterize_group or rasterize.rasterize_fused
        n_a = max(min(config.blur_anchors, n_s), 1)
        mid_global = n_s // 2
        per_anchor, counts, mid_anchor = [], [], None
        for a_lo, a_hi in anchor_groups(n_s, n_a):
            s_lo, s_hi = max(lo, a_lo), min(hi, a_hi)
            if s_lo >= s_hi:
                continue
            t_a = eps[a_lo:a_hi].mean()
            proj, colors = inputs(t_a)
            in_group = s_lo <= mid_global < s_hi
            if in_group:
                mid_anchor = len(per_anchor)
            per_anchor.append(rasterize_group(
                proj, colors, opac, w, h, background, eps=eps[s_lo:s_hi] - t_a,
                reduce="mean", mid_index=(mid_global - s_lo) if in_group else None,
                **raster_kw,
            ))
            counts.append(s_hi - s_lo)
        # the blur average is the group-size-weighted mean of the group means
        with span("splat.composite"):
            rgb = sum(c * o.rgb for c, o in zip(counts, per_anchor)) / n_s
            alpha = sum(c * o.alpha for c, o in zip(counts, per_anchor)) / n_s
            T = sum(c * o.transmittance for c, o in zip(counts, per_anchor)) / n_s
        depth = None if mid_anchor is None else per_anchor[mid_anchor].depth
        return RenderOutput(rgb=rgb, alpha=alpha, depth=depth, transmittance=T)
    if config.blur_mode != "exact":
        raise ValueError(f"unknown blur_mode {config.blur_mode!r}")
    outs = [render_subframe(eps[s]) for s in range(lo, hi)]
    with span("splat.composite"):
        return RenderOutput(
            rgb=torch.stack([o.rgb for o in outs]).sum(dim=0) / n_s,
            alpha=torch.stack([o.alpha for o in outs]).sum(dim=0) / n_s,
            depth=outs[n_s // 2 - lo].depth if lo <= n_s // 2 < hi else None,
            transmittance=torch.stack([o.transmittance for o in outs]).sum(dim=0) / n_s,
        )


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
    pad and the conic cull of the render's binning, through the step's own
    projection route: `counts > config.max_per_tile` is the overflow the
    next step's rasterizer drops."""
    with span("splat.bin"):
        g = params.gaussians
        motion = camera_motion(params, camera, config)
        proj, _ = subframe_inputs(params, motion, config, 0, motion.eps.new_zeros(()))
        return rasterize.tile_population(
            proj, torch.sigmoid(g.opacities_logit) * g.alive, motion.camera.width,
            motion.camera.height, motion.eps, motion.rs_time, config.tile_size,
            config.max_tiles_per_gaussian, impl=config.impl,
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
    pen = cam_opt.camera_opt_penalty(params.camera_opt, config.camera_optimizer,
                                     device=pred.device)
    loss = loss + pen
    aux["camera_opt_penalty"] = pen
    aux["loss"] = loss
    return loss, aux
