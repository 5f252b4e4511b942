"""Synthetic scene fixture generator (port of `splat_tpu/data/synthetic.py`).

Every random draw is numpy's and the trajectories are float64 numpy, so for
the same arguments `transforms.json` and `sparse_pc.ply` are the JAX
generator's byte for byte; the frames are rendered through this package's
projection and rasterizer on `device` (CUDA unless "cpu" is asked for) and
written as PNGs by `data/png.py`.

Two roles (SURVEY.md §4 "deterministic synthetic pipeline as fixture generator"):
  1. unit/integration fixtures: a known Gaussian scene rendered along a smooth
     camera trajectory WITH real motion blur (multi-sample exposure integration
     over the true trajectory) and rolling shutter, written to disk in the
     reference data contract (transforms.json + images/ + sparse_pc.ply,
     SURVEY.md §6b) — so the dataparser, model, and trainer are tested end to
     end against ground truth whose generative process is known;
  2. benchmark scenes for bench.py when the Zenodo datasets are unavailable.

Mirrors the *behavior* of the reference's process_synthetic_inputs.py (GT
camera-frame velocities from pose deltas over the exposure+readout window,
every-8th-frame eval with zero velocity at eval frames) without its inputs
(raw Deblur-NeRF re-renders are not shipped here).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import torch

from ..cameras.cameras import Cameras
from ..device import resolve_device
from ..ops import projection, rasterize, se3
from . import ply as ply_io
from . import png


def _f32(a, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def make_random_gaussians(rng: np.random.Generator, n: int, spread=0.8, z_center=0.0,
                          scale_mul: float = 1.0, device="cpu"):
    """A blob of Gaussians around the origin (world frame).

    scale_mul < 1 with large n gives HIGH-FREQUENCY content (many small
    splats) — the scene class where motion blur destroys information the
    multi-view-consistent baseline cannot recover, so compensation margins
    survive long training (the low-frequency default lets an uncompensated
    model average mild blur away given enough iterations)."""
    means = rng.normal(size=(n, 3)) * np.array([spread, spread, spread]) + np.array(
        [0.0, 0.0, z_center]
    )
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4) * 0.06 * spread * scale_mul
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0.05, 1.0, size=(n, 3))
    opacities = rng.uniform(0.5, 0.98, size=(n,))
    return dict(
        means=_f32(means, device),
        scales=_f32(scales, device),
        quats=_f32(quats, device),
        colors=_f32(colors, device),
        opacities=_f32(opacities, device),
    )


def look_at_gl(position: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenGL c2w 4x4: camera at `position` looking at `target` (-z forward)."""
    z = position - target
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, position
    return m


def orbit_pose_gl(t: float, radius=3.0, height=1.2, wobble=0.35, period=8.0) -> np.ndarray:
    """Smooth orbit trajectory with vertical wobble; t in seconds."""
    a = 2 * np.pi * t / period
    pos = np.array(
        [radius * np.cos(a), radius * np.sin(a), height + wobble * np.sin(2.3 * a)]
    )
    return look_at_gl(pos, np.array([0.0, 0.0, 0.0]))


def _rotvec_to_matrix(phi: np.ndarray) -> np.ndarray:
    """Rodrigues exp([phi]x) (float64, host-side)."""
    th = float(np.linalg.norm(phi))
    if th < 1e-12:
        return np.eye(3)
    k = phi / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def shake_pose_gl(t: float, amp: float = 0.06, period: float = 1.3,
                  phases=(0.0, 1.7, 3.1), envelope_period: float = 0.0,
                  envelope_shape: str = "raised_cosine") -> np.ndarray:
    """Handheld-style trajectory: the look-at orbit composed with a smooth
    camera-frame rotational shake exp([theta(t)]x).

    Pure camera rotation translates the WHOLE image at ~fx*|omega| px/s, so —
    unlike the bare orbit, whose blur self-cancels at the look-at center
    (benchmarks/README.md round-2 finding) — the exposure blur is uniform and
    heavy. Peak shake angular rate is amp*2*pi/period rad/s on each axis;
    period >> exposure keeps the constant-velocity model (SURVEY.md Appendix
    B.2) a fair approximation of the true integrated motion.

    envelope_period > 0 modulates theta by an envelope that dips to zero
    amplitude AND zero slope at t = k*T: INTERMITTENT shake. Real handheld
    blur is intermittent — the reference's blur-score eval protocol assumes
    each window of frames contains a genuinely sharp frame
    (the upstream train_eval_split_by_blur_score.py:27-47); a stand-in
    recording with continuous shake violates that assumption and makes
    fitting the blur beat compensating it (round-4 protocol finding,
    benchmarks/README.md).

    envelope_shape:
      'raised_cosine' — 0.5*(1-cos(2*pi*t/T)): smooth dips, but frames
        ADJACENT to the minimum are also near-sharp (env(0.35 s into a
        2.8 s period) = 0.15), which hands the uncompensated baseline sharp
        training signal at every window boundary (round-5 measured finding:
        baseline beats compensation on such recordings at stand-in scales).
      'notch' — 1 - cos(pi*t/T)^16: amplitude ~1 everywhere except a
        NARROW zero-slope dip at t = k*T (env(0.35 s) = 0.72, frames +-2
        at ~0.97), i.e. every train frame is genuinely blurred while one
        frame per window is sharp — the regime the 512px synthetic matrix
        shows compensation winning, expressed as a handheld recording with
        momentary stillness."""
    base = orbit_pose_gl(t)
    w = 2 * np.pi / period
    theta = amp * np.array(
        [np.sin(w * t + phases[0]), np.sin(0.83 * w * t + phases[1]),
         0.35 * np.sin(1.21 * w * t + phases[2])]
    )
    if envelope_period > 0.0:
        if envelope_shape == "notch":
            env = 1.0 - np.cos(np.pi * t / envelope_period) ** 16
        else:
            env = 0.5 * (1.0 - np.cos(2 * np.pi * t / envelope_period))
        theta = theta * env
    m = base.copy()
    m[:3, :3] = base[:3, :3] @ _rotvec_to_matrix(theta)
    return m


def jerk_pose_gl(t: float, amp: float = 0.06, period: float = 0.22,
                 phases=(0.4, 2.1, 3.7)) -> np.ndarray:
    """Jerk/handshake-reversal trajectory: rotational shake whose period is
    COMPARABLE to the exposure, so the angular velocity reverses direction
    *within* an exposure window. This is where the method's first-order
    constant-(v, omega) pose model (SURVEY.md Appendix B.2) — shared by the
    reference's per-sub-frame loop AND the fused warp — is weakest, and the
    scene class that tests whether the fused-anchor auto-resolution
    (models/splatfacto.py:resolve_blur_anchors) stays within its calibration.
    A second harmonic at 2.3x the base rate sharpens the reversals beyond a
    pure sinusoid."""
    base = orbit_pose_gl(t)
    w = 2 * np.pi / period
    theta = amp * np.array([
        np.sin(w * t + phases[0]) + 0.45 * np.sin(2.3 * w * t + phases[1]),
        np.sin(0.91 * w * t + phases[1]) + 0.45 * np.sin(2.1 * w * t + phases[2]),
        0.35 * np.sin(1.13 * w * t + phases[2]),
    ])
    m = base.copy()
    m[:3, :3] = base[:3, :3] @ _rotvec_to_matrix(theta)
    return m


def make_trajectory(name: str = "orbit", shake_amp: float = 0.06,
                    shake_period: float | None = None,
                    envelope_period: float = 0.0,
                    envelope_shape: str = "raised_cosine"):
    """Named trajectory -> pose_fn(t)->4x4 GL c2w. 'orbit' is the round-2
    look-at orbit; 'shake' adds camera-frame rotational shake on top; 'jerk'
    is shake with intra-exposure velocity reversal (short period).

    shake_period=None picks the per-trajectory default: 1.3 s for 'shake'
    but 0.22 s for 'jerk' — jerk's defining property (angular velocity
    reversal WITHIN a 0.06-0.12 s exposure) requires a period comparable to
    the exposure, so inheriting the long shake default would silently
    produce a non-jerk scene (round-4 advisor finding)."""
    if name == "orbit":
        return orbit_pose_gl
    if name == "shake":
        period = 1.3 if shake_period is None else shake_period
        return lambda t: shake_pose_gl(t, amp=shake_amp, period=period,
                                       envelope_period=envelope_period,
                                       envelope_shape=envelope_shape)
    if name == "jerk":
        period = 0.22 if shake_period is None else shake_period
        return lambda t: jerk_pose_gl(t, amp=shake_amp, period=period)
    raise ValueError(f"unknown trajectory {name!r}")


def screen_blur_px(pose_fn, t_mid: float, exposure: float,
                   fx: float, fy: float, cx: float, cy: float) -> float:
    """Measured screen-space blur extent in pixels: mean pixel displacement of
    a fixed probe grid of scene points between exposure start and end.

    This is what a real blur metric (the reference gets motion_blur_score
    from sai-cli's own estimator) responds to — and what a naive
    fx*|omega| proxy gets WRONG on look-at trajectories, where the orbit's
    large constant angular rate self-cancels against its translation
    (round-2 finding) and would mask the shake modulation the blur-score
    eval split needs to see."""
    if exposure <= 0.0:
        return 0.0
    pts = np.array([[0.0, 0.0, 0.0], [0.6, 0, 0], [-0.6, 0, 0],
                    [0, 0.6, 0], [0, -0.6, 0], [0, 0, 0.6], [0, 0, -0.6]])

    def project(m_gl: np.ndarray) -> np.ndarray:
        R, p = m_gl[:3, :3], m_gl[:3, 3]
        cam_gl = (pts - p) @ R  # rows: R^T (x - p)
        # GL -> CV: x, -y, -z
        x, y, z = cam_gl[:, 0], -cam_gl[:, 1], -cam_gl[:, 2]
        z = np.maximum(z, 1e-6)
        return np.stack([fx * x / z + cx, fy * y / z + cy], -1)

    d = project(pose_fn(t_mid + exposure / 2)) - project(pose_fn(t_mid - exposure / 2))
    return float(np.linalg.norm(d, axis=-1).mean())


def trajectory_velocities_gl(pose_fn, t: float, dt: float = 1e-3):
    """Camera-frame (GL axes) linear/angular velocity via central differences —
    same derivation as the reference's converters (process_synthetic_inputs.py:157-165,
    render_video.py:85-115)."""
    m0 = pose_fn(t - dt)
    m1 = pose_fn(t + dt)
    R0, R1 = m0[:3, :3], m1[:3, :3]
    v_world = (m1[:3, 3] - m0[:3, 3]) / (2 * dt)
    Rm = pose_fn(t)[:3, :3]
    v_cam = Rm.T @ v_world
    dR = R0.T @ R1
    w = se3.so3_log(_f32(dR[None])).numpy()[0] / (2 * dt)
    return v_cam, w


@torch.no_grad()
def render_frame_gt(
    gauss: dict,
    pose_fn,
    t_mid: float,
    fx: float, fy: float, cx: float, cy: float, w: int, h: int,
    exposure: float = 0.0,
    rs_time: float = 0.0,
    n_samples: int = 9,
    gamma: float = 2.2,
    background=(0.0, 0.0, 0.0),
    sh_degree: int = 0,
) -> np.ndarray:
    """Ground-truth render: integrate the exposure by sampling the TRUE
    trajectory (not the first-order model the training-time renderer uses), with
    rolling shutter applied via screen velocities at each sub-frame."""
    dev = gauss["means"].device
    bg = _f32(background, dev)
    # zero exposure -> a single sample regardless of n_samples (RS skew is
    # applied inside the rasterizer; integrating identical samples is waste)
    ts = [0.0] if exposure == 0.0 else list(
        np.linspace(-exposure / 2, exposure / 2, max(n_samples, 1))
    )
    acc = None
    for t_s in ts:
        m = pose_fn(t_mid + t_s)
        R_cv, p = Cameras.gl_to_cv_c2w(_f32(m[None], dev))
        R_cv, p = R_cv[0], p[0]
        R_cw = R_cv.T
        t_cw = -R_cw @ p
        v_gl, w_gl = trajectory_velocities_gl(pose_fn, t_mid + t_s)
        v_cv = Cameras.vel_gl_to_cv(_f32(v_gl, dev))
        w_cv = Cameras.vel_gl_to_cv(_f32(w_gl, dev))
        proj = projection.project_gaussians(
            gauss["means"], gauss["scales"], gauss["quats"], R_cw, t_cw,
            fx, fy, cx, cy, w, h, lin_vel=v_cv, ang_vel=w_cv,
        )
        out = rasterize.rasterize(
            proj, gauss["colors"], gauss["opacities"], w, h, bg,
            rolling_shutter_time=rs_time, tile_size=16, max_per_tile=256,
        )
        acc = out.rgb if acc is None else acc + out.rgb
    linear = acc / len(ts)
    img = torch.clamp(linear, 0.0, 1.0) ** (1.0 / gamma)
    return img.cpu().numpy()


def generate_scene(
    out_dir: str | Path,
    n_gaussians: int = 200,
    n_frames: int = 24,
    img_size: int = 64,
    exposure: float = 0.12,
    rolling_shutter: float = 0.0,
    n_blur_samples: int = 9,
    gamma: float = 2.2,
    seed: int = 0,
    eval_interval: int = 8,
    background=(0.0, 0.0, 0.0),
    n_seed_points: int = 128,
    trajectory: str = "orbit",
    shake_amp: float = 0.06,
    shake_period: float | None = None,
    shake_envelope_period: float = 0.0,
    shake_envelope_shape: str = "raised_cosine",
    scale_mul: float = 1.0,
    device: str | torch.device | None = None,
) -> dict:
    """Write a full reference-contract dataset; returns the scene dict. The
    frames are rendered on `device`: CUDA unless "cpu" is asked for."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    gauss = make_random_gaussians(rng, n_gaussians, scale_mul=scale_mul, device=dev)
    pose_fn = make_trajectory(trajectory, shake_amp, shake_period,
                              envelope_period=shake_envelope_period,
                              envelope_shape=shake_envelope_shape)

    fx = fy = img_size * 1.1
    cx = cy = img_size / 2.0
    frame_dt = 0.35  # seconds between frame midpoints along the orbit

    frames = []
    for i in range(n_frames):
        t_mid = i * frame_dt
        is_eval = i % eval_interval == 0
        # Reference invariant: eval frames have zero velocity (sharp GT), see
        # process_synthetic_inputs.py:287-293.
        exp_i = 0.0 if is_eval else exposure
        rs_i = 0.0 if is_eval else rolling_shutter
        img = render_frame_gt(
            gauss, pose_fn, t_mid, fx, fy, cx, cy, img_size, img_size,
            exposure=exp_i, rs_time=rs_i, n_samples=1 if is_eval else n_blur_samples,
            gamma=gamma, background=background,
        )
        name = f"images/frame_{i:05d}.png"
        png.write_png(out_dir / name, (np.clip(img, 0, 1) * 255).astype(np.uint8))

        v_gl, w_gl = trajectory_velocities_gl(pose_fn, t_mid)
        if is_eval:
            v_gl, w_gl = np.zeros(3), np.zeros(3)
        # Blur score: measured screen-space blur extent (pixels) over the
        # exposure — see screen_blur_px. The reference's score comes from
        # sai-cli's own blur metric; the pre-round-5 |v_lin| proxy cannot
        # discriminate on rotational-shake recordings whose orbit speed is
        # constant.
        blur_px = screen_blur_px(pose_fn, t_mid, exp_i, fx, fy, cx, cy)
        frames.append(
            {
                "file_path": name,
                "transform_matrix": pose_fn(t_mid).tolist(),
                "camera_linear_velocity": np.asarray(v_gl).tolist(),
                "camera_angular_velocity": np.asarray(w_gl).tolist(),
                "motion_blur_score": 0.0 if is_eval else blur_px,
            }
        )

    # Seed cloud: noisy subsample of the true means (stands in for SfM
    # points). n_seed_points controls density — benchmark scenes want a rich
    # cloud (a 128-point cloud for a 1500-gaussian 512px scene leaves the
    # model too underfit at draft steps to resolve method differences).
    sel = rng.choice(n_gaussians, size=min(n_gaussians, n_seed_points), replace=False)
    pts = gauss["means"].cpu().numpy()[sel] + rng.normal(size=(len(sel), 3)) * 0.02
    rgb = (gauss["colors"].cpu().numpy()[sel] * 255).astype(np.uint8)
    ply_io.write_ply(out_dir / "sparse_pc.ply", pts, rgb)

    meta = {
        "w": img_size, "h": img_size,
        "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
        "aabb_scale": 16,
        "exposure_time": exposure,
        "rolling_shutter_time": rolling_shutter,
        "orientation_override": "none",
        "ply_file_path": "sparse_pc.ply",
        "frames": frames,
    }
    (out_dir / "transforms.json").write_text(json.dumps(meta, indent=2))
    return {"gaussians": gauss, "meta": meta, "out_dir": out_dir}
