#!/usr/bin/env python
"""Demo-video generator (port of `cli/render_video.py`).

Builds a Kochanek-Bartels spline camera path from the scene's original
trajectory (or a synthetic orbit), adds finite-difference camera velocities
and exposure / readout times to the path JSON so the renderer re-renders
with simulated motion blur and rolling shutter, then renders the path
in-process to PNG frames and, if ffmpeg is on the PATH, an mp4.

Input poses are mapped through applied_transform^-1 -> dataparser
transform -> scale before rendering with the trained model.

  python -m splat_tpu_torch.cli.render_video OUT_FOLDER --load-config <run>/config.json \
      [--original_trajectory] [--seconds 4] [--fps 30] [--blur_scale 1]

It renders on the device the run was trained on (`device` in its config.json).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch


def build_path_json(args, scene_meta, dataparser_tf):
    from ..cameras import paths as pth

    frames = scene_meta["frames"]
    key_poses = np.array([f["transform_matrix"] for f in frames], dtype=np.float64)

    # original data frame -> model's internal frame: applied_transform^-1 (if
    # the converter recorded one), then the dataparser transform + scale
    applied = np.eye(4)
    applied[:3] = np.array(
        scene_meta.get("applied_transform", np.eye(4)[:3].tolist()), dtype=np.float64
    )
    t4 = np.eye(4)
    t4[:3] = np.array(dataparser_tf["transform"], dtype=np.float64)
    scale = float(dataparser_tf["scale"])

    def to_internal(pose):
        p = t4 @ np.linalg.inv(applied) @ pose
        p[:3, 3] *= scale
        return p

    key_internal = np.stack([to_internal(p) for p in key_poses])

    if args.original_trajectory:
        spline = pth.PoseSpline(key_internal)
        n_key = len(key_internal)
    else:  # synthetic orbit around the scene center
        center = key_internal[:, :3, 3].mean(axis=0)
        radius = np.linalg.norm(key_internal[:, :3, 3] - center, axis=1).mean() * args.zoom
        ang = np.linspace(0, 2 * np.pi, 13)
        orbit = np.stack([
            pth.look_at(center + radius * np.array([np.cos(a), np.sin(a), 0.4]), center)
            for a in ang
        ])
        spline = pth.PoseSpline(orbit)
        n_key = len(orbit)

    n_frames = int(args.seconds * args.fps)
    us = np.linspace(0, n_key - 1, n_frames)
    # path-parameter speed (du per second), scaled by playback_speed
    du_per_s = (n_key - 1) / args.seconds * args.playback_speed

    exposure = float(scene_meta.get("exposure_time", 0.0)) * args.blur_scale
    rs_time = float(scene_meta.get("rolling_shutter_time", 0.0))

    cam_path = []
    for u in us:
        pose = spline(u)[0]
        v_cam, w_cam = pth.path_velocities_gl(spline, float(u), time_scale=du_per_s)
        cam_path.append(
            {
                "camera_to_world": pose.reshape(-1).tolist(),
                "fov": args.fov,
                "aspect": 1.0,
                "camera_linear_velocity": v_cam.tolist(),
                "camera_angular_velocity": np.asarray(w_cam).tolist(),
            }
        )
    return {
        "render_width": args.width or int(scene_meta["w"]),
        "render_height": args.height or int(scene_meta["h"]),
        "fps": args.fps,
        "seconds": args.seconds,
        "exposure_time": exposure,
        "rolling_shutter_time": rs_time,
        "camera_path": cam_path,
    }


def path_config(model_config, path_json: dict):
    """The model config a path renders with: simulated blur (at least 5
    samples) when the path has an exposure, rolling shutter always on,
    independent of the training flags."""
    return dataclasses.replace(
        model_config,
        blur_samples=max(model_config.blur_samples, 5) if path_json["exposure_time"] > 0 else 0,
        rolling_shutter_compensation=True,
    )


def path_camera(frame: dict, path_json: dict, fov: float, device):
    """One path frame as a camera (leading dim 1), intrinsics from the fov."""
    from ..cameras.cameras import Cameras

    w, h = path_json["render_width"], path_json["render_height"]
    fl = 0.5 * h / np.tan(0.5 * np.radians(fov))
    f32 = dict(dtype=torch.float32, device=device)
    c2w_gl = torch.as_tensor(
        np.array(frame["camera_to_world"], dtype=np.float64).reshape(4, 4)[None], **f32)
    R_cv, p = Cameras.gl_to_cv_c2w(c2w_gl)
    full = lambda v: torch.full((1,), float(v), **f32)  # noqa: E731
    return Cameras(
        R_cv, p, fx=full(fl), fy=full(fl), cx=full(w / 2.0), cy=full(h / 2.0),
        width=w, height=h,
        lin_vel=Cameras.vel_gl_to_cv(torch.tensor([frame["camera_linear_velocity"]], **f32)),
        ang_vel=Cameras.vel_gl_to_cv(torch.tensor([frame["camera_angular_velocity"]], **f32)),
        exposure_time=full(path_json["exposure_time"]),
        rolling_shutter_time=full(path_json["rolling_shutter_time"]),
        cam_idx=torch.zeros((1,), dtype=torch.int64, device=device),
    )


def novel_view_params(params):
    """`params` without per-camera corrections: a path or viewer camera is a
    novel view, and its cam_idx 0 must not pick up train camera 0's."""
    return params._replace(camera_opt={}, velocity_opt={})


@torch.no_grad()
def render_frame(params, cam, model_config, sh_deg: int) -> np.ndarray:
    """(H, W, 3) gamma-encoded image in [0, 1] of one novel-view camera."""
    from ..models import splatfacto as sf

    bg = sf.background_color(params, model_config)
    out = sf.render_camera(novel_view_params(params), cam, model_config, sh_deg, bg)
    return np.clip(sf.gamma_encode(out.rgb, model_config).cpu().numpy(), 0, 1)


def render_path(config_path: Path, path_json: dict, out_dir: Path, args):
    """ns-render camera-path equivalent: honors per-frame velocities and the
    exposure / readout times to simulate blur and rolling shutter."""
    from ..data.png import write_png
    from ..models import splatfacto as sf
    from .evaluate import load_trainer_from_config
    from .render_model import to_uint8

    cfg, trainer = load_trainer_from_config(config_path)
    mcfg = path_config(cfg.model, path_json)
    sh_deg = int(sf.active_sh_degree(mcfg, trainer.step))
    out_dir.mkdir(parents=True, exist_ok=True)

    for i, frame in enumerate(path_json["camera_path"]):
        cam = path_camera(frame, path_json, args.fov, trainer.device)
        img = render_frame(trainer.params, cam, mcfg, sh_deg)
        write_png(out_dir / f"{i:05d}.png", to_uint8(img))
        if i % 10 == 0:
            print(f"frame {i}/{len(path_json['camera_path'])}", flush=True)

    if shutil.which("ffmpeg"):
        subprocess.check_call([
            "ffmpeg", "-y", "-loglevel", "error", "-framerate", str(path_json["fps"]),
            "-i", str(out_dir / "%05d.png"), "-pix_fmt", "yuv420p",
            str(out_dir.parent / f"{out_dir.name}.mp4"),
        ])
        print(f"wrote {out_dir.parent / (out_dir.name + '.mp4')}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_folder")
    ap.add_argument("--load-config", required=True, help="trained run config.json")
    ap.add_argument("--data", default="", help="scene dir (default: from config)")
    ap.add_argument("--original_trajectory", action="store_true")
    ap.add_argument("--zoom", type=float, default=1.5)
    ap.add_argument("--playback_speed", type=float, default=1.0)
    ap.add_argument("--blur_scale", type=float, default=1.0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    config_path = Path(args.load_config)
    cfg_raw = json.loads(config_path.read_text())
    data_dir = Path(args.data or cfg_raw["data"])
    scene_meta = json.loads((data_dir / "transforms.json").read_text())
    dataparser_tf = json.loads(
        (config_path.parent / "dataparser_transforms.json").read_text()
    )

    path_json = build_path_json(args, scene_meta, dataparser_tf)
    out_dir = Path(args.out_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "demo_video_camera_path.json").write_text(json.dumps(path_json, indent=2))
    print(f"wrote camera path ({len(path_json['camera_path'])} frames)")
    if args.dry_run:
        return path_json
    render_path(config_path, path_json, out_dir / "frames", args)
    return path_json


if __name__ == "__main__":
    main()
