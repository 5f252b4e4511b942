#!/usr/bin/env python
"""Convert raw re-rendered Deblur-NeRF scenes into the benchmark's synthetic datasets.

    python -m splat_tpu_torch.cli.process_synthetic_inputs
        [--input-dir data/inputs-raw/synthetic-raw] [--output-dir data/inputs-processed]
        [--single NAME] [--points_only] [--dry_run]

The JAX package's `cli/process_synthetic_inputs.py`, with the same output.
Each scene's raw_clear / raw_rs / raw_mb / raw_mbrs folder holds a raw
`transforms.json` (`fov` in radians, per-frame `filename`,
`transform_matrix`, `blurcount`, `blur_matrices`). Per variant it writes:
- poses with the uniform scale of the first pose's rotation taken out;
- fl = w / 2 / tan(fov / 2), the principal point at the image centre,
  `orientation_override` "none";
- ground-truth camera-frame velocities from the first and last blur pose
  over the window (exposure + readout); sharp frames (blurcount 0) get zero;
- for the `-posenoise` variants, orientation noise from the reference's
  machine-independent LCG (its position noise is drawn and discarded, as
  the reference's is); for `-calib-noise`, fl_x +1 % and fl_y -1 %;
- a seed cloud triangulated over the training frames (`data/seedpoints.py`,
  which needs OpenCV's SIFT: without `cv2` it raises ImportError).

Images are copied through `data/png.py` (PNG only; the JAX script goes
through OpenCV): the same pixels, as RGB8 with any alpha channel dropped, as
`cv2.imread` drops it.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

POSE_POSITION_NOISE_REL = 0.05
POSE_ORIENTATION_NOISE_DEG = 1.0
INTRINSIC_NOISE_REL = 0.01


def lcg_uniform(seed: int = 1000):
    """Machine-independent LCG (minstd) mapped to [0, 1) in 999 steps: the
    reference's sequence."""
    a, c, m = 48271, 0, 2147483647
    x = seed + 1
    steps = 999
    while True:
        x = (a * x + c) % m
        yield float(x % steps) / steps


def rotvec_to_matrix(v: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(v).as_matrix()


def read_rgb8(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a PNG: grey repeated, alpha dropped."""
    from splat_tpu_torch.data.png import read_png

    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def process_scene(raw_dir: Path, out_dir: Path, noisy_poses=False, noisy_intrinsics=False):
    from scipy.spatial.transform import Rotation

    from splat_tpu_torch.data.png import write_png

    meta = json.loads((raw_dir / "transforms.json").read_text())
    w, h = meta["w"], meta["h"]
    exposure = meta["exposure_time"]
    rs_time = meta["rolling_shutter_time"]
    fl = w / 2 / np.tan(meta["fov"] / 2)

    if out_dir.exists():
        shutil.rmtree(out_dir)
    (out_dir / "images").mkdir(parents=True)

    fx_scale = 1 + INTRINSIC_NOISE_REL if noisy_intrinsics else 1.0
    fy_scale = 1 - INTRINSIC_NOISE_REL if noisy_intrinsics else 1.0
    out_meta = {
        "aabb_scale": 16,
        "w": w, "h": h, "cx": w / 2, "cy": h / 2,
        "orientation_override": "none",
        "exposure_time": exposure,
        "rolling_shutter_time": rs_time,
        "fl_x": fl * fx_scale, "fl_y": fl * fy_scale,
        "k1": 0, "k2": 0, "p1": 0, "p2": 0,
        "frames": [],
    }

    scaling = None
    positions = []
    for fd in meta["frames"]:
        pose = np.array(fd["transform_matrix"], dtype=np.float64)
        if scaling is None:
            # take out any uniform scale baked into the raw poses
            scaling = 1.0 / np.sqrt((pose[:3, :3].T @ pose[:3, :3])[0, 0])
        pose[:3, :] *= scaling
        positions.append(pose[:3, 3].copy())

        name = Path(fd["filename"]).name
        write_png(out_dir / "images" / name, read_rgb8(raw_dir / fd["filename"]))

        if fd.get("blurcount", 0) == 0:
            v_cam = np.zeros(3)
            w_cam = np.zeros(3)
        else:
            blur = [np.array(m, dtype=np.float64) for m in fd["blur_matrices"]]
            for b in blur:
                b[:3, :] *= scaling
            window = exposure + rs_time
            v_world = (blur[-1][:3, 3] - blur[0][:3, 3]) / window
            rot = blur[-1][:3, :3] @ blur[0][:3, :3].T
            w_world = Rotation.from_matrix(rot).as_rotvec() / window
            R_w2c = pose[:3, :3].T
            v_cam = R_w2c @ v_world
            w_cam = R_w2c @ w_world

        out_meta["frames"].append({
            "camera_linear_velocity": v_cam.tolist(),
            "camera_angular_velocity": w_cam.tolist(),
            "file_path": f"./images/{name}",
            "transform_matrix": pose.tolist(),
        })

    if noisy_poses:
        rand = lcg_uniform()

        def rand3():
            return np.array([next(rand) for _ in range(3)]) * 2 - 1

        centers = np.asarray(positions)
        scene_scale = np.max(np.linalg.norm(centers - centers.mean(axis=0), axis=1))
        pos_scale = POSE_POSITION_NOISE_REL * scene_scale
        for f in out_meta["frames"]:
            pose = np.array(f["transform_matrix"])
            rand3() * pos_scale  # drawn and discarded, as the reference's position noise is
            ang = 0.0
            while ang < 1e-6:
                rv = rand3() * POSE_ORIENTATION_NOISE_DEG / 180.0 * np.pi
                ang = np.linalg.norm(rv)
            pose[:3, :3] = pose[:3, :3] @ rotvec_to_matrix(rv)
            f["transform_matrix"] = pose.tolist()

    (out_dir / "transforms.json").write_text(json.dumps(out_meta, indent=4))
    return out_meta


def generate_seed_cloud(out_dir: Path, max_reproj_px=10.0):
    """Triangulate a seed cloud over the training frames; the eval frames
    (every 8th by file path) must have zero velocity."""
    from splat_tpu_torch.data import ply as ply_io
    from splat_tpu_torch.data import seedpoints

    meta = json.loads((out_dir / "transforms.json").read_text())
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    train = []
    for i, f in enumerate(frames):
        if i % 8 == 0:
            vel = (np.linalg.norm(f.get("camera_linear_velocity", [0, 0, 0]))
                   + np.linalg.norm(f.get("camera_angular_velocity", [0, 0, 0])))
            if vel != 0:
                raise ValueError(f"eval frame {f['file_path']} has nonzero velocity")
            continue
        train.append(f)

    images = [read_rgb8(out_dir / f["file_path"]) for f in train]
    poses = [np.array(f["transform_matrix"]) for f in train]
    intr = {k: meta[k] for k in ("fl_x", "fl_y", "cx", "cy")}
    xyzrgb = seedpoints.generate_seed_points(images, poses, intr, max_reproj_px)
    print(f"triangulated {len(xyzrgb)} points")
    ply_io.write_ply(out_dir / "sparse_pc.ply", xyzrgb[:, :3], xyzrgb[:, 3:].astype(np.uint8))
    meta["ply_file_path"] = "./sparse_pc.ply"
    (out_dir / "transforms.json").write_text(json.dumps(meta, indent=4))


# the 8 dataset variants written (the reference's list)
DATASET_VARIANTS = [
    ("synthetic-posenoise", "raw_clear", dict(noisy_poses=True)),
    ("synthetic-rs", "raw_rs", {}),
    ("synthetic-mb", "raw_mb", {}),
    ("synthetic-mb-posenoise", "raw_mb", dict(noisy_poses=True)),
    ("synthetic-clear", "raw_clear", {}),
    ("synthetic-mbrs", "raw_mbrs", {}),
    ("synthetic-mbrs-posenoise", "raw_mbrs", dict(noisy_poses=True)),
    ("synthetic-mbrs-pose-calib-noise", "raw_mbrs", dict(noisy_poses=True, noisy_intrinsics=True)),
]


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input-dir", default="data/inputs-raw/synthetic-raw")
    ap.add_argument("--output-dir", default="data/inputs-processed")
    ap.add_argument("--single", default="", help="process one variant name only")
    ap.add_argument("--points_only", action="store_true")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    inp = Path(args.input_dir)
    variants = [v for v in DATASET_VARIANTS if not args.single or v[0] == args.single]
    outs = []
    for out_name, subfolder, kw in variants:
        for scene_dir in sorted(p for p in inp.iterdir() if p.is_dir()) if inp.exists() else []:
            raw = scene_dir / subfolder
            if not raw.exists():
                continue
            out = Path(args.output_dir) / out_name / scene_dir.name
            print(f"{raw} -> {out}")
            outs.append(out)
            if args.dry_run:
                continue
            if not args.points_only:
                process_scene(raw, out, **kw)
            if out.exists():
                generate_seed_cloud(out)
    return outs


if __name__ == "__main__":
    main()
