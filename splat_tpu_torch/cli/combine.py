#!/usr/bin/env python
"""Merge COLMAP poses with the VIO's velocities and blur scores, frame by frame.

    python -m splat_tpu_torch.cli.combine [COLMAP_FOLDER | all] [SAI_FOLDER] [OUTPUT_FOLDER]
        [--dataset sai-cli] [--processed-prefix data/inputs-processed]
        [--set_rolling_shutter_to S] [--keep_intrinsics] [--override_calibration JSON]
        [--tolerate_missing] [--pose_opt_pass_dir DIR] [--model_name splatfacto]
        [--dry_run] [--case_number N]

The JAX package's `cli/combine.py`, with the same flags, messages and output
(numpy only). Frames are matched by file name. The VIO's camera-frame linear
velocities are scaled by the ratio of the two pose sets' RMS radii about
their centroids (COLMAP's scale over the VIO's); angular velocities carry no
scale. Camera-frame velocities do not change under a rotation of the world,
so no rotation is applied to them.

Output modes: COLMAP's intrinsics (`colmap-DATASET-vels`, the default); the
VIO's intrinsics (`--keep_intrinsics`, `-orig-intrinsics`); a Brown-Conrady
calibration file (`--override_calibration`, `-calib-intrinsics`); the second
pass (`--pose_opt_pass_dir`), which takes the poses a trained model
optimised from its `transforms_train.json` into `DATASET-2nd-pass`.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np


def process(input_folder: Path, args) -> Path | None:
    """Merge one case; returns the output folder (None when skipped)."""
    override_calibration = None
    if args.override_calibration:
        calib = json.loads(Path(args.override_calibration).read_text())
        (override_calibration,) = calib["cameras"]

    name = input_folder.name
    sai_root = Path(args.processed_prefix) / args.dataset
    sai_folder = Path(args.sai_input_folder) if args.sai_input_folder else sai_root / name

    if args.pose_opt_pass_dir is None:
        src_poses = json.loads((input_folder / "transforms.json").read_text())
        image_folder = input_folder / "images"
        ply_pc = input_folder / "sparse_pc.ply"
    else:
        run = sorted((input_folder / args.model_name).iterdir())[0]
        src_poses = {"frames": json.loads((run / "transforms_train.json").read_text())}
        image_folder = sai_folder / "images"
        ply_pc = sai_folder / "sparse_pc.ply"

    sai_poses = json.loads((sai_folder / "transforms.json").read_text())
    by_name = {"./images/" + Path(f["file_path"]).name: f for f in src_poses["frames"]}
    if not by_name:
        print("skipping: no source poses found")
        return None

    combined, centers_sai, centers_src = [], [], []
    for sai_frame in sai_poses["frames"]:
        fid = sai_frame["file_path"]
        if fid.startswith("images"):
            fid = "./" + fid
        frame = by_name.get(fid)
        if frame is None:
            print(f"skipping frame {fid}: no matching source pose in the VIO set")
            if not args.tolerate_missing:
                return None
            continue
        if "transform" in frame:  # an optimised-pose export holds a 3x4 "transform"
            frame["transform_matrix"] = frame.pop("transform") + [[0, 0, 0, 1]]
        frame["file_path"] = fid
        centers_sai.append(np.array(sai_frame["transform_matrix"])[:3, 3])
        centers_src.append(np.array(frame["transform_matrix"])[:3, 3])
        for prop in ("camera_angular_velocity", "camera_linear_velocity", "motion_blur_score"):
            if prop in sai_frame:
                frame[prop] = sai_frame[prop]
        frame.pop("colmap_im_id", None)
        combined.append(frame)

    # linear velocities scale by the ratio of the two pose sets' RMS radii
    cs = np.asarray(centers_sai) - np.mean(centers_sai, axis=0)
    cc = np.asarray(centers_src) - np.mean(centers_src, axis=0)
    scale = float(np.sqrt((cc**2).sum()) / max(np.sqrt((cs**2).sum()), 1e-12))
    print(f"COLMAP/VIO RMS-radius scale ratio: {scale:.12f}")
    if args.pose_opt_pass_dir is None:
        for frame in combined:
            frame["camera_linear_velocity"] = [v * scale for v in frame["camera_linear_velocity"]]

    prefix = Path(args.processed_prefix)
    if args.pose_opt_pass_dir is not None:
        output_prefix = prefix / f"{args.dataset}-2nd-pass"
        combined_poses = sai_poses
    elif args.keep_intrinsics or override_calibration is not None:
        combined_poses = sai_poses
        if override_calibration is not None:
            if override_calibration["model"] != "brown-conrady":
                raise ValueError(f"{args.override_calibration}: camera model "
                                 f"{override_calibration['model']!r}, want 'brown-conrady'")
            for k, v in zip("k1 k2 p1 p2 k3".split(),
                            override_calibration["distortionCoefficients"][:5]):
                combined_poses[k] = v
            for k, src in zip("fl_x fl_y cx cy".split(),
                              "focalLengthX focalLengthY principalPointX principalPointY".split()):
                combined_poses[k] = override_calibration[src]
        postfix = ("orig" if (override_calibration is None and args.set_rolling_shutter_to is None)
                   else "calib")
        output_prefix = prefix / f"colmap-{args.dataset}-{postfix}-intrinsics"
        combined_poses["applied_transform"] = src_poses.get("applied_transform")
        for prop in ("orientation_override", "auto_scale_poses_override", "fx", "fy"):
            combined_poses.pop(prop, None)
    else:
        output_prefix = prefix / f"colmap-{args.dataset}-vels"
        combined_poses = src_poses
        for prop in ("exposure_time", "rolling_shutter_time"):
            if prop in sai_poses:
                combined_poses[prop] = sai_poses[prop]

    combined_poses["frames"] = combined
    if args.set_rolling_shutter_to is not None:
        combined_poses["rolling_shutter_time"] = args.set_rolling_shutter_to

    out = Path(args.output_folder) if args.output_folder else output_prefix / name
    print(f"output folder: {out}")
    if args.dry_run:
        return out
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(image_folder, out / "images")
    if ply_pc.exists():
        shutil.copyfile(ply_pc, out / "sparse_pc.ply")
    (out / "transforms.json").write_text(json.dumps(combined_poses, indent=4))
    return out


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input_folder", nargs="?", default=None)
    ap.add_argument("sai_input_folder", nargs="?", default=None)
    ap.add_argument("output_folder", nargs="?", default=None)
    ap.add_argument("--dataset", default="sai-cli")
    ap.add_argument("--processed-prefix", default="data/inputs-processed")
    ap.add_argument("--set_rolling_shutter_to", type=float, default=None)
    ap.add_argument("--keep_intrinsics", action="store_true")
    ap.add_argument("--tolerate_missing", action="store_true")
    ap.add_argument("--override_calibration", default=None)
    ap.add_argument("--pose_opt_pass_dir", default=None)
    ap.add_argument("--model_name", default="splatfacto")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--case_number", type=int, default=-1)
    args = ap.parse_args(argv)

    if args.input_folder == "all":
        args.case_number = 0
        args.input_folder = None

    if args.input_folder is None:
        src = (Path(args.pose_opt_pass_dir) if args.pose_opt_pass_dir
               else Path(args.processed_prefix) / f"colmap-{args.dataset}-imgs")
        cases = sorted(src.iterdir())
        if args.case_number == -1:
            for i, c in enumerate(cases):
                print(f"{i + 1}:\t{c}")
            return []
        selected = cases if args.case_number == 0 else [cases[args.case_number - 1]]
    else:
        selected = [Path(args.input_folder)]

    outs = []
    for case in selected:
        print(f"Processing {case}")
        out = process(case, args)
        if out is not None:
            outs.append(out)
    return outs


if __name__ == "__main__":
    main()
