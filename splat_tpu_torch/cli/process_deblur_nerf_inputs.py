#!/usr/bin/env python
"""Convert third-party deblurring benchmarks into the benchmark contract through SfM.

    python -m splat_tpu_torch.cli.process_deblur_nerf_inputs [INPUT_FOLDER]
        [--dataset synthetic_camera_motion_blur] [--input-root data/inputs-raw]
        [--processed-prefix data/inputs-processed] [--pass-no 1|2|3]
        [--use_all_images] [--exact_intrinsics] [--manual_point_cloud]
        [--sfm-backend colmap|hloc] [--dry_run]

The JAX package's `cli/process_deblur_nerf_inputs.py`, with the same flags
and output, for Deblur-NeRF / ExBluRF / BAD-NeRF / BAD-Gaussians /
MPR-deblurred sequences. Three passes make the novel-view and deblurring
splits:
- pass 1 registers the training images only (every 8th frame held out) ->
  `colmap-PAPER-synthetic-novel-view-temp`;
- pass 2 registers every image; each held-out frame's pose is carried into
  pass 1's frame through its nearest training frame,
  c2w_eval = c2w1[ref] inv(c2w2[ref]) c2w2[eval] -> `-novel-view`;
- pass 3 pairs the blurry images (`train_*`) with the sharp test images
  (`eval_*`), which share their poses -> `-deblurring`.
`--exact_intrinsics` writes the Deblur-NeRF renders' known intrinsics;
`--manual_point_cloud` re-triangulates the seed cloud
(`process_synthetic_inputs.generate_seed_cloud`, which needs OpenCV). SfM
goes through `run_colmap` (`--sfm-backend`), which raises `SystemExit`
without its binary or hloc.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

from splat_tpu_torch.cli import run_colmap

PAPER_BY_DATASET = {
    "synthetic_camera_motion_blur": ("deblurnerf", "images_1"),
    "synthetic_release": ("exblurf", "images_1"),
    "nerf_llff_data": ("bad-nerf", "images_1"),
    "synthetic-mb": ("sai-mb", "images"),
    "synthetic-rs": ("sai-rs", "images"),
    "bad-nerf-gtK-colmap-nvs": ("bad-gaussians", "images"),
    "colmap-bad-gaussians-synthetic-novel-view-deblurred-training": ("mpr-deblurred", "images"),
}

# the intrinsics every Deblur-NeRF synthetic render shares
KNOWN_INTRINSICS = {
    "w": 600, "h": 400, "cx": 300.0, "cy": 200.0,
    "fl_x": 541.8502321581475, "fl_y": 541.8502321581475,
    "k1": 0, "k2": 0, "p1": 0, "p2": 0,
}


def canonical_scene_name(name: str) -> str:
    """'Wine' is 'Trolley' (Deblur-NeRF's own naming slip)."""
    return name.replace("blur", "").replace("2", "").replace("wine", "trolley")


def frame_index(frame: dict) -> int:
    """frame_00001.png -> 0."""
    return int(Path(frame["file_path"]).stem.split("_")[-1], base=10) - 1


def transfer_novel_view_poses(pass1: dict, pass2: dict) -> dict:
    """Pass 1's training poses, and every 8th frame's pass-2 pose carried into
    pass 1's frame through the nearest training frame."""
    def to_mat(f):
        return np.array(f["transform_matrix"], dtype=np.float64)

    c2w1 = {frame_index(f): to_mat(f) for f in pass1["frames"]}
    c2w2 = {frame_index(f): to_mat(f) for f in pass2["frames"]}

    out = dict(pass1.items())
    out["frames"] = []
    orig_index = 0
    for index, frame in enumerate(sorted(pass2["frames"], key=lambda x: x["file_path"])):
        frame = dict(frame)
        if index % 8 == 0:
            ref = index - 1
            ref_orig = orig_index - 1
            if ref < 0:
                ref = index + 1
                ref_orig = orig_index
            pose = c2w1[ref_orig] @ np.linalg.inv(c2w2[ref]) @ c2w2[index]
            frame["transform_matrix"] = pose.tolist()
        else:
            frame["transform_matrix"] = c2w1[orig_index].tolist()
            orig_index += 1
        out["frames"].append(frame)
    return out


def build_deblurring_split(transforms: dict, test_images: list[str], out_dir: Path,
                           test_dir: Path, dry_run: bool) -> dict:
    """Pass 3: the registered blurry frames renamed train_*, and eval_* sharp
    frames added with the same poses."""
    if any("train_" in f["file_path"] for f in transforms["frames"]):
        return transforms
    test_frames = []
    for index, frame in enumerate(sorted(transforms["frames"], key=lambda x: x["file_path"])):
        orig_fn = test_images[index]
        test_path = f"images/eval_{orig_fn}"
        if not dry_run:
            shutil.copyfile(test_dir / orig_fn, out_dir / test_path)
        if "train_" not in frame["file_path"]:
            train_path = f"images/train_{orig_fn}"
            if not dry_run:
                shutil.move(str(out_dir / frame["file_path"]), str(out_dir / train_path))
            frame["file_path"] = train_path
        tf = dict(frame)
        tf["file_path"] = test_path
        test_frames.append(tf)
    transforms["frames"].extend(test_frames)
    return transforms


def run_sfm(image_dir: Path, output_folder: Path, dry_run: bool, sfm_backend: str = "colmap"):
    """Register the images in image_dir into output_folder's transforms.json."""
    print(f"{sfm_backend}: {image_dir} -> {output_folder}")
    if dry_run:
        return
    if sfm_backend == "colmap" and not run_colmap.colmap_available():
        raise SystemExit("colmap binary not found (external dependency)")
    if output_folder.exists():
        shutil.rmtree(output_folder)
    (output_folder / "images").mkdir(parents=True)
    for f in image_dir.iterdir():
        shutil.copyfile(f, output_folder / "images" / f.name)
    with tempfile.TemporaryDirectory() as td:
        work = Path(td)
        if not run_colmap.run_sfm_once(image_dir, work, backend=sfm_backend):
            raise SystemExit(f"{sfm_backend} failed")
        run_colmap.export_transforms(work, output_folder)


def process(input_folder: Path, args, pass_no: int = 1) -> Path:
    out_name = canonical_scene_name(input_folder.name)
    paper, image_subdir = PAPER_BY_DATASET.get(args.dataset, ("deblurnerf", "images_1"))
    basename = f"colmap-{paper}-synthetic"
    prefix = Path(args.processed_prefix)

    input_image_folder = input_folder / image_subdir
    test_image_folder = None
    first_pass_folder = None
    if pass_no == 1:
        dataset_name = basename + ("-all" if args.use_all_images else "-novel-view-temp")
    elif pass_no == 2:
        first_pass_folder = prefix / f"{basename}-novel-view-temp" / out_name
        dataset_name = basename + "-novel-view"
    elif pass_no == 3:
        dataset_name = basename + "-deblurring"
        input_image_folder = input_folder / "images"
        test_image_folder = input_folder / "images_test"
    else:
        raise ValueError(pass_no)
    if pass_no != 1 or args.use_all_images:
        if args.exact_intrinsics:
            dataset_name += "-exact-intrinsics"
        if args.manual_point_cloud:
            dataset_name += "-manual-pc"
    output_folder = prefix / dataset_name / out_name

    with tempfile.TemporaryDirectory() as td:
        staging = Path(td)
        n = 0
        images = sorted(input_image_folder.iterdir()) if input_image_folder.exists() else []
        for index, f in enumerate(images):
            if "depth" in f.name:
                continue
            if pass_no == 1 and index % 8 == 0 and not args.use_all_images:
                continue
            new_name = ("train_" + f.name) if test_image_folder is not None else f.name
            if not args.dry_run:
                shutil.copyfile(f, staging / new_name)
            n += 1
        print(f"{n} images staged")
        run_sfm(staging, output_folder, args.dry_run, sfm_backend=args.sfm_backend)

    json_fn = output_folder / "transforms.json"
    transforms = json.loads(json_fn.read_text()) if json_fn.exists() else {"frames": []}

    if test_image_folder is not None:
        transforms = build_deblurring_split(
            transforms, sorted(p.name for p in test_image_folder.iterdir()),
            output_folder, test_image_folder, args.dry_run)
    elif first_pass_folder is not None:
        pass1 = json.loads((first_pass_folder / "transforms.json").read_text())
        transforms = transfer_novel_view_poses(pass1, transforms)
        if not args.dry_run:
            shutil.copyfile(first_pass_folder / "sparse_pc.ply", output_folder / "sparse_pc.ply")

    if args.exact_intrinsics:
        transforms.update(KNOWN_INTRINSICS)

    if not args.dry_run:
        json_fn.write_text(json.dumps(transforms, indent=4))

    if pass_no == 1 and args.manual_point_cloud and output_folder.exists():
        from splat_tpu_torch.cli.process_synthetic_inputs import generate_seed_cloud

        if not args.dry_run:
            shutil.copyfile(output_folder / "sparse_pc.ply", output_folder / "sparse_pc_colmap.ply")
            shutil.copyfile(json_fn, output_folder / "transforms_colmap.json")
            generate_seed_cloud(output_folder)
    return output_folder


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input_folder", nargs="?", default=None)
    ap.add_argument("--dataset", default="synthetic_camera_motion_blur",
                    choices=sorted(PAPER_BY_DATASET))
    ap.add_argument("--input-root", default="data/inputs-raw")
    ap.add_argument("--processed-prefix", default="data/inputs-processed")
    ap.add_argument("--pass-no", type=int, default=1, choices=(1, 2, 3))
    ap.add_argument("--use_all_images", action="store_true")
    ap.add_argument("--exact_intrinsics", action="store_true")
    ap.add_argument("--manual_point_cloud", action="store_true")
    ap.add_argument("--post_process_only", action="store_true")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--sfm-backend", default="colmap", choices=["colmap", "hloc"],
                    help="hloc = superpoint+lightglue; colmap = exhaustive SIFT")
    args = ap.parse_args(argv)

    if args.input_folder:
        cases = [Path(args.input_folder)]
    else:
        root = Path(args.input_root) / args.dataset
        cases = sorted(p for p in root.iterdir() if p.is_dir()) if root.exists() else []
    outs = []
    for case in cases:
        print(f"Processing {case} (pass {args.pass_no})")
        outs.append(process(case, args, pass_no=args.pass_no))
    return outs


if __name__ == "__main__":
    main()
