#!/usr/bin/env python
"""Split a dataset into train and eval frames by the VIO's blur score.

    python -m splat_tpu_torch.cli.train_eval_split_by_blur_score DATASET [INPUT_FOLDER | all]
        [--processed-prefix data/inputs-processed] [--interval 8] [--dry_run]
        [--case_number N]

The JAX package's `cli/train_eval_split_by_blur_score.py`, with the same
flags and output: in each window of `--interval` frames (sorted by file
path) the frame with the lowest `motion_blur_score` becomes the eval frame.
Images are renamed `eval_*` / `train_*` and the dataset is written as
PREFIX/DATASET-blur-scored/NAME, which `cli.fit` reads with
`--eval-mode filename`.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path


def process(input_folder: Path, output_root: Path, interval: int, dry_run: bool) -> Path:
    out_dir = output_root / input_folder.name
    meta = json.loads((input_folder / "transforms.json").read_text())
    meta["frames"].sort(key=lambda f: f["file_path"])

    if not dry_run:
        if out_dir.exists():
            shutil.rmtree(out_dir)
        (out_dir / "images").mkdir(parents=True)

    for start in range(0, len(meta["frames"]), interval):
        window = meta["frames"][start:start + interval]
        least_blur = min(window, key=lambda f: f["motion_blur_score"])["file_path"]
        for frame in window:
            base = Path(frame["file_path"]).name
            new_name = ("eval_" if frame["file_path"] == least_blur else "train_") + base
            src = input_folder / "images" / base
            dst = out_dir / "images" / new_name
            frame["file_path"] = str(Path("images") / new_name)
            print(f"{src} -> {dst} ({frame['motion_blur_score']:g})")
            if not dry_run:
                shutil.copyfile(src, dst)

    if not dry_run:
        ply = input_folder / "sparse_pc.ply"
        if ply.exists():
            shutil.copyfile(ply, out_dir / "sparse_pc.ply")
        (out_dir / "transforms.json").write_text(json.dumps(meta, indent=4))
    print(f"output: {out_dir}")
    return out_dir


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset")
    ap.add_argument("input_folder", nargs="?", default=None)
    ap.add_argument("--processed-prefix", default="data/inputs-processed")
    ap.add_argument("--interval", type=int, default=8)
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--case_number", type=int, default=-1)
    args = ap.parse_args(argv)

    if args.input_folder == "all":
        args.case_number = 0
        args.input_folder = None

    prefix = Path(args.processed_prefix)
    dataset = args.dataset
    if dataset.startswith(str(prefix) + "/"):
        dataset = dataset[len(str(prefix)) + 1:]
    out_root = prefix / f"{dataset}-blur-scored"

    if args.input_folder is None:
        cases = sorted((prefix / dataset).iterdir())
        if args.case_number == -1:
            for i, c in enumerate(cases):
                print(f"{i + 1}:\t{c}")
            return []
        selected = cases if args.case_number == 0 else [cases[args.case_number - 1]]
    else:
        selected = [Path(args.input_folder)]
    return [process(case, out_root, args.interval, args.dry_run) for case in selected]


if __name__ == "__main__":
    main()
