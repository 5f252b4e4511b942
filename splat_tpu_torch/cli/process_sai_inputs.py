#!/usr/bin/env python
"""Run the Spectacular AI VIO (`sai-cli process`) over raw smartphone recordings.

    python -m splat_tpu_torch.cli.process_sai_inputs
        [--input-dir data/inputs-raw/spectacular-rec]
        [--output-dir data/inputs-processed/sai-cli] [--no_blur_score_filter] [--dry_run]

The JAX package's `cli/process_sai_inputs.py`, with the same command plan:
one `sai-cli process REC OUT` per recording directory with png output, no
undistortion, key-frame distance 0.1 and the internal limits
maxKeypoints 2000 / optimizerMaxIterations 50; `--no_blur_score_filter`
keeps the blurry frames and writes to OUTPUT_DIR-no-blur-filter. It writes
poses, per-frame velocities and blur scores in the benchmark's
`transforms.json`. `sai-cli` is closed-source and external: without it on
PATH the script raises `SystemExit`; `--dry_run` prints the plan.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

SAI_PARAMS = [
    "--output_format", "png",
    "--no_undistort",
    "--key_frame_distance", "0.1",
    "--internal", "maxKeypoints:2000",
    "--internal", "optimizerMaxIterations:50",
]


def build_cmd(rec_dir: Path, out_dir: Path, blur_filter: bool) -> list[str]:
    cmd = ["sai-cli", "process", str(rec_dir), str(out_dir), *SAI_PARAMS]
    if not blur_filter:
        cmd += ["--no_blur_score_filter"]
    return cmd


def process_subfolders(input_root: Path, output_root: Path, args) -> list[list[str]]:
    """Run (or with --dry_run only print) one command per recording; returns
    the commands."""
    cmds = []
    for rec in sorted(p for p in input_root.iterdir() if p.is_dir()):
        out = output_root / rec.name
        cmd = build_cmd(rec, out, blur_filter=not args.no_blur_score_filter)
        print(" ".join(cmd))
        cmds.append(cmd)
        if args.dry_run:
            continue
        if shutil.which("sai-cli") is None:
            raise SystemExit(
                "sai-cli not found on PATH — Spectacular AI SDK is a closed-"
                "source external dependency (reference scripts/install.sh:"
                " pip install spectacularAI[full])."
            )
        out.mkdir(parents=True, exist_ok=True)
        subprocess.check_call(cmd)
    return cmds


def main(argv=None) -> list[list[str]]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input-dir", default="data/inputs-raw/spectacular-rec")
    ap.add_argument("--output-dir", default="data/inputs-processed/sai-cli")
    ap.add_argument("--no_blur_score_filter", action="store_true")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.output_dir + ("-no-blur-filter" if args.no_blur_score_filter else ""))
    return process_subfolders(Path(args.input_dir), out, args)


if __name__ == "__main__":
    main()
