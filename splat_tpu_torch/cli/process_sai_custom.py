#!/usr/bin/env python
"""One Spectacular-Rec recording -> VIO -> COLMAP -> a trainable dataset.

    python -m splat_tpu_torch.cli.process_sai_custom RECORDING(.zip | dir)
        [--output-dir data/inputs-processed/sai-custom] [--skip_colmap]
        [--set_rolling_shutter_to S] [--dry_run]

The JAX package's `cli/process_sai_custom.py`, with the same steps:
- a `.zip` recording is unpacked into a temporary directory (into its one
  top-level directory if it has exactly one);
- `sai-cli process` with `process_sai_inputs.build_cmd`'s parameters writes
  OUTPUT_DIR/NAME;
- when the VIO's `transforms.json` has no `exposure_time`, the median of
  the per-frame exposures in the recording's `data.jsonl` is written there;
  `--set_rolling_shutter_to` overrides the readout time;
- unless `--skip_colmap`: `run_colmap.process` into
  ../colmap-sai-custom-imgs/NAME and `combine` into
  ../sai-custom-combined/NAME (a `python -m splat_tpu_torch.cli.combine`
  subprocess).

`sai-cli` (and COLMAP) are external binaries: without them the script
raises `SystemExit` with the JAX script's messages.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import zipfile
from pathlib import Path

import numpy as np

from splat_tpu_torch.cli import process_sai_inputs, run_colmap
from splat_tpu_torch.cli import train as cli_train


def exposure_from_data_jsonl(rec_dir: Path) -> float | None:
    """Median per-frame exposure time (seconds) from data.jsonl, if present."""
    fn = rec_dir / "data.jsonl"
    if not fn.exists():
        return None
    vals = []
    for line in fn.read_text().splitlines():
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        for key in ("exposureTimeSeconds", "exposure_time"):
            if key in d:
                vals.append(float(d[key]))
        for fr in d.get("frames") or []:
            for key in ("exposureTimeSeconds", "exposure_time"):
                if key in fr:
                    vals.append(float(fr[key]))
    return float(np.median(vals)) if vals else None


def unpack_recording(rec: Path, td: str, dry_run: bool) -> Path:
    """The recording's directory: REC itself, or REC.zip unpacked into TD."""
    if rec.suffix != ".zip":
        return rec
    print(f"unzip {rec} -> {td}")
    if dry_run:
        return Path(td)
    with zipfile.ZipFile(rec) as z:
        z.extractall(td)
    inner = [p for p in Path(td).iterdir() if p.is_dir()]
    return inner[0] if len(inner) == 1 else Path(td)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("recording", help=".zip or directory of a spectacular-rec recording")
    ap.add_argument("--output-dir", default="data/inputs-processed/sai-custom")
    ap.add_argument("--skip_colmap", action="store_true")
    ap.add_argument("--set_rolling_shutter_to", type=float, default=None)
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    rec = Path(args.recording)
    name = rec.stem
    out_root = Path(args.output_dir)
    vio_out = out_root / name

    with tempfile.TemporaryDirectory() as td:
        rec_dir = unpack_recording(rec, td, args.dry_run)
        cmd = process_sai_inputs.build_cmd(rec_dir, vio_out, blur_filter=True)
        print(" ".join(cmd))
        if not args.dry_run:
            if shutil.which("sai-cli") is None:
                raise SystemExit("sai-cli not found (Spectacular AI SDK, external)")
            vio_out.mkdir(parents=True, exist_ok=True)
            subprocess.check_call(cmd)

        # the exposure from the raw recording's metadata when the VIO has none
        tfn = vio_out / "transforms.json"
        if tfn.exists():
            meta = json.loads(tfn.read_text())
            if not meta.get("exposure_time"):
                exp = exposure_from_data_jsonl(rec_dir)
                if exp:
                    meta["exposure_time"] = exp
                    print(f"exposure_time from data.jsonl: {exp:.5f}s")
            if args.set_rolling_shutter_to is not None:
                meta["rolling_shutter_time"] = args.set_rolling_shutter_to
            if not args.dry_run:
                tfn.write_text(json.dumps(meta, indent=4))

    if args.skip_colmap:
        print(f"done (VIO poses): {vio_out}")
        return vio_out

    colmap_out = out_root.parent / "colmap-sai-custom-imgs" / name
    run_colmap.process(vio_out, colmap_out, max_retries=10, dry_run=args.dry_run)
    combined_out = out_root.parent / "sai-custom-combined" / name
    subprocess.check_call(
        [sys.executable, "-m", "splat_tpu_torch.cli.combine", str(colmap_out), str(vio_out),
         str(combined_out)] + (["--dry_run"] if args.dry_run else []),
        env=cli_train._subprocess_env())
    print(f"done: {combined_out}")
    return combined_out


if __name__ == "__main__":
    main()
