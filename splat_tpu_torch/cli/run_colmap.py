#!/usr/bin/env python
"""Structure from motion over a recording's images, into the benchmark contract.

    python -m splat_tpu_torch.cli.run_colmap [INPUT_FOLDER | all] [--dataset sai-cli]
        [--processed-prefix data/inputs-processed] [--sfm-backend colmap|hloc]
        [--text-model DIR] [--max_retries N] [--dry_run] [--case_number N]

The JAX package's `cli/run_colmap.py`, with the same flags and messages:
runs SfM over INPUT_FOLDER/images in a temporary directory with a retry
loop (COLMAP fails now and then), then writes
PREFIX/colmap-DATASET-imgs/NAME/{transforms.json, sparse_pc.ply} through
`data/colmap_io.py`, and copies the images beside them. Backends: the
`colmap` binary (exhaustive SIFT) or hloc (superpoint + lightglue); without
the selected one it raises `SystemExit` with the JAX script's message.

`--text-model DIR` takes a COLMAP TXT model that already exists (for example
one written by `colmap model_converter --output_type TXT` elsewhere) and
exports it the same way without running SfM: the path the pipeline takes on
a machine without COLMAP.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import tempfile
from pathlib import Path


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def hloc_available() -> bool:
    """hloc (superpoint + lightglue), the learned-feature SfM backend."""
    try:
        import hloc  # noqa: F401

        return True
    except ImportError:
        return False


def run_hloc_once(image_dir: Path, work_dir: Path, feature_type: str = "superpoint",
                  matcher_type: str = "superpoint+lightglue") -> bool:
    """One SfM attempt through hloc's python API, into work_dir/sparse/0 (the
    layout `run_colmap_once` writes)."""
    from hloc import extract_features, match_features, pairs_from_exhaustive, reconstruction

    feats = {"superpoint": "superpoint_aachen"}.get(feature_type, feature_type)
    feature_conf = extract_features.confs[feats]
    matcher_conf = match_features.confs[matcher_type]
    sfm_pairs = work_dir / "pairs.txt"
    sfm_dir = work_dir / "sparse" / "0"
    features = extract_features.main(feature_conf, image_dir, work_dir)
    pairs_from_exhaustive.main(sfm_pairs, features=features)
    matches = match_features.main(matcher_conf, sfm_pairs, feature_conf["output"], work_dir)
    reconstruction.main(sfm_dir, image_dir, sfm_pairs, features, matches)
    return sfm_dir.exists()


def run_sfm_once(image_dir: Path, work_dir: Path, backend: str = "colmap", **kw) -> bool:
    """Dispatch one SfM attempt to the selected backend."""
    if backend == "hloc":
        if not hloc_available():
            raise SystemExit(
                "--sfm-backend hloc requested but hloc is not installed. "
                "Install hloc (github.com/cvg/Hierarchical-Localization) or "
                "fall back to --sfm-backend colmap (exhaustive SIFT matching; "
                "fewer registrations on blurry/low-texture frames, same "
                "output contract)."
            )
        return run_hloc_once(image_dir, work_dir, **kw)
    return run_colmap_once(image_dir, work_dir)


def run_colmap_once(image_dir: Path, work_dir: Path, camera_model="SIMPLE_PINHOLE",
                    matching="exhaustive") -> bool:
    db = work_dir / "database.db"
    sparse = work_dir / "sparse"
    sparse.mkdir(parents=True, exist_ok=True)
    steps = [
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(image_dir), "--ImageReader.camera_model", camera_model,
         "--ImageReader.single_camera", "1"],
        ["colmap", f"{matching}_matcher", "--database_path", str(db)],
        ["colmap", "mapper", "--database_path", str(db),
         "--image_path", str(image_dir), "--output_path", str(sparse)],
    ]
    for cmd in steps:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-2000:])
            return False
    return (sparse / "0").exists()


def export_text_model(text_dir: Path, out_dir: Path) -> dict:
    """A COLMAP TXT model -> out_dir/transforms.json (+ sparse_pc.ply)."""
    from splat_tpu_torch.data.colmap_io import colmap_text_to_transforms

    return colmap_text_to_transforms(Path(text_dir), Path(out_dir))


def export_transforms(work_dir: Path, out_dir: Path) -> None:
    """COLMAP's binary sparse model -> TXT (`colmap model_converter`) ->
    transforms.json (+ sparse_pc.ply)."""
    r = subprocess.run(
        ["colmap", "model_converter", "--input_path", str(work_dir / "sparse" / "0"),
         "--output_path", str(work_dir / "text"), "--output_type", "TXT"],
        capture_output=True, text=True,
    )
    if r.returncode != 0:
        raise RuntimeError(f"model_converter failed: {r.stderr[-500:]}")
    export_text_model(work_dir / "text", out_dir)


def _copy_images(input_folder: Path, output_folder: Path) -> None:
    """The registered images beside transforms.json, as `ns-process-data`
    leaves them (the merge step reads them from there)."""
    src = input_folder / "images"
    if src.is_dir():
        if (output_folder / "images").exists():
            shutil.rmtree(output_folder / "images")
        shutil.copytree(src, output_folder / "images")


def process(input_folder: Path, output_folder: Path, max_retries: int, dry_run: bool,
            sfm_backend: str = "colmap", text_model: Path | None = None):
    image_dir = input_folder / "images"
    if text_model is not None:
        print(f"colmap text model: {text_model} -> {output_folder}")
        if dry_run:
            return
        export_text_model(Path(text_model), output_folder)
        _copy_images(input_folder, output_folder)
        return
    print(f"{sfm_backend}: {image_dir} -> {output_folder}")
    if dry_run:
        return
    if sfm_backend == "colmap" and not colmap_available():
        raise SystemExit(
            "colmap binary not found on PATH. Install COLMAP or run the "
            "pipeline on a machine that has it (external dependency, same as "
            "the reference's ns-process-data)."
        )
    for attempt in range(max_retries):
        with tempfile.TemporaryDirectory() as td:
            work = Path(td)
            if run_sfm_once(image_dir, work, backend=sfm_backend):
                export_transforms(work, output_folder)
                _copy_images(input_folder, output_folder)
                print("CONGRATS: sfm succeeded")
                return
        print(f"{sfm_backend} attempt {attempt + 1}/{max_retries} failed, retrying")
    raise SystemExit(f"{sfm_backend} failed after {max_retries} attempts")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input_folder", nargs="?", default=None)
    ap.add_argument("--dataset", default="sai-cli")
    ap.add_argument("--processed-prefix", default="data/inputs-processed")
    ap.add_argument("--max_retries", type=int, default=10)
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--case_number", type=int, default=-1)
    ap.add_argument("--sfm-backend", default="colmap", choices=["colmap", "hloc"],
                    help="colmap = exhaustive SIFT (binary on PATH); hloc = "
                         "superpoint+lightglue")
    ap.add_argument("--text-model", default=None,
                    help="export this COLMAP TXT model instead of running SfM")
    args = ap.parse_args(argv)

    prefix = Path(args.processed_prefix)
    out_root = prefix / f"colmap-{args.dataset}-imgs"
    if args.input_folder in (None, "all"):
        cases = sorted((prefix / args.dataset).iterdir())
        selected = cases if args.input_folder == "all" or args.case_number == 0 else (
            [cases[args.case_number - 1]] if args.case_number > 0 else [])
        if not selected:
            for i, c in enumerate(cases):
                print(f"{i + 1}:\t{c}")
            return []
    else:
        selected = [Path(args.input_folder)]
    if args.text_model is not None and len(selected) != 1:
        raise SystemExit("--text-model takes one input folder")
    for case in selected:
        process(case, out_root / case.name, args.max_retries, args.dry_run,
                sfm_backend=args.sfm_backend,
                text_model=Path(args.text_model) if args.text_model else None)
    return [out_root / case.name for case in selected]


if __name__ == "__main__":
    main()
