#!/usr/bin/env python
"""Variant trainer/driver (port of `cli/train.py`).

Enumerates (scene x variant) cases for a dataset, builds the
`splat_tpu_torch.cli.fit` command with the method flags for each variant,
times training, and renders the eval images with
`splat_tpu_torch.cli.render_model` (unless --no-render). Each run is its own
process, as in the JAX driver. Output tree:
OUTPUT/DATASET/VARIANT/SESSION/splatfacto/TIMESTAMP/.

  python -m splat_tpu_torch.cli.train --dataset synthetic-mb --input-dir data/inputs \
      --output-dir data/outputs [--draft] [--variants baseline,motion_blur] [--case N] \
      [-- --device cpu]

Flags after `--` go to every `fit` run as they are; `--device cpu` there runs
the plain PyTorch path, and `render_model` follows the run's config.json.

Variant semantics:
  * gamma correction (gamma=2.2, min-rgb-level=10) iff motion-blur comp. on;
  * rolling-shutter-only variants run blur-samples=0, gamma=1;
  * optimize-eval-cameras whenever pose or velocity optimization is on and
    --train_all is not set.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# the directory that holds the splat_tpu_torch package: the runs' subprocesses
# import it from there, whatever their working directory
REPO_ROOT = Path(__file__).resolve().parents[2]

FEATURE_ORDER = [
    "motion_blur", "no_gamma", "pose_opt", "rolling_shutter",
    "velocity_opt", "zero_init",
]

# dataset-specific parameter packs keyed by regex (reference train.py:11-24)
DATASET_PARAMS = [
    (r"^synthetic", {
        "blur_samples": 10,
        "cull_scale_thresh": 2.0,
        "eval_mode": "interval",
        "eval_interval": 8,
        "orientation_method": "none",
    }),
    (r"blur-scored", {"eval_mode": "filename"}),
    (r".*", {"eval_mode": "interval", "eval_interval": 8}),
]


def dataset_params(dataset: str) -> dict:
    for pattern, params in DATASET_PARAMS:
        if re.search(pattern, dataset):
            return dict(params)
    return {}


def flags_to_variant_name_and_cmd(
    features: set[str], dataset: str, train_all: bool
) -> tuple[str, list[str]]:
    """Feature set -> (variant name, fit.py flag list). Mirrors reference
    the JAX package's `cli/train.py`."""
    dp = dataset_params(dataset)
    name_parts = [f for f in FEATURE_ORDER if f in features]
    name = "-".join(name_parts) if name_parts else "baseline"

    cmd: list[str] = []
    motion_blur = "motion_blur" in features
    rolling_shutter = "rolling_shutter" in features

    if motion_blur:
        cmd += ["--pipeline.model.blur-samples", str(dp.get("blur_samples", 5))]
    else:
        cmd += ["--pipeline.model.blur-samples", "0"]

    cmd += [
        "--pipeline.model.rolling-shutter-compensation",
        "True" if rolling_shutter else "False",
    ]

    if motion_blur and "no_gamma" not in features:
        cmd += ["--pipeline.model.gamma", "2.2", "--pipeline.model.min-rgb-level", "10"]
    else:
        cmd += ["--pipeline.model.gamma", "1.0", "--pipeline.model.min-rgb-level", "0"]

    if "pose_opt" in features:
        cmd += ["--pipeline.model.camera-optimizer.mode", "SO3xR3"]

    if "velocity_opt" in features:
        cmd += ["--pipeline.model.camera-velocity-optimizer.enabled", "True"]
        if "zero_init" in features:
            cmd += [
                "--pipeline.model.camera-velocity-optimizer.zero-initial-velocities",
                "True",
            ]

    optimize_eval = (
        ("pose_opt" in features or "velocity_opt" in features) and not train_all
    )
    cmd += ["--pipeline.model.optimize-eval-cameras", str(optimize_eval)]

    if "cull_scale_thresh" in dp:
        cmd += ["--pipeline.model.cull-scale-thresh", str(dp["cull_scale_thresh"])]
    return name, cmd


def variants_for_dataset(dataset: str, extra: list[str] | None = None) -> list[set]:
    """The executed variant matrix (SURVEY.md Appendix A)."""
    synthetic = dataset.startswith("synthetic")
    has_rs = not synthetic and "rs" not in dataset  # RS force-off for synthetic-mb
    base: list[set] = [set(), {"motion_blur"}, {"pose_opt"}, {"pose_opt", "motion_blur"}]
    if "-rs" in dataset or "mbrs" in dataset or (not synthetic):
        base += [
            {"rolling_shutter"},
            {"motion_blur", "rolling_shutter"},
            {"pose_opt", "rolling_shutter"},
            {"pose_opt", "motion_blur", "rolling_shutter"},
        ]
    out = add_velocity_opt_variants(base, dataset)
    if extra:
        out += [set(e.split("-")) for e in extra]
    return out


def add_velocity_opt_variants(base: list[set], dataset: str) -> list[set]:
    """For every motion variant add velocity_opt and zero_init versions
    (reference train.py:216-239). Synthetic datasets have GT velocities, so the
    prior-init version is meaningful everywhere."""
    out = []
    for v in base:
        out.append(v)
        if "motion_blur" in v or "rolling_shutter" in v:
            out.append(v | {"velocity_opt"})
            out.append(v | {"velocity_opt", "zero_init"})
    return out


def find_sessions(input_root: Path, dataset: str) -> list[Path]:
    droot = input_root / dataset
    if not droot.exists():
        return []
    return sorted(p.parent for p in droot.glob("*/transforms.json"))


def find_config_path(out_dir: Path) -> Path:
    """One trained config per output dir is the contract (reference
    train.py:203-214), but a re-run appends a second timestamp dir — pick the
    NEWEST with a warning instead of crashing after a full training run."""
    configs = sorted(out_dir.glob("*/config.json"))
    assert configs, f"no trained run found in {out_dir}"
    if len(configs) > 1:
        print(
            f"warning: {len(configs)} runs in {out_dir}; using newest "
            f"{configs[-1].parent.name} (the reference expects one run per "
            f"dir — older timestamp dirs are stale re-runs)",
            file=sys.stderr, flush=True,
        )
    return configs[-1]


def _subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def process(session_dir: Path, dataset: str, features: set, args) -> Path | None:
    """Train one case in a `fit` subprocess, patch its metrics.json with the
    subprocess's wall time, and render its eval images; returns the run's
    config.json (None for a dry run)."""
    name, flags = flags_to_variant_name_and_cmd(features, dataset, args.train_all)
    dp = dataset_params(dataset)
    exp_name = f"{dataset}/{name}/{session_dir.name}"
    iters = 3000 if args.draft else args.iters

    eval_mode = "all" if args.train_all else dp.get("eval_mode", "interval")
    data_cmd = ["nerfstudio-data", "--eval-mode", eval_mode]
    if eval_mode == "interval":
        data_cmd += ["--eval-interval", str(dp.get("eval_interval", 8))]
    if dp.get("orientation_method"):
        data_cmd += ["--orientation-method", dp["orientation_method"]]

    cmd = [
        sys.executable, "-m", "splat_tpu_torch.cli.fit", "splatfacto",
        "--data", str(session_dir),
        "--output-dir", args.output_dir,
        "--experiment-name", exp_name,
        "--max-num-iterations", str(iters),
        "--vis", args.vis,
        *flags, *args.extra_flags, *data_cmd,
    ]
    print(" ".join(cmd), flush=True)
    if args.dry_run:
        return None
    env = _subprocess_env()
    t0 = time.time()
    subprocess.check_call(cmd, env=env)  # one process per run, as the JAX driver
    wall = time.time() - t0

    run_root = Path(args.output_dir) / exp_name / "splatfacto"
    config_path = find_config_path(run_root)
    metrics_path = config_path.parent / "metrics.json"
    if metrics_path.exists():
        m = json.loads(metrics_path.read_text())
        m["wall_clock_time_seconds"] = wall
        metrics_path.write_text(json.dumps(m, indent=2))

    if not args.no_render:
        subprocess.check_call(
            [sys.executable, "-m", "splat_tpu_torch.cli.render_model",
             "--load-config", str(config_path)], env=env)
    return config_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="colmap-sai-cli-vels-blur-scored")
    ap.add_argument("--input-dir", default="data/inputs")
    ap.add_argument("--output-dir", default="data/outputs")
    ap.add_argument("--case", type=int, default=0, help="1-based case number; 0 = all")
    ap.add_argument("--iters", type=int, default=20000)
    ap.add_argument("--draft", action="store_true", help="3000 iterations")
    ap.add_argument("--train_all", action="store_true")
    ap.add_argument("--no_eval", action="store_true")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--vis", default="none")
    ap.add_argument("--extra-variants", default="")
    ap.add_argument("--variants", default="",
                    help="comma list of variant NAMES to run (subset filter)")
    ap.add_argument("extra_flags", nargs="*", default=[])
    args = ap.parse_args(argv)

    extra = [e for e in args.extra_variants.split(",") if e]
    variants = variants_for_dataset(args.dataset, extra)
    if args.variants:
        want = set(args.variants.split(","))
        named = {
            flags_to_variant_name_and_cmd(v, args.dataset, args.train_all)[0]: v
            for v in variants
        }
        unknown = want - set(named)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}; "
                             f"have {sorted(named)}")
        variants = [named[n] for n in sorted(want)]
    sessions = find_sessions(Path(args.input_dir), args.dataset)
    if not sessions:
        print(f"no sessions found under {args.input_dir}/{args.dataset}")
        return []

    cases = list(itertools.product(sessions, variants))
    print(f"{len(cases)} cases ({len(sessions)} sessions x {len(variants)} variants)")
    selected = cases if args.case == 0 else [cases[args.case - 1]]
    return [process(session_dir, args.dataset, features, args)
            for session_dir, features in selected]


if __name__ == "__main__":
    main()
