#!/usr/bin/env python3
"""Train the port's variant matrix on the synthetic suite and report it.

    python3 scripts_dev/draft_matrix_torch.py [--work DIR] [--out DIR]
        [--plan draft|full|rs] [--seed N]

Writes synthetic-mb and synthetic-rs, scenes 0 and 1, with
`splat_tpu_torch.cli.generate_synthetic_suite --variants mb,rs --scenes 2`,
then trains single cases with `splat_tpu_torch.cli.train --variants ...
--case N` at `--draft` length (3000 iterations): synthetic-mb scene0
`baseline`, `motion_blur` and `motion_blur-pose_opt-velocity_opt`, and
synthetic-rs scene1 `baseline` and `rolling_shutter` (`--plan draft`).
`--plan full` trains the 20,000-iteration pair instead (synthetic-mb scene0
`baseline` and `motion_blur`), `--plan rs` only the synthetic-rs scene1
pair at draft length. `--seed N` passes `--seed N` to every `fit` (the runs'
default seed is 42), to measure the spread of a row over seeds. Last it runs
`splat_tpu_torch.cli.check_benchmark_ordering --margin 1.0` over the tree it
trained.

Prints, and writes to OUT/summary.json, one JSON object: each run's PSNR,
SSIM, training and wall seconds, steps per second (over the run, and the
median of its logged windows) and final Gaussian count; the checker's exit
code and output; the card's name and power limit. OUT also receives each
run's metrics.json, config.json and metrics_train.jsonl.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (dataset, --variants, the 1-based cases: (session, variant) in
# cli.train's order, sessions outer, variants sorted by name)
RS_PAIR = ("synthetic-rs", "baseline,rolling_shutter", [3, 4])
PLANS = {  # plan: (iteration flags, cases)
    "draft": (["--draft"], [("synthetic-mb",
                             "baseline,motion_blur,motion_blur-pose_opt-velocity_opt", [1, 2, 3]),
                            RS_PAIR]),
    "full": (["--iters", "20000"], [("synthetic-mb", "baseline,motion_blur", [1, 2])]),
    "rs": (["--draft"], [RS_PAIR]),
}


def run(cmd: list[str], log: Path) -> subprocess.CompletedProcess:
    print(" ".join(cmd), flush=True)
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    with open(log, "a") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    return proc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work", default=str(ROOT / "_runs" / "matrix"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "matrix"))
    ap.add_argument("--plan", default="draft", choices=sorted(PLANS))
    ap.add_argument("--seed", type=int, default=None, help="passed to every fit")
    args = ap.parse_args(argv)

    from splat_tpu_torch.utils.profiling import nvidia_smi

    work, out = Path(args.work), Path(args.out)
    tag = args.plan + ("" if args.seed is None else f"_seed{args.seed}")
    inputs, outputs, out = work / "inputs", work / f"outputs_{tag}", out / tag
    out.mkdir(parents=True, exist_ok=True)
    log = out / "log.txt"
    py = [sys.executable, "-m"]
    t0 = time.perf_counter()
    proc = run(py + ["splat_tpu_torch.cli.generate_synthetic_suite", "--input-dir", str(inputs),
                     "--variants", "mb,rs", "--scenes", "2"], log)
    if proc.returncode != 0:
        raise SystemExit(f"suite generation failed (rc {proc.returncode}); see {log}")
    gen_s = time.perf_counter() - t0

    iters, plan = PLANS[args.plan]
    seed = [] if args.seed is None else ["--", "--seed", str(args.seed)]
    for dataset, variants, cases in plan:
        for case in cases:
            proc = run(py + ["splat_tpu_torch.cli.train", "--dataset", dataset, "--input-dir",
                             str(inputs), "--output-dir", str(outputs), "--variants", variants,
                             "--case", str(case), *iters, *seed], log)
            if proc.returncode != 0:
                raise SystemExit(f"{dataset} case {case} failed (rc {proc.returncode}); see {log}")

    rows = []
    for metrics in sorted(outputs.rglob("*/splatfacto/*/metrics.json")):
        run_dir = metrics.parent
        dataset, variant, session = run_dir.relative_to(outputs).parts[:3]
        m = json.loads(metrics.read_text())
        logged = [json.loads(ln) for ln in (run_dir / "metrics_train.jsonl").read_text().splitlines()]
        logged = [r for r in logged if "steps_per_s" in r]
        steps = json.loads((run_dir / "config.json").read_text())["max_num_iterations"]
        rows.append({
            "dataset": dataset, "variant": variant, "session": session, "steps": steps,
            "psnr": m["results"]["psnr"], "ssim": m["results"]["ssim"],
            "train_time_seconds": m["train_time_seconds"],
            "wall_clock_time_seconds": m["wall_clock_time_seconds"],
            "compile_time_seconds": m["compile_time_seconds"],
            "steps_per_s": steps / m["train_time_seconds"],
            "steps_per_s_logged_median": statistics.median(r["steps_per_s"] for r in logged),
            "n_alive_end": logged[-1]["n_alive"]})
        dst = out / dataset / variant / session
        dst.mkdir(parents=True, exist_ok=True)
        for name in ("metrics.json", "config.json", "metrics_train.jsonl"):
            shutil.copy2(run_dir / name, dst / name)
    check = run(py + ["splat_tpu_torch.cli.check_benchmark_ordering", "--input-dir", str(outputs),
                      "--margin", "1.0"], log)
    summary = {"plan": args.plan, "seed": args.seed, "rows": rows,
               "checker_rc": check.returncode, "checker_output": check.stdout,
               "suite_seconds": gen_s, "card": nvidia_smi("name,power.limit")}
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
