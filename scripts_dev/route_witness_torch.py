#!/usr/bin/env python3
"""Train one matrix run on the kernel route and on the plain route side by side.

    python3 scripts_dev/route_witness_torch.py [--steps N] [--work DIR] [--out DIR]

Needs a CUDA card. Writes synthetic-mb and synthetic-rs (scenes 0 and 1, the
suite's defaults) with `splat_tpu_torch.cli.generate_synthetic_suite`, then
for each case (synthetic-mb scene0 `motion_blur`, synthetic-rs scene1
`rolling_shutter`) builds two trainers from the same config as `cli.train`
gives its `fit` at `--draft` length (seed 42, the schedule of 3000 steps):
one composites through the CUDA kernels (impl "auto"), the other through
their plain PyTorch versions on the same card (impl "torch"). Both draw the
same random numbers (the same generators on the same device), so they differ
only in the rasterizer's route. They take N steps in lockstep (default 100).

Prints, and writes to OUT/summary.json, per case: each step's loss on both
routes and their relative difference, every leaf's largest difference as a
share of its largest value at steps 1, 10 and N, the eval PSNR of both at
the start and the end, the seconds per step of each route, and the card's
name and power limit. A route fault shows as a difference far above float
rounding from the first steps on; rounding alone grows slowly from ~1e-7.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = [("synthetic-mb", "scene0", "motion_blur"), ("synthetic-rs", "scene1", "rolling_shutter")]
DRAFT_STEPS, SEED = 3000, 42
LEAF_AT = (1, 10)


@torch.no_grad()
def leaf_shares(a, b) -> dict[str, float]:
    """max|a - b| / max|a| for every Gaussian leaf and the background."""
    out = {}
    for name in a.gaussians._fields:
        x, y = getattr(a.gaussians, name), getattr(b.gaussians, name)
        out[name] = float((x - y).abs().max() / x.abs().max().clamp(min=1e-30))
    out["background_logit"] = float((a.background_logit - b.background_logit).abs().max()
                                    / a.background_logit.abs().max().clamp(min=1e-30))
    return out


def witness(scene_dir: Path, dataset: str, variant: str, steps: int,
            device: str = "cuda") -> dict:
    from splat_tpu_torch.cli import train as cli_train
    from splat_tpu_torch.data import dataparser, dataset as ds
    from splat_tpu_torch.engine import config as run_config
    from splat_tpu_torch.engine import trainer as tr

    _, flags = cli_train.flags_to_variant_name_and_cmd(set(variant.split("-")), dataset, False)
    dp = cli_train.dataset_params(dataset)
    argv = ["splatfacto", "--data", str(scene_dir), "--max-num-iterations", str(DRAFT_STEPS),
            "--seed", str(SEED), *flags, "nerfstudio-data", "--eval-mode", dp["eval_mode"],
            "--eval-interval", str(dp["eval_interval"]),
            "--orientation-method", dp["orientation_method"]]
    cfg = run_config.parse_cli(argv)
    scene = dataparser.parse_scene(cfg.data, cfg.dataparser)
    train_imgs, eval_imgs = ds.load_scene_images(scene)
    tc = dataclasses.replace(cfg.trainer, max_steps=DRAFT_STEPS, seed=cfg.seed, log_every=1)
    routes = {}
    for impl in ("auto", "torch"):
        mc = dataclasses.replace(cfg.model, impl=impl)
        routes[impl] = tr.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs,
                                  device=device)
    kern, plain = routes["auto"], routes["torch"]
    sync = torch.cuda.synchronize if kern.device.type == "cuda" else (lambda: None)
    start = {impl: t.evaluate()["psnr"] for impl, t in routes.items()}
    losses, seconds, leaves = {"auto": [], "torch": []}, {"auto": 0.0, "torch": 0.0}, {}
    for step in range(1, steps + 1):
        for impl, t in routes.items():
            sync()
            t0 = time.perf_counter()
            losses[impl].append(t.run(1)[-1]["loss"])
            sync()
            seconds[impl] += time.perf_counter() - t0
        if step in LEAF_AT or step == steps:
            leaves[step] = leaf_shares(plain.params, kern.params)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["auto"], losses["torch"])]
    end = {impl: t.evaluate()["psnr"] for impl, t in routes.items()}
    return {"dataset": dataset, "session": scene_dir.name, "variant": variant, "steps": steps,
            "blur_samples": kern.model_config.blur_samples,
            "blur_anchors": kern.model_config.blur_anchors,
            "loss_kernels": losses["auto"], "loss_plain": losses["torch"],
            "loss_rel_diff": rel, "loss_rel_diff_max": max(rel),
            "loss_rel_diff_at": {s: rel[s - 1] for s in (*LEAF_AT, steps) if s <= steps},
            "leaf_shares_at": leaves, "psnr_start": start, "psnr_end": end,
            "seconds_per_step": {k: v / steps for k, v in seconds.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--work", default=str(ROOT / "_runs" / "witness"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "witness"))
    args = ap.parse_args(argv)

    from splat_tpu_torch.cli import generate_synthetic_suite as cli_suite
    from splat_tpu_torch.utils.profiling import nvidia_smi

    if not torch.cuda.is_available():
        raise SystemExit("route_witness_torch: needs a CUDA card")
    work, out = Path(args.work), Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cli_suite.main(["--input-dir", str(work / "inputs"), "--variants", "mb,rs", "--scenes", "2"])
    cases = []
    for dataset, session, variant in CASES:
        res = witness(work / "inputs" / dataset / session, dataset, variant, args.steps)
        cases.append(res)
        print(f"{dataset}/{session} {variant}: loss rel diff at steps "
              + ", ".join(f"{s}: {v:.3g}" for s, v in res["loss_rel_diff_at"].items())
              + f" (max {res['loss_rel_diff_max']:.3g}); psnr end kernels "
              f"{res['psnr_end']['auto']:.4f}, plain {res['psnr_end']['torch']:.4f}; s/step "
              f"{res['seconds_per_step']}", flush=True)
    summary = {"cases": cases, "card": nvidia_smi("name,power.limit")}
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"card": summary["card"], "cases": [
        {k: v for k, v in c.items() if not k.startswith("loss_") or k.endswith(("_max", "_at"))}
        for c in cases]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
