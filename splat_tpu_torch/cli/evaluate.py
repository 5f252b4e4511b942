#!/usr/bin/env python
"""Standalone evaluation, the `ns-eval` equivalent (port of `cli/evaluate.py`):
loads a trained run's `config.json` and its newest checkpoint and computes
PSNR / SSIM over the eval split, writing `{"results": {...}}` to
--output-path (the metrics.json contract).

  python -m splat_tpu_torch.cli.evaluate --load-config <run_dir>/config.json

It runs on the device the run was trained on (`device` in its config.json).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def load_trainer_from_config(config_path: Path):
    """eval_setup equivalent: config.json -> (cfg, trainer with the newest
    checkpoint loaded), on the run's own device."""
    from ..data import dataparser as dp
    from ..engine import config as cfg_mod
    from ..engine import trainer as tr

    cfg = cfg_mod.load_config(config_path)
    scene = dp.parse_scene(cfg.data, cfg.dataparser)
    trainer = tr.Trainer(scene, cfg.model, cfg.trainer, device=cfg.device)
    ckpts = sorted(
        (Path(config_path).parent / "checkpoints").glob("step_*"),
        key=lambda p: int(p.name.split("_")[1]),
    )
    if ckpts:
        trainer.load_checkpoint(ckpts[-1])
    return cfg, trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--output-path", default="", help="default: <run_dir>/metrics.json")
    args = ap.parse_args(argv)

    config_path = Path(args.load_config)
    t0 = time.time()
    cfg, trainer = load_trainer_from_config(config_path)
    results = trainer.evaluate()
    out = {
        "experiment_name": cfg.experiment_name,
        "method_name": cfg.method_name,
        "checkpoint_step": trainer.step,
        "results": results,
        "eval_wall_clock_seconds": time.time() - t0,
    }
    out_path = Path(args.output_path) if args.output_path else config_path.parent / "metrics.json"
    # preserve an existing training wall clock if present
    if out_path.exists():
        try:
            prev = json.loads(out_path.read_text())
            if "wall_clock_time_seconds" in prev:
                out["wall_clock_time_seconds"] = prev["wall_clock_time_seconds"]
        except json.JSONDecodeError:
            pass
    out_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(results))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
