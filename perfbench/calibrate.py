"""The readings that a cell's limits are set from, at the cell's own size on
the card: the program's numbers against the reference on many seeds (the
lower readings); the control's, the reference computed with TF32 matrix
products and convolutions in the program's place; and, for a training cell,
the fault "half of the batch left out": the reference in the program's
place with its loss taken over the image's first half of rows (the upper
readings). The benchmark's runs never run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --what program|control|half_batch

One JSON line per seed: the seed, what was read, and the numbers compared.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control", "half_batch"), required=True)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load("workloads", args.workload)
    config = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    traffic = importlib.import_module(f"perfbench.traffic.{mix['kind']}")
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.what == "program":
            run = traffic.Run(cell, config, mix, seed, dev)
            res = run.window(0.0, False, None)
            program, notes = getattr(run, "recorded", None), run.notes
            run.free()
            del run
            checks = traffic.check(config, mix, seed, dev, program, res)
        elif args.what == "half_batch":
            from perfbench.reference import model as rm

            ref = traffic.reference_run(config, mix, seed, dev)
            full = rm.compute_losses

            def half(pred, gt, params, cfg):
                h = pred.shape[0] // 2
                return full(pred[:h], gt[:h], params, cfg)

            rm.compute_losses = half
            try:
                faulty = traffic.reference_run(config, mix, seed, dev)
            finally:
                rm.compute_losses = full
            checks = traffic.compare(faulty, ref)
            notes = {"ref_loss": ref["loss"], "fault_loss": faulty["loss"]}
        else:
            notes = {}
            if mix["kind"] == "train":
                ref = traffic.reference_run(config, mix, seed, dev)
                ctl = traffic.reference_run(config, mix, seed, dev, tf32=True)
                checks = traffic.compare(ctl, ref)
                notes = {"ref_loss": ref["loss"], "ctl_loss": ctl["loss"]}
            else:
                idx = traffic.check_indices(mix, seed)
                checks = traffic.compare(
                    traffic.reference_frames(config, mix, seed, dev, idx, tf32=True),
                    traffic.reference_frames(config, mix, seed, dev, idx))
        print(json.dumps({"cell": args.workload, "seed": seed, "what": args.what,
                          "checks": checks, "seconds": time.perf_counter() - t0,
                          "notes": notes}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
