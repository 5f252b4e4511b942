#!/usr/bin/env python3
"""Probe: does the host or the card set the pace of a training step, with no
profiler running?

    python3 scripts_dev/host_pace_torch.py [--cell phone_mbrs.train] [--seed N] [--steps 40]
                                           [--sync-audit 20]

Builds the benchmark cell's trainer as `perfbench/run.py` does (its set-up),
then times single steps, each from a synchronised card: `enqueue_ms`, the
host's time to return from the step with the card's waits removed (the
trainer's window-end synchronise is a no-op here, so the host does not wait
for the card unless the launch queue fills), and `step_ms`, to the end of a
synchronise after it. Where enqueue_ms is well under step_ms, the card sets
the pace; where they meet, the host does (or the queue filled). Steps that
log or refine read the device on the host and are left out. Prints the
medians of both, per kind of step (train alone, train with the eval-camera
step), and the card as nvidia-smi names it, as one JSON line.

--sync-audit N then runs on to 10 steps past a refine and runs N steps
(`Trainer.run`, chunks of `sync_every`) under
`torch.cuda.set_sync_debug_mode("warn")`: `sync_sites` counts every call
site that waited for the card (the chunk's closing synchronise is expected).
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sync_sites(tr, steps: int) -> dict:
    """`steps` of `tr.run` from 10 steps past a refine, under the sync debug
    mode "warn": {file:line: waits}."""
    import torch

    refine, chunk = tr.model_config.refine_every, tr.trainer_config.sync_every
    while tr.step % refine != 10:
        tr.run(min(chunk, (10 - tr.step) % refine or refine))
    sites = collections.Counter()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.run(steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            where = Path(w.filename)
            where = where.relative_to(ROOT) if ROOT in where.parents else where
            sites[f"{where}:{w.lineno}"] += 1
    return dict(sites.most_common())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="phone_mbrs.train")
    ap.add_argument("--seed", type=int, default=4000000201)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--sync-audit", type=int, default=0, metavar="STEPS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("host_pace_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from perfbench import harness
    from perfbench.traffic import train as traffic
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.utils.profiling import nvidia_smi

    cell = harness.load("workloads", args.cell)
    config = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    dev = torch.device("cuda")
    tr = traffic.Run(cell, config, mix, args.seed, dev).trainer
    tc, cfg = tr.trainer_config, tr.model_config
    real_sync = torch.cuda.synchronize
    rows = {"train": [], "train+eval_camera": []}
    launches = []
    for _ in range(args.steps):
        step = tr.step
        if (step % cfg.refine_every == 0 or (step + 1) % cfg.refine_every == 0
                or (step + 1) % tc.log_every == 0):
            tr.run(1)                     # a refine or a log record: the host reads the card
            continue
        kind = "train+eval_camera" if step % tc.eval_opt_every == 0 else "train"
        real_sync()
        before = sum(kcuda.path_launches().values())
        torch.cuda.synchronize = lambda *a, **k: None
        try:
            t0 = time.perf_counter()
            tr.run(1)
            t1 = time.perf_counter()
        finally:
            torch.cuda.synchronize = real_sync
        real_sync()
        t2 = time.perf_counter()
        rows[kind].append(((t1 - t0) * 1e3, (t2 - t0) * 1e3))
        launches.append(sum(kcuda.path_launches().values()) - before)
    out = {"cell": args.cell, "seed": args.seed, "card": nvidia_smi("name,power.limit"),
           "hand_written_launches_a_step": statistics.median(launches)}
    for kind, r in rows.items():
        if r:
            out[kind] = {"n": len(r), "enqueue_ms": statistics.median(e for e, _ in r),
                         "step_ms": statistics.median(s for _, s in r),
                         "enqueue_ms_all": [round(e, 3) for e, _ in r],
                         "step_ms_all": [round(s, 3) for _, s in r]}
    if args.sync_audit:
        start = tr.step
        out["sync_sites"] = sync_sites(tr, args.sync_audit)
        out["sync_audit_steps"] = [tr.step - args.sync_audit, tr.step]
        out["sync_audit_from"] = start
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
