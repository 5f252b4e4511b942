"""Probes for the benchmark's four-card cell `phone_mbrs_xl.mesh4`.

    python scripts_dev/mesh_xl_probe_torch.py one-card [--seed N]
        the one-card trainer (perfbench kind "train", no mesh) at the cell's
        2^24 slots: its peak device memory through set-up, or the
        allocation that fails; then the blocked reference's check against
        it
    python scripts_dev/mesh_xl_probe_torch.py reference [--seed N]
        the blocked reference and the same with TF32 matrix products (the
        control), timed, and the control's readings against it
    python scripts_dev/mesh_xl_probe_torch.py sync-audit [--seed N] [--steps 20] [--no-check]
                                                        [--control]
        the cell's ranks set up as the benchmark sets them up, then `steps`
        steps between two refines with rank 0 under
        `torch.cuda.set_sync_debug_mode("warn")`: every call site that
        waits for the card, counted; then the blocked reference's check of
        the ranks' first steps, leaf by leaf; with --control also the
        reference in TF32 against it, through the same comparison

Each prints one JSON line last. Needs CUDA (four cards for sync-audit).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELL = "phone_mbrs_xl.mesh4"


def _files():
    from perfbench import harness

    cell = harness.load("workloads", CELL)
    return cell, harness.load("configs", cell["config"]), harness.load("traffic", cell["traffic"])


def _card() -> dict:
    from splat_tpu_torch.utils.profiling import nvidia_smi

    return {"card": nvidia_smi("name,power.limit")}


def one_card(seed: int) -> dict:
    import torch

    from perfbench.traffic import train, train_mesh

    cell, config, mix = _files()
    dev = torch.device("cuda")
    out = _card()
    t0 = time.perf_counter()
    try:
        run = train.Run(cell, config, {**mix, "kind": "train"}, seed, dev)
        out["one_card"] = "fits"
    except torch.cuda.OutOfMemoryError as e:
        out["one_card"] = f"out of memory: {str(e).splitlines()[0]}"
        run = None
    out["one_card_s"] = time.perf_counter() - t0
    out["one_card_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    program = None
    if run is not None:
        program = run.recorded
        run.free()
        del run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    if program is not None:
        for tf32 in (False, True):
            t0 = time.perf_counter()
            ref = train_mesh.reference_run(config, mix, seed, dev, tf32=tf32)
            key = "control" if tf32 else "check"
            out[key] = train.compare(program, ref)
            out[f"{key}_s"] = time.perf_counter() - t0
            out[f"{key}_leaves"] = _leaf_gaps(program, ref)
    return out


def reference(seed: int) -> dict:
    import torch

    from perfbench.traffic import train, train_mesh

    _, config, mix = _files()
    dev = torch.device("cuda")
    out = _card()
    refs = {}
    for tf32 in (False, True):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        refs[tf32] = train_mesh.reference_run(config, mix, seed, dev, tf32=tf32)
        out[f"reference_tf32_{tf32}_s"] = time.perf_counter() - t0
        out[f"reference_tf32_{tf32}_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["control_against_reference"] = train.compare(refs[True], refs[False])
    out["losses"] = refs[False]["loss"]
    return out


def sync_audit(seed: int, steps: int, check: bool = True, control: bool = False) -> dict:
    import torch

    from perfbench.traffic import train, train_mesh

    cell, config, mix = _files()
    run = train_mesh.Run(cell, config, mix, seed, torch.device("cuda"))
    tr = run.trainer
    refine = tr.model_config.refine_every
    chunk = tr.trainer_config.sync_every
    # to a chunk boundary 10 steps past a refine, so the audited steps hold none
    while tr.step % refine != 10:
        run._run(chunk)
    start = tr.step
    sites = collections.Counter()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run._run(steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            where = Path(w.filename)
            where = where.relative_to(ROOT) if ROOT in where.parents else where
            sites[f"{where}:{w.lineno}"] += 1
    program = run.recorded
    out = {**_card(), "steps": [start, start + steps], "refine_every": refine,
           "sync_every": chunk, "sync_sites": dict(sites.most_common()), "setup": run.notes}
    run.free()
    del run, tr
    torch.cuda.empty_cache()
    if check:
        t0 = time.perf_counter()
        ref = train_mesh.reference_run(config, mix, seed, torch.device("cuda"))
        out.update(check=train.compare(program, ref), leaves=_leaf_gaps(program, ref),
                   check_s=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
        if control:
            ctl = train_mesh.reference_run(config, mix, seed, torch.device("cuda"), tf32=True)
            out.update(control=train.compare(ctl, ref), control_leaves=_leaf_gaps(ctl, ref))
    return out


def _leaf_gaps(program: dict, ref: dict) -> dict:
    """Each leaf's gap of `train.compare`'s grad and change, the largest first."""
    import statistics

    med = statistics.median(ref["grad"].values())
    out = {}
    for what in ("grad", "change"):
        gaps = {k: abs(program[what].get(k, 0.0) - v) / max(v, med, 1e-30)
                if what == "grad" else abs(program[what].get(k, 0.0) - v)
                / max(v, statistics.median(ref["change"].values()), 1e-30)
                for k, v in ref[what].items()}
        out[what] = dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:6])
        out[f"{what}_values"] = {k: [program[what].get(k), ref[what][k]] for k in out[what]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=("one-card", "reference", "sync-audit"))
    ap.add_argument("--seed", type=int, default=3500000017)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-check", action="store_true", help="sync-audit: skip the reference")
    ap.add_argument("--control", action="store_true",
                    help="sync-audit: also the TF32 reference against the reference")
    args = ap.parse_args(argv)
    if args.what == "one-card":
        out = one_card(args.seed)
    elif args.what == "reference":
        out = reference(args.seed)
    else:
        out = sync_audit(args.seed, args.steps, check=not args.no_check, control=args.control)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
