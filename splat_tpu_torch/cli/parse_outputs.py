#!/usr/bin/env python
"""Metrics aggregator (port of `cli/parse_outputs.py`): walks a run tree and
collects every `metrics.json` into one table with the columns `dataset
variant session psnr ssim lpips time compile_time wall_time`.

Expected path shape:
  OUTPUT/DATASET/VARIANT/SESSION/splatfacto/TIMESTAMP/metrics.json

  python -m splat_tpu_torch.cli.parse_outputs --input-dir data/outputs [--by-variant] [--csv F]

The table is printed with plain string formatting (no pandas).
"""
from __future__ import annotations

import argparse
import csv
import json
import math
from pathlib import Path

COLUMNS = ["dataset", "variant", "session", "psnr", "ssim", "lpips", "time",
           "compile_time", "wall_time"]


def find_and_parse_directories_containing_splatting_metrics(root: Path) -> list[dict]:
    rows = []
    for metrics_path in sorted(root.rglob("*/splatfacto/*/metrics.json")):
        rel = metrics_path.relative_to(root)
        parts = rel.parts
        # DATASET/VARIANT/SESSION/splatfacto/TIMESTAMP/metrics.json
        if len(parts) < 6:
            continue
        dataset, variant, session = parts[0], parts[1], parts[2]
        try:
            m = json.loads(metrics_path.read_text())
        except json.JSONDecodeError:
            continue
        res = m.get("results", {})
        rows.append(
            {
                "dataset": dataset,
                "variant": variant,
                "session": session,
                "psnr": res.get("psnr"),
                "ssim": res.get("ssim"),
                "lpips": res.get("lpips"),
                # `time` is TRAINING time when the run separated compile from
                # train (fit.py writes both); total wall kept in its own column
                "time": m.get("train_time_seconds",
                              m.get("wall_clock_time_seconds")),
                "compile_time": m.get("compile_time_seconds"),
                "wall_time": m.get("wall_clock_time_seconds"),
            }
        )
    return rows


def _cell(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v)


def format_table(rows: list[dict], columns: list[str]) -> str:
    """Right-aligned columns under a header line."""
    cells = [[_cell(r.get(c)) for c in columns] for r in rows]
    widths = [max([len(c)] + [len(row[i]) for row in cells]) for i, c in enumerate(columns)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(row, widths)) for row in cells]
    return "\n".join(lines)


def mean_by_variant(rows: list[dict]) -> list[dict]:
    """Mean of the numeric columns per (dataset, variant); missing values skipped."""
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        groups.setdefault((r["dataset"], r["variant"]), []).append(r)
    out = []
    for (dataset, variant), rs in sorted(groups.items()):
        agg = {"dataset": dataset, "variant": variant}
        for c in ("psnr", "ssim", "lpips", "time", "compile_time"):
            vals = [r[c] for r in rs if r.get(c) is not None and not math.isnan(r[c])]
            agg[c] = sum(vals) / len(vals) if vals else None
        out.append(agg)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input-dir", default="data/outputs")
    ap.add_argument("--csv", default="", help="write CSV here")
    ap.add_argument("--by-variant", action="store_true", help="mean per variant")
    args = ap.parse_args(argv)

    rows = find_and_parse_directories_containing_splatting_metrics(Path(args.input_dir))
    if not rows:
        print("no metrics found")
        return
    if args.by_variant:
        print(format_table(mean_by_variant(rows),
                           ["dataset", "variant", "psnr", "ssim", "lpips", "time",
                            "compile_time"]))
    else:
        print(format_table(rows, COLUMNS))
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=COLUMNS)
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.csv}")
    return rows


if __name__ == "__main__":
    main()
