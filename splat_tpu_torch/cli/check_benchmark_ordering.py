#!/usr/bin/env python
"""Variant-ordering check over a benchmark-matrix output tree (port of
`cli/check_benchmark_ordering.py`: the same rules, flags, messages and exit
codes, over the port's `parse_outputs`).

  python -m splat_tpu_torch.cli.check_benchmark_ordering --input-dir data/outputs --margin 1.0

The method's claim is that motion-blur / rolling-shutter compensation beats
the uncompensated Splatfacto baseline by dBs of PSNR on blurred or
rolling-shutter inputs. The check:

  * every `motion_blur*` variant beats `baseline` by >= --margin dB on each
    synthetic-mb session;
  * every `rolling_shutter*` variant beats `baseline` by >= --margin dB on
    each synthetic-rs session;
  * `zero_init` variants owe --zero-init-margin (default 0.25 dB) instead of
    the full margin: they discard the dataset's motion priors and must
    recover absolute velocities from scratch;
  * velocity-optimized variants stay within --vel-tol dB of their prior-
    velocity parents;
  * on `*velnoise` datasets (deliberately corrupted velocity priors,
    `generate_synthetic_suite.derive_velnoise`) velocity_opt variants must
    beat their fixed-prior parents by >= --vel-win-margin dB, and the
    beats-baseline rule is waived for fixed-prior variants.

Exit code 0 = ordering holds; 1 = violation (printed).
"""
import argparse
from pathlib import Path

from .parse_outputs import find_and_parse_directories_containing_splatting_metrics


def check(rows: list[dict], margin: float, vel_tol: float,
          vel_win_margin: float = 0.3, zero_init_margin: float = 0.25) -> list[str]:
    by_key = {}
    for r in rows:
        if r["psnr"] is not None:
            by_key[(r["dataset"], r["session"], r["variant"])] = r["psnr"]

    failures = []
    sessions = sorted({(d, s) for d, s, _ in by_key})
    for dataset, session in sessions:
        noisy_prior = "velnoise" in dataset or "posenoise" in dataset

        def p(variant):
            return by_key.get((dataset, session, variant))

        base = p("baseline")
        if base is None and not noisy_prior:
            failures.append(
                f"{dataset}/{session}: has variant rows but NO baseline row — "
                "nothing to compare against (baseline run missing/failed?)"
            )
            continue
        for (d, s, variant), psnr in sorted(by_key.items()):
            if (d, s) != (dataset, session):
                continue
            comp = None
            # smartphone-style recordings (the reference's real datasets)
            # carry BOTH motion blur and rolling shutter distortion
            has_mb = "mb" in dataset or "sai-cli" in dataset
            has_rs = "-rs" in dataset or "sai-cli" in dataset
            if has_mb and variant.startswith("motion_blur"):
                comp = "motion-blur compensation"
            if has_rs and variant.startswith("rolling_shutter"):
                comp = "rolling-shutter compensation"
            # on noisy-prior datasets only velocity-optimized variants have a
            # correct motion model available, so only they owe the margin
            if noisy_prior and "velocity_opt" not in variant:
                comp = None
            owed = zero_init_margin if variant.endswith("zero_init") else margin
            if comp and base is not None and psnr < base + owed:
                failures.append(
                    f"{dataset}/{session}: {variant} = {psnr:.2f} dB does not "
                    f"beat baseline = {base:.2f} dB by {owed} dB ({comp})"
                )
            if "velocity_opt" in variant:
                parent_name = variant.replace("-velocity_opt-zero_init", "") \
                                     .replace("-velocity_opt", "")
                parent = p(parent_name or "baseline")
                if parent is None:
                    continue
                if noisy_prior:
                    if psnr < parent + vel_win_margin:
                        failures.append(
                            f"{dataset}/{session}: {variant} = {psnr:.2f} dB "
                            f"does not beat its corrupted-prior parent "
                            f"{parent_name} = {parent:.2f} dB by "
                            f"{vel_win_margin} dB (velocity opt must recover "
                            "the wrong prior)"
                        )
                elif variant.endswith("velocity_opt") and psnr < parent - vel_tol:
                    failures.append(
                        f"{dataset}/{session}: {variant} = {psnr:.2f} dB fell "
                        f">{vel_tol} dB below its parent {parent:.2f} dB"
                    )
    if not sessions:
        failures.append("no baseline rows found — nothing checked")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input-dir", default="data/outputs")
    ap.add_argument("--margin", type=float, default=1.0,
                    help="min dB a compensated variant must beat baseline by")
    ap.add_argument("--vel-tol", type=float, default=0.5,
                    help="max dB velocity_opt may fall below its parent")
    ap.add_argument("--vel-win-margin", type=float, default=0.3,
                    help="min dB velocity_opt must beat its parent by on "
                         "corrupted-prior (*velnoise/*posenoise) datasets")
    ap.add_argument("--zero-init-margin", type=float, default=0.25,
                    help="margin owed by zero_init variants (motion learned "
                         "from scratch, priors discarded)")
    args = ap.parse_args(argv)

    rows = find_and_parse_directories_containing_splatting_metrics(
        Path(args.input_dir))
    failures = check(rows, args.margin, args.vel_tol, args.vel_win_margin,
                     args.zero_init_margin)
    n = len([r for r in rows if r["psnr"] is not None])
    if failures:
        print(f"ORDERING VIOLATIONS ({len(failures)}; {n} runs checked):")
        for f in failures:
            print("  " + f)
        return 1
    print(f"variant ordering holds over {n} runs "
          f"(margin {args.margin} dB, vel tol {args.vel_tol} dB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
