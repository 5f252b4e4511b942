#!/usr/bin/env python
"""Generate the synthetic benchmark suite (port of `cli/generate_synthetic_suite.py`).

The same dataset shapes as the JAX package's suite, from the port's scene
generator (`splat_tpu_torch/data/synthetic.py`, whose `transforms.json` and
`sparse_pc.ply` are byte-identical to the JAX generator's): ground-truth
images integrated over the true camera trajectory (real motion blur and
rolling shutter, not the first-order model the trainer uses), ground-truth
camera-frame velocities, every-8th sharp eval frames and sparse_pc.ply seed
clouds, at benchmark resolution.

Output tree matches `splat_tpu_torch.cli.train`'s session discovery:
  INPUT_DIR/synthetic-{clear,mb,rs,mbrs}/{scene}/transforms.json

  python -m splat_tpu_torch.cli.generate_synthetic_suite --input-dir data/inputs \
      --resolution 512 --scenes 2 [--variants mb,rs] [--device cpu]

The frames are rendered on the CUDA device unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import numpy as np

# (exposure, rolling_shutter) per variant — mirrors the reference's synthetic
# matrix semantics: mb = exposure blur only, rs = readout skew only, mbrs =
# both (process_synthetic_inputs.py raw_clear/raw_mb/raw_rs/raw_mbrs)
VARIANTS = {
    "clear": (0.0, 0.0),
    "mb": (0.12, 0.0),
    # rs 0.07 s readout: at the suite's shake rates (~0.45 rad/s) this gives
    # ~18 px of scanline skew — severity comparable to the mb variants'
    # exposure blur (sharp-vs-distorted ~25 dB), so the RS-compensation
    # ordering margin is as resolvable as the MB one. 0.04 measured too mild
    # (~30 dB severity on scene0).
    "rs": (0.0, 0.07),
    "mbrs": (0.12, 0.07),
}

# Per-scene trajectory: handheld-style rotational shake
# (data/synthetic.py:shake_pose_gl). A bare orbit's blur self-cancels at the
# look-at center (+0.66 dB MB-vs-baseline, below the 1 dB ordering margin,
# benchmarks/README.md); whole-image rotational blur is what a
# Deblur-NeRF-style benchmark exercises. scene2 is the heavy-motion scene
# (peak shake rate ~0.63 rad/s ~ 43 px of blur at 512px over the 0.12 s
# exposure). A 0.05 rad shake on scene0 left only 1.12 dB of blur-induced
# headroom at 20k iterations (benchmarks/README.md), below the 1.0 dB margin
# by construction, so scene0 sits at 0.095 rad, inside the band bracketed by
# scene1 (0.08 -> +1.56 dB at 20k) and scene2 (0.11 -> +1.92 dB).
SCENE_TRAJECTORIES = [
    ("shake", 0.095, 1.15),
    ("shake", 0.08, 1.2),
    ("shake", 0.11, 1.1),
    ("orbit", 0.0, 1.0),  # scene3+: the self-canceling orbit
]


def derive_velnoise(src: Path, dst: Path, seed: int, rel_noise: float = 0.6) -> None:
    """Write DST as SRC with per-frame velocity priors corrupted by
    deterministic Gaussian noise (rel_noise x the per-axis RMS), images
    shared via copy. Models a wrong VIO prior: on this dataset velocity
    optimization must recover what the prior got wrong (reference noise
    variants: process_synthetic_inputs.py:414-465 posenoise family)."""
    dst.mkdir(parents=True, exist_ok=True)
    meta = json.loads((src / "transforms.json").read_text())
    rng = np.random.default_rng(seed + 777)
    lin = np.array([f["camera_linear_velocity"] for f in meta["frames"]])
    ang = np.array([f["camera_angular_velocity"] for f in meta["frames"]])
    train = np.array([np.any(np.abs(l) > 0) or np.any(np.abs(a) > 0)
                      for l, a in zip(lin, ang)])
    lin_rms = np.sqrt((lin[train] ** 2).mean()) if train.any() else 0.0
    ang_rms = np.sqrt((ang[train] ** 2).mean()) if train.any() else 0.0
    for f, is_train in zip(meta["frames"], train):
        if not is_train:
            continue  # eval frames keep the zero-velocity invariant
        f["camera_linear_velocity"] = (
            np.array(f["camera_linear_velocity"])
            + rng.normal(size=3) * rel_noise * lin_rms
        ).tolist()
        f["camera_angular_velocity"] = (
            np.array(f["camera_angular_velocity"])
            + rng.normal(size=3) * rel_noise * ang_rms
        ).tolist()
    (dst / "transforms.json").write_text(json.dumps(meta, indent=2))
    if not (dst / "images").exists():
        shutil.copytree(src / "images", dst / "images")
    shutil.copy2(src / "sparse_pc.ply", dst / "sparse_pc.ply")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input-dir", default="data/inputs")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--scenes", type=int, default=2, help="scenes per variant")
    ap.add_argument("--n-gaussians", type=int, default=1500)
    ap.add_argument("--n-frames", type=int, default=33)
    ap.add_argument("--blur-gt-samples", type=int, default=17,
                    help="GT exposure-integration samples; heavy-motion scenes "
                         "(~40 px blur) need >=15 for band-free ground truth")
    ap.add_argument("--variants", default="mb,rs",
                    help="comma list from clear,mb,rs,mbrs")
    ap.add_argument("--derive-velnoise", action="store_true",
                    help="also write synthetic-mb-velnoise (corrupted velocity "
                         "priors, shared images) from each synthetic-mb scene")
    ap.add_argument("--trajectory", default="",
                    help="override per-scene trajectory (orbit|shake|jerk)")
    ap.add_argument("--texture-scene", action="store_true",
                    help="also emit a scene_tex session per variant: 8000 "
                         "small splats (high-frequency content) — blur "
                         "destroys information here, so compensation "
                         "margins survive full-length training (the "
                         "low-frequency default scenes let the baseline "
                         "average mild blur away by 20k iterations)")
    ap.add_argument("--tex-scale-mul", type=float, default=0.45,
                    help="scene_tex splat-scale multiplier. 0.25 "
                         "overshoots the difficulty: ~40 px blur "
                         "over 0.25x splats left nothing recoverable and "
                         "PSNR saturated at the blurry-reconstruction level "
                         "for both methods (benchmarks/README.md). 0.45 "
                         "keeps the content high-frequency while leaving "
                         "recoverable signal, so compensation discriminates "
                         "at 20k iterations.")
    ap.add_argument("--tex-shake-amp", type=float, default=0.08,
                    help="scene_tex shake amplitude (rad)")
    ap.add_argument("--jerk-scene", action="store_true",
                    help="also emit a scene_jerk session per variant: "
                         "rotational shake whose period (~2x exposure) makes "
                         "the angular velocity reverse WITHIN an exposure — "
                         "the class where the first-order constant-velocity "
                         "model (and the fused-anchor linearization) is "
                         "weakest")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the frames are rendered: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data import synthetic

    for variant in args.variants.split(","):
        exposure, rs = VARIANTS[variant.strip()]
        for si in range(args.scenes):
            traj, amp, period = SCENE_TRAJECTORIES[min(si, len(SCENE_TRAJECTORIES) - 1)]
            if args.trajectory:
                traj = args.trajectory
            out = Path(args.input_dir) / f"synthetic-{variant}" / f"scene{si}"
            if (out / "transforms.json").exists():
                print(f"skip {out} (exists)", flush=True)
            else:
                print(f"generate {out}  ({args.resolution}px, exp={exposure}, "
                      f"rs={rs}, traj={traj}/{amp}, seed={1000 + si})", flush=True)
                if args.dry_run:
                    continue
                t0 = time.time()
                synthetic.generate_scene(
                    out,
                    n_gaussians=args.n_gaussians,
                    n_frames=args.n_frames,
                    img_size=args.resolution,
                    exposure=exposure,
                    rolling_shutter=rs,
                    n_blur_samples=args.blur_gt_samples,
                    gamma=2.2,
                    seed=1000 + si,
                    eval_interval=8,
                    n_seed_points=args.n_gaussians,
                    trajectory=traj,
                    shake_amp=amp,
                    shake_period=period,
                    device=args.device,
                )
                dt = time.time() - t0
                print(f"  done in {dt:.1f}s ({dt / args.n_frames:.3f} s per frame)", flush=True)
            if args.derive_velnoise and variant.strip() == "mb" and not args.dry_run:
                dst = Path(args.input_dir) / "synthetic-mb-velnoise" / f"scene{si}"
                if not (dst / "transforms.json").exists():
                    derive_velnoise(out, dst, seed=1000 + si)
                    print(f"derived {dst}", flush=True)
        if args.texture_scene:
            out = Path(args.input_dir) / f"synthetic-{variant}" / "scene_tex"
            if (out / "transforms.json").exists():
                print(f"skip {out} (exists)", flush=True)
            elif not args.dry_run:
                print(f"generate {out}  (texture: 8000 splats, scale "
                      f"{args.tex_scale_mul}x, shake/{args.tex_shake_amp})",
                      flush=True)
                synthetic.generate_scene(
                    out, n_gaussians=8000, n_frames=args.n_frames,
                    img_size=args.resolution, exposure=exposure,
                    rolling_shutter=rs, n_blur_samples=args.blur_gt_samples,
                    gamma=2.2, seed=1777, eval_interval=8,
                    n_seed_points=4000, trajectory="shake",
                    shake_amp=args.tex_shake_amp, shake_period=1.2,
                    scale_mul=args.tex_scale_mul, device=args.device,
                )
        if args.jerk_scene:
            out = Path(args.input_dir) / f"synthetic-{variant}" / "scene_jerk"
            if (out / "transforms.json").exists():
                print(f"skip {out} (exists)", flush=True)
            elif not args.dry_run:
                # amp 0.05 at period 0.25 s: peak rate ~1.8 rad/s with full
                # direction reversal inside the 0.12 s exposure
                print(f"generate {out}  (jerk/0.05 period 0.25)", flush=True)
                synthetic.generate_scene(
                    out, n_gaussians=args.n_gaussians, n_frames=args.n_frames,
                    img_size=args.resolution, exposure=exposure,
                    rolling_shutter=rs, n_blur_samples=args.blur_gt_samples,
                    gamma=2.2, seed=1099, eval_interval=8,
                    n_seed_points=args.n_gaussians, trajectory="jerk",
                    shake_amp=0.05, shake_period=0.25, device=args.device,
                )


if __name__ == "__main__":
    main()
