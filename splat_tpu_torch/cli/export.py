#!/usr/bin/env python
"""Gaussian-splat exporter, the `ns-export gaussian-splat` equivalent (port
of `cli/export.py`).

Writes the de-facto-standard 3DGS PLY layout (INRIA training output /
antimatter15-style viewers): binary_little_endian vertices with properties
  x y z nx ny nz f_dc_0..2 f_rest_0..(3*(B-1)-1) opacity scale_0..2 rot_0..3
where f_rest is stored CHANNEL-MAJOR (all B-1 coeffs of R, then G, then B),
opacity is the pre-sigmoid logit, scales are log-scales and rot is the
(w, x, y, z) quaternion. Dead (culled) gaussians are dropped; an optional
axis-aligned crop box restricts the export region.

  python -m splat_tpu_torch.cli.export --load-config <run>/config.json \
      --output model.splat.ply [--crop xmin xmax ymin ymax zmin zmax] [--min-opacity 0.005]

It loads the run on the device it was trained on (`device` in its config.json).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def export_ply(path, means, scales_log, quats, opacities_logit,
               features_dc, features_rest):
    """Write the standard 3DGS binary PLY (see module docstring)."""
    n, b_rest = features_rest.shape[0], features_rest.shape[1]
    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(3 * b_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )
    # channel-major f_rest: (B-1, 3) per splat -> R-coeffs, G-coeffs, B-coeffs
    rest_cm = np.transpose(features_rest, (0, 2, 1)).reshape(n, 3 * b_rest)
    normals = np.zeros((n, 3), np.float32)
    rec = np.concatenate(
        [means, normals, features_dc, rest_cm,
         opacities_logit[:, None], scales_log, quats], axis=1
    ).astype("<f4")
    assert rec.shape[1] == len(props), (rec.shape, len(props))
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def export_mask(g, min_opacity: float = 0.0, lo=None, hi=None) -> np.ndarray:
    """The Gaussians of `g` (a `GaussianParams`) that are exported: alive, at
    least `min_opacity` after the sigmoid (when > 0), and inside [lo, hi]."""
    keep = g.alive.detach().cpu().numpy() > 0
    if min_opacity > 0:
        keep &= torch.sigmoid(g.opacities_logit.detach()).cpu().numpy() >= min_opacity
    if lo is not None:
        means = g.means.detach().cpu().numpy()
        keep &= np.all((means >= np.asarray(lo)) & (means <= np.asarray(hi)), axis=1)
    return keep


def export_gaussians(path, g, keep: np.ndarray) -> None:
    """export_ply of the rows of `g` where `keep` holds."""
    leaf = lambda t: t.detach().cpu().numpy()[keep]  # noqa: E731
    export_ply(path, leaf(g.means), leaf(g.scales_log), leaf(g.quats),
               leaf(g.opacities_logit), leaf(g.features_dc), leaf(g.features_rest))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--crop", type=float, nargs=6, default=None,
                    metavar=("XMIN", "XMAX", "YMIN", "YMAX", "ZMIN", "ZMAX"),
                    help="axis-aligned crop box in scene units")
    ap.add_argument("--min-opacity", type=float, default=0.0,
                    help="drop splats below this (post-sigmoid) opacity")
    args = ap.parse_args(argv)

    from .evaluate import load_trainer_from_config

    _, trainer = load_trainer_from_config(Path(args.load_config))
    g = trainer.params.gaussians
    lo = hi = None
    if args.crop is not None:
        lo, hi = np.array(args.crop[0::2]), np.array(args.crop[1::2])
    keep = export_mask(g, args.min_opacity, lo, hi)
    export_gaussians(args.output, g, keep)
    print(f"exported {int(keep.sum())} splats -> {args.output}")
    return int(keep.sum())


if __name__ == "__main__":
    main()
