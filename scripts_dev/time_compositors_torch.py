#!/usr/bin/env python3
"""Time the two compositing kernels at the main path's shapes, from one
checkout of the port.

    python3 scripts_dev/time_compositors_torch.py [--root DIR] [--label NAME]

Imports `splat_tpu_torch` and `chip_smoke` from DIR (default: the checkout
this script is in), so two trees can be timed in turns within one run on one
card: an unpacked older commit and this one, each building its own kernels.
The inputs are chip_smoke.py phase 2's: camera 0's binning of the bench scene
(100k Gaussians, 1024x1024, 4096 tiles of 16x16, K = 256, S = 5 fused blur
samples) and a seeded cotangent. Prints one JSON line: the card's name and
power limit, the ms per call of `rasterize_fwd` and `rasterize_bwd` (CUDA
events, median of 20 runs of 10 back-to-back calls), a checksum of each
output, and what ptxas reported for the S = 5 kernels when this run built
them. Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

RUNS, REPS = 20, 10


def ptxas_report(log: str, marker: str = "ILi5E") -> dict:
    """{kernel: "N registers, ..."} for the entry points whose mangled name
    holds `marker` (the S = 5 instantiation), from `nvcc -Xptxas -v`."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif name and marker in name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_compositors_torch: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    from splat_tpu_torch.cameras import optimizers as cam_opt
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import rasterize, tiling
    from splat_tpu_torch.ops.cuda import build
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy
    from splat_tpu_torch.utils.profiling import nvidia_smi, time_cuda

    report = build.build(["seg_copy", "rasterize_fwd", "rasterize_bwd", "row_gather"])
    dev = torch.device("cuda")
    res = chip_smoke.RES
    params = params_from_numpy(chip_smoke.model_tree(), device=dev)
    cams = cameras_from_numpy(chip_smoke.camera_fields(), device=dev)
    cfg = sf.SplatfactoConfig(camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                              camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True))
    k = cfg.max_per_tile
    with torch.no_grad():
        g = params.gaussians
        op = torch.sigmoid(g.opacities_logit) * g.alive
        motion = sf.camera_motion(params, cams[0], cfg)
        t_a = motion.eps.mean()
        proj, colors = sf.subframe_inputs(params, motion, cfg, cfg.sh_degree, t_a)
        eps = motion.eps - t_a
        lists = rasterize.bin_tiles(proj, op, res, res, eps, motion.rs_time, cfg.tile_size, k,
                                    cfg.max_tiles_per_gaussian)
        sp = kcuda.sorted_stream(kcuda.pack_param_table(proj, colors, op), lists.sorted_ids, k)
        blocks = seg_copy(sp, lists.starts, k, impl="cuda")
        tiles_x = tiling.num_tiles(res, res, cfg.tile_size)[0]
        fwd_args = (blocks, lists.counts, motion.rs_time, cfg.tile_size, tiles_x, res)
        fwd = rk.rasterize_fwd(*fwd_args, eps=eps, impl="cuda")
        g_out = torch.randn(fwd.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(chip_smoke.SEED))
        scalars = rk.scalar_vec(motion.rs_time, 0.0, eps, dev)
        bwd_args = (blocks, lists.counts, scalars, fwd, g_out, cfg.tile_size, tiles_x, res)
        grad = rk.rasterize_bwd(*bwd_args, impl="cuda")
        fwd_ms = time_cuda(lambda: rk.rasterize_fwd(*fwd_args, eps=eps, impl="cuda"), RUNS, REPS)
        bwd_ms = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="cuda"), RUNS, REPS)
    print(json.dumps({
        "label": args.label, "root": str(Path(args.root).resolve()),
        "card": nvidia_smi("name,power.limit"), "tiles": int(lists.counts.shape[0]), "K": k,
        "S": int(eps.shape[0]), "rasterize_fwd_ms": fwd_ms, "rasterize_bwd_ms": bwd_ms,
        "fwd_sum": float(fwd.double().sum()), "bwd_abs_sum": float(grad.double().abs().sum()),
        "ptxas": {name: ptxas_report(r["log"]) for name, r in report.items()
                  if name.startswith("rasterize")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
