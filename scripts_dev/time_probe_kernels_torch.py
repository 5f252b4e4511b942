#!/usr/bin/env python3
"""Time `row_scatter` and `bwd_stacked` beside `rasterize_bwd`, from one
checkout of the port.

    python3 scripts_dev/time_probe_kernels_torch.py [--root DIR] [--label NAME]

Imports `splat_tpu_torch` and `chip_smoke` from DIR (default: the checkout
this script is in), so two trees can be timed in turns within one run on one
card: an unpacked older commit and this one, each building its own kernels.

- `bwd_stacked` at every tps and `rasterize_bwd`, at chip_smoke.py phase 2's
  backward inputs: camera 0's binning of the bench scene (100k Gaussians,
  1024x1024, 4096 tiles of 16x16, K = 256, S = 5 fused blur samples) and a
  seeded cotangent;
- `row_scatter` at its probe's shape (1024 x 512 int32 indices over 100,008
  rows of 16 floats, `scripts_dev/probe_kernel_gather_torch.py`): the whole
  function with its plan, the sum given a plan, the plan alone, and float32
  `index_add_` (atomics) in the same run, back to back and cold;
- sha256 digests of each output, and of `rasterize_bwd`'s on `bits_inputs`
  (made by numpy alone), so two trees' bits can be compared.

CUDA events, median of 20 runs of 10 back-to-back calls (`time_cuda`), one
call after overwriting the L2 for the cold times (`time_cuda_cold`), and the
host's microseconds a call for `row_scatter`'s calls (100 enqueued without a
synchronise). Prints
one JSON line with the card's name and power limit and what ptxas reported
for the kernels this run built. Needs a CUDA device; exits nonzero without
one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

RUNS, REPS = 20, 10
TPS = (8, 4, 2, 1)
# the tiles and sample counts of `bits_inputs`
BITS_CASES = {"16x16 S=5": (16, 5), "16x8 S=16": ((16, 8), 16)}
SCATTER_SHAPE, SCATTER_ROWS, SCATTER_SOURCE_ROWS, SCATTER_WIDTH = (1024, 512), 100_008, 100_000, 16


def _load(name: str):
    """scripts_dev/<name>.py, which is a script and not a package module."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bits_inputs(dev, label):
    """rasterize_bwd's arguments from numpy alone: the cull probe's
    adversarial blocks (finite), a uniform forward output and a normal
    cotangent, seeded; `label` is a key of BITS_CASES."""
    from splat_tpu_torch.ops.tiling import tile_wh

    tile, n_samples = BITS_CASES[label]
    inp = _load("probe_cull_torch").make_inputs(dev, tile, n_samples, -0.05)
    sw, sh = tile_wh(tile)
    shape = (inp["params"].shape[0], n_samples, 5, sw * sh)
    rng = np.random.default_rng(11)
    fwd = torch.tensor(rng.uniform(size=shape).astype(np.float32), device=dev)
    g_out = torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev)
    return (inp["params"], inp["counts"], inp["scalars"], fwd, g_out, inp["tile_size"],
            inp["tiles_x"], inp["img_h"])


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def device_times(fn, calls: int = 10) -> dict:
    """{kernel name: mean device microseconds per call of fn} over `calls`
    calls under torch.profiler (launch counts beside), and the sum of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0:
            out[evt.key[:60]] = {"us": us / calls, "per_call": evt.count / calls}
    out["sum_us"] = sum(v["us"] for v in out.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_probe_kernels_torch: needs a CUDA device", file=sys.stderr)
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
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked
    from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, scatter_plan
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy
    from splat_tpu_torch.utils.profiling import nvidia_smi, time_cuda, time_cuda_cold

    report = build.build(["seg_copy", "rasterize_fwd", "rasterize_bwd", "row_gather",
                          "row_scatter", "bwd_stacked"])
    dev = torch.device("cuda")
    res = chip_smoke.RES
    params = params_from_numpy(chip_smoke.model_tree(), device=dev)
    cams = cameras_from_numpy(chip_smoke.camera_fields(), device=dev)
    cfg = sf.SplatfactoConfig(camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                              camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True))
    k = cfg.max_per_tile
    out = {"label": args.label, "root": str(Path(args.root).resolve()),
           "card": nvidia_smi("name,power.limit")}
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
        fwd = rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, cfg.tile_size, tiles_x, res,
                               eps=eps, impl="cuda")
        g_out = torch.randn(fwd.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(chip_smoke.SEED))
        scalars = rk.scalar_vec(motion.rs_time, 0.0, eps, dev)
        bwd_args = (blocks, lists.counts, scalars, fwd, g_out, cfg.tile_size, tiles_x, res)
        out["rasterize_bwd_sha256"] = digest(rk.rasterize_bwd(*bwd_args, impl="cuda"))
        out["bwd_stacked_sha256"] = digest(bwd_stacked(*bwd_args, tps=1, impl="cuda"))
        out["rasterize_bwd_ms"] = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="cuda"),
                                            RUNS, REPS)
        out["bwd_stacked_ms"] = {
            f"tps={tps}": time_cuda(lambda: bwd_stacked(*bwd_args, tps=tps, impl="cuda"),
                                    RUNS, REPS)
            for tps in TPS}
        out["bwd_stacked_device_us"] = device_times(
            lambda: bwd_stacked(*bwd_args, tps=1, impl="cuda"), 3)
        out["rasterize_bwd_ms_after"] = time_cuda(
            lambda: rk.rasterize_bwd(*bwd_args, impl="cuda"), RUNS, REPS)
        del blocks, sp, fwd, g_out, bwd_args

        rng = np.random.default_rng(0)
        idx = torch.tensor(rng.integers(0, SCATTER_SOURCE_ROWS, size=SCATTER_SHAPE)
                           .astype(np.int32), device=dev)
        src = torch.tensor(rng.normal(size=SCATTER_SHAPE + (SCATTER_WIDTH,)).astype(np.float32),
                           device=dev)
        n = SCATTER_ROWS
        plan = scatter_plan(idx, n)
        flat, rows = idx.reshape(-1).long(), src.reshape(-1, SCATTER_WIDTH)
        zeros = torch.zeros((n, SCATTER_WIDTH), device=dev)
        out["row_scatter_sha256"] = digest(row_scatter(idx, src, n, impl="cuda"))
        out["scatter_plan_sha256"] = digest(torch.cat(plan))
        calls = {
            "row_scatter_ms": lambda: row_scatter(idx, src, n, impl="cuda"),
            "row_scatter_kernel_ms": lambda: row_scatter(idx, src, n, impl="cuda", plan=plan),
            "scatter_plan_ms": lambda: scatter_plan(idx, n),
            "index_add_ms": lambda: zeros.zero_().index_add_(0, flat, rows),
        }
        for name, fn in calls.items():
            out[name] = time_cuda(fn, RUNS, REPS)
        for name, fn in calls.items():
            out[name.replace("_ms", "_cold_ms")] = time_cuda_cold(fn, RUNS)
        # host microseconds a call: 100 calls enqueued without a synchronise
        # (500 launches: under the queue's depth, so the host never waits)
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            out[name.replace("_ms", "_host_us")] = (time.perf_counter() - t0) * 1e4
            torch.cuda.synchronize()
        out["row_scatter_device_us"] = device_times(calls["row_scatter_ms"])
        out["index_add_device_us"] = device_times(calls["index_add_ms"])
        for label in BITS_CASES:
            out[f"rasterize_bwd_bits_sha256 {label}"] = digest(
                rk.rasterize_bwd(*bits_inputs(dev, label), impl="cuda"))
    ptxas_report = _load("time_compositors_torch").ptxas_report
    out["ptxas"] = {name: ptxas_report(r["log"], marker="") for name, r in report.items()
                    if name in ("rasterize_bwd", "bwd_stacked", "row_scatter")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
