#!/usr/bin/env python3
"""Probe: the binning kernels (`ops/cuda/csrc/bin_tiles.cu`) against the plain
route they replace (`ops/tiling.py`, impl "torch"), at the training path's
sizes.

    python3 scripts_dev/probe_bin_tiles_torch.py [--rows N] [--live FRACTION]
    python3 scripts_dev/probe_bin_tiles_torch.py --cell phone_mbrs.train [--seed N]

Inputs (`make_inputs`): Gaussians projected in front of a 1920x1080 camera
(fx 1400; scales and depths that give a few 16-pixel tiles a footprint, a
motion pad of a fast walk, some behind the camera or off screen), binned at
tile 16 with a 4x4 footprint cap (M = 16) and K = 2048. `live` < 1 lays the
Gaussians into a buffer of `rows` rows in four buckets, each live rows first
and zero rows after (not valid, no extent): a depth slab's receive buffer.
`stack` piles Gaussians onto one spot, so a tile takes the long-segment
path. `--cell` bins the benchmark cell's own state instead (its trainer set
up as `perfbench/run.py` sets it up): camera 0's first anchor.

Questions: are the kernels' lists the plain route's under the contract
(`hold`: counts, starts, overflow, clipped, entry_overflow, entry_slots and
the real count equal, sorted_ids equal below the real entries capped at the
stream's length), bitwise repeatable, and `tile_population` equal; and how
long does a binning take beside its bytes' bound, the plain route and
`torch.sort` over the culled-in entries' keys (the library yardstick)?
Prints one JSON line. Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROWS = 1 << 20
W, H, FX = 1920, 1080, 1400.0
TILE, K, MTPG = 16, 2048, 16
HBM_BYTES_PER_S = 3.35e12


def make_inputs(dev, rows=ROWS, live=0.75, seed=0, stack=0, img=(W, H), tile=TILE, k=K,
                row0_px=0.0, full_img_h=None, max_total_entries=0, tile_budget=None):
    """Keyword arguments of `tiling.build_tile_lists` for one binning."""
    from splat_tpu_torch.ops import projection

    rng = np.random.default_rng(seed)
    w, h = img
    fx = FX * w / W
    n = int(rows * live)
    z = rng.uniform(-0.5, 12.0, size=n)
    xy = rng.normal(size=(n, 2)) * np.maximum(z, 1.0)[:, None] * [0.5, 0.3]
    means = np.concatenate([xy, z[:, None]], axis=1)
    means[:stack] = [0.05, 0.02, 4.0] + rng.normal(size=(stack, 3)) * 0.002
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    scales = np.exp(rng.normal(size=(n, 3)) * 0.5 - 3.7)
    proj = projection.project_gaussians(
        f32(means), f32(scales), f32(rng.normal(size=(n, 4))), torch.eye(3, device=dev),
        torch.zeros(3, device=dev), fx, fx, w / 2, h / 2, w, h,
        lin_vel=f32([0.4, -0.2, 0.3]), ang_vel=f32([0.3, 0.5, -0.2]))
    opac = f32(rng.uniform(0.05, 1.0, size=n))
    cols = {"means2d": proj.means2d, "extents": proj.extents, "depths": proj.depths,
            "valid": proj.valid, "conics": proj.conics,
            "opacities": opac * proj.compensations * proj.valid.to(torch.float32),
            "radius_pad": torch.abs(proj.pix_vels) * 0.045}
    if n < rows:
        # four buckets, each its live rows first and zero rows after
        per, cap = -(-n // 4), rows // 4
        at = torch.cat([torch.arange(b * cap, b * cap + min(per, n - b * per), device=dev)
                        for b in range(4)])
        full = {}
        for name, v in cols.items():
            z_ = torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
            z_[at] = v
            full[name] = z_
        cols = full
    return {**cols, "img_w": w, "img_h": h, "tile_size": tile, "max_per_tile": k,
            "max_tiles_per_gaussian": MTPG, "row0_px": row0_px, "full_img_h": full_img_h,
            "max_total_entries": max_total_entries, "tile_budget": tile_budget}


def from_projection(proj, opacities, eps, rs_time, img_w, img_h, tile_size, k,
                    max_tiles_per_gaussian):
    """The inputs `rasterize.bin_tiles` hands the binning for one anchor."""
    t_max = torch.amax(torch.abs(eps)) + 0.5 * torch.abs(torch.as_tensor(rs_time))
    return {"means2d": proj.means2d.detach(), "extents": proj.extents, "depths": proj.depths,
            "valid": proj.valid, "conics": proj.conics,
            "opacities": (opacities * proj.compensations
                          * proj.valid.to(opacities.dtype)).detach(),
            "radius_pad": (torch.abs(proj.pix_vels) * t_max).detach(), "img_w": img_w,
            "img_h": img_h, "tile_size": tile_size, "max_per_tile": k,
            "max_tiles_per_gaussian": max_tiles_per_gaussian, "row0_px": 0.0,
            "full_img_h": None, "max_total_entries": 0, "tile_budget": None}


FIELDS = ("counts", "starts", "overflow", "clipped", "entry_overflow", "entry_slots")


def _args(inp):
    keys = ("means2d", "extents", "depths", "valid", "img_w", "img_h", "tile_size",
            "max_per_tile", "max_tiles_per_gaussian", "radius_pad", "conics", "opacities")
    return [inp[k] for k in keys] + [1.0 / 255.0, inp["row0_px"], inp["full_img_h"],
                                     inp["max_total_entries"], inp["tile_budget"]]


def hold(got, want, real_got, real_want) -> int:
    """Raise unless the kernels' lists are the plain route's under the
    contract; returns the positions of sorted_ids compared."""
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else "shape"
            raise AssertionError(f"bin_tiles: {f} differs from the plain route (first at {bad})")
    if not torch.equal(real_got, real_want):
        raise AssertionError(f"bin_tiles: real {int(real_got)} != {int(real_want)}")
    if got.sorted_ids.shape != want.sorted_ids.shape:
        raise AssertionError("bin_tiles: sorted_ids changed length")
    nr = min(int(real_want), want.sorted_ids.shape[0])
    if not torch.equal(got.sorted_ids[:nr], want.sorted_ids[:nr]):
        first = (got.sorted_ids[:nr] != want.sorted_ids[:nr]).nonzero()[:5].tolist()
        raise AssertionError(f"bin_tiles: sorted_ids differ below the real count at {first}")
    return nr


def check(inp) -> dict:
    """The kernels against the plain route on `inp`; raises on a mismatch."""
    from splat_tpu_torch.ops import tiling
    from splat_tpu_torch.ops.cuda import bin_tiles

    with torch.no_grad():
        before = bin_tiles.tile_lists.launches
        got, real, long_tiles = bin_tiles.tile_lists(*_args(inp))
        again, real2, long2 = bin_tiles.tile_lists(*_args(inp))
        want, real_want = tiling._tile_lists_plain(*_args(inp))
        compared = hold(got, want, real, real_want)
        hold(again, got, real2, real)
        if not (torch.equal(again.sorted_ids, got.sorted_ids) and torch.equal(long2, long_tiles)):
            raise AssertionError("bin_tiles: two launches differ")
        pop_args = [inp[k] for k in ("means2d", "extents", "depths", "valid", "img_w", "img_h",
                                     "tile_size", "max_tiles_per_gaussian", "radius_pad",
                                     "conics", "opacities")]
        pop_kw = dict(row0_px=inp["row0_px"], full_img_h=inp["full_img_h"])
        pop = tiling.tile_population(*pop_args, **pop_kw, impl="cuda")
        pop_want = tiling.tile_population(*pop_args, **pop_kw, impl="torch")
        if not torch.equal(pop, pop_want):
            raise AssertionError("bin_tiles: tile_population differs from the plain route")
        launched = bin_tiles.tile_lists.launches - before
    return {"rows": inp["means2d"].shape[0], "live_rows": int(inp["valid"].sum()),
            "real": int(real), "landed": int(got.counts.sum()), "compared": compared,
            "long_tiles": int(long_tiles), "max_tile_real": int(pop.max()),
            "launches": launched}


def bytes_bound(inp, real: int) -> int:
    """Each input read once and each output written once: per row means,
    extents, valid, motion pad, conic, opacity and depth (45 bytes);
    entry_slots (N * M int32), sorted_ids (the stream, int32), counts and
    starts; and each culled-in entry's 8-byte key written and read once."""
    n = inp["means2d"].shape[0]
    from splat_tpu_torch.ops import tiling

    sx, sy = tiling._spans(inp["tile_size"], inp["max_tiles_per_gaussian"])
    tw, th = tiling.num_tiles(inp["img_w"], inp["img_h"], inp["tile_size"])
    l_cap = n * sx * sy if inp["max_total_entries"] <= 0 else inp["max_total_entries"]
    return 45 * n + 4 * n * sx * sy + 4 * l_cap + 8 * tw * th + 16 * real


def bench(inp, runs=10, reps=3) -> dict:
    """ms of one binning: the kernels (the whole `tile_lists`, its PyTorch
    ops included), the plain route, and torch.sort over the culled-in
    entries' int64 keys (tile << 32 | depth bits)."""
    from splat_tpu_torch.ops import tiling
    from splat_tpu_torch.ops.cuda import bin_tiles
    from splat_tpu_torch.utils.profiling import time_cuda

    with torch.no_grad():
        lists, real, _ = bin_tiles.tile_lists(*_args(inp))
        real = int(real)
        keys = torch.randint(0, 2**62, (real,), dtype=torch.int64, device=inp["means2d"].device)
        out = {"ms": time_cuda(lambda: bin_tiles.tile_lists(*_args(inp)), runs, reps),
               "plain_ms": time_cuda(lambda: tiling._tile_lists_plain(*_args(inp)), 3),
               "library_ms": time_cuda(lambda: torch.sort(keys), runs, reps),
               "bytes": bytes_bound(inp, real)}
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def cell_inputs(dev, cell_name: str, seed: int):
    """Camera 0's first-anchor binning of a benchmark cell's trainer."""
    from perfbench import harness
    from perfbench.traffic import train as traffic
    from splat_tpu_torch.models import splatfacto as sf

    cell = harness.load("workloads", cell_name)
    config = harness.load("configs", cell["config"])
    tr = traffic.Run(cell, config, harness.load("traffic", cell["traffic"]), seed, dev).trainer
    cfg, cam = tr.model_config, tr.train_cams[0]
    with torch.no_grad():
        motion = sf.camera_motion(tr.params, cam, cfg)
        lo, hi = next(iter(sf.anchor_groups(motion.eps.shape[0], max(cfg.blur_anchors, 1))))
        t_a = motion.eps[lo:hi].mean()
        proj, _ = sf.subframe_inputs(tr.params, motion, cfg, cfg.sh_degree, t_a)
        g = tr.params.gaussians
        op = torch.sigmoid(g.opacities_logit) * g.alive
        return from_projection(proj, op, motion.eps[lo:hi] - t_a, motion.rs_time,
                               motion.camera.width, motion.camera.height, cfg.tile_size,
                               cfg.max_per_tile, cfg.max_tiles_per_gaussian)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--live", type=float, default=0.75)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cell", default=None, help="bin a benchmark cell's state instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_bin_tiles_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from splat_tpu_torch.utils.profiling import nvidia_smi

    dev = torch.device("cuda")
    inp = (cell_inputs(dev, args.cell, args.seed) if args.cell
           else make_inputs(dev, rows=args.rows, live=args.live, seed=args.seed))
    res = {"card": nvidia_smi("name,power.limit"), **check(inp), **bench(inp)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
