#!/usr/bin/env python3
"""Probe: the compositors' exact per-warp cull on adversarial rows.

    python3 scripts_dev/probe_cull_torch.py

Question: does the per-row cull of `csrc/rasterize_fwd.cu` and
`csrc/rasterize_bwd.cu` (a warp skips a row whose swept footprint box misses
its 32 pixels; `warp_hit_mask` is its plain version) keep every (row, warp)
group where a pair composites, on rows built to break it? Per tile, K = 96
rows (two staging batches) around the tile: near-degenerate conics (det ->
0+), conics with det <= 0, pixel velocities of hundreds of px/s, log
opacities under log(1/255) and at it, tiny and wide footprints, and grazing
rows whose footprint reaches a pixel centre of a warp's edge row or column by
a few hundredths of a pixel (a box short by 1 % misses them); negative
rolling-shutter time, a nonzero row offset, 16 blur samples. Counts include an
empty tile and one past K. Prints, for 16x16 and 16x8 tiles, the kernels'
agreement with their plain versions and the share of (row, warp) groups the
cull keeps, with the card's name and power limit. Needs a CUDA device; exits
nonzero without one.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TILES_X, TILES_Y = 4, 3
K = 96
ROW_OFFSET = 24.0
FWD_TOL = {"rgb_T": 1e-4, "depth": 1e-3}      # as chip_smoke.py phase 2
BWD_TOL = 1e-5                                 # of max|plain| per column
LOG_THRESH = math.log(1.0 / 255.0)
COV2D_DILATION = 0.3


def _conic(rng, kind):
    """(ca, cb, cc) of one footprint of the given kind. Kinds 0, 1, 4 and 5
    are projected footprints: a covariance plus the projection's 0.3 px^2
    dilation (`ops/projection.py`), inverted."""
    if kind == 1:                       # near-degenerate: a needle, det -> 0+
        s1, s2 = rng.uniform(0.0, 0.3), rng.uniform(30.0, 300.0)
    elif kind == 4:                     # as small as projection makes them
        s1, s2 = rng.uniform(0.0, 0.3, size=2)
    else:
        s1, s2 = np.exp(rng.uniform(math.log(0.4), math.log(8.0), size=2))
    th = rng.uniform(0.0, math.pi)
    rot = np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    conic = np.linalg.inv(rot @ np.diag([s1 ** 2, s2 ** 2]) @ rot.T + COV2D_DILATION * np.eye(2))
    ca, cb, cc = conic[0, 0], conic[0, 1], conic[1, 1]
    if kind == 2:                       # det <= 0, or not positive definite
        ca, cc = rng.uniform(0.01, 1.0, size=2)
        cb = rng.choice([-1.0, 1.0]) * math.sqrt(ca * cc) * rng.uniform(1.0, 1.5)
        if rng.uniform() < 0.3:
            ca = -ca
    elif kind == 3:                     # det a hair above 0 (ca, cc under 1 / 0.3 as projected)
        ca, cc = np.exp(rng.uniform(-6.0, 1.0, size=2))
        cb = rng.choice([-1.0, 1.0]) * math.sqrt(ca * cc) * (1.0 - 10.0 ** rng.uniform(-7.0, -3.0))
    return ca, cb, cc


def _grazing(rng, sw, sh, ca, cb, cc, lo_hi):
    """A tile-local mean (mx, my) from which the footprint (ca, cb, cc) at
    rest reaches a pixel centre on the edge row of a warp, or on the tile's
    edge column, by 0.002-0.02 px: the ellipse's extreme point sits on it."""
    det = ca * cc - cb * cb
    tau = lo_hi - LOG_THRESH
    hx, hy = math.sqrt(2 * tau * cc / det), math.sqrt(2 * tau * ca / det)
    d = rng.uniform(0.002, 0.02)
    if rng.uniform() < 0.7:                           # from above or below a warp
        starts = [w * 32 // sw for w in range(-(-sw * sh // 32))]
        w = rng.integers(0, len(starts))
        xc = rng.integers(0, sw) + 0.5
        if rng.uniform() < 0.5:      # above: the ellipse's lowest point on the warp's first row
            yc = starts[w] + 0.5
            return xc + cb / ca * hy, yc - hy + d
        yc = (starts[w + 1] if w + 1 < len(starts) else sh) - 0.5
        return xc - cb / ca * hy, yc + hy - d
    yc = rng.integers(0, sh) + 0.5                    # left or right of the tile
    if rng.uniform() < 0.5:
        return 0.5 - hx + d, yc + cb / cc * hx
    return sw - 0.5 + hx - d, yc - cb / cc * hx


def make_inputs(dev, tile_size=16, n_samples=16, rs=-0.05, seed=0, nonfinite=False):
    """Seeded (T, K, 16) blocks and their counts and scalars; the arguments
    of `rasterize_fwd_plain` / `warp_hit_mask` as a dict. nonfinite=True
    also puts NaN and inf into some rows (for the cull alone: the kernels'
    NaN handling in the opacity gradient differs from the plain version's)."""
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.tiling import tile_wh

    rng = np.random.default_rng(seed)
    sw, sh = tile_wh(tile_size)
    n_tiles = TILES_X * TILES_Y
    blocks = np.zeros((n_tiles, K, rk.PARAM_STRIDE), np.float32)
    for t in range(n_tiles):
        tx, ty = (t % TILES_X) * sw, (t // TILES_X) * sh
        for j in range(K):
            kind = rng.integers(0, 6)
            ca, cb, cc = _conic(rng, kind)
            pv = rng.normal(size=2) * (800.0 if rng.uniform() < 0.2 else 150.0)
            u = rng.uniform()
            lo_hi = (LOG_THRESH + rng.uniform(-1e-6, 1e-6) if u < 0.1
                     else rng.uniform(LOG_THRESH - 1.0, -0.01))
            mx, my = rng.uniform(-24.0, sw + 24.0), rng.uniform(-24.0, sh + 24.0)
            if kind == 5:                 # grazing, at rest
                lo_hi = rng.uniform(-2.0, -0.01)
                mx, my = _grazing(rng, sw, sh, ca, cb, cc, lo_hi)
                pv[:] = 0.0
            blocks[t, j, :13] = [
                tx + mx, ty + my, ca, cb, cc, *rng.uniform(size=3), math.exp(lo_hi),
                rng.uniform(1.0, 10.0), pv[0], pv[1], lo_hi]
    if nonfinite:
        cols = rng.integers(0, 13, size=40)
        slots = rng.integers(0, K, size=40)
        tiles = rng.integers(0, n_tiles, size=40)
        blocks[tiles, slots, cols] = rng.choice([np.nan, np.inf, -np.inf], size=40)
    counts = rng.integers(1, K + 1, size=n_tiles).astype(np.int32)
    counts[0], counts[1], counts[2] = 0, K, K + 5
    eps = np.linspace(-0.03, 0.03, n_samples).astype(np.float32) if n_samples > 1 else None
    scalars = rk.scalar_vec(rs, ROW_OFFSET, None if eps is None else torch.tensor(eps), dev)
    return {"params": torch.tensor(blocks, device=dev), "counts": torch.tensor(counts, device=dev),
            "scalars": scalars, "tile_size": tile_size, "tiles_x": TILES_X,
            "img_h": TILES_Y * sh + 2 * int(ROW_OFFSET)}


def check(inp) -> dict:
    """Both kernels against their plain versions on the adversarial block
    (forward atol 1e-4 on rgb and T, 1e-3 on depth; backward 1e-5 of
    max|plain| per column), each bitwise equal over two launches, and the
    cull sound on the plain recurrence (no hit group cleared). Returns the
    errors and the plain forward's work counts; raises on a failure."""
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk

    p, c, s = inp["params"], inp["counts"], inp["scalars"]
    geo = (inp["tile_size"], inp["tiles_x"], inp["img_h"])
    eps = s[2:] if s.shape[0] > 3 else None
    fwd = rk.rasterize_fwd(p, c, s[0], *geo, row_offset=s[1], eps=eps, impl="cuda")
    fwd2 = rk.rasterize_fwd(p, c, s[0], *geo, row_offset=s[1], eps=eps, impl="cuda")
    want, work = rk.rasterize_fwd_plain(p, c, s, *geo, count_work=True)
    err_c = (fwd[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
    err_d = (fwd[:, :, 3] - want[:, :, 3]).abs().max().item()
    g_out = torch.randn(fwd.shape, device=p.device,
                        generator=torch.Generator(device=p.device).manual_seed(0))
    args = (p, c, s, fwd, g_out, *geo)
    got = rk.rasterize_bwd(*args, impl="cuda")
    got2 = rk.rasterize_bwd(*args, impl="cuda")
    bwd_want = rk.rasterize_bwd_plain(*args)
    scale = bwd_want.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    share = ((got - bwd_want).abs().amax(dim=(0, 1)) / scale).max().item()
    res = {"fwd_rgb_T": err_c, "fwd_depth": err_d, "bwd_column_share": share,
           "bwd_max_abs_err": (got - bwd_want).abs().max().item(), "work": work}
    if not (torch.equal(fwd, fwd2) and torch.equal(got, got2)):
        raise RuntimeError("probe_cull: two launches of a compositing kernel differ")
    if not (err_c <= FWD_TOL["rgb_T"] and err_d <= FWD_TOL["depth"] and share <= BWD_TOL):
        raise RuntimeError(f"probe_cull: kernels off their plain versions: {res}")
    if work["missed_groups"]:
        raise RuntimeError(f"probe_cull: the cull cleared {work['missed_groups']} hit groups")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cull_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.utils.profiling import nvidia_smi

    dev = torch.device("cuda")
    print(f"card: {nvidia_smi('name,power.limit')}")
    for tile in (16, (16, 8)):
        r = check(make_inputs(dev, tile))
        w = r["work"]
        print(f"tile {tile}, S=16: forward max|err| rgb/T {r['fwd_rgb_T']:.3g}, depth "
              f"{r['fwd_depth']:.3g}; backward {r['bwd_column_share']:.3g} of max|plain| per "
              f"column; two launches bitwise equal; (row, warp) groups with a live pixel "
              f"{w['warp_groups']}, kept by the cull {w['kept_groups']} "
              f"({w['kept_groups'] / max(w['warp_groups'], 1):.3f}), hit {w['hit_groups']}, "
              f"hit but culled {w['missed_groups']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
