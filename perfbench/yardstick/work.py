"""The work a step or a frame needs, counted the same whatever implements it.

Compositing: the (Gaussian, pixel, sample) pairs that the compositing math
needs, those with alpha >= 1/255 while T > 1e-4 before the pair ("hit
pairs"), found by running the plain recurrence of `reference/compositor.py`
(a frozen copy of the program's `rasterize_fwd_plain(count_work=True)` and
`rasterize_bwd_plain(count_work=True)` loop) on the reference's own
binning. A kernel that skips more tiles or rows reads as faster, never as
doing less work.

The operation counts per item are `chip_smoke.py`'s at commit 49129b2
(reviewed there, frozen here); the other per-item counts are this file's, each
said where it is written. Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W).
"""
from __future__ import annotations

import torch

from ..reference import compositor as rc

# H100 SXM: float32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

# --- the compositors, per item (chip_smoke.py at 49129b2) ---
FLOPS_PER_PAIR = 5        # sigma and lo, for every evaluated (Gaussian, pixel, sample)
FLOPS_PER_ROW_PIXEL = 23  # dx0, dy0 and the A, B coefficients, per (Gaussian, pixel)
FLOPS_PER_ROW = 11        # the tile-local mean and the C coefficient, per live row
FWD_FLOPS_PER_HIT = 12    # alpha clamp, weight, 4 accumulates, T update
BWD_FLOPS_PER_HIT = 22    # alpha, w, v, contrib, prefix, suffix, 4 colour terms and sums, T
BWD_FLOPS_PER_SIGMA = 22  # d_sigma, dx, dy and the 8 moments with their sums
BWD_FLOPS_PER_ROW = FLOPS_PER_ROW + 17   # and the 16 output columns from the 12 sums

# --- the rest of a step, per item (this file's counts) ---
# projection of one Gaussian (`ops/projection.py`): the quaternion to R (~40),
# R diag(s)^2 R^T (45), the camera-frame mean (18) and covariance (2 x 45),
# the Jacobian and the 2D covariance (~30), dilation, determinant, conic,
# radius and extents (~30), the pixel velocity (~25): ~280; the backward ~2x
PROJ_FLOPS = 280
PROJ_BWD_FLOPS = 560
# degree-3 SH colour of one Gaussian: the direction (~10), 16 bases (~30),
# 16 x 3 multiply-adds (96), clamp (3): ~140; the backward ~2x
SH_FLOPS = 140
SH_BWD_FLOPS = 280
# the loss per pixel: black level and L1 (~12), SSIM's five separable 11-tap
# blurs (5 x 3 channels x 2 x 11 x 2 = 660) and its map (~45); the backward
# ~2x (the blurs' transposes and the map's gradient); gamma encode (~9)
LOSS_FLOPS_PER_PIXEL = 726
LOSS_BWD_FLOPS_PER_PIXEL = 1452
# Adam per parameter element: two moment updates (5), the bias-corrected
# denominator (sqrt, divide, add: 3), the step (2)
ADAM_FLOPS_PER_PARAM = 10


def count_blocks(blocks: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                 tile_size, tiles_x: int, img_h: int) -> dict[str, int]:
    """Walk one compositor call's inputs (the (T, K, 16) blocks, the counts
    and the scalars [rs, row_offset, eps...]) through the plain recurrence
    and count: `hit_pairs` (alpha >= 1/255 while T > 1e-4), `sigma_pairs`
    (hit pairs below the alpha clamp, whose backward adds the d_sigma
    moments), `hit_row_pixels` ((Gaussian, pixel) with a hit at some sample),
    `live_rows` (tile rows read before every pixel stopped) and
    `live_pairs` (pairs evaluated while T > 1e-4), and `visible_rows`
    (rows with a hit)."""
    n_tiles, k, _ = blocks.shape
    n_samples = scalars.shape[0] - 2
    dev = blocks.device
    tx, ty, px, py, ts = rc._tile_grid(n_tiles, scalars, tile_size, tiles_x, img_h, dev)
    n = torch.clamp(counts.long(), max=k)
    T = torch.ones((n_tiles, n_samples, px.shape[0]), dtype=torch.float32, device=dev)
    keys = ("hit_pairs", "sigma_pairs", "hit_row_pixels", "live_rows", "live_pairs",
            "visible_rows")
    work = {key: torch.zeros((), dtype=torch.int64, device=dev) for key in keys}
    n_max = int(n.max()) if n_tiles else 0
    for j in range(n_max):
        g = blocks[:, j, :, None, None]
        in_count = (j < n)[:, None, None]
        _, _, alpha, lo, live = rc._row_alpha(g, tx, ty, px, py, ts, T, in_count)
        alive = (T > rc.T_EPS) & in_count
        work["live_pairs"] += alive.sum()
        work["live_rows"] += alive.any(dim=1).any(dim=1).sum()
        work["hit_pairs"] += live.sum()
        work["sigma_pairs"] += (live & (lo < rc.LOG_MAX_ALPHA)).sum()
        hit_pix = live.any(dim=1)
        work["hit_row_pixels"] += hit_pix.sum()
        work["visible_rows"] += hit_pix.any(dim=1).sum()
        T = torch.where(live, T * (1.0 - alpha), T)
    return {key: int(v) for key, v in work.items()}


def compositor_bounds(w: dict, n_tiles: int, n_samples: int, n_pixels: int) -> dict:
    """The least time of one forward and one backward compositor call on
    these counts: each the larger of its operations over the float32 peak
    and its bytes over the HBM bandwidth. Bytes, all of them what the math
    needs whatever the layout: each visible row's 64-byte parameter row read
    once and the per-tile counts; the image's (S, 5, H x W) output written
    (forward), or read with its cotangent (backward); and the backward's
    gradient, one 64-byte row for each visible row (a row with no hit has no
    gradient). Neither the tiles' padding of the image nor the per-tile
    capacity K counts."""
    out_bytes = n_samples * 5 * n_pixels * 4
    fwd_flops = (w["hit_pairs"] * (FLOPS_PER_PAIR + FWD_FLOPS_PER_HIT)
                 + w["hit_row_pixels"] * FLOPS_PER_ROW_PIXEL + w["visible_rows"] * FLOPS_PER_ROW)
    bwd_flops = (w["hit_pairs"] * (FLOPS_PER_PAIR + BWD_FLOPS_PER_HIT)
                 + w["sigma_pairs"] * BWD_FLOPS_PER_SIGMA
                 + w["hit_row_pixels"] * FLOPS_PER_ROW_PIXEL
                 + w["visible_rows"] * BWD_FLOPS_PER_ROW)
    fwd_bytes = w["visible_rows"] * 64 + n_tiles * 4 + out_bytes
    bwd_bytes = w["visible_rows"] * (64 + 64) + n_tiles * 4 + 2 * out_bytes
    return {"fwd_flops": fwd_flops, "bwd_flops": bwd_flops,
            "fwd_s": max(fwd_flops / PEAK_FP32_FLOPS, fwd_bytes / PEAK_HBM_BYTES_S),
            "bwd_s": max(bwd_flops / PEAK_FP32_FLOPS, bwd_bytes / PEAK_HBM_BYTES_S)}


@torch.no_grad()
def camera_work(params, camera, config, sh_degree: int, is_eval: bool = False) -> dict:
    """The work of rendering `camera` (reference containers) as the method
    does: for each blur anchor, the reference's own binning and fetch, then
    `count_blocks` and `compositor_bounds`. Returns the summed counts, the
    forward and backward flops and least seconds, the anchors, and the
    visible Gaussians (those with a tile entry) summed over anchors."""
    from ..reference import model as rm

    motion = rm.camera_motion(params, camera, config, is_eval)
    g = params.gaussians
    opac = torch.sigmoid(g.opacities_logit) * g.alive
    w, h = motion.camera.width, motion.camera.height
    eps = motion.eps
    n_s = eps.shape[0]
    groups = (rm.anchor_groups(n_s, max(min(config.blur_anchors, n_s), 1))
              if config.blur_mode == "fused" and n_s > 1 else [(0, 1)])
    tw, _ = rc.tiling.num_tiles(w, h, config.tile_size)
    total: dict = {"anchors": len(groups), "visible": 0, "fwd_flops": 0, "bwd_flops": 0,
                   "fwd_s": 0.0, "bwd_s": 0.0}
    for lo, hi in groups:
        t_a = eps[lo:hi].mean()
        a_eps = eps[lo:hi] - t_a
        proj, colors = rm.subframe_inputs(params, motion, config, sh_degree, t_a)
        lists = rc.bin_tiles(proj, opac, w, h, a_eps, motion.rs_time, config.tile_size,
                             config.max_per_tile, config.max_tiles_per_gaussian, None, 0,
                             config.max_total_entries, materialize_indices=True)
        blocks = rc.gather_tile_params(lists, rc.pack_param_table(proj, colors, opac))
        scalars = rc.scalar_vec(motion.rs_time, 0.0, a_eps, blocks.device)
        counts = count_blocks(blocks, lists.counts, scalars, config.tile_size, tw, h)
        bounds = compositor_bounds(counts, blocks.shape[0], hi - lo, w * h)
        ids = lists.indices[lists.indices >= 0]
        total["visible"] += int(torch.unique(ids).numel())
        for key, v in list(counts.items()) + list(bounds.items()):
            total[key] = total.get(key, 0) + v
    return total


def step_flops(cw: dict, n_pixels: int, n_params: int, train: bool = True) -> float:
    """A whole step's model operations from `camera_work`: both compositors,
    projection and SH of the visible Gaussians at every anchor (forward and
    backward), the loss per pixel (both ways), and Adam over every trained
    element (train steps; the eval-camera step updates a few scalars only)."""
    per_gauss = PROJ_FLOPS + PROJ_BWD_FLOPS + SH_FLOPS + SH_BWD_FLOPS
    flops = (cw["fwd_flops"] + cw["bwd_flops"] + cw["visible"] * per_gauss
             + n_pixels * (LOSS_FLOPS_PER_PIXEL + LOSS_BWD_FLOPS_PER_PIXEL))
    return flops + (n_params * ADAM_FLOPS_PER_PARAM if train else 0)
