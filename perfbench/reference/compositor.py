"""Frozen copy of the plain compositing route of `splat_tpu_torch` at commit
49129b2: the plain compositor and its analytic backward
(`ops/cuda/rasterize_kernels.py`: `rasterize_fwd_plain`,
`rasterize_bwd_plain`, the cull `warp_hit_mask` and the work counts), the
parameter table and the per-tile output (`ops/cuda/__init__.py`), and the
dense per-tile fetch, binning and image assembly of the "torch" route
(`ops/rasterize.py`). The benchmark's reference renders through this; the
program's copies may change, this one does not.

Output of the compositor (T, S, NOUT, npix): rows 0-2 rgb, 3 depth_acc, 4
final transmittance.
"""
from __future__ import annotations

import math

import torch

from . import tiling
from ._util import scalar_tensor
from .projection import ProjectedGaussians
from .tiling import tile_wh

ALPHA_THRESH = 1.0 / 255.0
MAX_ALPHA = 0.999
T_EPS = 1e-4


NPARAM = 13    # used columns of a parameter row


PARAM_STRIDE = 16


NOUT = 5


LOG_THRESH = math.log(ALPHA_THRESH)


LOG_MAX_ALPHA = math.log(MAX_ALPHA)


WARP = 32


SIGMA_ABS_SLACK = 2.0 ** -13


SIGMA_REL_SLACK = 2.0 ** -18


DET_REL_SLACK = 2.0 ** -20


BOX_MARGIN = 1.0


BOX_REL_MARGIN = 2.0 ** -16


def scalar_vec(rs_time, row_offset, eps: torch.Tensor | None,
               device: torch.device) -> torch.Tensor:
    """[rs_time, row_offset, eps_0..eps_{S-1}] as one float32 tensor on device."""
    eps = (torch.zeros(1, device=device) if eps is None
           else eps.to(device=device, dtype=torch.float32))
    return torch.cat([scalar_tensor(rs_time, device).reshape(1),
                      scalar_tensor(row_offset, device).reshape(1), eps.reshape(-1)])


def _tile_grid(n_tiles: int, scalars: torch.Tensor, tile_size, tiles_x: int,
               img_h: int, dev: torch.device):
    """Tile origins (T, 1, 1), tile-local pixel centres (npix,) and the
    per-pixel sample times ts (T, S, npix), as the kernels form them."""
    sw, sh = tile_wh(tile_size)
    f32 = torch.float32
    tid = torch.arange(n_tiles, device=dev)
    tx = ((tid % tiles_x) * sw).to(f32)[:, None, None]          # (T, 1, 1)
    ty = ((tid // tiles_x) * sh).to(f32)[:, None, None]
    pix = torch.arange(sw * sh, device=dev)
    px = (pix % sw).to(f32) + 0.5                                # (npix,)
    py = torch.div(pix, sw, rounding_mode="floor").to(f32) + 0.5
    # a same-device divisor: CUDA turns division by a host scalar into a
    # multiply by its reciprocal, which the kernel does not do
    img_h_t = torch.full((), float(img_h), dtype=f32, device=dev)
    t_pix = scalars[0] * ((py + ty + scalars[1]) / img_h_t - 0.5)   # (T, 1, npix)
    ts = scalars[2:][None, :, None] + t_pix                      # (T, S, npix)
    return tx, ty, px, py, ts


def _row_alpha(g, tx, ty, px, py, ts, T, in_count):
    """One slot of every tile: (dx0, dy0, alpha, lo, live), each (T, S|1,
    npix), in the kernels' operation order. g (T, P, 1, 1) is the slot's row;
    in_count (T, 1, 1) says whether the slot is under the tile's count."""
    mx = g[:, 0] - tx
    my = g[:, 1] - ty
    ca, cb, cc = g[:, 2], g[:, 3], g[:, 4]
    pvx, pvy, lo_hi = g[:, 10], g[:, 11], g[:, 12]
    dx0 = px - mx                                                # (T, 1, npix)
    dy0 = py - my
    A = 0.5 * (ca * dx0 * dx0 + cc * dy0 * dy0) + cb * dx0 * dy0
    B = -(ca * dx0 * pvx + cb * (dx0 * pvy + dy0 * pvx) + cc * dy0 * pvy)
    C = 0.5 * (ca * pvx * pvx + cc * pvy * pvy) + cb * pvx * pvy
    sigma = A + ts * (B + ts * C)                                # (T, S, npix)
    lo = lo_hi - sigma
    live = (T > T_EPS) & (lo >= LOG_THRESH) & (lo <= lo_hi) & in_count
    alpha = torch.where(live, torch.clamp(torch.exp(lo), max=MAX_ALPHA), 0.0)
    return dx0, dy0, alpha, lo, live


def _tile_times(n_tiles, scalars, tile_size, tiles_x, img_h, dev):
    """Tile origins (T, 1) and each tile's first and last pixel row's
    rolling-shutter time (T, 1), as `make_tile` forms them."""
    sw, sh = tile_wh(tile_size)
    f32 = torch.float32
    tid = torch.arange(n_tiles, device=dev)
    tx = ((tid % tiles_x) * sw).to(f32)[:, None]                 # (T, 1)
    ty = ((tid // tiles_x) * sh).to(f32)[:, None]
    img_h_t = torch.full((), float(img_h), dtype=f32, device=dev)
    rs, row_off = scalars[0], scalars[1]
    t_first = rs * ((0.5 + ty + row_off) / img_h_t - 0.5)
    t_last = rs * (((sh - 1) + 0.5 + ty + row_off) / img_h_t - 0.5)
    return tx, ty, t_first, t_last


def _swept_box_mask(params, counts, tx, ty, t_lo, t_hi, tile_size):
    """(T, K, n_warps) bool: `warp_mask` of csrc/raster_common.cuh for the
    time range [t_lo, t_hi] (T, 1), operation for operation in float32."""
    n_tiles, k, _ = params.shape
    sw, sh = tile_wh(tile_size)
    npix = sw * sh
    dev = params.device
    f32 = torch.float32
    mx = params[..., 0] - tx                                     # (T, K)
    my = params[..., 1] - ty
    ca, cb, cc = params[..., 2], params[..., 3], params[..., 4]
    pvx, pvy, lo_hi = params[..., 10], params[..., 11], params[..., 12]
    chk = ca + cb + cc + pvx + pvy + mx + my + lo_hi + t_lo + t_hi
    tau = lo_hi - LOG_THRESH
    det = ca * cc - cb * cb
    det_lo = det - DET_REL_SLACK * ((ca * cc).abs() + cb * cb)
    sx_a, sx_b = pvx * t_lo, pvx * t_hi
    sy_a, sy_b = pvy * t_lo, pvy * t_hi
    sx_abs = torch.maximum(sx_a.abs(), sx_b.abs())
    sy_abs = torch.maximum(sy_a.abs(), sy_b.abs())
    ax = torch.maximum((0.5 - mx).abs(), ((sw - 0.5) - mx).abs()) + sx_abs
    ay = torch.maximum((0.5 - my).abs(), ((sh - 0.5) - my).abs()) + sy_abs
    mag = 0.5 * (ca.abs() * ax * ax + cc.abs() * ay * ay) + cb.abs() * ax * ay
    tau2 = tau + SIGMA_ABS_SLACK + SIGMA_REL_SLACK * mag
    hx = torch.sqrt(2.0 * tau2 * cc / det_lo)
    hy = torch.sqrt(2.0 * tau2 * ca / det_lo)
    mgx = BOX_MARGIN + BOX_REL_MARGIN * (hx + mx.abs() + sx_abs)
    mgy = BOX_MARGIN + BOX_REL_MARGIN * (hy + my.abs() + sy_abs)
    x_lo = (mx + torch.minimum(sx_a, sx_b) - hx - mgx)[..., None]
    x_hi = (mx + torch.maximum(sx_a, sx_b) + hx + mgx)[..., None]
    y_lo = (my + torch.minimum(sy_a, sy_b) - hy - mgy)[..., None]
    y_hi = (my + torch.maximum(sy_a, sy_b) + hy + mgy)[..., None]
    # each warp's pixel centres: whole rows row0..row1, or part of one row
    p0 = torch.arange(0, npix, WARP, device=dev)
    p1 = torch.clamp(p0 + WARP, max=npix) - 1
    row0, row1 = p0 // sw, p1 // sw
    one_row = row0 == row1
    col0 = torch.where(one_row, p0 % sw, 0).to(f32) + 0.5
    col1 = torch.where(one_row, p1 % sw, sw - 1).to(f32) + 0.5
    row0, row1 = row0.to(f32) + 0.5, row1.to(f32) + 0.5
    miss = (x_hi < col0) | (x_lo > col1) | (y_hi < row0) | (y_lo > row1)   # (T, K, n_warps)
    keep_all = (~torch.isfinite(chk)
                | ((lo_hi >= LOG_THRESH) & ~((ca > 0.0) & (det_lo > 0.0))))[..., None]
    culled = torch.isfinite(chk) & (lo_hi < LOG_THRESH)
    mask = keep_all | (~culled[..., None] & ~miss)
    in_count = torch.arange(k, device=dev) < torch.clamp(counts.long(), max=k)[:, None]
    return mask & in_count[..., None]


def warp_hit_mask(params: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                  tile_size, tiles_x: int, img_h: int) -> torch.Tensor:
    """(T, K, n_warps) bool: whether slot k can reach any pixel of warp w (32
    consecutive pixels of the tile) at any sample time of the tile. The
    kernels' per-row cull (`warp_mask` in csrc/raster_common.cuh), operation
    for operation in float32: the ellipse sigma <= lo_hi - log(1/255), with
    rounding slack, swept over the tile's least and greatest sample time and
    grown by a margin, against each warp's pixel box. Never False where the
    recurrence composites a pair; False for slots past the tile's count."""
    tx, ty, t_first, t_last = _tile_times(params.shape[0], scalars, tile_size, tiles_x, img_h,
                                          params.device)
    eps = scalars[2:]
    t_lo = eps.min() + torch.minimum(t_first, t_last)            # (T, 1)
    t_hi = eps.max() + torch.maximum(t_first, t_last)
    return _swept_box_mask(params, counts, tx, ty, t_lo, t_hi, tile_size)


WORK_KEYS = ("live_pairs", "live_row_pixels", "live_rows", "hit_pairs", "warp_live_pairs",
             "warp_live_row_pixels", "warp_groups", "kept_groups", "hit_groups",
             "missed_groups", "hit_warp_samples")


def _new_work(dev, keys=WORK_KEYS):
    return {k: torch.zeros((), dtype=torch.int64, device=dev) for k in keys}


def _by_warp(x: torch.Tensor) -> torch.Tensor:
    """(..., npix) -> (..., n_warps, 32), pixels past the tile padded with 0."""
    x = x.to(torch.int32)
    pad = (-x.shape[-1]) % WARP
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, WARP)


def _count_step(work, T, in_count, live, kept):
    """Add one slot's work to the counts of rasterize_fwd_plain(count_work);
    live (T, S, npix) marks the pairs that composite, kept (T, n_warps) the
    warps the cull keeps."""
    alive = (T > T_EPS) & in_count                               # (T, S, npix)
    alive_pix = alive.any(dim=1)                                 # (T, npix)
    work["live_pairs"] += alive.sum()
    work["live_row_pixels"] += alive_pix.sum()
    work["live_rows"] += alive_pix.any(dim=1).sum()
    work["hit_pairs"] += live.sum()
    # by (row, warp) group
    pairs_w = _by_warp(alive).sum(dim=(1, 3))                    # (T, n_warps)
    pix_w = _by_warp(alive_pix).sum(dim=2)
    hit_w = _by_warp(live).sum(dim=(1, 3)) > 0
    work["warp_live_pairs"] += (pairs_w * hit_w).sum()
    work["warp_live_row_pixels"] += (pix_w * hit_w).sum()
    work["warp_groups"] += (pix_w > 0).sum()
    work["kept_groups"] += ((pix_w > 0) & kept).sum()
    work["hit_groups"] += hit_w.sum()
    work["missed_groups"] += (hit_w & ~kept).sum()
    work["hit_warp_samples"] += (_by_warp(live).sum(dim=3) > 0).sum()


def rasterize_fwd_plain(params: torch.Tensor, counts: torch.Tensor,
                        scalars: torch.Tensor, tile_size, tiles_x: int,
                        img_h: int, count_work: bool = False):
    """Plain PyTorch version of the kernel: a loop over the K slots, batched
    over tiles, samples and pixels, with the kernel's arithmetic in the same
    order (each product and sum rounded once).

    count_work=True also returns the work these inputs need, as a dict:
    `live_pairs`, the (Gaussian, pixel, sample) steps taken while the pixel's
    T > T_EPS; `live_row_pixels`, the (Gaussian, pixel) steps taken while any
    sample of the pixel has T > T_EPS (each needs the sigma coefficients);
    `live_rows`, the tile rows read before every pixel of the tile stopped
    (the kernel's early exit); and `hit_pairs`, the live pairs that
    composite (alpha above its floor). By (row, warp) group, a warp being 32
    consecutive pixels: `warp_live_pairs` and `warp_live_row_pixels`, the
    live pairs and (row, pixel) steps in groups where some pair composites
    (the least work a warp-granular kernel must do); `warp_groups`, the
    groups with a live pixel; `kept_groups`, those of them `warp_hit_mask`
    keeps (the groups the kernels evaluate, but for a warp's stop at a batch
    boundary); `hit_groups`, the groups where some pair composites; and
    `missed_groups`, hit groups the mask clears (0: the cull is sound);
    `hit_warp_samples`, the (row, warp, sample) triples where some pixel
    composites (the times a warp runs the compositing step, so hit_pairs /
    (32 hit_warp_samples) is the share of its lanes that do work there)."""
    n_tiles, k, _ = params.shape
    n_samples = scalars.shape[0] - 2
    dev = params.device
    tx, ty, px, py, ts = _tile_grid(n_tiles, scalars, tile_size, tiles_x, img_h, dev)

    n = torch.clamp(counts.long(), max=k)
    T = torch.ones((n_tiles, n_samples, px.shape[0]), dtype=torch.float32, device=dev)
    acc = [torch.zeros_like(T) for _ in range(4)]
    n_max = int(n.max()) if n_tiles else 0
    work = _new_work(dev)
    if count_work:
        kept = warp_hit_mask(params, counts, scalars, tile_size, tiles_x, img_h)
    for j in range(n_max):
        g = params[:, j, :, None, None]                          # (T, P, 1, 1)
        _, _, alpha, _, live = _row_alpha(g, tx, ty, px, py, ts, T, (j < n)[:, None, None])
        if count_work:
            _count_step(work, T, (j < n)[:, None, None], live, kept[:, j])
        w = T * alpha
        for r, col in enumerate((5, 6, 7, 9)):
            acc[r] = acc[r] + w * g[:, col]
        T = torch.where(live, T * (1.0 - alpha), T)
    out = torch.stack(acc + [T], dim=2)                          # (T, S, 5, npix)
    if count_work:
        return out, {k: int(v) for k, v in work.items()}
    return out


def rasterize_bwd_plain(params: torch.Tensor, counts: torch.Tensor,
                        scalars: torch.Tensor, fwd_out: torch.Tensor,
                        g_out: torch.Tensor, tile_size, tiles_x: int,
                        img_h: int, count_work: bool = False):
    """Plain PyTorch version of the backward kernel: d_params (T, K, 16).

    The math of `_bwd_one_tile`: one front-to-back pass that reruns the
    forward recurrence (same operations, same order, so the live set is the
    forward's), with the suffix S = A_total - prefix_inclusive and A_total =
    rgb.dC + depth_acc dD + T_final dT taken from the forward output. Per
    (slot, pixel, sample): v = c.dC + d dD, contrib = w v, and
    d_sigma = alpha / (1 - alpha) * S - contrib where the pixel is live and
    alpha below its clamp, else 0. Columns 0-11 are the gradients of mean
    x/y, conic a/b/c, rgb, opacity, depth and pixel velocity x/y, summed over
    samples and pixels; the opacity gradient is -sum d_sigma / max(op, 1e-12);
    columns 12-15 (the log opacity and the pad) are zero, as is every slot
    past the tile's count.

    count_work=True also returns the forward's work counts (see
    rasterize_fwd_plain; each of the `hit_pairs` takes the full backward
    step) plus `sigma_pairs`, the compositing pairs below the alpha clamp,
    which add the d_sigma moments."""
    n_tiles, k, p = params.shape
    dev = params.device
    tx, ty, px, py, ts = _tile_grid(n_tiles, scalars, tile_size, tiles_x, img_h, dev)
    dC = [g_out[:, :, r] for r in range(4)]                      # (T, S, npix) each
    a_total = (fwd_out[:, :, 0] * g_out[:, :, 0] + fwd_out[:, :, 1] * g_out[:, :, 1]
               + fwd_out[:, :, 2] * g_out[:, :, 2] + fwd_out[:, :, 3] * g_out[:, :, 3]
               + fwd_out[:, :, 4] * g_out[:, :, 4])

    n = torch.clamp(counts.long(), max=k)
    T = torch.ones_like(a_total)
    prefix = torch.zeros_like(a_total)
    d_params = torch.zeros((n_tiles, k, p), dtype=torch.float32, device=dev)
    n_max = int(n.max()) if n_tiles else 0
    work = _new_work(dev, WORK_KEYS + ("sigma_pairs",))
    if count_work:
        kept = warp_hit_mask(params, counts, scalars, tile_size, tiles_x, img_h)
    for j in range(n_max):
        g = params[:, j, :, None, None]                          # (T, P, 1, 1)
        dx0, dy0, alpha, lo, live = _row_alpha(g, tx, ty, px, py, ts, T,
                                               (j < n)[:, None, None])
        if count_work:
            _count_step(work, T, (j < n)[:, None, None], live, kept[:, j])
            work["sigma_pairs"] += (live & (lo < LOG_MAX_ALPHA)).sum()
        w = T * alpha
        v = g[:, 5] * dC[0] + g[:, 6] * dC[1] + g[:, 7] * dC[2] + g[:, 9] * dC[3]
        contrib = w * v
        prefix = prefix + contrib
        suffix = a_total - prefix
        d_sigma = torch.where(live & (lo < LOG_MAX_ALPHA),
                              alpha / (1.0 - alpha) * suffix - contrib, 0.0)
        dx = dx0 - g[:, 10] * ts                                 # (T, S, npix)
        dy = dy0 - g[:, 11] * ts
        xs, ys = dx * d_sigma, dy * d_sigma
        terms = [w * dC[0], w * dC[1], w * dC[2], w * dC[3], d_sigma, xs, ys,
                 ts * xs, ts * ys, dx * xs, dy * ys, dx * ys]
        (gr, gg, gb, gd, p0, su1, su2, sv1, sv2, xx, yy, xy) = (
            t.sum(dim=(1, 2)) for t in terms)                    # (T,) each
        row = params[:, j]
        ca, cb, cc, op = row[:, 2], row[:, 3], row[:, 4], row[:, 8]
        d_params[:, j, :12] = torch.stack([
            -(ca * su1 + cb * su2), -(cc * su2 + cb * su1),
            0.5 * xx, xy, 0.5 * yy, gr, gg, gb,
            -p0 / torch.clamp(op, min=1e-12), gd,
            -(ca * sv1 + cb * sv2), -(cc * sv2 + cb * sv1),
        ], dim=1)
        T = torch.where(live, T * (1.0 - alpha), T)
    if count_work:
        return d_params, {k: int(v) for k, v in work.items()}
    return d_params


class _Composite(torch.autograd.Function):
    """The plain compositor with its analytic backward; the scalars get no
    gradient."""

    @staticmethod
    def forward(ctx, params, counts, scalars, tile_size, tiles_x, img_h):
        out = rasterize_fwd_plain(params, counts, scalars, tile_size, tiles_x, img_h)
        ctx.save_for_backward(params, counts, scalars, out)
        ctx.cfg = (tile_size, tiles_x, img_h)
        return out

    @staticmethod
    def backward(ctx, g_out):
        params, counts, scalars, out = ctx.saved_tensors
        tile_size, tiles_x, img_h = ctx.cfg
        d_params = rasterize_bwd_plain(params, counts, scalars, out, g_out.contiguous(),
                                       tile_size, tiles_x, img_h)
        return d_params, None, None, None, None, None


def rasterize_fwd(params, counts, rs_time, tile_size, tiles_x: int, img_h: int,
                  row_offset=0.0, eps=None) -> torch.Tensor:
    """Composite all tiles for all sub-frames: (T, S, NOUT, npix)."""
    scalars = scalar_vec(rs_time, row_offset, eps, params.device)
    return _Composite.apply(params, counts, scalars, tile_size, tiles_x, img_h)


def pack_param_table(
    proj: ProjectedGaussians, colors: torch.Tensor, opacities: torch.Tensor
) -> torch.Tensor:
    """Per-Gaussian packed (N+1, 16) parameter table; row N is a zero pad row.

    Columns 0-12 as in the JAX package: mean x/y, conic a/b/c, rgb, effective
    opacity, depth, pixel velocity x/y, log(effective opacity). Columns 13-15
    are zero so each row is 64 bytes and the kernels load it 16 bytes at a
    time. The log column carries no gradient (the opacity gradient flows
    through column 8)."""
    op_eff = opacities * proj.compensations * proj.valid.to(colors.dtype)
    log_op = torch.log(torch.clamp(op_eff, min=1e-35)).detach()
    cols = [
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        colors[:, 0], colors[:, 1], colors[:, 2],
        op_eff, proj.depths,
        proj.pix_vels[:, 0], proj.pix_vels[:, 1],
        log_op,
    ]
    table = torch.stack(cols, dim=1)                                  # (N, 13)
    return torch.nn.functional.pad(table, (0, PARAM_STRIDE - NPARAM, 0, 1))  # (N+1, 16)


def composite_output(out: torch.Tensor, tile_size, reduce_mean: bool = False,
                     mid_index: int | None = None,
                     background: torch.Tensor | None = None):
    """Per-tile images from the (T, S, 5, npix) compositor output.

    reduce_mean=False: (rgb (T,S,th,tw,3), depth_acc (T,S,th,tw), T (T,S,th,tw)).
    reduce_mean=True: the blur average with the background folded in, in tile
    space: (rgb_with_bg (T,th,tw,3), T_mean (T,th,tw), depth_mid (T,th,tw)),
    depth_mid = depth_acc[mid] / max(1 - T[mid], 1e-10), mid = S // 2 unless
    mid_index is given."""
    n_tiles, n_samples = out.shape[0], out.shape[1]
    sw, sh = tiling.tile_wh(tile_size)
    if reduce_mean:
        mid = n_samples // 2 if mid_index is None else mid_index
        m = out.mean(dim=1)                                            # (T, 5, npix)
        t_mean = m[:, 4]
        rgb_bg = m[:, 0:3] + background[None, :, None] * m[:, 4:5]
        rgb_t = rgb_bg.transpose(1, 2).reshape(n_tiles, sh, sw, 3)
        alpha_mid = torch.clamp(1.0 - out[:, mid, 4], min=1e-10)
        depth_mid = (out[:, mid, 3] / alpha_mid).reshape(n_tiles, sh, sw)
        return rgb_t, t_mean.reshape(n_tiles, sh, sw), depth_mid
    rgb_t = out[:, :, 0:3, :].transpose(2, 3).reshape(n_tiles, n_samples, sh, sw, 3)
    dep_t = out[:, :, 3, :].reshape(n_tiles, n_samples, sh, sw)
    T_t = out[:, :, 4, :].reshape(n_tiles, n_samples, sh, sw)
    return rgb_t, dep_t, T_t


class _GatherDense(torch.autograd.Function):
    """table[indices] with a gather-form backward built from the id table
    itself (independent of `entry_slots`): a stable sort groups each table
    row's slots in slot order, and each row sums its slots' gradients from an
    (N, M) table of slot numbers, M the most slots any row holds. Empty slots
    (id -1) read the zero pad row and send it nothing."""

    @staticmethod
    def forward(ctx, table, indices):
        pad_row = table.shape[0] - 1
        idx = torch.where(indices >= 0, indices, pad_row).long()
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_rows, width = ctx.n_rows, g.shape[-1]
        flat = idx.reshape(-1)
        slots = torch.nonzero(flat < n_rows - 1).reshape(-1)    # filled slots, ascending
        d_table = g.new_zeros((n_rows, width))
        if slots.numel() == 0:
            return d_table, None
        order = torch.sort(flat[slots], stable=True).indices
        rows, slots = flat[slots][order], slots[order]
        first = torch.searchsorted(rows, torch.arange(n_rows, device=rows.device))
        rank = torch.arange(rows.shape[0], device=rows.device) - first[rows]
        slot_of = torch.full((n_rows, int(rank.max()) + 1), flat.shape[0],
                             dtype=torch.long, device=rows.device)
        slot_of[rows, rank] = slots
        d_slots = torch.cat([g.reshape(-1, width), g.new_zeros((1, width))])
        return d_slots[slot_of].sum(dim=1), None


def gather_tile_params(lists: tiling.TileLists, table: torch.Tensor) -> torch.Tensor:
    """Per-tile parameter blocks (T, K, 16) from the dense id table; empty
    slots (id -1) take the table's zero pad row."""
    return _GatherDense.apply(table, lists.indices)


def assemble_image(tiles: torch.Tensor, img_w: int, img_h: int, tile_size) -> torch.Tensor:
    """(num_tiles, th, tw, C?) row-major tile grid -> (H, W, C?) image, cropped."""
    tw, th = tiling.num_tiles(img_w, img_h, tile_size)
    sw, sh = tiling.tile_wh(tile_size)
    chan = tuple(tiles.shape[3:])
    img = tiles.reshape((th, tw, sh, sw) + chan)
    img = img.transpose(1, 2).reshape((th * sh, tw * sw) + chan)
    return img[:img_h, :img_w]


def bin_tiles(
    proj: ProjectedGaussians,
    opacities: torch.Tensor,
    img_w: int,
    img_h: int,
    eps: torch.Tensor,
    rolling_shutter_time,
    tile_size=16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 64,
    rs_full_height: int | None = None,
    rs_row_offset=0,
    max_total_entries: int = 0,
    materialize_indices: bool = False,
) -> tiling.TileLists:
    """Bin once for all sub-frames: the footprint is padded by the largest
    screen shift over the exposure and readout, |pix_vel| * (max|eps| + |rs|/2)
    per axis, and the conic cull uses the effective opacity."""
    rs = scalar_tensor(rolling_shutter_time, opacities.device, opacities.dtype)
    t_max = torch.amax(torch.abs(eps)) + 0.5 * torch.abs(rs)
    radius_pad = torch.abs(proj.pix_vels) * t_max
    op_eff = opacities * proj.compensations * proj.valid.to(opacities.dtype)
    return tiling.build_tile_lists(
        proj.means2d, proj.extents, proj.depths, proj.valid,
        img_w, img_h, tile_size, max_per_tile, max_tiles_per_gaussian,
        radius_pad=radius_pad, conics=proj.conics, opacities=op_eff,
        materialize_indices=materialize_indices,
        row0_px=rs_row_offset, full_img_h=rs_full_height,
        max_total_entries=max_total_entries,
    )


def _composite(proj, colors, opacities, img_w, img_h, eps, rs, tile_size, max_per_tile,
               max_tiles_per_gaussian, max_total_entries, **reduce_kw):
    """The "torch" route of `ops/rasterize.py:_composite`: binning, the dense
    per-tile fetch and the plain compositor."""
    lists = bin_tiles(proj, opacities, img_w, img_h, eps, rs, tile_size, max_per_tile,
                      max_tiles_per_gaussian, None, 0, max_total_entries,
                      materialize_indices=True)
    tw, _ = tiling.num_tiles(img_w, img_h, tile_size)
    blocks = gather_tile_params(lists, pack_param_table(proj, colors, opacities))
    out = rasterize_fwd(blocks, lists.counts, rs, tile_size, tw, img_h, eps=eps)
    return composite_output(out, tile_size, **reduce_kw)


def rasterize(proj, colors, opacities, img_w: int, img_h: int, background,
              rolling_shutter_time=0.0, tile_size=16, max_per_tile: int = 512,
              max_tiles_per_gaussian: int = 64, max_total_entries: int = 0):
    """One (sub-)frame: (rgb, alpha, depth, T) of `ops/rasterize.py:rasterize`."""
    eps = torch.zeros(1, dtype=colors.dtype, device=colors.device)
    rgb_t, dep_t, T_t = _composite(proj, colors, opacities, img_w, img_h, eps,
                                   rolling_shutter_time, tile_size, max_per_tile,
                                   max_tiles_per_gaussian, max_total_entries)
    rgb = assemble_image(rgb_t[:, 0], img_w, img_h, tile_size)
    depth_acc = assemble_image(dep_t[:, 0], img_w, img_h, tile_size)
    T = assemble_image(T_t[:, 0], img_w, img_h, tile_size)
    alpha = 1.0 - T
    rgb = rgb + T[..., None] * background
    depth = depth_acc / torch.clamp(alpha, min=1e-10)
    return rgb, alpha, depth, T


def rasterize_fused_mean(proj, colors, opacities, img_w: int, img_h: int, background, eps,
                         rolling_shutter_time=0.0, tile_size=16, max_per_tile: int = 512,
                         max_tiles_per_gaussian: int = 64, mid_index: int | None = None,
                         max_total_entries: int = 0):
    """`ops/rasterize.py:rasterize_fused` with reduce="mean": the blur average
    of the S sub-frames of one binning, (rgb, alpha, depth, T)."""
    bg = torch.as_tensor(background, dtype=colors.dtype, device=colors.device).expand(3)
    rgb_t, T_t, dep_t = _composite(proj, colors, opacities, img_w, img_h, eps,
                                   rolling_shutter_time, tile_size, max_per_tile,
                                   max_tiles_per_gaussian, max_total_entries,
                                   reduce_mean=True, mid_index=mid_index, background=bg)
    T_mean = assemble_image(T_t, img_w, img_h, tile_size)
    return (assemble_image(rgb_t, img_w, img_h, tile_size), 1.0 - T_mean,
            assemble_image(dep_t, img_w, img_h, tile_size), T_mean)
