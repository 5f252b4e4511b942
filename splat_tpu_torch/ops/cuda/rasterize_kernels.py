"""Compositing kernels: the port of the default TPU forward
`splat_tpu/ops/pallas/rasterize_kernels_gmajor.py::rasterize_fwd_gpacked_rowin`
and of the analytic backward `splat_tpu/ops/pallas/rasterize_kernels.py::
rasterize_bwd_packed`.

`rasterize_fwd` composites every tile for all S blur sub-frames from the
per-tile (T, K, P) parameter blocks (P = 16: the 13 columns of
`pack_param_table`, zero-padded for 16-byte loads). On a CUDA tensor it
launches `csrc/rasterize_fwd.cu`; on a CPU tensor it runs
`rasterize_fwd_plain`, the same recurrence in plain PyTorch. It is a
`torch.autograd.Function` whose backward is `rasterize_bwd`: the kernel
`csrc/rasterize_bwd.cu` on CUDA tensors, `rasterize_bwd_plain` on CPU
tensors (and both plain versions under impl="torch").

Output (T, S, NOUT, npix): rows 0-2 rgb, 3 depth_acc, 4 final transmittance
(the TPU kernel's zero rows 5-7 are left out).

Both kernels skip the (row, warp) groups that `warp_hit_mask` clears: its
plain version, the same float32 computation, is here for the tests and for
the work counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...device import scalar_tensor
from ..reference import ALPHA_THRESH, MAX_ALPHA, T_EPS
from ..tiling import tile_wh
from . import build

NPARAM = 13    # used columns of a parameter row
PARAM_STRIDE = 16
NOUT = 5
MAX_SAMPLES = 16  # the kernel's compile-time limit on S
MAX_TILE_PIXELS = 256
LOG_THRESH = math.log(ALPHA_THRESH)
LOG_MAX_ALPHA = math.log(MAX_ALPHA)
WARP = 32
# the cull's slack (csrc/raster_common.cuh says why each is enough); powers
# of two, the same floats in both languages
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


def sample_hit_mask(params: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                    tile_size, tiles_x: int, img_h: int) -> torch.Tensor:
    """(T, K, S, n_warps) bool: `warp_hit_mask` with the box swept over one
    sample's times only (eps_s over the tile's pixel rows), as `bwd_stacked`'s
    per-row pass takes it for each sample (`make_tile` over samples
    [s, s + 1)). Bit (s, w) clear: no pixel of warp w composites the slot at
    sample s. Every bit it sets is set in `warp_hit_mask` (the narrower time
    range gives a box inside the wider one's, rounding step by rounding
    step)."""
    tx, ty, t_first, t_last = _tile_times(params.shape[0], scalars, tile_size, tiles_x, img_h,
                                          params.device)
    lo, hi = torch.minimum(t_first, t_last), torch.maximum(t_first, t_last)
    return torch.stack([_swept_box_mask(params, counts, tx, ty, e + lo, e + hi, tile_size)
                        for e in scalars[2:]], dim=2)


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


def _check_inputs(params, counts, scalars, tile_size, n_samples, what="rasterize_fwd"):
    if not (params.is_cuda and counts.device == params.device
            and scalars.device == params.device):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device, "
                         f"got {params.device}, {counts.device}, {scalars.device}")
    if params.dtype != torch.float32 or counts.dtype != torch.int32:
        raise ValueError(f"{what} wants float32 params and int32 counts, "
                         f"got {params.dtype}, {counts.dtype}")
    if params.ndim != 3 or params.shape[2] != PARAM_STRIDE:
        raise ValueError(f"{what} wants params (T, K, {PARAM_STRIDE}), "
                         f"got {tuple(params.shape)}")
    if counts.shape != (params.shape[0],):
        raise ValueError(f"counts {tuple(counts.shape)} vs {params.shape[0]} tiles")
    if not (params.is_contiguous() and counts.is_contiguous() and scalars.is_contiguous()):
        raise ValueError(f"{what} wants contiguous inputs")
    if params.data_ptr() % 16:
        raise ValueError(f"{what} wants 16-byte aligned params")
    if not 1 <= n_samples <= MAX_SAMPLES:
        raise ValueError(f"{what} kernel supports 1..{MAX_SAMPLES} samples, "
                         f"got {n_samples}")
    sw, sh = tile_wh(tile_size)
    if sw * sh > MAX_TILE_PIXELS:
        raise ValueError(f"{what} kernel supports tiles of up to "
                         f"{MAX_TILE_PIXELS} pixels, got {sw}x{sh}")


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    """The dispatch rule: kernel for "cuda", and for "auto" on a CUDA tensor."""
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "cuda" or (impl == "auto" and t.is_cuda)


def _launch_fwd(params, counts, scalars, tile_size, tiles_x, img_h):
    n_samples = scalars.shape[0] - 2
    _check_inputs(params, counts, scalars, tile_size, n_samples)
    n_tiles, k, _ = params.shape
    sw, sh = tile_wh(tile_size)
    out = torch.empty((n_tiles, n_samples, NOUT, sw * sh), dtype=torch.float32,
                      device=params.device)
    fn = build.entry("rasterize_fwd", "rasterize_fwd_f32",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        rasterize_fwd.launches += 1
        build.check(fn(params.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
                       out.data_ptr(), n_tiles, k, sw, sh, tiles_x, float(img_h),
                       n_samples, stream), "rasterize_fwd")
    return out


def rasterize_bwd(params: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                  fwd_out: torch.Tensor, g_out: torch.Tensor, tile_size, tiles_x: int,
                  img_h: int, impl: str = "auto") -> torch.Tensor:
    """Gradient of `rasterize_fwd` with respect to its (T, K, 16) blocks,
    given the forward output and its cotangent (T, S, NOUT, npix).

    impl as for rasterize_fwd: the kernel `csrc/rasterize_bwd.cu` for "cuda"
    and for "auto" on CUDA tensors, `rasterize_bwd_plain` otherwise."""
    if not _use_kernel(impl, params):
        return rasterize_bwd_plain(params, counts, scalars, fwd_out, g_out, tile_size,
                                   tiles_x, img_h)
    n_samples = scalars.shape[0] - 2
    _check_inputs(params, counts, scalars, tile_size, n_samples, "rasterize_bwd")
    n_tiles, k, _ = params.shape
    sw, sh = tile_wh(tile_size)
    want = (n_tiles, n_samples, NOUT, sw * sh)
    for name, t in (("fwd_out", fwd_out), ("g_out", g_out)):
        if (t.shape != want or t.dtype != torch.float32 or t.device != params.device
                or not t.is_contiguous()):
            raise ValueError(f"rasterize_bwd wants a contiguous float32 {name} {want} on "
                             f"{params.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    if (sw * sh) % WARP:
        raise ValueError(f"rasterize_bwd kernel wants whole warps: {sw}x{sh} tiles "
                         f"are not a multiple of {WARP} pixels")
    d_params = torch.empty_like(params)
    fn = build.entry("rasterize_bwd", "rasterize_bwd_f32",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        rasterize_bwd.launches += 1
        build.check(fn(params.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
                       fwd_out.data_ptr(), g_out.data_ptr(), d_params.data_ptr(),
                       n_tiles, k, sw, sh, tiles_x, float(img_h), n_samples, stream),
                    "rasterize_bwd")
    return d_params


rasterize_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """The compositor with its analytic backward (the port of the JAX
    package's `_composite_packed` custom VJP). The residuals are the blocks,
    counts, scalars and the forward output; the scalars get no gradient, as
    in JAX, where rs_time, row_offset and eps get zero cotangents."""

    @staticmethod
    def forward(ctx, params, counts, scalars, tile_size, tiles_x, img_h, use_kernel):
        if use_kernel:
            out = _launch_fwd(params, counts, scalars, tile_size, tiles_x, img_h)
        else:
            out = rasterize_fwd_plain(params, counts, scalars, tile_size, tiles_x, img_h)
        ctx.save_for_backward(params, counts, scalars, out)
        ctx.cfg = (tile_size, tiles_x, img_h, "cuda" if use_kernel else "torch")
        return out

    @staticmethod
    def backward(ctx, g_out):
        params, counts, scalars, out = ctx.saved_tensors
        tile_size, tiles_x, img_h, impl = ctx.cfg
        d_params = rasterize_bwd(params, counts, scalars, out, g_out.contiguous(),
                                 tile_size, tiles_x, img_h, impl=impl)
        return d_params, None, None, None, None, None, None


def rasterize_fwd(params: torch.Tensor, counts: torch.Tensor, rs_time,
                  tile_size, tiles_x: int, img_h: int, row_offset=0.0,
                  eps: torch.Tensor | None = None, impl: str = "auto") -> torch.Tensor:
    """Composite all tiles for all sub-frames: (T, S, NOUT, npix).

    params (T, K, 16) per-tile blocks; counts (T,) int32 live rows per tile
    (capped at K; rows past it are masked); rs_time, row_offset scalars;
    eps (S,) sub-frame times (None: one sample at 0); img_h the full height
    the rolling-shutter time is taken over.

    impl: "auto" (kernel on CUDA tensors, plain version on CPU tensors),
    "torch" (plain version on any device) or "cuda" (kernel; raises on CPU).
    The backward (`rasterize_bwd`) takes the same route as the forward."""
    scalars = scalar_vec(rs_time, row_offset, eps, params.device)
    return _Composite.apply(params, counts, scalars, tile_size, tiles_x, img_h,
                            _use_kernel(impl, params))


rasterize_fwd.launches = 0
