"""The compositor's backward with the blur samples stacked on the pixel axis:
the port of `scripts_dev/probe_bwd_stacked.py`'s `bwd_stacked`.

`bwd_stacked(params, counts, scalars, fwd_out, g_out, ...)` computes what
`rasterize_bwd` computes, d_params (T, K, 16) from the (T, K, 16) blocks, the
forward output and its cotangent (T, S, NOUT, npix), in the probe's
formulation: every per-pixel quantity is a column of S * npix stacked rows
(row s * npix + p), one early-stop test covers all of them, and the per-slot
sums over samples and pixels are one reduction over all stacked rows. On CUDA
tensors it launches `csrc/bwd_stacked.cu`: every thread owns the same number
of stacked rows (`stacked_layout`), a warp one sample's 32 pixels per row it
owns, `tps` tiles per block in turn; a warp skips a slot's (sample, strip)
group that `sample_hit_mask` clears, and each row's twelve terms are formed
about the slot's own mean and added directly. On CPU tensors it runs
`bwd_stacked_plain`, which takes the reduction as the probe does, through
the tile-local pixel basis {1, px, py, px^2, px py, py^2} tiled S times, and
assembles the twelve gradients from those moments and the slot's tile-local
mean, conic and pixel velocity. No training path calls it: like its TPU
original it is a probe of which mapping wins
(`scripts_dev/probe_bwd_stacked_torch.py`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...device import use_kernel
from ..reference import MAX_ALPHA, T_EPS
from ..tiling import tile_wh
from . import build
from .rasterize_kernels import (LOG_MAX_ALPHA, LOG_THRESH, NOUT, WARP, _check_inputs,
                                _tile_grid, sample_hit_mask)

MAX_THREADS = 1024     # the kernel's block size limit
MAX_ROWS = 4           # stacked rows a thread may own (the kernel's instantiations)
NEG_BIG = -1e30        # the log opacity of a slot past the tile's count
# the plain version's working set: slots per chunk, elements per plane
PLAIN_CHUNK = 64
PLAIN_PLANE_ELEMS = 1 << 24


class StackedLayout(NamedTuple):
    rows: int              # stacked rows a thread owns
    threads: int           # threads a block
    coefficient_passes: float   # times a pixel's sigma coefficients are formed


def stacked_layout(n_samples: int, npix: int) -> StackedLayout:
    """The kernel's layout for S samples and npix pixels a tile: the tile's
    S * npix / 32 groups of 32 stacked rows spread evenly over the block,
    the least rows a thread (1 to 4) that divide them into at most 16 warps,
    else into at most 32 (a block of <= 16 warps leaves room for two or
    three an SM). Groups are strip-major (strip k, sample s is group
    k * S + s) and warp w owns groups w R .. w R + R - 1, so a thread forms
    the sigma coefficients once per distinct strip of its groups:
    `coefficient_passes` of them a pixel. Raises for a tile the kernel does
    not take."""
    groups = n_samples * npix // WARP
    rows = next((r for most in (MAX_THREADS // WARP // 2, MAX_THREADS // WARP)
                 for r in range(1, MAX_ROWS + 1) if groups % r == 0 and groups // r <= most), 0)
    if npix % WARP or not rows:
        raise ValueError(f"bwd_stacked kernel: {npix}-pixel tiles at S = {n_samples} make "
                         f"{n_samples * npix / WARP:g} groups of {WARP} stacked rows; no count of "
                         f"1 to {MAX_ROWS} rows a thread divides them into at most "
                         f"{MAX_THREADS // WARP} warps")
    strip = [g // n_samples for g in range(groups)]
    passes = sum(len(set(strip[w:w + rows])) for w in range(0, groups, rows))
    return StackedLayout(rows, n_samples * npix // rows, passes / (npix // WARP))


def bwd_stacked_plain(params: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                      fwd_out: torch.Tensor, g_out: torch.Tensor, tile_size, tiles_x: int,
                      img_h: int, count_work: bool = False):
    """Plain PyTorch version in the stacked formulation: d_params (T, K, 16).

    Slots are taken `PLAIN_CHUNK` at a time and tiles as many at a time as keep
    a plane at `PLAIN_PLANE_ELEMS` elements. Per chunk every quantity is
    a (tiles, S * npix, chunk) plane; only the transmittance and the prefix
    walk the chunk slot by slot (the forward's recurrence, operation for
    operation), carried per stacked row from chunk to chunk. The sums over
    the stacked rows are matrix products with the cotangents (4, S * npix) and
    with the pixel basis tiled S times (S * npix, 6): M0 from d_sigma, M1 from
    t d_sigma (3 terms), M2 from t^2 d_sigma (1 term). Expanding (px - mx)^2
    over those moments cancels (in float32 it costs the conic columns up to
    4e-5 of their max on a 96 x 64 test scene), so the products and the
    assembly are taken in float64 and rounded once. A tile group stops after
    the chunk in which every stacked row's T fell to T_EPS.

    count_work=True also returns the kernel's per-sample cull on these inputs,
    by (slot, group of 32 stacked rows: one sample's pixel strip): `groups`,
    those with a row still live (T > T_EPS; the kernel's unit of work);
    `kept_groups`, those of them `sample_hit_mask` keeps; `hit_groups`, those
    where some row composites; `missed_groups`, hit groups the mask clears
    (0: the cull is sound)."""
    n_tiles, k, width = params.shape
    dev = params.device
    n_samples = scalars.shape[0] - 2
    sw, sh = tile_wh(tile_size)
    npix = sw * sh
    sp = n_samples * npix
    tx, ty, px, py, ts = _tile_grid(n_tiles, scalars, tile_size, tiles_x, img_h, dev)
    phi6 = torch.stack([torch.ones_like(px), px, py, px * px, px * py, py * py], dim=1)
    phi6 = phi6.repeat(n_samples, 1).double()                     # (sp, 6)
    n = torch.clamp(counts.long(), max=k)
    d_params = torch.zeros((n_tiles, k, width), dtype=torch.float32, device=dev)
    work = {key: 0 for key in ("groups", "kept_groups", "hit_groups", "missed_groups")}
    if count_work:
        kept_all = sample_hit_mask(params, counts, scalars, tile_size, tiles_x, img_h)
        kept_all = kept_all.reshape(n_tiles, k, sp // WARP)     # group s * strips + strip
    chunk = PLAIN_CHUNK
    step = max(1, PLAIN_PLANE_ELEMS // (sp * chunk))
    for t0 in range(0, n_tiles, step):
        sl = slice(t0, min(t0 + step, n_tiles))
        n_g = n[sl]
        n_max = int(n_g.max())
        if n_max == 0:
            continue
        gt = sl.stop - sl.start
        t_flat = ts[sl].reshape(gt, sp, 1)
        # stacked cotangents, one (tiles, sp, 1) column per output row
        dC = [g_out[sl, :, r].reshape(gt, sp, 1) for r in range(4)]
        f, c = fwd_out[sl], g_out[sl]
        a_total = (f[:, :, 0] * c[:, :, 0] + f[:, :, 1] * c[:, :, 1] + f[:, :, 2] * c[:, :, 2]
                   + f[:, :, 3] * c[:, :, 3] + f[:, :, 4] * c[:, :, 4]).reshape(gt, sp, 1)
        dC4 = torch.cat(dC, dim=2).transpose(1, 2)                # (tiles, 4, sp)
        T = torch.ones((gt, sp), dtype=torch.float32, device=dev)
        prefix = torch.zeros_like(T)
        for base in range(0, n_max, chunk):
            sub = params[sl, base:base + chunk]                   # (tiles, c, 16)
            nc = sub.shape[1]
            col = [sub[:, :, i].unsqueeze(1) for i in range(13)]  # (tiles, 1, c) each
            mx, my = col[0] - tx[sl], col[1] - ty[sl]
            ca, cb, cc, op, pvx, pvy = col[2], col[3], col[4], col[8], col[10], col[11]
            j = base + torch.arange(nc, device=dev)
            lo_hi = torch.where(j[None, None, :] < n_g[:, None, None], col[12], NEG_BIG)
            dx0 = px[None, :, None] - mx                          # (tiles, npix, c)
            dy0 = py[None, :, None] - my
            A = 0.5 * (ca * dx0 * dx0 + cc * dy0 * dy0) + cb * dx0 * dy0
            B = -(ca * dx0 * pvx + cb * (dx0 * pvy + dy0 * pvx) + cc * dy0 * pvy)
            C = 0.5 * (ca * pvx * pvx + cc * pvy * pvy) + cb * pvx * pvy
            t3 = ts[sl].unsqueeze(-1)                             # (tiles, S, npix, 1)
            sigma = (A[:, None] + t3 * (B[:, None] + t3 * C[:, None])).reshape(gt, sp, nc)
            lo = lo_hi - sigma
            mask = (lo >= LOG_THRESH) & (lo <= lo_hi)
            alpha = torch.where(mask, torch.clamp(torch.exp(lo), max=MAX_ALPHA), 0.0)
            v = col[5] * dC[0] + col[6] * dC[1] + col[7] * dC[2] + col[9] * dC[3]
            w = torch.empty_like(alpha)
            contrib = torch.empty_like(alpha)
            prefix_inc = torch.empty_like(alpha)
            for i in range(nc):      # the recurrence, as the forward runs it
                a_i = alpha[:, :, i]
                active = T > T_EPS
                if count_work:
                    live_g = active.reshape(gt, -1, WARP).any(dim=2)            # (tiles, groups)
                    hit_g = (active & mask[:, :, i]).reshape(gt, -1, WARP).any(dim=2)
                    kept_g = kept_all[sl, base + i]
                    work["groups"] += int(live_g.sum())
                    work["kept_groups"] += int((live_g & kept_g).sum())
                    work["hit_groups"] += int(hit_g.sum())
                    work["missed_groups"] += int((hit_g & ~kept_g).sum())
                w[:, :, i] = torch.where(active, T * a_i, 0.0)
                contrib[:, :, i] = w[:, :, i] * v[:, :, i]
                prefix = prefix + contrib[:, :, i]
                prefix_inc[:, :, i] = prefix
                T = torch.where(active, T * (1.0 - a_i), T)
            suffix = a_total - prefix_inc
            live = (w > 0) & (lo < LOG_MAX_ALPHA)
            d_sigma = torch.where(live, alpha / (1.0 - alpha) * suffix - contrib, 0.0)
            d64 = d_sigma.double()
            td = t_flat.double() * d64
            g_cd = torch.matmul(dC4.double(), w.double())         # (tiles, 4, c)
            M0 = torch.matmul(phi6.T, d64)                        # (tiles, 6, c)
            M1 = torch.matmul(phi6[:, :3].T, td)
            m2 = (t_flat.double() * td).sum(dim=1, keepdim=True)  # (tiles, 1, c)
            mx, my, ca, cb, cc, op, pvx, pvy = (
                x.double() for x in (mx, my, ca, cb, cc, op, pvx, pvy))
            M00, M01, M02, M03, M04, M05 = (M0[:, i:i + 1] for i in range(6))
            M10, M11, M12 = (M1[:, i:i + 1] for i in range(3))
            X0, Y0 = M01 - mx * M00, M02 - my * M00
            X1, Y1 = M11 - mx * M10, M12 - my * M10
            XX0 = M03 - 2.0 * mx * M01 + mx * mx * M00
            YY0 = M05 - 2.0 * my * M02 + my * my * M00
            XY0 = M04 - mx * M02 - my * M01 + mx * my * M00
            SU1, SU2 = X0 - pvx * M10, Y0 - pvy * M10
            SV1, SV2 = X1 - pvx * m2, Y1 - pvy * m2
            grads = torch.cat([
                -(ca * SU1 + cb * SU2), -(cc * SU2 + cb * SU1),
                0.5 * (XX0 - 2.0 * pvx * X1 + pvx * pvx * m2),
                XY0 - pvx * Y1 - pvy * X1 + pvx * pvy * m2,
                0.5 * (YY0 - 2.0 * pvy * Y1 + pvy * pvy * m2),
                g_cd[:, 0:3], -M00 / torch.clamp(op, min=1e-12), g_cd[:, 3:4],
                -(ca * SV1 + cb * SV2), -(cc * SV2 + cb * SV1)], dim=1)   # (tiles, 12, c)
            d_params[sl, base:base + nc, :12] = grads.transpose(1, 2).float()
            if not bool((T > T_EPS).any()):
                break
    if count_work:
        return d_params, work
    return d_params


def bwd_stacked(params: torch.Tensor, counts: torch.Tensor, scalars: torch.Tensor,
                fwd_out: torch.Tensor, g_out: torch.Tensor, tile_size, tiles_x: int,
                img_h: int, tps: int = 1, impl: str = "auto") -> torch.Tensor:
    """d_params (T, K, 16), as `rasterize_bwd` and from the same arguments
    (`scalars` = [rs_time, row_offset, eps_0..eps_{S-1}]); tps: tiles a thread
    block works through in turn (the sums do not depend on it).

    impl: `device.use_kernel`'s; otherwise `bwd_stacked_plain`."""
    if not use_kernel(impl, params):
        return bwd_stacked_plain(params, counts, scalars, fwd_out, g_out, tile_size, tiles_x,
                                 img_h)
    n_samples = scalars.shape[0] - 2
    _check_inputs(params, counts, scalars, tile_size, n_samples, "bwd_stacked")
    n_tiles, k, _ = params.shape
    sw, sh = tile_wh(tile_size)
    npix = sw * sh
    want = (n_tiles, n_samples, NOUT, npix)
    for name, t in (("fwd_out", fwd_out), ("g_out", g_out)):
        if (t.shape != want or t.dtype != torch.float32 or t.device != params.device
                or not t.is_contiguous()):
            raise ValueError(f"bwd_stacked wants a contiguous float32 {name} {want} on "
                             f"{params.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    rows = stacked_layout(n_samples, npix).rows
    if tps < 1:
        raise ValueError(f"bwd_stacked wants tps >= 1, got {tps}")
    d_params = torch.empty_like(params)
    fn = build.entry("bwd_stacked", "bwd_stacked_f32",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        build.count_launch(bwd_stacked)
        build.check(fn(params.data_ptr(), counts.data_ptr(), scalars.data_ptr(),
                       fwd_out.data_ptr(), g_out.data_ptr(), d_params.data_ptr(),
                       n_tiles, k, sw, sh, tiles_x, float(img_h), n_samples, tps, rows, stream),
                    f"bwd_stacked(tps={tps})")
    return d_params


bwd_stacked.launches = 0
