"""Binning on the card (`csrc/bin_tiles.cu`): `tiling.build_tile_lists` and
`tiling.tile_population` with work that follows the culled-in entries.

On CUDA tensors `tiling` calls `tile_lists` and `population` here. They
launch four kernels (count, scan, scatter, per-tile sort; `population` the
count alone) and a few PyTorch ops: the per-Gaussian cull budget, computed
with the plain route's own ops, the fills of the outputs, and the per-tile
cap (`max_per_tile`, or a `tile_budget` of the uncapped counts) between the
scan and the sort. No launch size depends on the data, so the host never
waits for the card.

The lists are the plain route's, bitwise: counts, starts, overflow,
clipped, entry_overflow and entry_slots equal, sorted_ids equal at every
position below the real entries (capped at the stream's length), and the
real and candidate counts the binning counters read. sorted_ids keeps its
length; past the real entries it holds the id 0, which no output reads (the
compositors mask each tile's rows past its count).

`tile_lists_plain` is the same algorithm in plain PyTorch, step for step:
the count's candidates and cull (the plain route's per-candidate
arithmetic), ranks handed out in an arbitrary arrival order as the atomics
hand them out, the scan, the scatter of the 64-bit keys, and the per-tile
sort through the kernel's network, a segment longer than `chunk` keys in
chunks as the long-segment path sorts it. The CPU tests hold it to the plain
route; the wrappers never take it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tiling
from . import build

SORT_CAP = 4096          # keys a block sorts in shared memory, as in csrc/bin_tiles.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_ROW_ARGTYPES = [_P, _P, _I, _P, _P, _I, _P, ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _I]


def _budget(opacities: torch.Tensor, alpha_thresh: float) -> torch.Tensor:
    """Each Gaussian's cull threshold on sigma_min, with the plain route's
    ops (`tiling._expand_tile_entries`): log(max(op, 1e-12) / alpha) + 1e-4."""
    return torch.log(torch.clamp(opacities.detach(), min=1e-12) / alpha_thresh) + 1e-4


def _row_args(means2d, extents, valid, radius_pad, row0_px, img_w, img_h, tile_size,
              max_tiles_per_gaussian, full_img_h):
    """The C functions' row and grid arguments, the tensors they point into
    (the caller holds them until the launch is enqueued), T and M."""
    dev = means2d.device
    for name, t in (("means2d", means2d), ("extents", extents), ("radius_pad", radius_pad)):
        if t is not None and (not t.is_cuda or t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"bin_tiles wants float32 CUDA tensors on {dev}, got {name} "
                             f"{t.dtype} on {t.device}")
    if means2d.ndim != 2 or means2d.shape[1] != 2:
        raise ValueError(f"bin_tiles wants means2d (N, 2), got {tuple(means2d.shape)}")
    m2d = means2d.detach().contiguous()
    ext = extents.detach().contiguous()
    ok = valid.to(torch.bool).contiguous()
    pad = None if radius_pad is None else radius_pad.detach().contiguous()
    if isinstance(row0_px, torch.Tensor):
        row0 = row0_px.detach().to(device=dev, dtype=torch.float32).reshape(())
        row0_ptr, row0_val = row0.data_ptr(), 0.0
    else:
        row0, row0_ptr, row0_val = None, None, float(row0_px)
    tw, th = tiling.num_tiles(img_w, img_h, tile_size)
    sw, sh = tiling.tile_wh(tile_size)
    _, th_g = tiling.num_tiles(img_w, img_h if full_img_h is None else full_img_h, tile_size)
    span_x, span_y = tiling._spans(tile_size, max_tiles_per_gaussian)
    n = m2d.shape[0]
    args = [m2d.data_ptr(), ext.data_ptr(), 1 if ext.ndim == 1 else ext.shape[1],
            ok.data_ptr(), None if pad is None else pad.data_ptr(),
            0 if pad is None else (1 if pad.ndim == 1 else pad.shape[1]),
            row0_ptr, row0_val, n, tw, th, th_g, sw, sh, span_x, span_y]
    return args, (m2d, ext, ok, pad, row0), tw * th, span_x * span_y


def _cull_args(conics, opacities, alpha_thresh):
    if conics is None or opacities is None:
        return None, None, ()
    con = conics.detach().to(torch.float32).contiguous()
    thr = _budget(opacities, alpha_thresh).to(torch.float32).contiguous()
    return con.data_ptr(), thr.data_ptr(), (con, thr)


def population(means2d, extents, valid, img_w, img_h, tile_size, max_tiles_per_gaussian,
               radius_pad, conics, opacities, alpha_thresh, row0_px, full_img_h) -> torch.Tensor:
    """`tiling.tile_population` on the card: the count kernel alone."""
    args, keep, n_tiles, _ = _row_args(means2d, extents, valid, radius_pad, row0_px, img_w,
                                       img_h, tile_size, max_tiles_per_gaussian, full_img_h)
    con_ptr, thr_ptr, keep_cull = _cull_args(conics, opacities, alpha_thresh)
    cnt = torch.zeros(n_tiles, dtype=torch.int32, device=means2d.device)
    fn = build.entry("bin_tiles", "bin_count_f32", _ROW_ARGTYPES + [_P, _P, _P, _P, _P])
    with torch.cuda.device(means2d.device):
        stream = torch.cuda.current_stream(means2d.device).cuda_stream
        build.count_launch(population)
        build.check(fn(*args, con_ptr, thr_ptr, cnt.data_ptr(), None, stream), "bin_count")
    return cnt


def _int_views(ints: torch.Tensor, n_tiles: int) -> dict:
    """The named parts of the kernels' int32 buffer (csrc/bin_tiles.cu)."""
    t = n_tiles
    return {"clipped": ints[t], "overflow": ints[t + 1], "long_tiles": ints[t + 2],
            "starts": ints[2 * t + 4:3 * t + 4], "counts_full": ints[3 * t + 4:4 * t + 4],
            "real": ints[4 * t + 4], "entry_overflow": ints[4 * t + 5]}


def tile_lists(means2d, extents, depths, valid, img_w, img_h, tile_size, max_per_tile,
               max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh, row0_px,
               full_img_h, max_total_entries, tile_budget):
    """`tiling.build_tile_lists` on the card, without `indices`: (TileLists,
    real entries, long tiles), the last two 0-dim int32 device tensors."""
    dev = means2d.device
    args, keep, n_tiles, m = _row_args(means2d, extents, valid, radius_pad, row0_px, img_w,
                                       img_h, tile_size, max_tiles_per_gaussian, full_img_h)
    con_ptr, thr_ptr, keep_cull = _cull_args(conics, opacities, alpha_thresh)
    if depths.dtype != torch.float32 or not depths.is_cuda:
        raise ValueError(f"bin_tiles wants float32 CUDA depths, got {depths.dtype} on "
                         f"{depths.device}")
    dep = depths.detach().contiguous()
    n = means2d.shape[0]
    n_entries = n * m
    l_cap = n_entries if max_total_entries <= 0 else min(max_total_entries, n_entries)
    dummy = n_tiles * max_per_tile
    ints = torch.zeros(4 * n_tiles + 6, dtype=torch.int32, device=dev)
    slots = torch.full((n_entries,), dummy, dtype=torch.int32, device=dev)
    # a tile past l_cap is never scattered, so the keys fit l_cap plus one
    # tile's, and a tile holds at most one entry a Gaussian
    keys = torch.empty((min(n_entries, l_cap + n),), dtype=torch.int64, device=dev)
    sorted_ids = torch.empty((l_cap,), dtype=torch.int32, device=dev)
    front = build.entry("bin_tiles", "bin_front_f32",
                        _ROW_ARGTYPES + [_P, _P, _P, _I, _I, _P, _P, _P, _P])
    sort = build.entry("bin_tiles", "bin_sort", [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P])
    views = _int_views(ints, n_tiles)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(tile_lists)
        build.check(front(*args, con_ptr, thr_ptr, dep.data_ptr(), l_cap, dummy,
                          ints.data_ptr(), slots.data_ptr(), keys.data_ptr(), stream),
                    "bin_front")
        counts = tiling.cap_counts(views["counts_full"], max_per_tile, tile_budget)
        counts = counts.to(torch.int32).contiguous()
        build.check(sort(n_tiles, max_per_tile, m, l_cap, counts.data_ptr(), ints.data_ptr(),
                         slots.data_ptr(), keys.data_ptr(), sorted_ids.data_ptr(), stream),
                    "bin_sort")
    lists = tiling.TileLists(
        indices=None, counts=counts, overflow=views["overflow"], clipped=views["clipped"],
        entry_slots=slots, sorted_ids=sorted_ids, starts=views["starts"],
        entry_overflow=views["entry_overflow"])
    return lists, views["real"], views["long_tiles"]


tile_lists.launches = 0
population.launches = 0


# ---------------------------------------------------------------------------
# the plain transliteration (CPU tests)

def depth_keys(depths: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving 32 bits of each float32 depth (-0.0 as
    +0.0, every NaN above +inf), as int64 in [0, 2^32)."""
    bits = depths.detach().to(torch.float32).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)
    return torch.where(torch.isnan(depths.detach()), torch.full_like(key, 0xFFFFFFFF), key)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _cswap(s: torch.Tensor, i: torch.Tensor, l: torch.Tensor, n: int) -> None:
    keep = l < n
    i, l = i[keep], l[keep]
    a, b = s[i], s[l]
    swap = a > b
    s[i] = torch.where(swap, b, a)
    s[l] = torch.where(swap, a, b)


def _flip_step(s, n, p, k):
    q = torch.arange(p // 2)
    h = k // 2
    i = (q // h) * k + q % h
    _cswap(s, i, i ^ (k - 1), n)


def _half_step(s, n, p, j):
    q = torch.arange(p // 2)
    i = (q // j) * 2 * j + q % j
    _cswap(s, i, i + j, n)


def _sort_shared(s: torch.Tensor, n: int) -> None:
    p = _pow2_at_least(n)
    k = 2
    while k <= p:
        _flip_step(s, n, p, k)
        j = k // 4
        while j >= 1:
            _half_step(s, n, p, j)
            j //= 2
        k *= 2


def _sort_long(seg: torch.Tensor, n: int, chunk: int) -> None:
    p = _pow2_at_least(n)
    for c0 in range(0, n, chunk):
        s = seg[c0:c0 + chunk].clone()
        _sort_shared(s, s.shape[0])
        seg[c0:c0 + chunk] = s
    k = 2 * chunk
    while k <= p:
        _flip_step(seg, n, p, k)
        j = k // 4
        while j >= chunk:
            _half_step(seg, n, p, j)
            j //= 2
        for c0 in range(0, n, chunk):
            s = seg[c0:c0 + chunk].clone()
            j = chunk // 2
            while j >= 1:
                _half_step(s, s.shape[0], chunk, j)
                j //= 2
            seg[c0:c0 + chunk] = s
        k *= 2


def tile_lists_plain(means2d, extents, depths, valid, img_w, img_h, tile_size, max_per_tile,
                     max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh,
                     row0_px, full_img_h, max_total_entries, tile_budget, chunk=SORT_CAP,
                     generator=None):
    """`tile_lists`' algorithm in plain PyTorch (any device; the tests run it
    on the CPU). `chunk` is the shared-memory capacity of the sort (a smaller
    one sends more tiles down the long-segment path); `generator` draws the
    order in which the atomics hand out the ranks (None: entry order)."""
    tw, th = tiling.num_tiles(img_w, img_h, tile_size)
    n_tiles = tw * th
    n = means2d.shape[0]
    # count: each Gaussian's candidates and the cull, the plain route's arithmetic
    tile_ids, was_clipped = tiling._expand_tile_entries(
        means2d, extents, depths, valid, img_w, img_h, tile_size, max_tiles_per_gaussian,
        radius_pad, conics, opacities, alpha_thresh, row0_px=row0_px, full_img_h=full_img_h)
    m = tile_ids.shape[1]
    flat = tile_ids.reshape(-1).cpu()
    surv = torch.nonzero(flat < tiling.TILE_SENTINEL).squeeze(1)
    tile_of = flat[surv].long()
    arrival = (torch.arange(surv.shape[0]) if generator is None
               else torch.randperm(surv.shape[0], generator=generator))
    by_tile = torch.sort(tile_of[arrival], stable=True).indices
    ranked = tile_of[arrival][by_tile]
    rank = torch.empty_like(surv)
    rank[arrival[by_tile]] = (torch.arange(surv.shape[0])
                              - torch.searchsorted(ranked, ranked, right=False))
    cnt = torch.bincount(tile_of, minlength=n_tiles)
    # scan
    n_entries = n * m
    l_cap = n_entries if max_total_entries <= 0 else min(max_total_entries, n_entries)
    prefix = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    starts = torch.clamp(prefix[:-1], max=l_cap)
    counts_full = torch.clamp(prefix[1:], max=l_cap) - starts
    real = int(prefix[-1])
    # scatter: (depth bits, entry) keys, as signed int64 in the same order
    dkey = depth_keys(depths).cpu()[surv // m]
    key = (dkey - 2**31) * 2**32 + surv
    base = prefix[tile_of]
    scattered = base < l_cap
    keys = torch.zeros(min(n_entries, l_cap + n), dtype=torch.int64)
    keys[(base + rank)[scattered]] = key[scattered]
    # the per-tile cap between the scan and the sort
    dev = means2d.device
    counts = tiling.cap_counts(counts_full.to(device=dev, dtype=torch.int32), max_per_tile,
                         tile_budget).to(torch.int32)
    counts_h = counts.cpu().long()
    # sort, one tile at a time
    slots = torch.full((n_entries,), n_tiles * max_per_tile, dtype=torch.int32)
    sorted_ids = torch.zeros((l_cap,), dtype=torch.int32)
    long_tiles = 0
    for t in torch.nonzero((cnt > 0) & (prefix[:-1] < l_cap)).squeeze(1).tolist():
        b, nt = int(prefix[t]), int(cnt[t])
        seg = keys[b:b + nt].clone()
        if nt <= chunk:
            _sort_shared(seg, nt)
        else:
            long_tiles += 1
            _sort_long(seg, nt, chunk)
        lim = int(counts_full[t])
        landed = max(min(int(counts_h[t]), lim), 0)
        e = seg[:lim] & 0xFFFFFFFF
        sorted_ids[b:b + lim] = (e // m).to(torch.int32)
        slots[e[:landed]] = t * max_per_tile + torch.arange(landed, dtype=torch.int32)
    lists = tiling.TileLists(
        indices=None, counts=counts,
        overflow=torch.sum(counts_full.to(dev) - counts, dtype=torch.int32),
        clipped=torch.sum(was_clipped, dtype=torch.int32),
        entry_slots=slots.to(dev), sorted_ids=sorted_ids.to(dev),
        starts=starts.to(device=dev, dtype=torch.int32),
        entry_overflow=torch.tensor(max(real - l_cap, 0), dtype=torch.int32, device=dev))
    return (lists, torch.tensor(real, dtype=torch.int32, device=dev),
            torch.tensor(long_tiles, dtype=torch.int32, device=dev))


def population_plain(means2d, extents, valid, img_w, img_h, tile_size, max_tiles_per_gaussian,
                     radius_pad, conics, opacities, alpha_thresh, row0_px, full_img_h):
    """The count pass alone in plain PyTorch: the survivors of each tile."""
    tw, th = tiling.num_tiles(img_w, img_h, tile_size)
    tile_ids, _ = tiling._expand_tile_entries(
        means2d, extents, None, valid, img_w, img_h, tile_size, max_tiles_per_gaussian,
        radius_pad, conics, opacities, alpha_thresh, row0_px=row0_px, full_img_h=full_img_h)
    flat = tile_ids.reshape(-1)
    return torch.bincount(flat[flat < tiling.TILE_SENTINEL].long(),
                          minlength=tw * th).to(torch.int32)
