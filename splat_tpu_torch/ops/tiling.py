"""Tile intersection, depth sorting and binning (port of `splat_tpu/ops/tiling.py`).

  1. each Gaussian's screen footprint -> a clamped rect of tiles, expanded into
     at most M = span_x * span_y candidate entries, with the exact conic-vs-rect
     alpha cull;
  2. a lexicographic (tile, depth) sort that keeps entry order on ties — two
     stable sorts, by depth and then by tile, reproduce JAX's stable
     `lax.sort(..., num_keys=2)` exactly;
  3. per-tile ranges by a left searchsorted over the sorted tile ids, and the
     slot <-> entry bijection the training slice's gather-form VJP needs.

Integer results (counts, starts, sorted_ids, entry_slots, overflow counts)
equal JAX's for the same projected inputs. Binning carries no gradient: it
reads detached copies of its float inputs.

That is the plain route, taken on CPU tensors and under impl "torch". On
CUDA tensors `build_tile_lists` and `tile_population` run the kernels of
`ops/cuda/bin_tiles.py`, which build the same lists from the culled-in
entries alone, with no (N, M) candidate tensors and no sort over them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import scalar_tensor, use_kernel
from ..utils import profiling

TILE_SENTINEL = 2**30
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: saturating, NaN -> 0.

    A plain torch cast wraps out-of-range values (1e12, -1e12 and NaN all give
    INT32_MIN), and Gaussians just in front of the near plane project to such
    values; clamp in float64 (exact at the int32 bounds) before the cast."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return torch.clamp(x, _I32_MIN, _I32_MAX).to(torch.int32)


def _add_i32(a: torch.Tensor, k: int) -> torch.Tensor:
    """a + k with int32 wraparound, as XLA's int32 add (INT32_MAX + 1 -> INT32_MIN)."""
    v = a.long() + k
    return ((v - _I32_MIN) % 2**32 + _I32_MIN).to(torch.int32)


def _sigma_min_on_rect(lx, hx, ly, hy, ca, cb, cc):
    """Min of sigma(d) = ca/2 dx^2 + cb dx dy + cc/2 dy^2 over the box
    [lx,hx]x[ly,hy] (relative to the Gaussian mean): 0 when the box holds the
    origin, else the least of the four edges' clamped 1-D minima."""
    def sig(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    ca_s = torch.clamp(ca, min=1e-12)
    cc_s = torch.clamp(cc, min=1e-12)
    vals = []
    for d in (lx, hx):
        dy = torch.minimum(torch.maximum(-(cb / cc_s) * d, ly), hy)
        vals.append(sig(d, dy))
    for e in (ly, hy):
        dx = torch.minimum(torch.maximum(-(cb / ca_s) * e, lx), hx)
        vals.append(sig(dx, e))
    edge_min = torch.minimum(torch.minimum(vals[0], vals[1]),
                             torch.minimum(vals[2], vals[3]))
    inside = (lx <= 0) & (0 <= hx) & (ly <= 0) & (0 <= hy)
    return torch.where(inside, torch.zeros_like(edge_min), edge_min)


class TileRects(NamedTuple):
    x0: torch.Tensor  # (N,) inclusive tile coords, int32
    y0: torch.Tensor
    x1: torch.Tensor  # (N,) exclusive
    y1: torch.Tensor


class TileLists(NamedTuple):
    indices: torch.Tensor | None  # (T, K) int32 gaussian ids, -1 = empty
    counts: torch.Tensor          # (T,) int32 entries per tile (capped at K)
    overflow: torch.Tensor        # () int32 entries dropped by max_per_tile
    clipped: torch.Tensor         # () int32 gaussians whose rect was clamped
    entry_slots: torch.Tensor     # (N * M,) int32 slot t*K + j of each entry, T*K if dropped
    sorted_ids: torch.Tensor      # (L_cap,) int32 gaussian id per sorted position
    starts: torch.Tensor          # (T,) int32 first sorted position per tile
    entry_overflow: torch.Tensor  # () int32 real entries beyond max_total_entries


def tile_wh(tile_size) -> tuple[int, int]:
    """A tile spec (int, or (w, h)) -> (tile_w, tile_h)."""
    if isinstance(tile_size, (tuple, list)):
        tw, th = tile_size
        return int(tw), int(th)
    return int(tile_size), int(tile_size)


def num_tiles(img_w: int, img_h: int, tile_size) -> tuple[int, int]:
    sw, sh = tile_wh(tile_size)
    return -(-img_w // sw), -(-img_h // sh)


def _floor_div_i32(x: torch.Tensor, s: int) -> torch.Tensor:
    return _f2i(torch.floor(x / s))


def gaussian_tile_rects(
    means2d: torch.Tensor,
    extents: torch.Tensor,
    valid: torch.Tensor,
    img_w: int,
    img_h: int,
    tile_size,
    radius_pad: torch.Tensor | None = None,
    max_span: int | tuple[int, int] | None = None,
    row0_px: torch.Tensor | float = 0.0,
    full_img_h: int | None = None,
) -> tuple[TileRects, torch.Tensor]:
    """Tile rects [x0,x1) x [y0,y1) per Gaussian and whether each was clamped.

    extents: (N, 2) half-extents or (N,) radii; radius_pad: (N,) or per-axis
    (N, 2) motion pad; max_span: clamp width/height in tiles around the mean's
    tile; row0_px / full_img_h: row-strip coordinates of a taller image (the
    rect and clamp window are computed globally, then cut to the strip)."""
    dev = means2d.device
    tw, th = num_tiles(img_w, img_h, tile_size)
    sw, sh = tile_wh(tile_size)
    _, th_g = num_tiles(img_w, img_h if full_img_h is None else full_img_h, tile_size)
    row0 = scalar_tensor(row0_px, dev)
    r0 = _f2i(row0 / sh)
    if extents.ndim == 1:
        extents = torch.stack([extents, extents], dim=-1)
    if radius_pad is None:
        px = py = 0.0
    elif radius_pad.ndim == 2:
        px, py = radius_pad[:, 0], radius_pad[:, 1]
    else:
        px = py = radius_pad
    rx = extents[:, 0] + px
    ry = extents[:, 1] + py
    gy = means2d[:, 1] + row0
    x0 = _floor_div_i32(means2d[:, 0] - rx, sw)
    y0 = _floor_div_i32(gy - ry, sh)
    x1 = _add_i32(_floor_div_i32(means2d[:, 0] + rx, sw), 1)
    y1 = _add_i32(_floor_div_i32(gy + ry, sh), 1)
    x0 = torch.clamp(x0, 0, tw)
    y0 = torch.clamp(y0, 0, th_g)
    x1 = torch.clamp(x1, 0, tw)
    y1 = torch.clamp(y1, 0, th_g)

    clipped = torch.zeros_like(x0, dtype=torch.bool)
    if max_span is not None:
        span_x, span_y = max_span if isinstance(max_span, tuple) else (max_span, max_span)
        cx = torch.clamp(_floor_div_i32(means2d[:, 0], sw), 0, tw - 1)
        cy = torch.clamp(_floor_div_i32(gy, sh), 0, th_g - 1)
        wide_x = (x1 - x0) > span_x
        wide_y = (y1 - y0) > span_y
        clipped = wide_x | wide_y
        nx0 = torch.clamp(cx - span_x // 2, 0, tw)
        ny0 = torch.clamp(cy - span_y // 2, 0, th_g)
        x0 = torch.where(wide_x, nx0, x0)
        x1 = torch.where(wide_x, torch.clamp(nx0 + span_x, max=tw), x1)
        y0 = torch.where(wide_y, ny0, y0)
        y1 = torch.where(wide_y, torch.clamp(ny0 + span_y, max=th_g), y1)

    y0 = torch.clamp(y0 - r0, 0, th)
    y1 = torch.clamp(y1 - r0, 0, th)

    keep = valid & (torch.amax(extents, dim=-1) > 0)
    x1 = torch.where(keep, x1, x0)
    y1 = torch.where(keep, y1, y0)
    return TileRects(x0, y0, x1, y1), clipped & keep


def _spans(tile_size, max_tiles_per_gaussian: int) -> tuple[int, int]:
    """Static (span_x, span_y) footprint caps, Python ints."""
    sw, sh = tile_wh(tile_size)
    span_x = max(int((max_tiles_per_gaussian * sh / sw) ** 0.5), 1)
    span_y = max(min(int(span_x * sw / sh), max_tiles_per_gaussian // span_x), 1)
    return span_x, span_y


def _expand_tile_entries(
    means2d, extents, depths, valid, img_w, img_h, tile_size,
    max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh,
    row0_px=0.0, full_img_h=None,
):
    """Candidate (gaussian, tile) entries, at most M per Gaussian, after the
    exact conic cull: (tile_ids (N, M) int32 with TILE_SENTINEL for dead
    entries, was_clipped (N,) bool)."""
    tw, th = num_tiles(img_w, img_h, tile_size)
    sw, sh = tile_wh(tile_size)
    span_x, span_y = _spans(tile_size, max_tiles_per_gaussian)
    m2d = means2d.detach()
    rp = None if radius_pad is None else radius_pad.detach()

    rects, was_clipped = gaussian_tile_rects(
        m2d, extents.detach(), valid, img_w, img_h, tile_size,
        radius_pad=rp, max_span=(span_x, span_y),
        row0_px=row0_px, full_img_h=full_img_h,
    )
    w_rect = rects.x1 - rects.x0
    h_rect = rects.y1 - rects.y0
    n_touch = w_rect * h_rect

    k = torch.arange(span_x * span_y, dtype=torch.int32, device=m2d.device)[None, :]
    w_safe = torch.clamp(w_rect[:, None], min=1)
    ex = rects.x0[:, None] + torch.remainder(k, w_safe)
    ey = rects.y0[:, None] + torch.div(k, w_safe, rounding_mode="floor")
    entry_valid = k < n_touch[:, None]

    if conics is not None and opacities is not None:
        con = conics.detach()
        op = opacities.detach()
        if rp is None:
            pad_ex = pad_ey = torch.zeros((m2d.shape[0], 1), dtype=m2d.dtype, device=m2d.device)
        elif rp.ndim == 2:
            pad_ex, pad_ey = rp[:, 0:1], rp[:, 1:2]
        else:
            pad_ex = pad_ey = rp[:, None]
        lx = ex.to(m2d.dtype) * sw - m2d[:, 0:1] - pad_ex
        hx = lx + sw + 2 * pad_ex
        ly = ey.to(m2d.dtype) * sh - m2d[:, 1:2] - pad_ey
        hy = ly + sh + 2 * pad_ey
        sig_min = _sigma_min_on_rect(lx, hx, ly, hy, con[:, 0:1], con[:, 1:2], con[:, 2:3])
        # alpha_max >= thresh <=> sig_min <= ln(op/thresh); +1e-4 slack so a
        # pixel whose alpha rounds to exactly the floor is never culled
        sig_budget = torch.log(torch.clamp(op, min=1e-12) / alpha_thresh)[:, None]
        entry_valid = entry_valid & (sig_min <= sig_budget + 1e-4)

    tile_ids = ey * tw + ex
    tile_ids = torch.where(entry_valid, tile_ids, torch.full_like(tile_ids, TILE_SENTINEL))
    return tile_ids, was_clipped


def tile_population(
    means2d, extents, depths, valid, img_w: int, img_h: int, tile_size=16,
    max_tiles_per_gaussian: int = 64, radius_pad=None, conics=None,
    opacities=None, alpha_thresh: float = 1.0 / 255.0, row0_px=0.0,
    full_img_h: int | None = None, impl: str = "auto",
) -> torch.Tensor:
    """Uncapped per-tile entry counts (T,) int32: the same footprint and conic
    cull as build_tile_lists, without the sort or the per-tile cap: the
    count kernel of `ops/cuda/bin_tiles.py` where `device.use_kernel` says
    so, else the plain route."""
    if use_kernel(impl, means2d):
        from .cuda import bin_tiles
        return bin_tiles.population(
            means2d, extents, valid, img_w, img_h, tile_size, max_tiles_per_gaussian,
            radius_pad, conics, opacities, alpha_thresh, row0_px, full_img_h)
    tw, th = num_tiles(img_w, img_h, tile_size)
    tile_ids, _ = _expand_tile_entries(
        means2d, extents, depths, valid, img_w, img_h, tile_size,
        max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh,
        row0_px=row0_px, full_img_h=full_img_h,
    )
    flat = torch.clamp(tile_ids.reshape(-1), 0, tw * th).long()  # sentinel -> extra bin
    counts = torch.bincount(flat, minlength=tw * th + 1)
    return counts[:-1].to(torch.int32)


def build_tile_lists(
    means2d: torch.Tensor,
    extents: torch.Tensor,
    depths: torch.Tensor,
    valid: torch.Tensor,
    img_w: int,
    img_h: int,
    tile_size=16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 64,
    radius_pad: torch.Tensor | None = None,
    conics: torch.Tensor | None = None,
    opacities: torch.Tensor | None = None,
    alpha_thresh: float = 1.0 / 255.0,
    materialize_indices: bool = True,
    row0_px: torch.Tensor | float = 0.0,
    full_img_h: int | None = None,
    max_total_entries: int = 0,
    tile_budget=None,
    impl: str = "auto",
) -> TileLists:
    """Dense per-tile, depth-sorted Gaussian lists.

    conics/opacities (effective opacity, compensation folded in): when given,
    entries whose best pixel cannot reach the alpha floor are culled exactly
    before the sort. max_total_entries > 0 caps the sorted stream; real
    entries past it are dropped and counted in entry_overflow. tile_budget:
    a function of the uncapped per-tile counts (T,) int32 that gives each
    tile's cap (T,) int32, at most max_per_tile (None: max_per_tile for
    every tile); a depth slab of a mesh keeps what the whole cloud's lists
    keep of it this way (`parallel.sharding`). Inside a
    trainer's step the binning adds its candidate, culled-in and landed
    entries to the active `profiling.BinningCounters`.

    Where `device.use_kernel(impl, means2d)` says so, the kernels of
    `ops/cuda/bin_tiles.py` build the same lists from the culled-in entries
    alone; sorted_ids then holds the id 0 past the real entries, which no
    output reads. Otherwise the plain route runs."""
    span_x, span_y = _spans(tile_size, max_tiles_per_gaussian)
    n_entries = means2d.shape[0] * span_x * span_y
    if use_kernel(impl, means2d):
        from .cuda import bin_tiles
        lists, n_real, long_tiles = bin_tiles.tile_lists(
            means2d, extents, depths, valid, img_w, img_h, tile_size, max_per_tile,
            max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh, row0_px,
            full_img_h, max_total_entries, tile_budget)
    else:
        lists, n_real = _tile_lists_plain(
            means2d, extents, depths, valid, img_w, img_h, tile_size, max_per_tile,
            max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh, row0_px,
            full_img_h, max_total_entries, tile_budget)
        long_tiles = None
    counters = profiling.active_counters()
    if counters is not None:
        counters.add(n_entries, n_real, lists.counts, long_tiles)
    if materialize_indices:
        lists = lists._replace(indices=materialize(lists, max_per_tile))
    return lists


def materialize(lists: TileLists, max_per_tile: int) -> torch.Tensor:
    """The dense (T, K) id table of a binning, -1 past each tile's count."""
    j = torch.arange(max_per_tile, dtype=torch.int32, device=lists.counts.device)[None, :]
    ids = lists.sorted_ids
    ids_padded = torch.cat([ids, ids.new_zeros(max_per_tile)])
    idx = ids_padded[(lists.starts[:, None] + j).long()]
    return torch.where(j < lists.counts[:, None], idx, torch.full_like(idx, -1))


def cap_counts(counts_full: torch.Tensor, max_per_tile: int, tile_budget) -> torch.Tensor:
    """Each tile's landed count: its count in the stream, capped at
    max_per_tile or at tile_budget(counts_full)."""
    if tile_budget is None:
        return torch.clamp(counts_full, max=max_per_tile)
    return torch.minimum(counts_full, tile_budget(counts_full))


def _tile_lists_plain(means2d, extents, depths, valid, img_w, img_h, tile_size, max_per_tile,
                      max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh,
                      row0_px, full_img_h, max_total_entries, tile_budget):
    """The plain route of build_tile_lists, without `indices`: (TileLists,
    culled-in entries as an int32 scalar)."""
    dev = means2d.device
    n = means2d.shape[0]
    tw, th = num_tiles(img_w, img_h, tile_size)
    n_tiles = tw * th
    tile_ids, was_clipped = _expand_tile_entries(
        means2d, extents, depths, valid, img_w, img_h, tile_size,
        max_tiles_per_gaussian, radius_pad, conics, opacities, alpha_thresh,
        row0_px=row0_px, full_img_h=full_img_h,
    )
    m = tile_ids.shape[1]
    flat_tiles = tile_ids.reshape(-1)
    flat_depths = depths.detach()[:, None].expand(n, m).reshape(-1)
    n_entries = flat_tiles.shape[0]

    # stable lexicographic (tile, depth) order, entry order on ties
    by_depth = torch.sort(flat_depths, stable=True).indices
    by_tile = torch.sort(flat_tiles[by_depth], stable=True).indices
    sorted_entry = by_depth[by_tile]
    sorted_tiles = flat_tiles[sorted_entry]
    sorted_ids = torch.div(sorted_entry, m, rounding_mode="floor").to(torch.int32)

    l_cap = n_entries if max_total_entries <= 0 else min(max_total_entries, n_entries)
    n_real = torch.sum(sorted_tiles < TILE_SENTINEL, dtype=torch.int32)
    entry_overflow = torch.clamp(n_real - l_cap, min=0)
    sorted_tiles_c = sorted_tiles[:l_cap]
    sorted_ids_c = sorted_ids[:l_cap]

    tile_range = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
    edges = torch.searchsorted(sorted_tiles_c, tile_range, right=False).to(torch.int32)
    starts, ends = edges[:-1], edges[1:]
    counts_full = ends - starts
    counts = cap_counts(counts_full, max_per_tile, tile_budget)

    # slot <-> entry bijection: a real entry at sorted position p < l_cap lands
    # in slot (tile, p - starts[tile]) when that rank is under the per-tile
    # cap. (The JAX package finds the run start with a cummax scan, cheaper
    # than an L-row gather on a TPU; on CUDA the gather is the cheap one.
    # Both give the same slots for every position that can hold one.)
    pos = torch.arange(n_entries, dtype=torch.int32, device=dev)
    t_of_pos = torch.clamp(sorted_tiles, 0, n_tiles - 1)
    j_of_pos = pos - starts[t_of_pos.long()]
    j_cap = max_per_tile if tile_budget is None else counts[t_of_pos.long()]
    slot_valid = (sorted_tiles < TILE_SENTINEL) & (j_of_pos < j_cap) & (pos < l_cap)
    dummy = n_tiles * max_per_tile
    slot_of_pos = torch.where(slot_valid, t_of_pos * max_per_tile + j_of_pos,
                              torch.full_like(pos, dummy))
    slot_of_entry = torch.full((n_entries,), dummy, dtype=torch.int32, device=dev)
    slot_of_entry[sorted_entry[:l_cap]] = slot_of_pos[:l_cap]

    return TileLists(
        indices=None,
        counts=counts,
        overflow=torch.sum(counts_full - counts, dtype=torch.int32),
        clipped=torch.sum(was_clipped, dtype=torch.int32),
        entry_slots=slot_of_entry,
        sorted_ids=sorted_ids_c,
        starts=starts,
        entry_overflow=entry_overflow,
    ), n_real
