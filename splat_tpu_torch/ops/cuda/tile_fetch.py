"""Tile fetch on the card (`csrc/tile_fetch.cu`): the rasterizer's fetch
with bytes that follow the landed entries.

`tile_fetch_fwd(table, sorted_ids, starts, counts, k_pad)` gives the
(T, k_pad, 16) per-tile blocks: row j < counts[t] of tile t is
table[sorted_ids[starts[t] + j]] (the zero row where that position is at or
past the stream's length). `tile_fetch_bwd(g, entry_slots, n_rows)` gives
the (n_rows, 16) table gradient: row i < n_rows - 1 sums the slot gradients
g[entry_slots[i * M + m]] of its landed entries in the order m = 0 .. M - 1;
the pad row is zero.

On a CUDA tensor each launches its kernel; on a CPU tensor it runs its plain
version. The plain forward is the chain the kernel replaces, the sorted
stream (`row_gather_plain` with k_pad zero rows) cut into windows
(`seg_copy_plain`): equal on every counted row. Rows past a tile's count
are the stream's next rows there and unwritten in the kernel's output: no
kernel reads them (both compositors stop at the count), but the
compositors' plain versions do (with a zero weight, and 0 * NaN is NaN), so
those must be given the counted rows alone. The plain backward adds in the
kernel's order, so the two are bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import use_kernel
from . import build
from .rasterize_kernels import PARAM_STRIDE
from .row_gather import row_gather_plain
from .seg_copy import check_inputs, seg_copy_plain


def tile_fetch_fwd_plain(table: torch.Tensor, sorted_ids: torch.Tensor, starts: torch.Tensor,
                         k_pad: int) -> torch.Tensor:
    """seg_copy_plain(row_gather_plain(table, sorted_ids, k_pad), starts, k_pad)."""
    return seg_copy_plain(row_gather_plain(table, sorted_ids, pad_rows=k_pad), starts, k_pad)


def tile_fetch_bwd_plain(g: torch.Tensor, entry_slots: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows, 16): row i < n_rows - 1 is the sum over m of the slot
    gradient at entry_slots[i * M + m], dropped slots (T * K) adding the zero
    row, in the order m = 0 .. M - 1; row n_rows - 1 (the pad) is zero."""
    width = g.shape[-1]
    d_slots = torch.cat([g.reshape(-1, width), g.new_zeros((1, width))])
    d_table = g.new_zeros((n_rows, width))
    n = n_rows - 1
    if n > 0:
        slots = entry_slots.long().reshape(n, -1)
        for m in range(slots.shape[1]):
            d_table[:n] += d_slots[slots[:, m]]
    return d_table


def check_fwd_inputs(table, sorted_ids, starts, counts, k_pad) -> None:
    """Raise unless `tile_fetch_fwd`'s kernel takes these inputs."""
    for ids in (sorted_ids, starts, counts):
        check_inputs(table, ids, k_pad, name="tile_fetch_fwd")
    if table.shape[1] != PARAM_STRIDE or starts.shape != counts.shape:
        raise ValueError(f"tile_fetch_fwd wants a (R, {PARAM_STRIDE}) table and starts and "
                         f"counts of one shape, got {tuple(table.shape)}, "
                         f"{tuple(starts.shape)}, {tuple(counts.shape)}")


def tile_fetch_fwd(table: torch.Tensor, sorted_ids: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, k_pad: int, impl: str = "auto") -> torch.Tensor:
    """The (T, k_pad, 16) per-tile blocks; rows past a tile's count are not
    part of the result (see the module's docstring). Every sorted id below
    the stream's length must lie in [0, R).

    impl: `device.use_kernel`'s; otherwise `tile_fetch_fwd_plain`."""
    if not use_kernel(impl, table):
        return tile_fetch_fwd_plain(table, sorted_ids, starts, k_pad)
    check_fwd_inputs(table, sorted_ids, starts, counts, k_pad)
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "tile_fetch_fwd's kernel has no backward of its own: differentiate through "
            "ops.cuda.gather_table, whose backward is tile_fetch_bwd")
    n_tiles = starts.shape[0]
    blocks = torch.empty((n_tiles, k_pad, PARAM_STRIDE), dtype=table.dtype, device=table.device)
    fn = build.entry("tile_fetch", "tile_fetch_fwd_f32",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                              ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        build.count_launch(tile_fetch_fwd)
        build.check(fn(table.data_ptr(), sorted_ids.data_ptr(), starts.data_ptr(),
                       counts.data_ptr(), blocks.data_ptr(), n_tiles, k_pad,
                       sorted_ids.shape[0], stream), "tile_fetch_fwd")
    return blocks


def check_bwd_inputs(g, entry_slots, n_rows) -> None:
    """Raise unless `tile_fetch_bwd`'s kernel takes these inputs."""
    n = n_rows - 1
    if g.ndim != 3 or g.shape[-1] != PARAM_STRIDE or n < 0 or (n > 0 and entry_slots.numel() % n):
        raise ValueError(f"tile_fetch_bwd wants g (T, K, {PARAM_STRIDE}) and M entry slots for "
                         f"each of {n} rows, got {tuple(g.shape)} and {entry_slots.numel()}")
    if not g.is_contiguous():
        raise ValueError("tile_fetch_bwd wants contiguous inputs")
    check_inputs(g.view(-1, PARAM_STRIDE), entry_slots, g.shape[1], name="tile_fetch_bwd")


def tile_fetch_bwd(g: torch.Tensor, entry_slots: torch.Tensor, n_rows: int,
                   impl: str = "auto") -> torch.Tensor:
    """The (n_rows, 16) table gradient of `tile_fetch_fwd`'s blocks from
    their gradient g (T, K, 16) and the binning's entry_slots (N * M,
    N = n_rows - 1; T * K marks a dropped entry).

    impl: `device.use_kernel`'s; otherwise `tile_fetch_bwd_plain`."""
    if not use_kernel(impl, g):
        return tile_fetch_bwd_plain(g, entry_slots, n_rows)
    g = g.contiguous()
    check_bwd_inputs(g, entry_slots, n_rows)
    n = n_rows - 1
    m = entry_slots.numel() // n if n > 0 else 0
    d_table = torch.empty((n_rows, PARAM_STRIDE), dtype=g.dtype, device=g.device)
    fn = build.entry("tile_fetch", "tile_fetch_bwd_f32",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                              ctypes.c_void_p])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        build.count_launch(tile_fetch_bwd)
        build.check(fn(g.data_ptr(), entry_slots.data_ptr(), d_table.data_ptr(), n, m,
                       g.shape[0] * g.shape[1], stream), "tile_fetch_bwd")
    return d_table


tile_fetch_fwd.launches = 0
tile_fetch_bwd.launches = 0
