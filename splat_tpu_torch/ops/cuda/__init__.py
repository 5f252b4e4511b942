"""The kernel path of the rasterizer: the counterpart of `splat_tpu/ops/pallas/__init__.py`.

`rasterize_tiles` packs one parameter row per Gaussian, fetches each tile's
counted rows of the depth-sorted order straight from that table with
`tile_fetch_fwd`, composites every tile and sub-frame with `rasterize_fwd`,
and reshapes to per-tile images.

Both steps carry their own backward, and neither scatter-adds: the
compositor's is the `rasterize_bwd` kernel, and the fetch's (`tile_fetch_bwd`)
maps each slot's gradient back to its Gaussian by a gather over the
binning's slot <-> entry bijection (`TileLists.entry_slots`), as the JAX
package's `_gather_table` does. So the route's backward is deterministic and
uses no float atomics.
"""
from __future__ import annotations

import torch

from ...utils.profiling import span
from .. import tiling
from ..projection import ProjectedGaussians, effective_opacity
from . import bin_tiles as _bin_tiles
from .project_sh import project_sh_bwd, project_sh_fwd
from .rasterize_kernels import NPARAM, PARAM_STRIDE, rasterize_bwd, rasterize_fwd
from .row_gather import row_gather as _row_gather
from .tile_fetch import tile_fetch_bwd as _tile_fetch_bwd
from .tile_fetch import tile_fetch_fwd as _tile_fetch_fwd


def path_launches() -> dict[str, int]:
    """This process's launches of the kernels on the render and training
    path (each wrapper counts its own; zero where only plain versions ran):
    the fetch pair and the compositing kernels, the projection pair (a
    backward launch is the per-Gaussian kernel with, where the camera takes a
    gradient, its fixed-order sum over blocks) and the binning (a launch is
    one binning's count, scan, scatter and sort)."""
    return {"tile_fetch_fwd": _tile_fetch_fwd.launches, "rasterize_fwd": rasterize_fwd.launches,
            "rasterize_bwd": rasterize_bwd.launches, "tile_fetch_bwd": _tile_fetch_bwd.launches,
            "project_sh_fwd": project_sh_fwd.launches,
            "project_sh_bwd": project_sh_bwd.launches,
            "bin_tiles": _bin_tiles.tile_lists.launches}


def pack_param_table(
    proj: ProjectedGaussians, colors: torch.Tensor, opacities: torch.Tensor
) -> torch.Tensor:
    """Per-Gaussian packed (N+1, 16) parameter table; row N is a zero pad row.

    Columns 0-12 as in the JAX package: mean x/y, conic a/b/c, rgb, effective
    opacity, depth, pixel velocity x/y, log(effective opacity). Columns 13-15
    are zero so each row is 64 bytes and the kernels load it 16 bytes at a
    time. The log column carries no gradient (the opacity gradient flows
    through column 8)."""
    op_eff = effective_opacity(proj, opacities)
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


def sorted_stream(table: torch.Tensor, sorted_ids: torch.Tensor, k_pad: int,
                  impl: str = "auto") -> torch.Tensor:
    """Table rows in sorted (tile, depth) order plus k_pad zero rows, so every
    tile's k_pad-row window is in bounds: (L + k_pad, 16). On CUDA tensors the
    `row_gather` kernel reads the int32 ids as they are and writes the pad
    rows into the same buffer. The render and training path do not build
    it (`gather_table` fetches from the table); `seg_copy` over it is the
    input the compositor probes and tests use."""
    return _row_gather(table, sorted_ids.contiguous(), impl=impl, pad_rows=k_pad)


class _GatherTable(torch.autograd.Function):
    """Forward: `tile_fetch_fwd`, each tile's counted rows from the table.
    Backward: `tile_fetch_bwd`, the gather form of `_gather_table_bwd`: each
    Gaussian's landed slot gradients (`entry_slots`, M per Gaussian) summed in
    a fixed order, dropped entries skipped, the pad row zero."""

    @staticmethod
    def forward(ctx, table, sorted_ids, starts, counts, entry_slots, k_pad, impl):
        ctx.save_for_backward(entry_slots)
        ctx.n_rows = table.shape[0]
        ctx.impl = impl
        return _tile_fetch_fwd(table, sorted_ids.contiguous(), starts.contiguous(),
                               counts.contiguous(), k_pad, impl=impl)

    @staticmethod
    def backward(ctx, g):
        (entry_slots,) = ctx.saved_tensors
        with span("splat.fetch"):
            d_table = _tile_fetch_bwd(g, entry_slots.contiguous(), ctx.n_rows, impl=ctx.impl)
        return d_table, None, None, None, None, None, None


def gather_table(table: torch.Tensor, lists: tiling.TileLists, k_pad: int,
                 impl: str = "auto") -> torch.Tensor:
    """Per-tile parameter blocks (T, k_pad, 16) straight from sorted order
    (the port of the JAX package's `_gather_table`). Only each tile's first
    counts[t] rows are part of the result: past them the kernel writes
    nothing (the plain version leaves the stream's next rows). No kernel
    reads those rows, so they get no gradient; the compositors' plain
    versions must be given the counted rows alone. k_pad must be the
    binning's max_per_tile, the K of `lists.entry_slots`."""
    return _GatherTable.apply(table, lists.sorted_ids, lists.starts, lists.counts,
                              lists.entry_slots, k_pad, impl)


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


def rasterize_tiles(
    lists: tiling.TileLists,
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_w: int,
    img_h: int,
    tile_size,
    rs_time,
    max_per_tile: int,
    rs_full_height: int | None = None,
    rs_row_offset=0,
    eps: torch.Tensor | None = None,
    reduce_mean: bool = False,
    mid_index: int | None = None,
    background: torch.Tensor | None = None,
    impl: str = "auto",
):
    """Per-tile compositing through the two kernels (port of
    `rasterize_tiles_pallas`). eps: (S,) sub-frame times (None: S = 1).
    Returns composite_output's tuple."""
    tw, _ = tiling.num_tiles(img_w, img_h, tile_size)
    with span("splat.fetch"):
        table = pack_param_table(proj, colors, opacities)
        blocks = gather_table(table, lists, max_per_tile, impl=impl)
    out = rasterize_fwd(blocks, lists.counts, rs_time, tile_size, tw,
                        rs_full_height or img_h, row_offset=rs_row_offset, eps=eps,
                        impl=impl)
    return composite_output(out, tile_size, reduce_mean, mid_index, background)
