"""Tile rasterization orchestration (port of `splat_tpu/ops/rasterize.py`).

Projected Gaussians are binned once per call (`ops.tiling`), each tile's
parameter rows are fetched, every tile is composited for all S sub-frames,
and the tiles are assembled into images. Two routes share this:

  * impl "auto" / "cuda": `ops.cuda.rasterize_tiles` — the seg_copy fetch from
    the sorted stream and the forward compositing kernel (their plain
    versions on CPU tensors under "auto");
  * impl "torch": `gather_tile_params` from the dense (T, K) id table and the
    compositor's plain forward and backward, on any device — an independent
    route to the same result and gradients, used to check the kernel route
    on the card.

Neither route's backward scatter-adds: both map slot gradients back to
Gaussians by gathers, each built from its own route's data.
"""
from __future__ import annotations

import torch

from ..device import scalar_tensor
from ..utils.profiling import span
from . import tiling
from .cuda import composite_output, pack_param_table, rasterize_tiles
from .cuda.rasterize_kernels import rasterize_fwd
from .projection import ProjectedGaussians
from .reference import RenderOutput

IMPLS = ("auto", "torch", "cuda")


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
        with span("splat.fetch"):
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
    tile_budget=None,
    impl: str = "auto",
) -> tiling.TileLists:
    """Bin once for all sub-frames: the footprint is padded by the largest
    screen shift over the exposure and readout, |pix_vel| * (max|eps| + |rs|/2)
    per axis, and the conic cull uses the effective opacity. tile_budget:
    each tile's cap from its uncapped count (`tiling.build_tile_lists`).
    impl: "auto" (the binning kernels on CUDA tensors), "torch" (the plain
    route) or "cuda"."""
    with span("splat.bin"):
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
            max_total_entries=max_total_entries, tile_budget=tile_budget, impl=impl,
        )


def _composite(proj, colors, opacities, img_w, img_h, eps, rs, tile_size,
               max_per_tile, max_tiles_per_gaussian, impl, rs_full_height,
               rs_row_offset, max_total_entries, tile_budget=None, **reduce_kw):
    if impl not in IMPLS:
        raise ValueError(f"unknown rasterize impl: {impl}")
    lists = bin_tiles(
        proj, opacities, img_w, img_h, eps, rs, tile_size, max_per_tile,
        max_tiles_per_gaussian, rs_full_height, rs_row_offset, max_total_entries,
        materialize_indices=(impl == "torch"), tile_budget=tile_budget, impl=impl,
    )
    if impl == "torch":
        tw, _ = tiling.num_tiles(img_w, img_h, tile_size)
        with span("splat.fetch"):
            blocks = gather_tile_params(lists, pack_param_table(proj, colors, opacities))
        out = rasterize_fwd(blocks, lists.counts, rs, tile_size, tw,
                            rs_full_height or img_h, row_offset=rs_row_offset,
                            eps=eps, impl="torch")
        return composite_output(out, tile_size, **reduce_kw)
    return rasterize_tiles(
        lists, proj, colors, opacities, img_w, img_h, tile_size, rs, max_per_tile,
        rs_full_height=rs_full_height, rs_row_offset=rs_row_offset, eps=eps,
        impl=impl, **reduce_kw,
    )


def rasterize(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_w: int,
    img_h: int,
    background: torch.Tensor,
    rolling_shutter_time=0.0,
    tile_size=16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 64,
    impl: str = "auto",
    rs_full_height: int | None = None,
    rs_row_offset=0,
    max_total_entries: int = 0,
) -> RenderOutput:
    """Rasterize one (sub-)frame. rs_full_height / rs_row_offset: a row strip
    of a taller image (scanline times over the full height)."""
    with span("splat.composite"):
        eps = torch.zeros(1, dtype=colors.dtype, device=colors.device)
        rgb_t, dep_t, T_t = _composite(
            proj, colors, opacities, img_w, img_h, eps, rolling_shutter_time,
            tile_size, max_per_tile, max_tiles_per_gaussian, impl, rs_full_height,
            rs_row_offset, max_total_entries,
        )
        rgb = assemble_image(rgb_t[:, 0], img_w, img_h, tile_size)
        depth_acc = assemble_image(dep_t[:, 0], img_w, img_h, tile_size)
        T = assemble_image(T_t[:, 0], img_w, img_h, tile_size)
        alpha = 1.0 - T
        rgb = rgb + T[..., None] * background
        depth = depth_acc / torch.clamp(alpha, min=1e-10)
        return RenderOutput(rgb=rgb, alpha=alpha, depth=depth, transmittance=T)


def rasterize_fused(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_w: int,
    img_h: int,
    background: torch.Tensor,
    eps: torch.Tensor,
    rolling_shutter_time=0.0,
    tile_size=16,
    max_per_tile: int = 512,
    max_tiles_per_gaussian: int = 64,
    impl: str = "auto",
    rs_full_height: int | None = None,
    rs_row_offset=0,
    reduce: str | None = None,
    mid_index: int | None = None,
    max_total_entries: int = 0,
    tile_budget=None,
) -> RenderOutput:
    """Fused-exposure rasterization: all S sub-frames (eps, seconds) from one
    binning, each rendered by shifting means along their pixel velocity,
    mu + pix_vel * (eps_s + t_rs * (py/H - 1/2)). tile_budget: each tile's
    cap from its uncapped count (`tiling.build_tile_lists`).

    reduce=None: outputs with a leading (S,) axis. reduce="mean": the blur
    average of rgb / alpha / transmittance and the mid-exposure depth (index
    mid_index, default S // 2), reduced in tile space."""
    if reduce not in (None, "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    with span("splat.composite"):
        if reduce == "mean":
            bg = torch.as_tensor(background, dtype=colors.dtype, device=colors.device).expand(3)
            rgb_t, T_t, dep_t = _composite(
                proj, colors, opacities, img_w, img_h, eps, rolling_shutter_time,
                tile_size, max_per_tile, max_tiles_per_gaussian, impl, rs_full_height,
                rs_row_offset, max_total_entries, tile_budget,
                reduce_mean=True, mid_index=mid_index, background=bg,
            )
            T_mean = assemble_image(T_t, img_w, img_h, tile_size)
            return RenderOutput(
                rgb=assemble_image(rgb_t, img_w, img_h, tile_size),
                alpha=1.0 - T_mean,
                depth=assemble_image(dep_t, img_w, img_h, tile_size),
                transmittance=T_mean,
            )
        rgb_t, dep_t, T_t = _composite(
            proj, colors, opacities, img_w, img_h, eps, rolling_shutter_time,
            tile_size, max_per_tile, max_tiles_per_gaussian, impl, rs_full_height,
            rs_row_offset, max_total_entries, tile_budget,
        )

        def assemble(x):
            return torch.stack([assemble_image(x[:, s], img_w, img_h, tile_size)
                                for s in range(x.shape[1])])

        rgb, depth_acc, T = assemble(rgb_t), assemble(dep_t), assemble(T_t)
        alpha = 1.0 - T
        rgb = rgb + T[..., None] * background
        depth = depth_acc / torch.clamp(alpha, min=1e-10)
        return RenderOutput(rgb=rgb, alpha=alpha, depth=depth, transmittance=T)
