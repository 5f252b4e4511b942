"""Plain reference renderer: the port's numerical oracle (port of
`splat_tpu/ops/reference.py`).

A slow but simple renderer over the full image, independent of the tile
binning and of the kernels: the tile route's images and gradients (the plain
route on the CPU, the CUDA kernels on the card) are held against it. It is
differentiable through torch autograd. Each chunk holds several (K, H, W)
tensors, so it is for small images (tests, and checks at 128-256 px).

Compositing model (gsplat semantics):
    alpha_i = min(0.999, o_i * exp(-sigma_i)),  sigma = 0.5(a dx^2 + c dy^2) + b dx dy
    skip if alpha < 1/255; front-to-back: C = sum_i T_i alpha_i c_i, T_{i+1} = T_i(1-alpha_i)
    per-pixel early stop at T < 1e-4; background added with remaining T.

Rolling shutter: the Gaussian's 2D mean is advanced by its screen velocity
times the scanline's residual readout time before evaluating the conic:
    mu_eff(py) = mu + pix_vel * t_read * (py/H - 1/2).

Chunked scan: the depth-sorted Gaussians are processed in chunks of K by a
Python loop. Within a chunk the running transmittances are reconstructed
with an exclusive cumulative product, and the early-stop rule "skip once
T <= 1e-4" is applied by masking on those reconstructed values. Because
alphas only ever shrink T, masking on the unfrozen cumulative product selects
exactly the contributors of the sequential skip rule, and the frozen
post-chunk T equals the inclusive product at the last active position.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_THRESH = 1.0 / 255.0
MAX_ALPHA = 0.999
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    rgb: torch.Tensor            # (H, W, 3) linear-space color
    alpha: torch.Tensor          # (H, W) accumulated opacity (1 - T_final)
    depth: torch.Tensor          # (H, W) alpha-weighted expected depth
    transmittance: torch.Tensor  # (H, W) final T


def _pad_to_multiple(x: torch.Tensor, k: int) -> torch.Tensor:
    """x with zero rows appended along dim 0 up to a multiple of k."""
    pad = (-x.shape[0]) % k
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def render_reference(
    proj,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    img_w: int,
    img_h: int,
    background: torch.Tensor,
    rolling_shutter_time: torch.Tensor | float = 0.0,
    chunk: int = 64,
    tile_size=None,
    max_tiles_per_gaussian: int | None = None,
) -> RenderOutput:
    """Render N Gaussians (`ops.projection.ProjectedGaussians`) over the full
    image, front to back by depth (no tiling).

    colors: (N, 3) linear-space per-Gaussian color (SH already evaluated);
    opacities: (N,) post-sigmoid opacity (compensation applied here);
    background: (3,) composited with remaining transmittance.

    tile_size: if given, emulate the tile rasterizer's visibility rule exactly:
    a Gaussian only contributes to pixels whose tile lies inside its (clamped)
    footprint rect, so comparisons with the tile route can be tight."""
    from . import tiling

    n = proj.means2d.shape[0]
    dtype, dev = colors.dtype, colors.device
    rs = (rolling_shutter_time.to(dtype=dtype, device=dev)
          if isinstance(rolling_shutter_time, torch.Tensor)
          else torch.tensor(float(rolling_shutter_time), dtype=dtype, device=dev))

    # effective opacity: antialias compensation folded in; invalid => 0
    op_eff = opacities * proj.compensations * proj.valid.to(dtype)
    op_eff = torch.where(proj.radii > 0, op_eff, torch.zeros_like(op_eff))

    # optional tile-visibility rects (emulating the tile rasterizer's binning)
    if tile_size is not None:
        span = None
        if max_tiles_per_gaussian is not None:
            sw_, sh_ = tiling.tile_wh(tile_size)
            span_x = max(int((max_tiles_per_gaussian * sh_ / sw_) ** 0.5), 1)
            span_y = max(min(int(span_x * sw_ / sh_), max_tiles_per_gaussian // span_x), 1)
            span = (span_x, span_y)
        radius_pad = torch.abs(proj.pix_vels) * torch.abs(rs) * 0.5  # per-axis box
        rects, _ = tiling.gaussian_tile_rects(
            proj.means2d, proj.extents, proj.valid, img_w, img_h, tile_size,
            radius_pad=radius_pad, max_span=span)
        rect_arr = torch.stack([rects.x0, rects.y0, rects.x1, rects.y1], dim=-1)
    else:
        rect_arr = torch.zeros((n, 4), dtype=torch.int32, device=dev)

    # global front-to-back depth order (invalid pushed to the back)
    sort_depth = torch.where(proj.valid, proj.depths,
                             torch.full_like(proj.depths, float("inf")))
    order = torch.argsort(sort_depth, stable=True)

    rect_s = _pad_to_multiple(rect_arr[order], chunk)
    means2d = _pad_to_multiple(proj.means2d[order], chunk)
    conics = _pad_to_multiple(proj.conics[order], chunk)
    cols = _pad_to_multiple(colors[order], chunk)
    ops = _pad_to_multiple(op_eff[order], chunk)
    depths = _pad_to_multiple(proj.depths[order], chunk)
    pvels = _pad_to_multiple(proj.pix_vels[order], chunk)
    n_pad = means2d.shape[0]

    # pixel-center grid and per-row residual rolling-shutter time
    px = (torch.arange(img_w, dtype=dtype, device=dev) + 0.5)[None, :]  # (1, W)
    py = (torch.arange(img_h, dtype=dtype, device=dev) + 0.5)[:, None]  # (H, 1)
    t_row = rs * (py / img_h - 0.5)                                      # (H, 1)
    if tile_size is not None:
        sw, sh = tiling.tile_wh(tile_size)
        pix_tx = torch.floor(px / sw).to(torch.int32)  # (1, W)
        pix_ty = torch.floor(py / sh).to(torch.int32)  # (H, 1)

    rgb = torch.zeros((img_h, img_w, 3), dtype=dtype, device=dev)
    depth_acc = torch.zeros((img_h, img_w), dtype=dtype, device=dev)
    T = torch.ones((img_h, img_w), dtype=dtype, device=dev)
    for c0 in range(0, n_pad, chunk):
        sl = slice(c0, c0 + chunk)
        m2d, con, col, op, dep, pv, rct = (means2d[sl], conics[sl], cols[sl], ops[sl],
                                           depths[sl], pvels[sl], rect_s[sl])
        # effective means per scanline: mu + pix_vel * t_row -> (K, H, W) deltas
        dx = px[None] - (m2d[:, 0, None, None] + pv[:, 0, None, None] * t_row[None])
        dy = py[None] - (m2d[:, 1, None, None] + pv[:, 1, None, None] * t_row[None])
        sigma = (0.5 * (con[:, 0, None, None] * dx * dx + con[:, 2, None, None] * dy * dy)
                 + con[:, 1, None, None] * dx * dy)
        alpha = torch.clamp(op[:, None, None] * torch.exp(-sigma), max=MAX_ALPHA)
        keep = (sigma >= 0) & (alpha >= ALPHA_THRESH)
        if tile_size is not None:
            keep = keep & ((pix_tx[None] >= rct[:, 0, None, None])
                           & (pix_tx[None] < rct[:, 2, None, None])
                           & (pix_ty[None] >= rct[:, 1, None, None])
                           & (pix_ty[None] < rct[:, 3, None, None]))
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))  # (K, H, W)

        t_inc = T[None] * torch.cumprod(1.0 - alpha, dim=0)        # inclusive running T
        t_exc = torch.cat([T[None], t_inc[:-1]], dim=0)             # exclusive running T
        active = t_exc > T_EPS
        w = torch.where(active, t_exc * alpha, torch.zeros_like(alpha))

        rgb = rgb + torch.einsum("khw,kc->hwc", w, col)
        depth_acc = depth_acc + torch.einsum("khw,k->hw", w, dep)
        # frozen transmittance: the inclusive product at the last active
        # position (amin shares the gradient among ties, as jnp.min does)
        T = torch.amin(torch.where(active, t_inc, T[None].expand_as(t_inc)), dim=0)

    alpha = 1.0 - T
    rgb = rgb + T[..., None] * background
    depth = depth_acc / torch.clamp(alpha, min=1e-10)
    return RenderOutput(rgb=rgb, alpha=alpha, depth=depth, transmittance=T)
