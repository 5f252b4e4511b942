"""The reference's render, binning probe and steps for a scene too large to
render whole on one card: the same arithmetic as `model.render_camera`,
`model.binning_counts`, `train.train_step` and `train.eval_opt_step`,
computed in blocks of Gaussians. The frozen files stay as they are; this
one is the benchmark's own and imports nothing of the program.

A camera's render, anchor group by anchor group:
  1. binning in blocks of `BLOCK` Gaussians without gradient: each block
     projected (`model.subframe_inputs`), its footprints expanded and culled
     exactly as `compositor.bin_tiles` does (`tiling._expand_tile_entries`),
     and only the real entries kept, in the order of the whole array;
  2. the per-tile lists from those entries: the two stable sorts of
     `tiling.build_tile_lists` order the real entries as they order them
     among the dead ones, so the lists are the whole array's;
  3. the landed Gaussians alone (a view holds a part of the scene)
     projected again with gradient, through `index_select` so their
     gradients land in the whole leaves, and composited by the frozen
     compositor over the lists renumbered to them.
The loss is `model.compute_losses` on the whole image (the compositor's
memory is the one-card cell's: the entries landing per binning are about
as many). A landed Gaussian's projection is the same per-row arithmetic in
both passes, up to the blocks' matrix products.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import compositor, tiling
from . import model as m
from . import train as rt

BLOCK = 1 << 21


class _Lists(NamedTuple):
    """What `compositor.gather_tile_params` reads of the tile lists."""
    indices: torch.Tensor


def _block(params: m.ModelParams, lo: int, hi: int) -> m.ModelParams:
    return params._replace(gaussians=m.GaussianParams(*(t[lo:hi] for t in params.gaussians)))


def _taken(params: m.ModelParams, idx: torch.Tensor) -> m.ModelParams:
    return params._replace(gaussians=m.GaussianParams(
        *(t.index_select(0, idx) for t in params.gaussians)))


@torch.no_grad()
def _tile_lists(params, motion, config, sh_deg, t_a, eps, opac, block):
    """The per-tile lists of the anchor at t_a: (indices (T, K) of Gaussian
    ids, -1 empty; counts (T,) capped at K)."""
    w, h = motion.camera.width, motion.camera.height
    n = opac.shape[0]
    t_max = torch.amax(torch.abs(eps)) + 0.5 * torch.abs(motion.rs_time)
    ids, tiles, depths = [], [], []
    m_span = None
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        proj, _ = m.subframe_inputs(_block(params, lo, hi), motion, config, sh_deg, t_a)
        op_eff = opac[lo:hi] * proj.compensations * proj.valid.to(opac.dtype)
        tile_ids, _ = tiling._expand_tile_entries(
            proj.means2d, proj.extents, proj.depths, proj.valid, w, h, config.tile_size,
            config.max_tiles_per_gaussian, torch.abs(proj.pix_vels) * t_max, proj.conics,
            op_eff, compositor.ALPHA_THRESH)
        m_span = tile_ids.shape[1]
        flat = tile_ids.reshape(-1)
        pos = torch.nonzero(flat < tiling.TILE_SENTINEL).reshape(-1)
        g_id = torch.div(pos, m_span, rounding_mode="floor")
        ids.append((g_id + lo).to(torch.int32))
        tiles.append(flat[pos])
        depths.append(proj.depths[g_id])
    ids, tiles, depths = torch.cat(ids), torch.cat(tiles), torch.cat(depths)
    # tiling.build_tile_lists over the real entries alone
    dev = opac.device
    tw, th = tiling.num_tiles(w, h, config.tile_size)
    n_tiles, k = tw * th, config.max_per_tile
    by_depth = torch.sort(depths, stable=True).indices
    by_tile = torch.sort(tiles[by_depth], stable=True).indices
    order = by_depth[by_tile]
    l_cap = ids.shape[0]
    if config.max_total_entries > 0:
        l_cap = min(config.max_total_entries, n * m_span, l_cap)
    sorted_tiles, sorted_ids = tiles[order][:l_cap], ids[order][:l_cap]
    edges = torch.searchsorted(sorted_tiles, torch.arange(n_tiles + 1, dtype=torch.int32,
                                                          device=dev)).to(torch.int32)
    starts = edges[:-1]
    counts = torch.clamp(edges[1:] - starts, max=k)
    j = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    padded = torch.cat([sorted_ids, sorted_ids.new_zeros(k)])
    idx = padded[(starts[:, None] + j).long()]
    return torch.where(j < counts[:, None], idx, torch.full_like(idx, -1)), counts


def render_camera(params: m.ModelParams, camera: m.Cameras, config: m.SplatfactoConfig,
                  sh_degree_active, background: torch.Tensor, is_eval_camera: bool = False,
                  means2d_probe: torch.Tensor | None = None,
                  block: int | None = None) -> m.Render:
    """`model.render_camera` (fused blur anchors) for one whole camera, the
    Gaussians binned in blocks and only the landed ones differentiated."""
    motion = m.camera_motion(params, camera, config, is_eval_camera)
    g = params.gaussians
    opac = torch.sigmoid(g.opacities_logit) * g.alive.detach()
    w, h = motion.camera.width, motion.camera.height
    tw, _ = tiling.num_tiles(w, h, config.tile_size)
    eps = motion.eps
    n_s = eps.shape[0]
    groups = m.anchor_groups(n_s, max(min(config.blur_anchors, n_s), 1)) if n_s > 1 else [(0, 1)]
    mid_global = n_s // 2
    per_anchor, counts, mid_anchor = [], [], None
    for a_lo, a_hi in groups:
        t_a = eps[a_lo:a_hi].mean()
        eps_a = eps[a_lo:a_hi] - t_a
        idx, tile_counts = _tile_lists(params, motion, config, sh_degree_active, t_a.detach(),
                                       eps_a.detach(), opac.detach(), block or BLOCK)
        landed = torch.unique(idx[idx >= 0])               # ascending Gaussian ids
        local = torch.where(idx >= 0, torch.searchsorted(landed, idx.clamp(min=0)), -1)
        probe = None if means2d_probe is None else means2d_probe.index_select(0, landed)
        proj, colors = m.subframe_inputs(_taken(params, landed), motion, config,
                                         sh_degree_active, t_a, probe)
        table = compositor.pack_param_table(proj, colors, opac.index_select(0, landed))
        tiles = compositor.gather_tile_params(_Lists(local), table)
        out = compositor.rasterize_fwd(tiles, tile_counts, motion.rs_time, config.tile_size, tw,
                                       h, eps=eps_a)
        in_group = a_lo <= mid_global < a_hi
        if in_group:
            mid_anchor = len(per_anchor)
        bg = torch.as_tensor(background, dtype=colors.dtype, device=colors.device).expand(3)
        rgb_t, t_t, dep_t = compositor.composite_output(
            out, config.tile_size, reduce_mean=True,
            mid_index=(mid_global - a_lo) if in_group else None, background=bg)
        t_img = compositor.assemble_image(t_t, w, h, config.tile_size)
        per_anchor.append(m.Render(compositor.assemble_image(rgb_t, w, h, config.tile_size),
                                   1.0 - t_img,
                                   compositor.assemble_image(dep_t, w, h, config.tile_size),
                                   t_img))
        counts.append(a_hi - a_lo)
    rgb = sum(c * o.rgb for c, o in zip(counts, per_anchor)) / n_s
    alpha = sum(c * o.alpha for c, o in zip(counts, per_anchor)) / n_s
    t_all = sum(c * o.transmittance for c, o in zip(counts, per_anchor)) / n_s
    return m.Render(rgb, alpha, per_anchor[mid_anchor].depth, t_all)


@torch.no_grad()
def binning_counts(params: m.ModelParams, camera: m.Cameras, config: m.SplatfactoConfig,
                   block: int | None = None) -> torch.Tensor:
    """`model.binning_counts`, summed over blocks of Gaussians (counts over
    a partition of the Gaussians add)."""
    n = params.gaussians.alive.shape[0]
    block = block or BLOCK
    total = None
    for lo in range(0, n, block):
        c = m.binning_counts(_block(params, lo, min(lo + block, n)), camera, config).long()
        total = c if total is None else total + c
    return total.to(torch.int32)


def _with_render(fn):
    """`fn` of `train.py` with `model.render_camera` the blocked render."""
    def wrapped(*args, **kw):
        prev = rt.m.render_camera
        rt.m.render_camera = render_camera
        try:
            return fn(*args, **kw)
        finally:
            rt.m.render_camera = prev
    return wrapped


train_step = _with_render(rt.train_step)
eval_opt_step = _with_render(rt.eval_opt_step)
