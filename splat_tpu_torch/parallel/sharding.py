"""Multi-device training on the `(data, gauss, blur, tile)` mesh (port of
`splat_tpu/parallel/sharding.py` onto `torch.distributed`).

One process per device (one rank per card on CUDA, with NCCL; gloo on the
CPU). The rank order puts `data` outermost, then `gauss`, `blur` and
`tile`: under `torchrun --nnodes N` the data axis spans the nodes and the
others stay within one, the layout of the JAX package's
`make_multihost_mesh`.

  * `data`: a camera batch, one camera per rank, the loss their mean;
  * `gauss`: the Gaussian leaves, their Adam moments and the densification
    accumulators live sharded along the capacity axis. Each rank projects
    its shard, then either gathers the 16-float rasterization table (and the
    2-float footprint) of every shard (`gauss_shard_mode="gather"`) or
    trades rows so that each rank holds one depth slab of the scene,
    composites only that slab and merges the slabs' images with the
    over-operator (`"slab"`). Needs the fused blur mode when S > 1;
  * `blur`: the S sub-frames of an exposure split into equal groups; their
    linear sums are added over the axis;
  * `tile`: the image split into row strips; each rank bins and composites
    its own strip, with rolling-shutter times over the full height. A
    strip's means are the full image's moved up by its first row, which is
    exact; the JAX package projects with a strip-local principal point,
    whose rounding (6e-5 px at 1024 rows) carries a faint pixel across the
    1/255 alpha floor now and then.

The loss is exact against the single-device loss: L1 over strips adds
per-strip sums, and SSIM evaluates, on each strip, the 11x11 windows that
start in its rows, with the 10 rows below taken from the next strip(s)
(`_halo_rows_below`), and adds the window sums over the global window count.

The exchanges the loss differentiates through are `collectives`' autograd
functions; their convention is that each rank back-propagates its own share
of the loss and the shares sum to the single-device loss. `sharded_loss`
returns this rank's share; `reduce_gradients` then sums each leaf's gradient
over the ranks that hold the same leaf (every rank for a replicated leaf,
the ranks of one `gauss` coordinate for a shard).

Blur anchors: each blur rank renders the part of every anchor group (the
single-device fused mode's `blur_anchors` groups) that falls in its own
samples, each at its group's anchor pose, so every mesh shape reproduces
the single-device render. (The JAX package anchors each blur shard at its own
samples' mean when `blur_anchors` > 1, which is the single-device render only
when the groups and the shards coincide.)
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..cameras import optimizers as cam_opt
from ..cameras.cameras import Cameras
from ..device import resolve_device
from ..models import splatfacto as sf
from ..models import strategy as st
from ..ops import projection, rasterize
from ..ops.cuda import pack_param_table
from ..ops.reference import RenderOutput
from ..ops.ssim import ssim_map
from ..ops.tiling import tile_wh
from ..utils.profiling import active_slab_counters, span
from .collectives import Axis, all_gather, all_reduce_sum, all_to_all, from_next, gather_, reduce_

AXES = ("data", "gauss", "blur", "tile")
SSIM_WINDOW = 11
# the environment of a multi-process launch: a failed init with any of these
# set is a real failure, never a silent single-process run
LAUNCH_INDICATORS = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID")


# ----------------------------------------------------------------- the mesh
class Mesh:
    """This rank's view of the mesh: the world size, this rank, the axis
    sizes (`shape`), this rank's index along each (`coords`), and one `Axis`
    (process group) per mesh axis, plus `peers` (the ranks that hold the
    same Gaussian shard: one `gauss` coordinate) and `world`."""

    def __init__(self, shape: dict[str, int], rank: int, axes: dict[str, Axis]):
        self.shape = dict(shape)
        self.world = math.prod(shape.values())
        self.rank = rank
        self.axes = axes
        self.coords = {a: axes[a].index for a in AXES}

    def __repr__(self) -> str:
        return ("Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES)
                + f"; rank {self.rank} of {self.world} at {self.coords})")

    @property
    def owner(self) -> bool:
        """The one rank of each Gaussian shard that adds the terms the loss
        counts once per shard (data, blur and tile index 0)."""
        return all(self.coords[a] == 0 for a in ("data", "blur", "tile"))


def _rank_of(coords: dict[str, int], shape: dict[str, int]) -> int:
    r = 0
    for a in AXES:
        r = r * shape[a] + coords[a]
    return r


def _coords_of(rank: int, shape: dict[str, int]) -> dict[str, int]:
    out = {}
    for a in reversed(AXES):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in AXES}


def _all_coords(shape: dict[str, int], fixed: dict[str, int] | None = None):
    """Every coordinate dict of the mesh, in rank order, with `fixed` held."""
    fixed = fixed or {}
    for r in range(math.prod(shape.values())):
        c = _coords_of(r, shape)
        if all(c[a] == v for a, v in fixed.items()):
            yield c


def make_mesh(shape: dict[str, int]) -> Mesh:
    """The mesh of axis sizes `shape` ({data, gauss, blur, tile}; missing
    axes are 1) over the initialized process group, whose world size must be
    their product; a single process needs no process group. Every rank calls
    this with the same shape: process groups are made collectively."""
    shape = {a: int(shape.get(a, 1)) for a in AXES}
    world = math.prod(shape.values())
    if dist.is_initialized():
        rank = dist.get_rank()
        if dist.get_world_size() != world:
            raise ValueError(f"mesh {shape} needs {world} ranks; the process group has "
                             f"{dist.get_world_size()}")
    elif world == 1:
        rank = 0
    else:
        raise RuntimeError(f"mesh {shape} needs {world} ranks and torch.distributed is not "
                           "initialized (parallel.launch starts them)")
    me = _coords_of(rank, shape)

    def axis_over(name: str, members: list[list[int]]) -> Axis:
        """Make a group of every member list (all ranks call this alike) and
        keep the one holding this rank."""
        mine = next(m for m in members if rank in m)
        group = None
        for m in members:
            g = dist.new_group(m) if len(m) > 1 else None
            if m is mine:
                group = g
        return Axis(name, len(mine), mine.index(rank), tuple(mine), group)

    axes = {}
    for a in AXES:
        # one group per line of the mesh along `a`
        axes[a] = axis_over(a, [[_rank_of({**c, a: i}, shape) for i in range(shape[a])]
                                for c in _all_coords({**shape, a: 1})])
        assert axes[a].index == me[a], a
    # the ranks of one gauss coordinate hold the same shard
    peers = [[_rank_of(c, shape) for c in _all_coords(shape, {"gauss": g})]
             for g in range(shape["gauss"])]
    axes["peers"] = axis_over("peers", peers)
    axes["world"] = Axis("world", world, rank, tuple(range(world)),
                         dist.group.WORLD if world > 1 else None)
    return Mesh(shape, rank, axes)


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device: str | torch.device | None = None) -> bool:
    """Initialize `torch.distributed` for ranks on `device` (CUDA unless the
    caller asks otherwise; `device.resolve_device`): NCCL on CUDA, gloo on
    the CPU. Returns True when a process group is up. Without arguments it
    reads the launch environment (`torchrun`'s RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); with nothing to read it is a no-op single-process run. A
    failure raises when arguments were given or the environment shows a
    multi-process launch (WORLD_SIZE > 1, MASTER_ADDR, TORCHELASTIC_RUN_ID):
    each process would otherwise train alone and silently."""
    if dist.is_initialized():
        return True
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kw = {k: v for k, v in (("init_method", init_method), ("world_size", world_size),
                            ("rank", rank)) if v is not None}
    try:
        dist.init_process_group(backend, **kw)
    except (RuntimeError, ValueError) as e:
        if kw:
            raise
        indicators = [k for k in LAUNCH_INDICATORS if os.environ.get(k)]
        if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
            indicators.insert(0, "WORLD_SIZE")
        if indicators:
            raise RuntimeError(
                "torch.distributed.init_process_group() failed while multi-process "
                f"environment indicators are set ({', '.join(indicators)}); refusing to "
                "continue as a silent single-process run") from e
        return False
    return True


def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def resolve_mesh(mc, config: sf.SplatfactoConfig, img_h: int, n_devices: int) -> dict[str, int]:
    """The axis sizes {data, gauss, blur, tile} of a `MeshConfig` (0 = auto)
    over n_devices, the JAX package's auto-fill: blur divides blur_samples,
    tile splits the image height into tile-aligned strips (tile strips
    preferred, then blur); their product may leave devices idle, never
    exceed them."""
    data = mc.data or 1
    gauss = mc.gauss or 1
    assert n_devices % (data * gauss) == 0, (
        f"{n_devices} devices not divisible by data*gauss = {data * gauss}")
    rem = n_devices // (data * gauss)
    s = max(config.blur_samples, 1)
    tile_h = tile_wh(config.tile_size)[1]
    blur, tile = mc.blur, mc.tile
    if blur == 0 and tile == 0:
        for t in _divisors_desc(rem):
            strip = img_h // t
            aligned = t == 1 or (img_h % t == 0 and strip % tile_h == 0)
            if aligned and (rem // t) <= s and s % (rem // t) == 0:
                tile, blur = t, rem // t
                break
        else:
            tile, blur = 1, max(d for d in _divisors_desc(rem) if s % d == 0)
    elif blur == 0:
        assert rem % tile == 0, (rem, tile)
        blur = max(d for d in _divisors_desc(rem // tile) if s % d == 0)
    elif tile == 0:
        assert rem % blur == 0, (rem, blur)
        tile = rem // blur
    assert s % blur == 0, f"blur_samples={s} not divisible by blur axis {blur}"
    # one strip is the whole image, whose last tile row may be partial
    assert tile == 1 or (img_h % tile == 0 and (img_h // tile) % tile_h == 0), (
        f"image height {img_h} must split into {tile} tile-aligned strips")
    used = data * gauss * blur * tile
    assert used <= n_devices, (used, n_devices)
    return {"data": data, "gauss": gauss, "blur": blur, "tile": tile}


# ------------------------------------------------------- the strip render
def _all_gather_projected(proj: projection.ProjectedGaussians, colors: torch.Tensor,
                          opacities: torch.Tensor, gauss: Axis):
    """The full cloud's rasterization inputs from every shard's: the packed
    16-float table and the 2-float footprint, gathered in one exchange (the
    backward a reduce-scatter of their cotangents). Returns a
    ProjectedGaussians with the opacity folded in, its colours and
    opacities."""
    table = pack_param_table(proj, colors, opacities)[:-1]
    rows = torch.cat([table, proj.extents], dim=1)
    rows = all_gather(rows, gauss).reshape(-1, rows.shape[1])
    return _from_rows(rows, table.shape[1])


def _from_rows(rows: torch.Tensor, npar: int):
    op_eff = rows[:, 8]
    ext = rows[:, npar:npar + 2]
    synth = projection.ProjectedGaussians(
        means2d=rows[:, 0:2], depths=rows[:, 9], conics=rows[:, 2:5],
        radii=torch.amax(ext, dim=-1), compensations=torch.ones_like(op_eff),
        pix_vels=rows[:, 10:12],
        valid=op_eff > 0,                  # invalid and dead rows (and pad rows) culled
        extents=ext)
    return synth, rows[:, 5:8], op_eff


def _depth_slab_exchange(proj: projection.ProjectedGaussians, colors: torch.Tensor,
                         opacities: torch.Tensor, gauss: Axis, slack: float = 2.0):
    """Re-shard the packed table by depth slab: rank k of the gauss axis ends
    up with the k-th depth quantile of the whole cloud. A 256-bin depth
    histogram over the axis gives each bin a slab (quantiles at bin
    granularity); each rank sorts its rows by slab (stably), cuts them into
    fixed-size buckets of C = slack * N_loc / D rows and trades them
    (`all_to_all`; its backward sends the rows' gradients back). Rows past a
    bucket's C are dropped and counted. Since slabs are depth-monotone, the
    per-slab composites merge into the single-device composite
    (`_combine_depth_slabs`) up to its early stop: a pixel stops once its T
    falls to T_EPS, while each slab starts at T = 1 and composites on (at
    most T_EPS of a colour). A tile's K rows are the whole cloud's: each
    slab's binning keeps what the single composite keeps of it
    (`_front_budget`). Nothing here waits for the device; the trade's counts
    go to the active `SlabCounters`.

    Returns (ProjectedGaussians, colours, opacities, overflow) for this
    rank's slab; zero rows are padding (opacity 0, culled)."""
    with span("splat.exchange"):
        table = pack_param_table(proj, colors, opacities)[:-1]
        rows = torch.cat([table, proj.extents], dim=1)
        d = gauss.size
        counters = active_slab_counters()
        slab, slab_sizes = slab_ids(table[:, 9], table[:, 8] > 0, d, gauss)
        send, overflow = slab_buckets(rows, slab, d, slack)
        recv = all_to_all(send, gauss)
        overflow = reduce_(overflow, gauss)
        if counters is not None:
            live = send[:, :, 8].detach() > 0
            got = recv[:, :, 8].detach() > 0
            me = gauss.index
            counters.add(got.sum() - got[me].sum(), live.sum() - live[me].sum(), overflow,
                         slab_sizes.max() * d / torch.clamp(slab_sizes.sum(), min=1))
    synth, colors_s, op_s = _from_rows(recv.reshape(-1, rows.shape[1]), table.shape[1])
    return synth, colors_s, op_s, overflow


def slab_buckets(rows: torch.Tensor, slab: torch.Tensor, d: int, slack: float):
    """This rank's rows cut into d send buckets by slab: (d, C, n_col) with
    C = slack * N_loc / d rounded up to 8 rows, bucket k holding the rows of
    slab k in their order (stable sort) and zero rows after them; and the
    count of rows past a bucket's C, which are dropped."""
    n_loc, n_col = rows.shape
    dev = rows.device
    order = torch.sort(slab, stable=True).indices
    edges = torch.searchsorted(slab[order], torch.arange(d + 1, device=dev), side="left")
    cnt = edges[1:] - edges[:-1]
    c_send = min(n_loc, max(8, int(-(-slack * n_loc // (8 * d)) * 8)))
    j = torch.arange(c_send, device=dev)[None, :]
    valid = j < torch.clamp(cnt, max=c_send)[:, None]
    rows_pad = torch.cat([rows[order], rows.new_zeros((c_send, n_col))])
    send = torch.where(valid[..., None], rows_pad[edges[:-1, None] + j], 0.0)
    return send, torch.clamp(cnt - c_send, min=0).sum()


def slab_ids(depth: torch.Tensor, live: torch.Tensor, d: int, gauss: Axis):
    """(slab, sizes): each row's depth slab in [0, d) (d for rows that are
    not live), from a 256-bin histogram of the live depths over the gauss
    axis, each bin in the slab of its first row's quantile (slab boundaries
    fall between bins, so a slab's depths all lie before the next one's);
    and each slab's live rows over the whole axis, (d,) int64. Host scalars enter as fills and the histogram is a sort and a search,
    so nothing waits for the device (a `torch.tensor` copy or `bincount`
    would) and nothing accumulates by atomics."""
    depth = depth.detach()
    big = 3.0e38
    dmin = reduce_(torch.where(live, depth, big).min().reshape(1), gauss, dist.ReduceOp.MIN)[0]
    dmax = reduce_(torch.where(live, depth, -big).max().reshape(1), gauss, dist.ReduceOp.MAX)[0]
    nbins = 256
    scale = (nbins - 1) / torch.clamp(dmax - dmin, min=1e-9)
    b = torch.clamp(((depth - dmin) * scale).to(torch.int32), 0, nbins - 1)
    ranked = torch.sort(torch.where(live, b, nbins)).values
    edges = torch.searchsorted(ranked, torch.arange(nbins + 1, dtype=torch.int32,
                                                    device=depth.device))
    hist = reduce_(edges[1:] - edges[:-1], gauss)
    prefix = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)[:-1]])
    total = torch.clamp(hist.sum(), min=1)
    bin_slab = torch.clamp(prefix * d // total, 0, d - 1)
    slab = torch.where(live, bin_slab[b.long()], d)
    own = bin_slab[None, :] == torch.arange(d, device=depth.device)[:, None]
    return slab, (own * hist[None, :]).sum(dim=1)


def _front_budget(gauss: Axis, k: int):
    """The tile budget (`tiling.build_tile_lists`) of this rank's depth
    slab: a tile keeps the K rows nearest the camera over the whole cloud,
    so slab s keeps K less the rows the slabs in front of it bin there (none
    once they fill K). The per-tile counts of every slab are gathered over
    the gauss axis, on the device."""
    def budget(counts: torch.Tensor) -> torch.Tensor:
        with span("splat.exchange"):
            per_slab = gather_(counts, gauss)
        front = per_slab[:gauss.index].sum(dim=0)
        return torch.clamp(k - front, min=0, max=k).to(counts.dtype)
    return budget


def over(rgbs: torch.Tensor, ts: torch.Tensor):
    """Composite premultiplied layers front to back: rgbs (D, ..., 3) without
    background, ts (D, ...) their transmittances, in depth order:
    rgb = sum_k (prod_{j<k} T_j) rgb_k, T = prod_k T_k. A loop over the D
    layers: autograd's `cumprod` and `prod` backward read on the host
    whether a factor is zero, a wait for the device in every step."""
    rgb, t = rgbs[0], ts[0]
    for k in range(1, rgbs.shape[0]):
        rgb = rgb + t[..., None] * rgbs[k]
        t = t * ts[k]
    return rgb, t


def _combine_depth_slabs(rgb_local: torch.Tensor, t_local: torch.Tensor, gauss: Axis):
    """Merge the slabs' composites, rgb (S, h, w, 3) without background and
    T (S, h, w), gathered over the axis in slab order, with `over`."""
    with span("splat.exchange"):
        rgbs, ts = all_gather(rgb_local, gauss), all_gather(t_local, gauss)
    with span("splat.composite"):
        return over(rgbs, ts)


def _render_strip_linear(params: sf.ModelParams, camera: Cameras, config: sf.SplatfactoConfig,
                         sh_degree_active, background: torch.Tensor, strip_h: int, row0: int,
                         samples: tuple[int, int], gauss: Axis,
                         means2d_probe: torch.Tensor | None = None, is_eval: bool = False):
    """The row strip [row0, row0 + strip_h) of sub-frames [lo, hi)'s share of
    the linear-space blur average (their sum over S): (strip_h, W, 3), and an
    info dict (the depth slabs' overflow count). `sf.render_camera` on the
    strip and the samples, with the gauss axis's exchange before each anchor
    group's compositing."""
    info = {"slab_overflow": torch.zeros((), dtype=torch.int64, device=background.device)}
    group = None
    if gauss.size > 1:
        if config.blur_mode != "fused" and config.blur_samples > 1:
            raise ValueError("gauss-sharded meshes need blur_mode='fused' (one projection per "
                             "anchor; exact per-sub-frame projection would trade the table per "
                             "sample)")
        if config.gauss_shard_mode == "gather":
            def group(proj, colors, opac, *args, **kw):
                return rasterize.rasterize_fused(*_all_gather_projected(proj, colors, opac, gauss),
                                                 *args, **kw)
        elif config.gauss_shard_mode == "slab":
            if config.max_total_entries > 0:
                raise ValueError("depth slabs keep the whole cloud's K rows a tile; a cap on the "
                                 "sorted stream (max_total_entries) would cut each slab's apart")

            def group(proj, colors, opac, w, h, bg, eps, reduce, mid_index, **kw):
                proj, colors, op, overflow = _depth_slab_exchange(proj, colors, opac, gauss,
                                                                  config.slab_slack)
                info["slab_overflow"] = info["slab_overflow"] + overflow
                out = rasterize.rasterize_fused(
                    proj, colors, op, w, h, torch.zeros_like(bg), eps=eps,
                    tile_budget=_front_budget(gauss, kw["max_per_tile"]), **kw)
                rgb_s, t_s = _combine_depth_slabs(out.rgb, out.transmittance, gauss)
                t_mean = t_s.mean(dim=0)
                return RenderOutput(rgb=(rgb_s + t_s[..., None] * bg).mean(dim=0),
                                    alpha=1.0 - t_mean, depth=None, transmittance=t_mean)
        else:
            raise ValueError(f"unknown gauss_shard_mode {config.gauss_shard_mode!r}")
    out = sf.render_camera(params, camera, config, sh_degree_active, background, is_eval,
                           means2d_probe, rows=(row0, strip_h), samples=samples,
                           rasterize_group=group)
    return out.rgb, info


# ------------------------------------------------------------- the loss
def _halo_rows_below(x: torch.Tensor, tile: Axis, n_rows: int) -> torch.Tensor:
    """The n_rows of the image directly below this rank's strip, from the
    next strip(s) (several hops when a strip is shorter than n_rows); zeros
    below the last strip, whose windows over them the caller masks out."""
    strip_h = x.shape[0]
    hops = -(-n_rows // strip_h)
    src = x if strip_h < n_rows else x[:n_rows]
    return torch.cat([from_next(src, tile, hop) for hop in range(1, hops + 1)])[:n_rows]


def _exact_strip_ssim(pred: torch.Tensor, gt_below: torch.Tensor, row0: int, full_h: int,
                      tile: Axis) -> torch.Tensor:
    """This strip's part of the full image's SSIM: the sum of the 11x11
    windows that start in its rows over the image's window count. pred is
    the strip; gt_below the ground truth from row0 on (the strip and the
    rows below it, as many as there are). The parts of all strips add to the
    single-device SSIM."""
    pad = SSIM_WINDOW - 1
    strip_h, width, chan = pred.shape
    if tile.size > 1:
        pred = torch.cat([pred, _halo_rows_below(pred, tile, pad)])
    gt = gt_below[:pred.shape[0]]
    if gt.shape[0] < pred.shape[0]:
        gt = torch.cat([gt, gt.new_zeros((pred.shape[0] - gt.shape[0], width, chan))])
    smap = ssim_map(pred, gt, SSIM_WINDOW)
    rows = smap.shape[0]
    valid = (row0 + torch.arange(rows, device=pred.device)) < (full_h - pad)
    total = (smap * valid[:, None, None].to(smap.dtype)).sum()
    return total / ((full_h - pad) * smap.shape[1] * smap.shape[2])


def _strip(mesh: Mesh, camera: Cameras, config: sf.SplatfactoConfig) -> tuple[int, int]:
    full_h = camera.height
    n_tile = mesh.shape["tile"]
    if full_h % n_tile:
        raise ValueError(f"image height {full_h} does not divide the tile axis {n_tile}")
    strip_h = full_h // n_tile
    if n_tile > 1 and strip_h % tile_wh(config.tile_size)[1]:
        raise ValueError(f"strip height {strip_h} is not a multiple of the tile height")
    return strip_h, mesh.coords["tile"] * strip_h


def _samples(mesh: Mesh, config: sf.SplatfactoConfig) -> tuple[int, int]:
    s_total = max(config.blur_samples, 1)
    n_blur = mesh.shape["blur"]
    if s_total % n_blur:
        raise ValueError(f"blur_samples={s_total} does not divide the blur axis {n_blur}")
    s_local = s_total // n_blur
    return mesh.coords["blur"] * s_local, (mesh.coords["blur"] + 1) * s_local


def sharded_loss(mesh: Mesh, params: sf.ModelParams, camera: Cameras, gt: torch.Tensor,
                 config: sf.SplatfactoConfig, step, probe: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, is_eval: bool = False):
    """This rank's share of the training loss: (share, info). The shares of
    all ranks sum to the loss `sf.compute_losses` gives on one device (the
    mean over the data axis's cameras).

    params: this rank's leaves (Gaussian shards on a gauss axis); camera:
    this rank's camera of the data batch (leading dim 1); gt: its full
    (H, W, 3) frame; step: the SH warm-up's step; probe: (C_local, 2) zeros
    whose gradient is the densification statistic; generator: the random
    background's (every rank draws alike)."""
    strip_h, row0 = _strip(mesh, camera, config)
    full_h, width = camera.height, camera.width
    bg = sf.background_color(params, config, generator)
    sh_deg = sf.active_sh_degree(config, step)
    rgb_share, info = _render_strip_linear(
        params, camera, config, sh_deg, bg, strip_h, row0, _samples(mesh, config),
        mesh.axes["gauss"], means2d_probe=probe, is_eval=is_eval)
    rgb_mean = all_reduce_sum(rgb_share, mesh.axes["blur"])
    with span("splat.loss"):
        pred = sf.apply_black_level(sf.gamma_encode(rgb_mean, config), config)
        gt_below = sf.apply_black_level(gt[row0:], config)
        l1 = torch.abs(pred - gt_below[:strip_h]).sum() / (full_h * width * 3)
        ssim_part = _exact_strip_ssim(pred, gt_below, row0, full_h, mesh.axes["tile"])
        lam = config.ssim_lambda
        core = (1 - lam) * l1 + lam * (1.0 / mesh.shape["tile"] - ssim_part)
        # every gauss and blur rank of a strip computes it alike; the data axis averages
        share = core / (mesh.shape["gauss"] * mesh.shape["blur"] * mesh.shape["data"])
        if config.use_scale_regularization:
            g = params.gaussians
            n_alive = torch.clamp(reduce_(g.alive.detach().sum(), mesh.axes["gauss"]), min=1.0)
            # once per shard; every rank builds the same graph (a zero weight elsewhere)
            once = 1.0 if mesh.owner else 0.0
            share = share + once * sf.scale_regularizer(g, config, n_alive)
        pen = cam_opt.camera_opt_penalty(params.camera_opt, config.camera_optimizer,
                                         device=pred.device)
        share = share + (1.0 if mesh.rank == 0 else 0.0) * pen
    return share, info


def reduce_gradients(mesh: Mesh, sharded: list[torch.Tensor], replicated: list[torch.Tensor]):
    """Sum each leaf's gradient over the ranks that hold the same leaf, in
    one exchange per group: the Gaussian shards (and the probe) over
    `peers`, the replicated leaves over the world. Leaves without a
    gradient (the same on every rank) are left alone."""
    buckets = ([(sharded + replicated, mesh.axes["world"])] if mesh.shape["gauss"] == 1
               else [(sharded, mesh.axes["peers"]), (replicated, mesh.axes["world"])])
    with span("splat.exchange"):
        for leaves, axis in buckets:
            leaves = [p for p in leaves if p.grad is not None]
            if axis.size == 1 or not leaves:
                continue
            flat = torch.cat([p.grad.reshape(-1) for p in leaves])
            reduce_(flat, axis)
            offset = 0
            for p in leaves:
                n = p.grad.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n


def world_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of a value without gradient over every rank (the logged loss)."""
    return reduce_(x.detach().clone(), mesh.axes["world"])


def sharded_train_step(mesh: Mesh, params: sf.ModelParams, optimizer, strat_state: st.StrategyState,
                       config: sf.SplatfactoConfig, camera: Cameras, gt: torch.Tensor, step: int,
                       generator: torch.Generator | None = None):
    """One step on the mesh (the counterpart of `engine.trainer.train_step`):
    this rank's share of the loss with the means2d probe, backward, the
    gradients summed over the ranks holding each leaf, Adam on this rank's
    leaves, the densification statistics on its shard. Returns (loss, aux,
    strat_state) with the loss summed over the ranks."""
    with span("splat.optimizer"):
        optimizer.zero_grad()
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    share, info = sharded_loss(mesh, params, camera, gt, config, step, probe=probe,
                               generator=generator)
    share.backward()
    gauss_leaves = {id(t) for t in params.gaussians}
    reduce_gradients(mesh, [p for p in optimizer.params if id(p) in gauss_leaves] + [probe],
                     [p for p in optimizer.params if id(p) not in gauss_leaves])
    with span("splat.optimizer"):
        optimizer.step()
        visible = torch.linalg.norm(probe.grad, dim=-1) > 0
        strat_state = st.accumulate_grads(strat_state, probe.grad, visible, camera.width,
                                          camera.height)
    n_visible = reduce_(visible.sum(), mesh.axes["gauss"])
    return world_sum(mesh, share), {"n_visible": n_visible, **info}, strat_state


def sharded_eval_opt_step(mesh: Mesh, params: sf.ModelParams, eval_optimizer,
                          config: sf.SplatfactoConfig, camera: Cameras, gt: torch.Tensor,
                          step: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """The eval cameras' pose and velocity corrections optimised on the mesh
    with the scene frozen (the counterpart of `engine.trainer.eval_opt_step`):
    gradients only for the eval leaves, summed over the world. Returns the
    loss summed over the ranks."""
    g = params.gaussians
    frozen = params._replace(
        gaussians=sf.GaussianParams(*(t.detach() for t in g)),
        background_logit=params.background_logit.detach(),
        camera_opt={k: v.detach() for k, v in params.camera_opt.items()},
        velocity_opt={k: v.detach() for k, v in params.velocity_opt.items()})
    share, _ = sharded_loss(mesh, frozen, camera, gt, config, step, generator=generator,
                            is_eval=True)
    grads = torch.autograd.grad(share, eval_optimizer.leaves, allow_unused=True)
    for p, grad in zip(eval_optimizer.leaves, grads):
        p.grad = grad
    reduce_gradients(mesh, [], eval_optimizer.leaves)
    with span("splat.optimizer"):
        eval_optimizer.adam.step()
        eval_optimizer.adam.zero_grad(set_to_none=True)
    return world_sum(mesh, share)


@torch.no_grad()
def sharded_render(mesh: Mesh, params: sf.ModelParams, camera: Cameras,
                   config: sf.SplatfactoConfig, step, background: torch.Tensor,
                   is_eval: bool = False) -> torch.Tensor:
    """The linear-space blur average of one camera, (H, W, 3), on every rank:
    each strip rendered by its tile ranks, the blur sums added, the strips
    gathered."""
    strip_h, row0 = _strip(mesh, camera, config)
    rgb_share, _ = _render_strip_linear(
        params, camera, config, sf.active_sh_degree(config, step), background, strip_h, row0,
        _samples(mesh, config), mesh.axes["gauss"], is_eval=is_eval)
    rgb = all_reduce_sum(rgb_share, mesh.axes["blur"])
    return all_gather(rgb, mesh.axes["tile"]).reshape(camera.height, camera.width, 3)


# ------------------------------------------------------ the training state
def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the capacity axis (a copy)."""
    n = mesh.shape["gauss"]
    if x.shape[0] % n:
        raise ValueError(f"capacity {x.shape[0]} does not divide the gauss axis {n}")
    c = x.shape[0] // n
    i = mesh.coords["gauss"]
    return x[i * c:(i + 1) * c].clone()


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole capacity axis from every rank's slice (no gradient)."""
    return gather_(x.detach().contiguous(), mesh.axes["gauss"]).reshape(-1, *x.shape[1:])


def _remap_state(mesh: Mesh, params: sf.ModelParams, optimizer, strat_state: st.StrategyState,
                 fn):
    g = params.gaussians
    new_g = sf.GaussianParams(*(fn(mesh, t.detach()) for t in g))
    optimizer.remap({getattr(g, f): getattr(new_g, f) for f in sf.GaussianParams._fields
                     if f != "alive"}, lambda m: fn(mesh, m))
    strat_state = strat_state._replace(grad_accum=fn(mesh, strat_state.grad_accum),
                                       grad_count=fn(mesh, strat_state.grad_count))
    return params._replace(gaussians=new_g), strat_state


def shard_train_state(mesh: Mesh, params: sf.ModelParams, optimizer,
                      strat_state: st.StrategyState):
    """This rank's slice of the capacity axis of every Gaussian leaf, of its
    Adam moments (the optimizer is remapped in place) and of the strategy
    accumulators; everything else stays replicated. Returns (params,
    strat_state). The counterpart of `place_train_state`."""
    if mesh.shape["gauss"] == 1:
        return params, strat_state
    return _remap_state(mesh, params, optimizer, strat_state, shard_rows)


def gather_train_state(mesh: Mesh, params: sf.ModelParams, optimizer,
                       strat_state: st.StrategyState):
    """The global training state from every rank's shard, on every rank (the
    inverse of `shard_train_state`)."""
    if mesh.shape["gauss"] == 1:
        return params, strat_state
    return _remap_state(mesh, params, optimizer, strat_state, gather_rows)


# ------------------------------------------------------ the shard's refine
class ShardPlacement(st.Placement):
    """`strategy.refine`'s placement on a gauss-sharded mesh, with the
    single-device semantics over the whole capacity axis: the r-th candidate
    of the whole cloud goes to its r-th dead slot. `ranks` gathers each
    shard's candidate and dead-slot counts over the gauss axis (two integers
    a shard, read on the host: the refine's one wait) and gives this shard's
    first candidate rank and the global dead count; `scatter` sends each new
    row to the shard of its dead slot in one exchange whose sizes those
    counts fix, and writes the rows arriving here into this shard's first
    dead slots, in order. `moved` counts the rows that went to another
    shard, over the whole axis."""

    def __init__(self, mesh: Mesh):
        self.axis = mesh.axes["gauss"]
        self.moved = 0
        self._counts: list[list[int]] | None = None

    def ranks(self, want: torch.Tensor, alive_b: torch.Tensor):
        local = torch.stack([want.sum(), alive_b.numel() - alive_b.sum()]).to(torch.int64)
        with span("splat.exchange"):
            self._counts = gather_(local, self.axis).tolist()
        wants = [w for w, _ in self._counts]
        return sum(wants[:self.axis.index]), sum(d for _, d in self._counts)

    def _pairs(self) -> list[list[int]]:
        """rows[s][t]: the candidates of shard s placed in a dead slot of
        shard t (ranks [P_s, P_s + K_s) against [Q_t, Q_t + D_t))."""
        wants = [w for w, _ in self._counts]
        deads = [d for _, d in self._counts]
        n_dead = sum(deads)
        placed = [max(0, min(w, n_dead - sum(wants[:s]))) for s, w in enumerate(wants)]
        p = [sum(placed[:s]) for s in range(len(placed))]
        q = [sum(deads[:t]) for t in range(len(deads))]
        return [[max(0, min(p[s] + placed[s], q[t] + deads[t]) - max(p[s], q[t]))
                 for t in range(len(deads))] for s in range(len(placed))]

    def scatter(self, params: sf.GaussianParams, new_vals: sf.GaussianParams,
                want: torch.Tensor):
        pairs = self._pairs()
        me, n = self.axis.index, len(pairs)
        send = pairs[me]
        recv = [pairs[s][me] for s in range(n)]
        self.moved = sum(pairs[s][t] for s in range(n) for t in range(n) if s != t)
        fields = sf.GaussianParams._fields
        widths = [getattr(params, f)[0].numel() for f in fields]
        # the placed candidates in slot order (they lead the want mask's order)
        cand = torch.argsort((~want).to(torch.uint8), stable=True)[:sum(send)]
        rows = torch.cat([getattr(new_vals, f)[cand].reshape(len(cand), w)
                          for f, w in zip(fields, widths)], 1)
        with span("splat.exchange"):
            if n == 1:
                got = rows
            else:
                got = rows.new_empty((sum(recv), rows.shape[1]))
                dist.all_to_all_single(got, rows, output_split_sizes=recv,
                                       input_split_sizes=send, group=self.axis.group)
        alive_b = params.alive > 0.5
        dead = torch.argsort(alive_b.to(torch.uint8), stable=True)[:got.shape[0]]
        out, col = [], 0
        for f, w in zip(fields, widths):
            t = getattr(params, f).clone()
            t[dead] = got[:, col:col + w].reshape((-1,) + tuple(t.shape[1:]))
            out.append(t)
            col += w
        filled = torch.zeros_like(alive_b)
        filled[dead] = True
        counters = active_slab_counters()
        if counters is not None:
            counters.moved += self.moved
        return sf.GaussianParams(*out), filled


def refine_shard(mesh: Mesh, params: sf.GaussianParams, state: st.StrategyState, step: int,
                 config: sf.SplatfactoConfig, noise: tuple[torch.Tensor, torch.Tensor]):
    """`strategy.refine` on this rank's shard of a gauss-sharded mesh, the
    same state bitwise as the refine of the gathered cloud: cull, densify and
    the accumulators' zeroing on the shard, the split noise the whole
    capacity's draw cut to the shard, the new rows placed by
    `ShardPlacement`. Returns (params, state, changed, info) as `refine`
    does, info summed over the gauss axis (0-dim tensors)."""
    noise = tuple(shard_rows(mesh, e) for e in noise)
    params, state, changed, info = st.refine(params, state, step, config, noise,
                                             ShardPlacement(mesh))
    keys = list(info)
    with span("splat.exchange"):
        sums = reduce_(torch.stack([info[k] for k in keys]).to(torch.int64), mesh.axes["gauss"])
    return params, state, changed, dict(zip(keys, sums.unbind()))
