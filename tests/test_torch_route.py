"""The one rule of `impl` (`splat_tpu_torch/device.py:use_kernel`) at every
entry that takes it, on the CPU.

For each entry: impl "cuda" on CPU tensors raises (and the kernel's own
launcher under it refuses CPU tensors too, where the entry has one); an
unknown impl raises; impl "auto" on CPU tensors launches no kernel (every
wrapper's launch counter in `ops/cuda/` stays where it was) and gives
bitwise what impl "torch" gives.
"""
import importlib
import pkgutil

import numpy as np
import pytest
import torch

import splat_tpu_torch.ops.cuda as kcuda
from splat_tpu_torch.cameras.cameras import Cameras
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.ops import projection, rasterize, tiling
from splat_tpu_torch.ops.cuda import project_sh as ps
from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked
from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum
from splat_tpu_torch.ops.cuda.row_gather import row_gather
from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, scatter_plan
from splat_tpu_torch.ops.cuda.seg_copy import check_inputs, seg_copy
from splat_tpu_torch.ops.cuda.seg_dma import seg_dma
from splat_tpu_torch.ops.cuda.tile_fetch import (check_bwd_inputs, check_fwd_inputs,
                                                 tile_fetch_bwd, tile_fetch_fwd)

W, H, TILE = 40, 24, 8
N = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters():
    """Every kernel wrapper of `ops/cuda/`: the callables that count their
    launches."""
    found = {}
    for info in pkgutil.iter_modules(kcuda.__path__):
        mod = importlib.import_module(f"{kcuda.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches"):
                found[f"{info.name}.{name}"] = obj
    return found


def _launches():
    return {name: f.launches for name, f in _counters().items()}


def _model(n=N):
    rng = np.random.default_rng(3)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    g = sf.GaussianParams(
        means=t(rng.normal(size=(n, 3)) * [1.0, 0.6, 0.5] + [0.0, 0.0, 4.0]),
        scales_log=t(rng.normal(size=(n, 3)) * 0.3 - 2.0),
        quats=t(rng.normal(size=(n, 4))), opacities_logit=t(rng.normal(size=n)),
        features_dc=t(rng.normal(size=(n, 3)) * 0.5),
        features_rest=t(rng.normal(size=(n, 15, 3)) * 0.1), alive=torch.ones(n))
    return sf.ModelParams(gaussians=g, background_logit=torch.zeros(3), camera_opt={},
                          velocity_opt={}, eval_camera_opt={}, eval_velocity_opt={})


def _camera():
    return Cameras(R_c2w=torch.eye(3)[None], p_c2w=torch.tensor([[0.1, -0.2, 0.0]]),
                   fx=torch.tensor([40.0]), fy=torch.tensor([40.0]),
                   cx=torch.tensor([W / 2]), cy=torch.tensor([H / 2]), width=W, height=H,
                   lin_vel=torch.tensor([[0.3, -0.1, 0.2]]),
                   ang_vel=torch.tensor([[0.2, 0.4, -0.1]]),
                   exposure_time=torch.tensor([0.05]),
                   rolling_shutter_time=torch.tensor([0.03]))


def _scene():
    """One camera's plain projection and its plain binning's blocks."""
    params, cam = _model(), _camera()
    cfg = sf.SplatfactoConfig(impl="torch", tile_size=TILE, max_per_tile=16,
                              max_tiles_per_gaussian=16)
    motion = sf.camera_motion(params, cam, cfg)
    with torch.no_grad():
        proj, colors = sf.subframe_inputs(params, motion, cfg, 3, motion.eps[0])
        opac = torch.sigmoid(params.gaussians.opacities_logit)
        lists = rasterize.bin_tiles(proj, opac, W, H, motion.eps, motion.rs_time, TILE, 16, 16,
                                    impl="torch")
        blocks = rasterize.gather_tile_params(lists, kcuda.pack_param_table(proj, colors, opac),
                                              16)
    return params, cfg, motion, proj, colors, opac, lists, blocks.contiguous()


def _entries():
    params, cfg, motion, proj, colors, opac, lists, blocks = _scene()
    tiles_x, _ = tiling.num_tiles(W, H, TILE)
    scalars = rk.scalar_vec(motion.rs_time, 0.0, motion.eps, torch.device("cpu"))
    fwd = rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, TILE, tiles_x, H,
                           eps=motion.eps, impl="torch").contiguous()
    g_out = torch.ones_like(fwd)
    rng = np.random.default_rng(4)
    sp = torch.tensor(rng.normal(size=(64, 16)), dtype=torch.float32)
    starts = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    idx = torch.tensor(rng.integers(0, 10, size=30), dtype=torch.int32)
    rows = torch.tensor(rng.normal(size=(30, 16)), dtype=torch.float32)
    cum = torch.tensor(rng.normal(size=(3, 32, 8)), dtype=torch.float32)
    bin_args = (proj.means2d, proj.extents, proj.depths, proj.valid, W, H, TILE)
    g = params.gaussians
    table = kcuda.pack_param_table(proj, colors, opac)
    fetch_args = (table, lists.sorted_ids, lists.starts, lists.counts, 16)
    slot_args = (blocks, lists.entry_slots, table.shape[0])
    return {
        "seg_copy": (lambda impl: seg_copy(sp, starts, 8, impl=impl),
                     lambda: check_inputs(sp, starts, 8)),
        "row_gather": (lambda impl: row_gather(sp, idx, impl=impl), None),
        "tile_fetch_fwd": (lambda impl: tile_fetch_fwd(*fetch_args, impl=impl),
                           lambda: check_fwd_inputs(*fetch_args)),
        "tile_fetch_bwd": (lambda impl: tile_fetch_bwd(*slot_args, impl=impl),
                           lambda: check_bwd_inputs(*slot_args)),
        "seg_dma": (lambda impl: seg_dma(sp, starts, 8, impl=impl), None),
        "chunk_cumsum": (lambda impl: chunk_cumsum(cum, impl=impl), None),
        "scatter_plan": (lambda impl: scatter_plan(idx, 10, impl=impl), None),
        "row_scatter": (lambda impl: row_scatter(idx, rows, 10, impl=impl), None),
        "rasterize_fwd": (
            lambda impl: rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, TILE, tiles_x,
                                          H, eps=motion.eps, impl=impl),
            lambda: rk._launch_fwd(blocks, lists.counts, scalars, TILE, tiles_x, H)),
        "rasterize_bwd": (lambda impl: rk.rasterize_bwd(blocks, lists.counts, scalars, fwd,
                                                        g_out, TILE, tiles_x, H, impl=impl),
                          None),
        "bwd_stacked": (lambda impl: bwd_stacked(blocks, lists.counts, scalars, fwd, g_out,
                                                 TILE, tiles_x, H, impl=impl), None),
        "build_tile_lists": (lambda impl: tiling.build_tile_lists(
            *bin_args, 16, 16, conics=proj.conics, opacities=opac, impl=impl), None),
        "tiling.tile_population": (lambda impl: tiling.tile_population(
            *bin_args, 16, conics=proj.conics, opacities=opac, impl=impl), None),
        "rasterize.tile_population": (lambda impl: rasterize.tile_population(
            proj, opac, W, H, motion.eps, motion.rs_time, TILE, 16, impl=impl), None),
        "rasterize": (lambda impl: rasterize.rasterize(
            proj, colors, opac, W, H, torch.zeros(3), motion.rs_time, TILE, 16, 16,
            impl=impl), None),
        "subframe_inputs": (
            lambda impl: sf.subframe_inputs(params, motion, sf.SplatfactoConfig(impl=impl), 3,
                                            motion.eps[0]),
            lambda: ps.project_sh_fwd(g.means, g.scales_log, g.quats, g.features_dc,
                                      g.features_rest, torch.zeros(22), 3, W, H, True)),
    }


ENTRIES = ("seg_copy", "row_gather", "tile_fetch_fwd", "tile_fetch_bwd", "seg_dma",
           "chunk_cumsum", "scatter_plan", "row_scatter", "rasterize_fwd", "rasterize_bwd",
           "bwd_stacked", "build_tile_lists", "tiling.tile_population",
           "rasterize.tile_population", "rasterize", "subframe_inputs")


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _leaves(x)]
    return []


@pytest.mark.parametrize("impl", ["cuda", "pallas", "auto"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_impl_rule_at_every_entry(entry, impl):
    run, launcher = _entries()[entry]
    assert len(_counters()) >= 13
    if impl == "cuda":
        with pytest.raises(ValueError, match="impl='cuda'"):
            run(impl)
        if launcher is not None:
            with pytest.raises(ValueError, match="CUDA"):
                launcher()
        return
    if impl == "pallas":
        with pytest.raises(ValueError, match="unknown impl"):
            run(impl)
        return
    before = _launches()
    with torch.no_grad():
        got, want = _leaves(run("auto")), _leaves(run("torch"))
    assert _launches() == before
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_rule_alone():
    from splat_tpu_torch.device import IMPLS, use_kernel

    cpu = torch.zeros(1)
    assert [use_kernel(i, cpu) for i in IMPLS if i != "cuda"] == [False, False]
    with pytest.raises(ValueError, match=r"impl='cuda' needs CUDA tensors, got cpu"):
        use_kernel("cuda", cpu)
    with pytest.raises(ValueError, match=r"unknown impl 'triton'"):
        use_kernel("triton", cpu)
    proj = projection.ProjectedGaussians(*(torch.ones(2),) * 8)
    assert torch.equal(projection.effective_opacity(proj._replace(
        compensations=torch.tensor([0.5, 2.0]), valid=torch.tensor([True, False])),
        torch.tensor([0.4, 0.3])), torch.tensor([0.2, 0.0]))
