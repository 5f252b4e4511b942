"""The benchmark's frozen yardsticks against the program they were copied
from, on the CPU: the work counter against `rasterize_fwd_plain` /
`rasterize_bwd_plain(count_work=True)`, the reference's render against the
program's plain route, and the trace reader against a canned chrome trace."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import harness, scene
from perfbench.reference import compositor as rc
from perfbench.reference import model as rm
from perfbench.traffic.train import _ref_cameras
from perfbench.yardstick import trace as yt
from perfbench.yardstick import work as wk


def _small_scene(seed=7, n_samples=3):
    """A phone_mbrs scene at 48 x 32 with 300 Gaussians: (params, cameras,
    config) in the reference's containers."""
    config = harness.load("configs", "phone_mbrs")
    sc = config["scene"]
    sc.update(width=48, height=32, fx=36.0, fy=36.0, cx=24.0, cy=16.0, capacity=400, alive=300,
              n_train=16, n_eval=2)
    cfg, _ = harness.reference_configs(config, seed)
    cfg = dataclasses.replace(cfg, blur_samples=n_samples, blur_anchors=1, max_per_tile=256)
    tr, _ = scene.split(sc)
    cams = _ref_cameras(rm, scene.cameras(sc, tr), "cpu")
    g = rm.GaussianParams(**scene.gaussians(sc, seed, "cpu"))
    params = rm.ModelParams(g, torch.zeros(3), {}, {}, {}, {})
    return params, cams, cfg


def _blocks(params, cam, cfg):
    motion = rm.camera_motion(params, cam, cfg)
    g = params.gaussians
    opac = torch.sigmoid(g.opacities_logit) * g.alive
    t_a = motion.eps.mean()
    eps = motion.eps - t_a
    proj, colors = rm.subframe_inputs(params, motion, cfg, 3, t_a)
    w, h = cam.width, cam.height
    lists = rc.bin_tiles(proj, opac, w, h, eps, motion.rs_time, cfg.tile_size, cfg.max_per_tile,
                         cfg.max_tiles_per_gaussian, None, 0, 0, materialize_indices=True)
    blocks = rc.gather_tile_params(lists, rc.pack_param_table(proj, colors, opac))
    scalars = rc.scalar_vec(motion.rs_time, 0.0, eps, blocks.device)
    tw, _ = rc.tiling.num_tiles(w, h, cfg.tile_size)
    return blocks.contiguous(), lists.counts, scalars, tw, h


@pytest.mark.parametrize("n_samples", [1, 3])
def test_counter_matches_program_plain_counts(n_samples):
    from splat_tpu_torch.ops.cuda import rasterize_kernels as prk

    params, cams, cfg = _small_scene(n_samples=n_samples)
    blocks, counts, scalars, tw, h = _blocks(params, cams[3], cfg)
    mine = wk.count_blocks(blocks, counts, scalars, cfg.tile_size, tw, h)
    _, fwd = prk.rasterize_fwd_plain(blocks, counts, scalars, cfg.tile_size, tw, h,
                                     count_work=True)
    out = prk.rasterize_fwd_plain(blocks, counts, scalars, cfg.tile_size, tw, h)
    _, bwd = prk.rasterize_bwd_plain(blocks, counts, scalars, out, torch.ones_like(out),
                                     cfg.tile_size, tw, h, count_work=True)
    assert mine["hit_pairs"] > 1000
    for key in ("hit_pairs", "live_pairs", "live_rows"):
        assert mine[key] == fwd[key] == bwd[key], key
    assert mine["sigma_pairs"] == bwd["sigma_pairs"]
    # a (Gaussian, pixel) with a hit is a live (Gaussian, pixel) step
    assert mine["hit_row_pixels"] <= fwd["live_row_pixels"]
    assert mine["visible_rows"] <= fwd["live_rows"]


def test_compositor_bounds_take_the_larger_of_operations_and_bytes():
    w = {"hit_pairs": 10**9, "sigma_pairs": 10**9, "hit_row_pixels": 10**8, "visible_rows": 10**6}
    b = wk.compositor_bounds(w, n_tiles=100, n_samples=1, n_pixels=25600)
    assert b["fwd_s"] == pytest.approx(b["fwd_flops"] / wk.PEAK_FP32_FLOPS)
    w0 = dict(w, hit_pairs=0, sigma_pairs=0, hit_row_pixels=0)
    b0 = wk.compositor_bounds(w0, n_tiles=10**5, n_samples=5, n_pixels=256 * 10**5)
    assert b0["bwd_s"] > b0["bwd_flops"] / wk.PEAK_FP32_FLOPS


def test_work_count_does_not_depend_on_the_tile_capacity():
    """The same camera's work at K = 256 and at K = 1024 (no tile overflows
    at either): the padded capacity is the layout's, not the work's."""
    params, cams, cfg = _small_scene(n_samples=3)
    rows = [wk.camera_work(params, cams[3], dataclasses.replace(cfg, max_per_tile=k), 3)
            for k in (256, 1024)]
    assert rows[0]["hit_pairs"] > 1000
    for key in ("hit_pairs", "visible_rows", "fwd_flops", "bwd_flops", "fwd_s", "bwd_s"):
        assert rows[0][key] == rows[1][key], key


@pytest.mark.parametrize("blur_samples", [0, 5])
def test_reference_render_matches_program_plain_route(blur_samples):
    """The frozen copies give the program's plain route's image bit for bit."""
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.models.convert import cameras_from_numpy

    config = harness.load("configs", "phone_mbrs")
    sc = config["scene"]
    sc.update(width=40, height=24, fx=30.0, fy=30.0, cx=20.0, cy=12.0, capacity=300, alive=200,
              n_train=16, n_eval=2)
    cfg_r, _ = harness.reference_configs(config, 3)
    cfg_p, _ = harness.program_configs(config, 3, "cpu")
    cfg_r = dataclasses.replace(cfg_r, blur_samples=blur_samples, blur_anchors=2, max_per_tile=256)
    cfg_p = dataclasses.replace(cfg_p, blur_samples=blur_samples, blur_anchors=2, max_per_tile=256,
                                impl="torch")
    tr, _ = scene.split(sc)
    cams_np = scene.cameras(sc, tr)
    gauss = scene.gaussians(sc, 3, "cpu")
    corr = scene.corrections(len(tr), 3, "cpu", stream=3)
    pose = {k: corr[k] for k in ("phi", "dp")}
    vel = {k: corr[k] for k in ("dv", "dom")}
    ref = rm.render_camera(rm.ModelParams(rm.GaussianParams(**gauss), torch.zeros(3), pose, vel,
                                          {}, {}),
                           _ref_cameras(rm, cams_np, "cpu")[5], cfg_r, 3, torch.zeros(3)).rgb
    pcams = cameras_from_numpy(cams_np, "cpu")
    prog = sf.render_camera(sf.ModelParams(sf.GaussianParams(**gauss), torch.zeros(3), pose, vel,
                                           {}, {}),
                            pcams[5], cfg_p, 3, torch.zeros(3)).rgb
    assert float(prog.abs().max()) > 0.1
    assert torch.equal(ref, prog)


def _canned_trace():
    """Two kernels and a copy on the device, with host ops around them."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},      # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 70.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 12.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 48.0, "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": "outer", "ts": 0.0, "dur": 200.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
    ]
    return {"traceEvents": ev}


def test_trace_reader_on_a_canned_trace():
    tr = _canned_trace()
    stats = yt.kernel_stats(tr)
    assert [(s.name, s.total_us, s.count) for s in stats] == [("a", 40.0, 2), ("b", 10.0, 1)]
    tl = yt.timeline(tr)
    assert tl == {"span_us": 100.0, "busy_us": 45.0, "idle_us": 55.0, "gaps": 1,
                  "max_gap_us": 55.0, "busy_share": 0.45}
    tl = yt.timeline(tr, yt.DEVICE_CATEGORIES)
    assert tl["busy_us"] == 55.0 and tl["gaps"] == 2 and tl["idle_us"] == 45.0
    gaps = yt.gap_causes(tr)
    # the gap 15-40 begins inside aten::sort, the gap 50-70 inside aten::copy_
    assert gaps == [["aten::sort", pytest.approx(25e-6)], ["aten::copy_", pytest.approx(20e-6)]]


def test_trace_reader_matches_the_programs_copy():
    from splat_tpu_torch.utils import trace_report as prt

    tr = _canned_trace()
    assert yt.timeline(tr) == prt.timeline(tr)
    assert ([dataclasses.astuple(s) for s in yt.kernel_stats(tr)]
            == [dataclasses.astuple(s) for s in prt.kernel_stats(tr)])


def test_tile_capacity_rule():
    quiet = np.full(10, 100)
    assert harness.tile_capacity([quiet], 256, 0.002, 2048) == 256
    busy = np.array([100] * 9 + [700])
    assert harness.tile_capacity([quiet, busy], 256, 0.002, 2048) == 1024
    assert harness.tile_capacity([np.array([5000])], 256, 0.002, 2048) == 2048
