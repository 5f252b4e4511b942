"""The CUDA kernels against their plain versions on the card.

These need a CUDA device and skip without one (the kernels have no CPU
mode). The file imports no JAX, so on a machine with a card and no JAX it
runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: seg_copy moves bits (exact). The compositor and its plain
version do the same float32 operations in the same order where they feed a
mask (the kernels are built with -fmad=false), so they differ only where expf
does and in the four colour and depth sums, which the kernel contracts into
FMAs: atol 1e-4 on rgb and T, 1e-3 on depth_acc (depths ~4). Both compositors
are bitwise equal over two launches, and hold these tolerances on the
adversarial rows of scripts_dev/probe_cull_torch.py too (their per-warp cull
must keep every group where a pair composites). The backward kernel reruns the
same per-pixel arithmetic and sums over pixels in another order than its
plain version: |kernel - plain| <= 1e-5 * max|plain| per column within each
64-slot batch (the deeper batches' gradients are ~1e-3 of the first's, so a
column-wide bound would not see them), and <= 1e-3 of each (tile, slot)
row's max over its columns (where a row's pixel sum cancels, the two
summation orders differ by a few 1e-5 of the row's max). bwd_stacked is held
to the same bounds against its own plain version (the stacked formulation,
moment products in float64) and against the rasterize_bwd kernel (the same
terms summed over other threads) in each of its layouts (1 to 4 rows a
thread, reached through the tiles and sample counts whose layout they are),
is bitwise repeatable and does not depend on tps. Gradients of the
kernel route against the
plain route (impl="torch"):
each leaf within 1e-3 * max|leaf gradient|; and the kernel route's
gradients are bitwise repeatable (no float atomics anywhere).
row_gather and both seg_dma variants move bits (exact). The reference renderer
(`ops/reference.py`, tile emulation on) holds the kernel route's images to
the CPU test's 1e-5. row_scatter adds each
destination row's contributors in index order: bitwise repeatable, and within
1e-5 of max|column| of a float64 sum rounded to float32; bitwise the
sequential loop (np.add.at), and its plan kernels bitwise the stable sort of
`scatter_plan_plain`, on uniform, skewed, half-on-one-row and out-of-range
indices. rasterize_bwd's output on seeded numpy inputs has the digest it had
before its transpose-reduce moved into raster_common.cuh (exact). chunk_cumsum's "seq"
variant adds in row order in float32 and its "warp" variant in another
association: both within 1e-6 of max|plain| of the plain version on the CPU
(a sequential walk that accumulates in float64), and within the JAX probe's
own atol 1e-3 of the plain version on the card (a parallel scan). The mesh
(`parallel/sharding.py`) on NCCL at world = the visible cards (NCCL needs a
card per rank) holds its loss within 1e-5 and every gradient within 1e-3 *
max|leaf gradient| of one device's, the kernel route's bounds.
"""
import dataclasses
import hashlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu_torch.engine import trainer
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models import strategy
from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
from splat_tpu_torch.ops import cuda as kcuda
from splat_tpu_torch.ops import rasterize, tiling
from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked, stacked_layout
from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum, chunk_cumsum_plain
from splat_tpu_torch.ops.cuda.row_gather import row_gather, row_gather_plain
from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, scatter_plan, scatter_plan_plain
from splat_tpu_torch.ops.cuda.seg_copy import seg_copy, seg_copy_plain
from splat_tpu_torch.ops.cuda.seg_dma import seg_dma
from splat_tpu_torch.parallel import launch, sharding

IMG_W, IMG_H = 96, 64
K = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, n=600, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = rng.normal(size=(n, 3)) * np.array([0.7, 0.5, 0.6]) + np.array([0, 0, 4.0])
    means[:200] = np.array([0.1, 0.0, 3.5]) + rng.normal(size=(200, 3)) * 0.05
    tree = {"gaussians": {
        "means": means.astype(f32),
        "scales_log": (rng.normal(size=(n, 3)) * 0.4 - 3.0).astype(f32),
        "quats": rng.normal(size=(n, 4)).astype(f32),
        "opacities_logit": rng.normal(size=n).astype(f32),
        "features_dc": rng.normal(size=(n, 3)).astype(f32),
        "features_rest": (rng.normal(size=(n, 15, 3)) * 0.1).astype(f32),
        "alive": np.ones(n, f32)}, "background_logit": np.zeros(3, f32)}
    cams = dict(R_c2w=np.eye(3, dtype=f32)[None], p_c2w=np.zeros((1, 3), f32),
                fx=f32([80.0]), fy=f32([80.0]), cx=f32([IMG_W / 2]), cy=f32([IMG_H / 2]),
                width=IMG_W, height=IMG_H, lin_vel=f32([[0.5, -0.3, 0.2]]),
                ang_vel=f32([[0.1, 0.15, -0.1]]), exposure_time=f32([0.06]),
                rolling_shutter_time=f32([0.04]))
    return params_from_numpy(tree, device=dev), cameras_from_numpy(cams, device=dev)


def _inputs(dev, tile_size):
    params, cams = _model(dev)
    cfg = sf.SplatfactoConfig(tile_size=tile_size, max_per_tile=K)
    motion = sf.camera_motion(params, cams, cfg)
    proj, colors = sf.subframe_inputs(params, motion, cfg, 3, motion.eps.mean())
    opac = torch.sigmoid(params.gaussians.opacities_logit)
    lists = rasterize.bin_tiles(proj, opac, IMG_W, IMG_H, motion.eps, motion.rs_time,
                                tile_size, K, 16)
    sp = kcuda.sorted_stream(kcuda.pack_param_table(proj, colors, opac), lists.sorted_ids, K)
    return lists, sp, motion


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,n_samples,row_off",
                         [(16, 5, 0.0), (16, 1, 0.0), (16, 2, 0.0), (16, 3, 8.0), (16, 4, 0.0),
                          ((16, 8), 5, 8.0), (8, 16, 0.0)])
def test_kernels_match_plain_on_card(cuda_device, tile_size, n_samples, row_off):
    lists, sp, motion = _inputs(cuda_device, tile_size)
    assert int(lists.counts.max()) == K, "one tile must be full"
    blocks = seg_copy(sp, lists.starts, K, impl="cuda")
    assert torch.equal(blocks, seg_copy_plain(sp, lists.starts, K))
    eps = torch.linspace(-0.03, 0.03, n_samples, device=cuda_device)
    tiles_x = tiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    args = (blocks, lists.counts, motion.rs_time, tile_size, tiles_x, IMG_H + 2 * int(row_off))
    got = rk.rasterize_fwd(*args, row_offset=row_off, eps=eps, impl="cuda")
    want = rk.rasterize_fwd(*args, row_offset=row_off, eps=eps, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, rk.rasterize_fwd(*args, row_offset=row_off, eps=eps, impl="cuda"))
    torch.testing.assert_close(got[:, :, [0, 1, 2, 4]], want[:, :, [0, 1, 2, 4]],
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(got[:, :, 3], want[:, :, 3], atol=1e-3, rtol=0)
    assert (got[:, :, 4] < 0.5).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,n_samples,rs", [(16, 16, -0.05), ((16, 8), 16, 0.04),
                                                   (16, 1, 0.0)])
def test_compositors_on_adversarial_rows_on_card(cuda_device, tile_size, n_samples, rs):
    spec = importlib.util.spec_from_file_location(
        "probe_cull_torch", Path(__file__).resolve().parents[1] / "scripts_dev" / "probe_cull_torch.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    res = probe.check(probe.make_inputs(cuda_device, tile_size, n_samples, rs))
    assert res["work"]["missed_groups"] == 0 and res["work"]["hit_groups"] > 0


@pytest.mark.cuda
def test_seg_copy_unaligned_width_on_card(cuda_device):
    g = torch.Generator().manual_seed(0)
    sp = torch.randn((5000, 13), generator=g).to(cuda_device)
    starts = torch.randint(0, 4000, (300,), generator=g, dtype=torch.int32).to(cuda_device)
    assert torch.equal(seg_copy(sp, starts, 64, impl="cuda"), seg_copy_plain(sp, starts, 64))


@pytest.mark.cuda
def test_render_camera_cuda_matches_torch_route(cuda_device):
    params, cams = _model(cuda_device)
    cfg = sf.SplatfactoConfig(max_per_tile=K)
    before = (seg_copy.launches, rk.rasterize_fwd.launches)
    out = sf.render_camera(params, cams, cfg, 3, torch.zeros(3, device=cuda_device))
    assert seg_copy.launches > before[0] and rk.rasterize_fwd.launches > before[1]
    ref = sf.render_camera(params, cams, dataclasses.replace(cfg, impl="torch"), 3,
                           torch.zeros(3, device=cuda_device))
    for name in ("rgb", "alpha", "transmittance"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name), atol=1e-4, rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,n_samples,row_off",
                         [(16, 5, 0.0), (16, 1, 0.0), (16, 2, 0.0), (16, 3, 8.0), (16, 4, 0.0),
                          ((16, 8), 5, 8.0), (8, 16, 0.0)])
def test_bwd_kernel_matches_plain_on_card(cuda_device, tile_size, n_samples, row_off):
    lists, sp, motion = _inputs(cuda_device, tile_size)
    blocks = seg_copy(sp, lists.starts, K, impl="cuda")
    eps = torch.linspace(-0.03, 0.03, n_samples, device=cuda_device)
    tiles_x = tiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    full_h = IMG_H + 2 * int(row_off)
    scalars = rk.scalar_vec(motion.rs_time, row_off, eps, cuda_device)
    fwd = rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, tile_size, tiles_x, full_h,
                           row_offset=row_off, eps=eps, impl="cuda")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    g_out = torch.randn(fwd.shape, generator=g, device=cuda_device)
    args = (blocks, lists.counts, scalars, fwd, g_out, tile_size, tiles_x, full_h)
    got = rk.rasterize_bwd(*args, impl="cuda")
    want = rk.rasterize_bwd(*args, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, rk.rasterize_bwd(*args, impl="cuda")), "bitwise repeatable"
    assert not got[:, :, rk.NPARAM - 1:].any()
    assert (want[:, :, :rk.NPARAM - 1].abs().amax(dim=(0, 1)) > 0).all()
    err = (got - want)[:, :, :rk.NPARAM - 1].abs()
    ref = want[:, :, :rk.NPARAM - 1].abs()
    for j in range(0, K, 64):      # per column within each 64-slot batch
        e, m = err[:, j:j + 64].amax(dim=(0, 1)), ref[:, j:j + 64].amax(dim=(0, 1))
        assert (e <= 1e-5 * m).all(), (j, e, m)
    e, m = err.amax(dim=2), ref.amax(dim=2)        # per (tile, slot) row
    assert (e <= 1e-3 * m).all(), (e / m).nan_to_num().max()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,n_samples,row_off,tps",
                         [(16, 5, 0.0, 1), (16, 5, 0.0, 4), (16, 1, 0.0, 2), ((16, 8), 5, 8.0, 8),
                          (8, 16, 0.0, 1), (16, 16, 0.0, 2), (16, 3, 0.0, 5)])
def test_bwd_stacked_matches_plain_and_rasterize_bwd_on_card(cuda_device, tile_size, n_samples,
                                                            row_off, tps):
    """S * npix from 256 to 4096 stacked rows: one row per thread, strided
    rows (1280 and 4096 on 1024 threads), and a block narrower than 1024."""
    lists, sp, motion = _inputs(cuda_device, tile_size)
    blocks = seg_copy(sp, lists.starts, K, impl="cuda")
    eps = torch.linspace(-0.03, 0.03, n_samples, device=cuda_device)
    tiles_x = tiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    full_h = IMG_H + 2 * int(row_off)
    scalars = rk.scalar_vec(motion.rs_time, row_off, eps, cuda_device)
    fwd = rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, tile_size, tiles_x, full_h,
                           row_offset=row_off, eps=eps, impl="cuda")
    g_out = torch.randn(fwd.shape, generator=_seeded(cuda_device, 0), device=cuda_device)
    args = (blocks, lists.counts, scalars, fwd, g_out, tile_size, tiles_x, full_h)
    before = bwd_stacked.launches
    got = bwd_stacked(*args, tps=tps, impl="cuda")
    torch.cuda.synchronize()
    assert bwd_stacked.launches == before + 1
    assert torch.equal(got, bwd_stacked(*args, tps=tps, impl="cuda")), "bitwise repeatable"
    assert torch.equal(got, bwd_stacked(*args, tps=1, impl="cuda")), "tps does not change sums"
    assert not got[:, :, rk.NPARAM - 1:].any()
    for want in (bwd_stacked(*args, impl="torch"), rk.rasterize_bwd(*args, impl="cuda")):
        assert (want[:, :, :rk.NPARAM - 1].abs().amax(dim=(0, 1)) > 0).all()
        err = (got - want)[:, :, :rk.NPARAM - 1].abs()
        ref = want[:, :, :rk.NPARAM - 1].abs()
        for j in range(0, K, 64):      # per column within each 64-slot batch
            e, m = err[:, j:j + 64].amax(dim=(0, 1)), ref[:, j:j + 64].amax(dim=(0, 1))
            assert (e <= 1e-5 * m).all(), (j, e, m)
        e, m = err.amax(dim=2), ref.amax(dim=2)        # per (tile, slot) row
        assert (e <= 1e-3 * m).all(), (e / m).nan_to_num().max()
    with pytest.raises(ValueError, match="CUDA"):
        bwd_stacked(*(a.cpu() if torch.is_tensor(a) else a for a in args), impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size,n_samples,rows", [(8, 5, 1), ((16, 8), 5, 2), (16, 3, 2),
                                                      (16, 6, 3), (16, 9, 3), (16, 5, 4),
                                                      (16, 16, 4)])
def test_bwd_stacked_rows_a_thread_on_card(cuda_device, tile_size, n_samples, rows):
    """Each layout the kernel instantiates (rows a thread), through a tile and
    sample count whose layout it is, within the same bounds of the plain
    version, bitwise repeatable and the same for every tps."""
    sw, sh = tiling.tile_wh(tile_size)
    assert stacked_layout(n_samples, sw * sh).rows == rows
    lists, sp, motion = _inputs(cuda_device, tile_size)
    blocks = seg_copy(sp, lists.starts, K, impl="cuda")
    eps = torch.linspace(-0.03, 0.03, n_samples, device=cuda_device)
    tiles_x = tiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    scalars = rk.scalar_vec(motion.rs_time, 0.0, eps, cuda_device)
    fwd = rk.rasterize_fwd(blocks, lists.counts, motion.rs_time, tile_size, tiles_x, IMG_H,
                           eps=eps, impl="cuda")
    g_out = torch.randn(fwd.shape, generator=_seeded(cuda_device, 0), device=cuda_device)
    args = (blocks, lists.counts, scalars, fwd, g_out, tile_size, tiles_x, IMG_H)
    got = bwd_stacked(*args, tps=2, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, bwd_stacked(*args, tps=1, impl="cuda"))
    want = bwd_stacked(*args, impl="torch")
    err = (got - want)[:, :, :rk.NPARAM - 1].abs()
    ref = want[:, :, :rk.NPARAM - 1].abs()
    for j in range(0, K, 64):
        e, m = err[:, j:j + 64].amax(dim=(0, 1)), ref[:, j:j + 64].amax(dim=(0, 1))
        assert (e <= 1e-5 * m).all(), (j, e, m)
    e, m = err.amax(dim=2), ref.amax(dim=2)
    assert (e <= 1e-3 * m).all(), (e / m).nan_to_num().max()


def _train_grads(params, cams, cfg, gt):
    """Every trainable leaf's gradient and the probe's for one loss."""
    leaves = trainer.param_groups(params)
    flat = [p for group in leaves.values() for p in group]
    for p in flat:
        p.grad = None
        p.requires_grad_(True)
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    out = sf.render_camera(params, cams, cfg, 3, sf.background_color(params, cfg),
                           means2d_probe=probe)
    loss, _ = sf.compute_losses(sf.gamma_encode(out.rgb, cfg), gt, params, cfg)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in flat] + [probe.grad]


@pytest.mark.cuda
def test_cuda_path_gradients_match_torch_route(cuda_device):
    """The kernel route's loss and gradients (rasterize_bwd, the entry_slots
    gather) against the plain route's (dense id table, plain backward), and
    two evaluations of the kernel route bitwise equal."""
    params, cams = _model(cuda_device)
    cfg = sf.SplatfactoConfig(max_per_tile=K)
    gt = torch.rand((IMG_H, IMG_W, 3), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    before = (rk.rasterize_bwd.launches, row_gather.launches)
    loss, grads = _train_grads(params, cams, cfg, gt)
    assert rk.rasterize_bwd.launches > before[0]
    assert row_gather.launches == before[1] + 2, "the stream gather and its backward"
    loss2, grads2 = _train_grads(params, cams, cfg, gt)
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    loss_t, grads_t = _train_grads(params, cams, dataclasses.replace(cfg, impl="torch"), gt)
    torch.testing.assert_close(loss, loss_t, rtol=1e-5, atol=0)
    for a, b in zip(grads, grads_t):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * b.abs().max().item())


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / "scripts_dev" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("degree,active,vel,frozen",
                         [(0, 0, True, False), (1, 0, False, False), (2, 1, True, False),
                          (3, 2, False, False), (3, 3, True, False), (3, 1, True, True)])
def test_project_sh_matches_plain_on_card(cuda_device, degree, active, vel, frozen):
    """The projection and SH pair against its plain closed form on the same
    inputs (scripts_dev/probe_project_sh_torch.py's hold, at its TOL), for
    each highest SH degree, with and without velocities, a partial last
    block, a tensor active degree and frozen Gaussians; the backward bitwise
    equal over two launches, and only the gradients asked for written."""
    from splat_tpu_torch.ops.cuda import project_sh as ps

    probe = _load_script("probe_project_sh_torch")
    n = 3 * ps.BLOCK * 8 + 77
    inp = probe.make_inputs(cuda_device, n=n, seed=degree)
    rest = inp["features_rest"][:, :(degree + 1) ** 2 - 1].contiguous()
    cam = probe._camera(inp)
    deg = torch.tensor(active, device=cuda_device) if degree == 2 else active
    args = (inp["means"], inp["scales_log"], inp["quats"], inp["features_dc"], rest, cam, deg,
            probe.W, probe.H, vel)
    out = ps.project_sh_fwd(*args)
    probe.hold_fwd(args, out)
    if not vel:
        assert not out[5].any(), "no pixel velocities without velocities"
    grads = tuple(inp["cot"][k] for k in (*probe.FWD_NAMES, "colors"))
    needs = (False,) * 5 + (True,) if frozen else (True,) * 6
    before = ps.project_sh_bwd.launches
    got = ps.project_sh_bwd(*args, grads, needs)
    again = ps.project_sh_bwd(*args, grads, needs)
    assert ps.project_sh_bwd.launches == before + 2
    assert [g is None for g in got] == [not k for k in needs]
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    probe.hold_bwd(args + (grads, needs), got)


BIN_CASES = {
    # rows, live share, stack, image, tile, K, and what the case must reach
    "tile16": dict(rows=1 << 16, img=(480, 270), k=64),
    "tile16x8": dict(rows=1 << 16, img=(480, 270), tile=(16, 8), k=64),
    "tile12x10": dict(rows=1 << 16, img=(480, 270), tile=(12, 10), k=64),
    "strip_tensor_row0": dict(rows=1 << 15, img=(480, 270), strip=(96, 96.0, True)),
    "strip_number_row0": dict(rows=1 << 15, img=(480, 270), strip=(64, 150.0, False)),
    "capped_stream": dict(rows=1 << 15, img=(480, 270), cap_share=0.5),
    "budget": dict(rows=1 << 15, img=(480, 270), k=96, budget=True),
    "long_tiles": dict(rows=1 << 15, img=(480, 270), stack=9000),
    "zero_rows": dict(rows=1 << 17, live=0.125, img=(480, 270)),
    "equal_depths": dict(rows=1 << 15, img=(480, 270), ties=True),
    "near_plane": dict(rows=1 << 14, img=(480, 270), near=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_tiles_matches_plain_on_card(cuda_device, case):
    """The binning kernels against the plain route (impl "torch") on the same
    inputs, under the contract of scripts_dev/probe_bin_tiles_torch.py's
    `hold`; two launches bitwise equal and tile_population equal."""
    probe = _load_script("probe_bin_tiles_torch")
    spec = BIN_CASES[case]
    inp = probe.make_inputs(cuda_device, rows=spec["rows"], live=spec.get("live", 0.75),
                            seed=7, stack=spec.get("stack", 0), img=spec["img"],
                            tile=spec.get("tile", 16), k=spec.get("k", 2048))
    if "strip" in spec:
        strip_h, row0, as_tensor = spec["strip"]
        inp.update(img_h=strip_h, full_img_h=spec["img"][1],
                   row0_px=torch.tensor(row0, device=cuda_device) if as_tensor else row0)
        inp["means2d"] = inp["means2d"] - torch.tensor([0.0, row0], device=cuda_device)
    if "cap_share" in spec:
        real = int(probe.check(inp)["real"])
        inp["max_total_entries"] = int(real * spec["cap_share"]) + 1
    if spec.get("budget"):
        inp["tile_budget"] = lambda c: torch.clamp(96 - c // 3, 0, 96).to(c.dtype)
    if spec.get("ties"):
        inp["depths"] = torch.round(inp["depths"] * 2.0) / 2.0
    if spec.get("near"):
        bad = torch.tensor([[1e12, 5.0], [-1e12, 5.0], [float("nan"), 10.0], [20.0, 3e11],
                            [float("inf"), -float("inf")], [24.0, 16.0], [30.0, 12.0]],
                           device=cuda_device)
        inp["means2d"][:7] = bad
        inp["extents"][:7] = torch.tensor([[4.0, 4.0], [3.0, 3.0], [2.0, 2.0], [5.0, 1e12],
                                           [2.0, 2.0], [3e10, 3e10], [60.0, 40.0]],
                                          device=cuda_device)
        inp["valid"][:7] = True
    res = probe.check(inp)
    assert res["launches"] == 2 and res["compared"] > 0
    if case == "long_tiles":
        assert res["long_tiles"] > 0 and res["max_tile_real"] > 4096
    if case == "capped_stream":
        assert res["compared"] == inp["max_total_entries"] < res["real"]
    if case in ("tile16", "budget"):
        assert res["landed"] < res["real"], "some tile must overflow"


@pytest.mark.cuda
def test_bin_tiles_on_the_training_path_on_card(cuda_device):
    """A training step bins through the kernels once an anchor; the plain
    route (impl "torch") does not launch them."""
    from splat_tpu_torch.ops.cuda import bin_tiles

    params, cams = _model(cuda_device)
    cfg = sf.SplatfactoConfig(max_per_tile=K)
    opt = trainer.Optimizer(params, trainer.TrainerConfig())
    state = strategy.init_strategy_state(params.gaussians.means.shape[0], device=cuda_device)
    gt = torch.full((IMG_H, IMG_W, 3), 0.5, device=cuda_device)
    before = bin_tiles.tile_lists.launches
    trainer.train_step(params, opt, state, cfg, cams, gt, 3000)
    assert bin_tiles.tile_lists.launches - before == sf.resolve_blur_anchors(cfg, cams)
    before = bin_tiles.tile_lists.launches, bin_tiles.population.launches
    sf.binning_counts(params, cams, cfg)
    with torch.no_grad():
        sf.render_camera(params, cams, dataclasses.replace(cfg, impl="torch"), 3,
                         torch.zeros(3, device=cuda_device))
    assert (bin_tiles.tile_lists.launches, bin_tiles.population.launches) == (
        before[0], before[1] + 1)


@pytest.mark.cuda
def test_train_step_on_card(cuda_device):
    params, cams = _model(cuda_device)
    cfg = sf.SplatfactoConfig(max_per_tile=K)
    opt = trainer.Optimizer(params, trainer.TrainerConfig())
    state = strategy.init_strategy_state(params.gaussians.means.shape[0], device=cuda_device)
    gt = torch.full((IMG_H, IMG_W, 3), 0.5, device=cuda_device)
    losses = []
    for step in range(3):
        loss, aux, state = trainer.train_step(params, opt, state, cfg, cams, gt, 3000 + step)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and int(aux["n_visible"]) > 0
    assert int(state.grad_count.max()) == 3


def _seeded(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("n_table,idx_shape,width,pad_rows",
                         [(100_008, (1024, 512), 16, 0), (5000, (70_001,), 16, 128),
                          (333, (17, 5), 13, 0)])
def test_row_gather_matches_plain_on_card(cuda_device, n_table, idx_shape, width, pad_rows):
    table = torch.randn((n_table, width), generator=_seeded(cuda_device, 0), device=cuda_device)
    idx = torch.randint(0, n_table, idx_shape, generator=_seeded(cuda_device, 1),
                        device=cuda_device, dtype=torch.int32)
    before = row_gather.launches
    got = row_gather(table, idx, impl="cuda", pad_rows=pad_rows)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(table, idx, pad_rows))
    with pytest.raises(ValueError, match="CUDA"):
        row_gather(table.cpu(), idx.cpu(), impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,idx_shape,width",
                         [(100_008, (1024, 512), 16), (50, (4000,), 16), (777, (31, 9), 13)])
def test_row_scatter_matches_float64_sum_on_card(cuda_device, n_rows, idx_shape, width):
    idx = torch.randint(0, n_rows, idx_shape, generator=_seeded(cuda_device, 2),
                        device=cuda_device, dtype=torch.int32)
    g = torch.randn(idx_shape + (width,), generator=_seeded(cuda_device, 3), device=cuda_device)
    got = row_scatter(idx, g, n_rows, impl="cuda")
    again = row_scatter(idx, g, n_rows, impl="cuda", plan=scatter_plan(idx, n_rows))
    torch.cuda.synchronize()
    assert torch.equal(got, again), "bitwise repeatable"
    want = torch.zeros((n_rows, width), dtype=torch.float64, device=cuda_device).index_add_(
        0, idx.reshape(-1).long(), g.reshape(-1, width).double())
    err = (got.double() - want).abs().amax(dim=0)
    assert (err <= 1e-5 * want.abs().amax(dim=0)).all(), err
    # the additions are the sequential loop's, bit for bit (np.add.at is unbuffered)
    loop = np.zeros((n_rows, width), np.float32)
    np.add.at(loop, idx.reshape(-1).cpu().numpy(), g.reshape(-1, width).cpu().numpy())
    assert np.array_equal(got.cpu().numpy(), loop)


def _plan_indices(kind, n_rows, shape, seed=8):
    """Seeded int32 indices: uniform; half of them on one row (a segment far
    longer than a block); runs of 150 (segments of a few hundred, past the
    rank-sorted length); Zipf-skewed; with negative and >= n_rows ones."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if kind == "runs":
        flat = (np.arange(n) // 150) % n_rows
    elif kind == "skewed":
        flat = (rng.zipf(1.3, size=n) - 1) % n_rows
    else:
        flat = rng.integers(0, n_rows, size=n)
    if kind == "half_one_row":
        flat[rng.permutation(n)[:n // 2]] = n_rows // 3
    if kind == "out_of_range":
        pick = rng.permutation(n)[:n // 5]
        flat[pick] = rng.choice([-1, -7, -2**31, n_rows, n_rows + 3, 2**31 - 1], size=pick.size)
    return flat.astype(np.int32).reshape(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_rows,shape,width", [
    ("uniform", 100_008, (1024, 512), 16), ("half_one_row", 100_008, (1024, 512), 16),
    ("out_of_range", 5000, (70_001,), 13), ("uniform", 1, (3000,), 4),
    ("runs", 200, (40_000,), 32), ("skewed", 97, (50_000,), 16),
    ("out_of_range", 1, (4096,), 8)])
def test_scatter_plan_kernels_and_row_scatter_are_the_sequential_loop_on_card(
        cuda_device, kind, n_rows, shape, width):
    """The plan kernels give `scatter_plan_plain`'s stable sort bit for bit,
    and the sum is np.add.at's sequential loop bit for bit, with the plan made
    here or handed in; out-of-range indices are dropped."""
    idx_np = _plan_indices(kind, n_rows, shape)
    idx = torch.tensor(idx_np, device=cuda_device)
    before = (scatter_plan.launches, row_scatter.launches)
    order, offsets = scatter_plan(idx, n_rows)
    torch.cuda.synchronize()
    assert scatter_plan.launches == before[0] + 1
    want_order, want_offsets = scatter_plan_plain(idx.cpu(), n_rows)
    assert torch.equal(offsets.cpu(), want_offsets)
    assert torch.equal(order.cpu(), want_order)
    g = torch.randn(shape + (width,), generator=_seeded(cuda_device, 9), device=cuda_device)
    got = row_scatter(idx, g, n_rows, impl="cuda")
    again = row_scatter(idx, g, n_rows, impl="cuda", plan=(order, offsets))
    torch.cuda.synchronize()
    assert row_scatter.launches == before[1] + 2 and scatter_plan.launches == before[0] + 2
    assert torch.equal(got, again), "bitwise repeatable"
    flat = idx_np.reshape(-1)
    valid = (flat >= 0) & (flat < n_rows)
    loop = np.zeros((n_rows, width), np.float32)
    np.add.at(loop, flat[valid], g.reshape(-1, width).cpu().numpy()[valid])
    assert np.array_equal(got.cpu().numpy(), loop)


def _ab_script():
    spec = importlib.util.spec_from_file_location(
        "time_probe_kernels_torch",
        Path(__file__).resolve().parents[1] / "scripts_dev" / "time_probe_kernels_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# sha256 of rasterize_bwd's output on `time_probe_kernels_torch.bits_inputs`,
# from the tree before the transpose-reduce moved into raster_common.cuh
RASTERIZE_BWD_SHA256 = {
    "16x16 S=5": "11d737159e62ebcbac71d44e23ea642035603a74f8af24e78daf37143fed65c3",
    "16x8 S=16": "83e535829094c2ef7eddc350a6bd8d521de9f88687b441ce6400ae1ce0344cf8",
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(RASTERIZE_BWD_SHA256))
def test_rasterize_bwd_bits_unchanged_on_card(cuda_device, label):
    """rasterize_bwd's output, on inputs made by numpy alone (the cull probe's
    adversarial rows, a uniform forward output, a normal cotangent), has the
    digest the kernel gave before it shared its reduction with bwd_stacked."""
    args = _ab_script().bits_inputs(cuda_device, label)
    got = rk.rasterize_bwd(*args, impl="cuda")
    torch.cuda.synchronize()
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == RASTERIZE_BWD_SHA256[label]


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,k_pad", [(4096, 256), (301, 64)])
@pytest.mark.parametrize("tps,align", [(1, 0), (4, 0), (8, 0), (4, 8), (4, 32), (4, 128)])
def test_seg_dma_matches_plain_on_card(cuda_device, n_tiles, k_pad, tps, align):
    n_rows = n_tiles * 70
    sp = torch.randn((n_rows + k_pad, 16), generator=_seeded(cuda_device, 4), device=cuda_device)
    starts = torch.randint(0, n_rows, (n_tiles,), generator=_seeded(cuda_device, 5),
                           device=cuda_device, dtype=torch.int32)
    starts[-1] = n_rows                # the last window ends at the stream's last row
    got = seg_dma(sp, starts, k_pad, tps=tps, align=align, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, seg_copy_plain(sp, starts, k_pad))


@pytest.mark.cuda
def test_seg_dma_refuses_what_does_not_fit(cuda_device):
    sp = torch.zeros((4096, 16), device=cuda_device)
    starts = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        seg_dma(sp, starts, 512, tps=8, impl="cuda")
    with pytest.raises(ValueError, match="multiple of 4"):
        seg_dma(torch.zeros((4096, 13), device=cuda_device), starts, 64, impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 1024), (3, 32, 100), (5, 256, 33)])
@pytest.mark.parametrize("variant", ["seq", "warp"])
def test_chunk_cumsum_matches_plain_on_card(cuda_device, shape, variant):
    x = torch.randn(shape, generator=_seeded(cuda_device, 6), device=cuda_device) * 0.01
    got = chunk_cumsum(x, variant=variant, impl="cuda")
    torch.cuda.synchronize()
    want = chunk_cumsum_plain(x.cpu())        # a sequential walk on the CPU
    torch.testing.assert_close(got.cpu(), want, atol=1e-6 * want.abs().max().item(), rtol=0)
    torch.testing.assert_close(got, chunk_cumsum_plain(x), atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_chunk_cumsum_seq_takes_any_chunk_on_card(cuda_device):
    x = torch.randn((7, 19, 40), generator=_seeded(cuda_device, 7), device=cuda_device)
    want = chunk_cumsum_plain(x.cpu())
    torch.testing.assert_close(chunk_cumsum(x, impl="cuda").cpu(), want,
                               atol=1e-6 * want.abs().max().item(), rtol=0)
    with pytest.raises(ValueError, match="32 lanes"):
        chunk_cumsum(x, variant="warp", impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rs", [0.0, 0.03], ids=["global", "rolling"])
def test_reference_renderer_holds_the_kernel_route_on_card(cuda_device, rs):
    """`ops.reference.render_reference` with tile emulation against the kernel
    route's `rasterize`: rgb, alpha, T and the alpha-weighted depth sum within
    1e-5, the tolerance of the CPU test against the plain route."""
    from splat_tpu_torch.ops import projection
    from splat_tpu_torch.ops.reference import render_reference

    rng = np.random.default_rng(11)
    n, res = 1500, 128
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=cuda_device)  # noqa: E731
    means = rng.normal(size=(n, 3)) * np.array([0.7, 0.6, 1.2]) + np.array([0, 0, 4.0])
    proj = projection.project_gaussians(
        f32(means), f32(np.exp(rng.normal(size=(n, 3)) * 0.6) * 0.04),
        f32(rng.normal(size=(n, 4))), torch.eye(3, device=cuda_device),
        torch.zeros(3, device=cuda_device), 0.9 * res, 0.9 * res, res / 2, res / 2, res, res,
        lin_vel=f32([0.4, -0.2, 0.1]), ang_vel=f32([0.05, 0.1, -0.02]))
    colors, opac = f32(rng.uniform(0, 1, (n, 3))), f32(rng.uniform(0.3, 0.95, n))
    bg = f32([0.1, 0.2, 0.3])
    before = rk.rasterize_fwd.launches
    got = rasterize.rasterize(proj, colors, opac, res, res, bg, rolling_shutter_time=rs,
                              tile_size=16, max_per_tile=512, max_tiles_per_gaussian=16,
                              impl="cuda")
    assert rk.rasterize_fwd.launches > before
    want = render_reference(proj, colors, opac, res, res, bg, rolling_shutter_time=rs, chunk=64,
                            tile_size=16, max_tiles_per_gaussian=16)
    assert float(want.alpha.max()) > 0.5
    for name in ("rgb", "alpha", "transmittance"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-5, rtol=0)
    torch.testing.assert_close(got.depth * got.alpha, want.depth * want.alpha, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_render_tools_round_trip_on_card(cuda_device, tmp_path):
    """A render on the card through `colorize_depth` and `write_png` decodes
    to the same bytes (the tools need no PIL or matplotlib there)."""
    from splat_tpu_torch.cli.render_model import colorize_depth, to_uint8
    from splat_tpu_torch.data.png import decode_png, encode_png, read_png, write_png

    params, cams = _model(cuda_device)
    cfg = sf.SplatfactoConfig(max_per_tile=K)
    out = sf.render_camera(params, cams, cfg, 3, torch.zeros(3, device=cuda_device))
    img = to_uint8(np.clip(out.rgb.cpu().numpy(), 0, 1))
    depth = colorize_depth(out.depth.cpu().numpy(), out.alpha.cpu().numpy())
    assert img.std() > 0 and depth.std() > 0
    write_png(tmp_path / "rgb.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "rgb.png"), img)
    np.testing.assert_array_equal(decode_png(encode_png(depth)), depth)


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(cuda_device):
    """LPIPS of one seeded pair on the card against the CPU: the same
    float32 graph, TF32 off, within 1e-5 relative (cuDNN and the CPU
    convolutions sum in other orders)."""
    from splat_tpu_torch.ops import lpips

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(96, 80, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape) * 0.1, 0, 1).astype(np.float32)
    w = {k: torch.from_numpy(v) for k, v in lpips.random_weights(seed=0).items()}
    cpu = float(lpips.lpips_pair(torch.from_numpy(x), torch.from_numpy(y), w))
    card = float(lpips.lpips_pair(torch.from_numpy(x).to(cuda_device),
                                  torch.from_numpy(y).to(cuda_device),
                                  {k: v.to(cuda_device) for k, v in w.items()}))
    assert cpu > 0 and abs(card - cpu) <= 1e-5 * cpu, (card, cpu)


MESH_CFG = dict(max_per_tile=K, blur_samples=4)


def _mesh_loss(params, cams, cfg, gt, mesh=None):
    """The loss and every trainable leaf's gradient with the probe's, on one
    device (mesh None) or as this rank's reduced share of a mesh."""
    flat = [p for group in trainer.param_groups(params).values() for p in group]
    for p in flat:
        p.grad = None
        p.requires_grad_(True)
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    if mesh is None:
        out = sf.render_camera(params, cams, cfg, 3, sf.background_color(params, cfg),
                               means2d_probe=probe)
        loss, _ = sf.compute_losses(sf.gamma_encode(out.rgb, cfg), gt, params, cfg)
        loss.backward()
    else:
        share, _ = sharding.sharded_loss(mesh, params, cams, gt, cfg, 3000, probe=probe)
        share.backward()
        sharding.reduce_gradients(mesh, [], flat + [probe])
        loss = sharding.world_sum(mesh, share)
    return loss.detach(), [p.grad for p in flat] + [probe.grad]


def mesh_rank(rank, world, dev, shape, out):
    """One rank of the card mesh check; rank 0 writes the result to `out`."""
    params, cams = _model(dev)
    gt = torch.rand((IMG_H, IMG_W, 3), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    loss, grads = _mesh_loss(params, cams, sf.SplatfactoConfig(**MESH_CFG), gt,
                             sharding.make_mesh(shape))
    if rank == 0:
        np.savez(out, loss=loss.cpu().numpy(), **{f"g{i}": g.cpu().numpy()
                                                  for i, g in enumerate(grads)})


@pytest.mark.cuda
def test_mesh_on_nccl_matches_one_device(cuda_device, tmp_path):
    """The mesh at world = the visible cards (the auto-filled axes; one rank
    per card, NCCL): the loss and every gradient against one device."""
    from splat_tpu_torch.engine.config import MeshConfig

    cfg = sf.SplatfactoConfig(**MESH_CFG)
    shape = sharding.resolve_mesh(MeshConfig(enabled=True), cfg, IMG_H,
                                  torch.cuda.device_count())
    out = tmp_path / "rank0.npz"
    launch.launch(mesh_rank, math.prod(shape.values()), args=(shape, out), device="cuda")
    got = np.load(out)
    params, cams = _model(cuda_device)
    gt = torch.rand((IMG_H, IMG_W, 3), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    loss, grads = _mesh_loss(params, cams, cfg, gt)
    assert abs(float(got["loss"]) - loss.item()) <= 1e-5 * loss.item()
    for i, g in enumerate(grads):
        want = g.cpu().numpy()
        np.testing.assert_allclose(got[f"g{i}"], want, rtol=0, atol=1e-3 * np.abs(want).max())
