"""The two kernels' plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU, as tests/test_pallas.py runs them). Each kernel
against its plain version on the card is tests/test_torch_cuda.py; the rule
of `impl` at every entry is tests/test_torch_route.py.

Tolerances: the compositor runs the same math as the TPU kernels but as a
sequential per-pixel recurrence instead of a log-space matmul prefix, so
values differ by float32 rounding (a few ulp per step over <= 128 steps):
atol 1e-4 on rgb and T, 1e-3 on depth_acc (depths are ~4, so 1e-3 is the
same relative error). The segment copy moves bits: exact. The kernels' per-warp
cull (`warp_hit_mask`) is held to soundness, exactly: on adversarial rows
(`scripts_dev/probe_cull_torch.py`) it never clears a (row, warp) group where
the recurrence's float32 condition composites a pair.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.ops import projection as jproj
from splat_tpu.ops import tiling as jtiling
from splat_tpu.ops.pallas import pack_param_table as j_pack
from splat_tpu.ops.pallas.rasterize_kernels import rasterize_fwd_packed
from splat_tpu.ops.pallas.rasterize_kernels_gmajor import (
    rasterize_fwd_gpacked,
    rasterize_fwd_gpacked_rowin,
)
from splat_tpu.ops.pallas.seg_copy import seg_copy as j_seg_copy
from splat_tpu_torch.ops import cuda as tcuda
from splat_tpu_torch.ops import projection as tproj
from splat_tpu_torch.ops.cuda import rasterize_kernels as trk
from splat_tpu_torch.ops.cuda import seg_copy as tseg

K = 128
IMG_W, IMG_H = 48, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(tile_size, n=220, seed=1):
    """JAX-projected scene binned by JAX: (proj, colors, opac, lists)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.4, 0.8]) + np.array([0, 0, 4.0])
    means[:150] = np.array([0.05, 0.0, 3.5]) + rng.normal(size=(150, 3)) * 0.05  # a full tile
    scales = np.exp(rng.normal(size=(n, 3)) * 0.35) * 0.12
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    proj = jproj.project_gaussians(
        *(jnp.asarray(a, jnp.float32) for a in (means, scales, quats)),
        jnp.eye(3), jnp.zeros(3), 40.0, 40.0, IMG_W / 2, IMG_H / 2, IMG_W, IMG_H,
        lin_vel=jnp.array([0.5, -0.3, 0.2]), ang_vel=jnp.array([0.1, 0.15, -0.1]),
    )
    op_eff = opac * proj.compensations * proj.valid.astype(jnp.float32)
    lists = jtiling.build_tile_lists(
        proj.means2d, proj.extents, proj.depths, proj.valid, IMG_W, IMG_H, tile_size,
        K, 16, radius_pad=jnp.abs(proj.pix_vels) * 0.05, conics=proj.conics,
        opacities=op_eff, materialize_indices=False,
    )
    return proj, jnp.asarray(colors), jnp.asarray(opac), lists


def _blocks(tile_size):
    """(T, K, 13) per-tile blocks as the JAX forward gathers them, and counts
    with one empty tile and one full (count = K) tile."""
    proj, colors, opac, lists = _scene(tile_size)
    table = j_pack(proj, colors, opac)
    sp = jnp.concatenate([jnp.take(table, lists.sorted_ids, axis=0),
                          jnp.zeros((K, table.shape[1]))])
    pos = lists.starts[:, None] + jnp.arange(K)[None, :]
    blocks = np.asarray(jnp.take(sp, pos, axis=0))
    counts = np.array(lists.counts)
    assert counts.max() == K, "the scene must fill one tile"
    counts[0] = 0
    assert 0 < np.median(counts) < K
    return blocks, counts


CASES = [
    # (tile_size, n_samples, rs_time, row_offset)
    (8, 1, 0.0, 0.0),
    (8, 5, 0.04, 0.0),
    (8, 5, 0.04, 16.0),
    ((16, 8), 5, 0.04, 8.0),
    ((16, 8), 1, 0.0, 0.0),
]


@pytest.mark.parametrize("tile_size,n_samples,rs,row_off", CASES)
@pytest.mark.parametrize("jax_kernel", ["gpacked_rowin", "packed", "gpacked"])
def test_rasterize_fwd_plain_matches_pallas(tile_size, n_samples, rs, row_off, jax_kernel):
    """The port's one forward against the three TPU layouts of the same
    function: (T, 13, K) rows in (#1, #3) and (T, K, 13) in (#4)."""
    blocks, counts = _blocks(tile_size)
    tiles_x = jtiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    full_h = IMG_H + 2 * int(row_off)
    eps = np.linspace(-0.5, 0.5, n_samples).astype(np.float32) * 0.06
    j_fn = {"gpacked_rowin": rasterize_fwd_gpacked_rowin, "packed": rasterize_fwd_packed,
            "gpacked": rasterize_fwd_gpacked}[jax_kernel]
    j_blocks = jnp.asarray(blocks)
    want = np.asarray(j_fn(
        j_blocks if jax_kernel == "gpacked" else j_blocks.transpose(0, 2, 1),
        jnp.asarray(counts), jnp.float32(rs),
        tile_size, tiles_x, full_h, jnp.float32(row_off), jnp.asarray(eps),
    ))[:, :, :trk.NOUT]
    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    got = trk.rasterize_fwd(padded, torch.tensor(counts, dtype=torch.int32), rs, tile_size,
                            tiles_x, full_h, row_offset=row_off, eps=torch.tensor(eps)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :, [0, 1, 2, 4]], want[:, :, [0, 1, 2, 4]], atol=1e-4)
    np.testing.assert_allclose(got[:, :, 3], want[:, :, 3], atol=1e-3)
    np.testing.assert_array_equal(got[0, :, 4], 1.0)    # the empty tile stays clear
    assert (got[:, :, 4] < 1.0).any()


def test_rasterize_fwd_plain_counts_work():
    """The work counts chip_smoke.py's bound reads: every step of every live
    row when no pixel can saturate, fewer once the full tile saturates."""
    blocks, counts = _blocks(8)
    tiles_x = jtiling.num_tiles(IMG_W, IMG_H, 8)[0]
    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    counts_t = torch.tensor(counts, dtype=torch.int32)
    n_s, npix = 3, 64
    scalars = trk.scalar_vec(0.04, 0.0, torch.linspace(-0.03, 0.03, n_s), torch.device("cpu"))
    rows = int(np.minimum(counts, K).sum())

    faint = padded.clone()
    faint[:, :, 12] = trk.LOG_THRESH - 1.0     # every alpha under the floor: T stays 1
    _, work = trk.rasterize_fwd_plain(faint, counts_t, scalars, 8, tiles_x, IMG_H,
                                      count_work=True)
    assert work == dict(live_pairs=rows * npix * n_s, live_row_pixels=rows * npix,
                        live_rows=rows, hit_pairs=0, warp_live_pairs=0, warp_live_row_pixels=0,
                        warp_groups=rows * npix // trk.WARP, kept_groups=0, hit_groups=0,
                        missed_groups=0, hit_warp_samples=0)

    out, work = trk.rasterize_fwd_plain(padded, counts_t, scalars, 8, tiles_x, IMG_H,
                                        count_work=True)
    torch.testing.assert_close(out, trk.rasterize_fwd_plain(padded, counts_t, scalars, 8,
                                                            tiles_x, IMG_H), rtol=0, atol=0)
    assert (out[:, :, 4] <= trk.T_EPS).any(), "some pixel must saturate"
    assert work["live_pairs"] < work["live_row_pixels"] * n_s or \
        work["live_row_pixels"] < work["live_rows"] * npix
    assert work["live_row_pixels"] * n_s >= work["live_pairs"]
    assert 0 < work["live_rows"] <= rows and work["live_pairs"] < rows * npix * n_s
    assert 0 < work["hit_pairs"] < work["live_pairs"]
    assert work["hit_pairs"] <= work["warp_live_pairs"] < work["live_pairs"]
    assert work["warp_live_row_pixels"] < work["live_row_pixels"]
    assert work["missed_groups"] == 0
    assert 0 < work["hit_groups"] <= work["kept_groups"] < work["warp_groups"]
    assert work["hit_groups"] <= work["hit_warp_samples"] <= work["hit_groups"] * n_s
    assert work["hit_pairs"] <= work["hit_warp_samples"] * trk.WARP


def _probe_cull():
    spec = importlib.util.spec_from_file_location(
        "probe_cull_torch", Path(__file__).resolve().parents[1] / "scripts_dev" / "probe_cull_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("tile_size,n_samples,rs,nonfinite", [
    (16, 16, -0.05, False), (16, 1, -0.05, True), ((16, 8), 16, 0.04, True),
    ((16, 8), 1, -0.05, False), (8, 5, -0.05, False), (16, 1, 0.0, False)])
def test_warp_hit_mask_keeps_every_compositing_group(tile_size, n_samples, rs, nonfinite,
                                                     monkeypatch):
    """Adversarial rows (near-degenerate and indefinite conics, pixel
    velocities of hundreds of px/s, log opacities under and at the floor,
    negative rs, a row offset, NaN and inf): every (row, warp) group where
    the float32 condition T > T_EPS, lo >= log(1/255), lo <= lo_hi holds for
    some pixel and sample is kept, with T held at 1 (so no pixel stops) and
    on the recurrence itself; so is it by the swept box without its rounding
    slack and margin (which would hide a box a fraction of a pixel short);
    the mask still culls, and the warp-granular work counts lie between the
    compositing pairs and the live pairs."""
    inp = _probe_cull().make_inputs(torch.device("cpu"), tile_size, n_samples, rs,
                                    nonfinite=nonfinite)
    p, counts, scalars = inp["params"], inp["counts"], inp["scalars"]
    geo = (inp["tile_size"], inp["tiles_x"], inp["img_h"])
    mask = trk.warp_hit_mask(p, counts, scalars, *geo)
    with monkeypatch.context() as m:
        for name in ("SIGMA_ABS_SLACK", "SIGMA_REL_SLACK", "DET_REL_SLACK", "BOX_MARGIN",
                     "BOX_REL_MARGIN"):
            m.setattr(trk, name, 0.0)
        bare = trk.warp_hit_mask(p, counts, scalars, *geo)
    assert not (bare & ~mask).any()
    n_tiles, k, _ = p.shape
    tx, ty, px, py, ts = trk._tile_grid(n_tiles, scalars, *geo, p.device)
    n = torch.clamp(counts.long(), max=k)
    ones = torch.ones((n_tiles, ts.shape[1], px.shape[0]))
    for j in range(k):
        _, _, _, _, live = trk._row_alpha(p[:, j, :, None, None], tx, ty, px, py, ts, ones,
                                          (j < n)[:, None, None])
        hit = trk._by_warp(live).sum(dim=(1, 3)) > 0                  # (T, n_warps)
        assert not (hit & ~bare[:, j]).any(), f"slot {j}: a hit group culled"
    _, work = trk.rasterize_fwd_plain(p, counts, scalars, *geo, count_work=True)
    assert work["missed_groups"] == 0
    assert work["hit_pairs"] <= work["warp_live_pairs"] <= work["live_pairs"]
    assert work["warp_live_row_pixels"] <= work["live_row_pixels"]
    assert work["hit_groups"] <= work["kept_groups"] < work["warp_groups"]
    in_count = (torch.arange(k) < n[:, None])[..., None].expand_as(mask)
    assert mask.sum() < in_count.sum() and (in_count & ~mask).all(dim=2).any(), \
        "some rows culled for every warp"
    assert not mask[~in_count].any()


@pytest.mark.parametrize("tile_size,n_samples,rs,nonfinite", [
    (16, 1, -0.05, True), (16, 3, -0.05, False), ((16, 8), 5, 0.04, True),
    (8, 5, -0.05, False), (16, 16, 0.04, True), ((16, 8), 16, -0.05, False),
    (16, 5, 0.0, True)])
def test_sample_hit_mask_keeps_every_compositing_group(tile_size, n_samples, rs, nonfinite,
                                                       monkeypatch):
    """bwd_stacked's per-sample cull on the adversarial rows of
    test_warp_hit_mask_keeps_every_compositing_group: every (row, sample,
    warp) group where the float32 condition composites some pixel of the
    warp at that sample is kept, with T held at 1 and, through
    `bwd_stacked_plain(count_work=True)`, on the stacked recurrence itself;
    so by the box without its slack and margin; every bit it sets is set in
    `warp_hit_mask` for the same pixels, and with S > 1 it culls groups that
    mask keeps."""
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked_plain

    inp = _probe_cull().make_inputs(torch.device("cpu"), tile_size, n_samples, rs,
                                    nonfinite=nonfinite)
    p, counts, scalars = inp["params"], inp["counts"], inp["scalars"]
    geo = (inp["tile_size"], inp["tiles_x"], inp["img_h"])
    mask = trk.sample_hit_mask(p, counts, scalars, *geo)             # (T, K, S, n_warps)
    whole = trk.warp_hit_mask(p, counts, scalars, *geo)
    assert mask.shape == whole.shape[:2] + (n_samples,) + whole.shape[2:]
    assert not (mask & ~whole[:, :, None]).any(), "a bit the exposure-wide mask clears"
    with monkeypatch.context() as m:
        for name in ("SIGMA_ABS_SLACK", "SIGMA_REL_SLACK", "DET_REL_SLACK", "BOX_MARGIN",
                     "BOX_REL_MARGIN"):
            m.setattr(trk, name, 0.0)
        bare = trk.sample_hit_mask(p, counts, scalars, *geo)
    assert not (bare & ~mask).any()
    n_tiles, k, _ = p.shape
    tx, ty, px, py, ts = trk._tile_grid(n_tiles, scalars, *geo, p.device)
    n = torch.clamp(counts.long(), max=k)
    ones = torch.ones((n_tiles, ts.shape[1], px.shape[0]))
    for j in range(k):
        _, _, _, _, live = trk._row_alpha(p[:, j, :, None, None], tx, ty, px, py, ts, ones,
                                          (j < n)[:, None, None])
        hit = trk._by_warp(live).sum(dim=3) > 0                       # (T, S, n_warps)
        assert not (hit & ~bare[:, j]).any(), f"slot {j}: a hit group culled"
    fwd = trk.rasterize_fwd_plain(p, counts, scalars, *geo)
    g_out = torch.randn(fwd.shape, generator=torch.Generator().manual_seed(0))
    _, work = bwd_stacked_plain(p, counts, scalars, fwd, g_out, *geo, count_work=True)
    assert work["missed_groups"] == 0
    assert 0 < work["hit_groups"] <= work["kept_groups"] < work["groups"]
    if n_samples > 1:
        assert mask.sum() < whole.sum() * n_samples, "one sample's sweep culls more"


def test_sample_hit_mask_on_a_seeded_scene():
    """The same soundness on a projected scene (a full tile that saturates,
    so rows stop): bwd_stacked_plain's recurrence composites in no group the
    per-sample mask clears, the mask lies inside warp_hit_mask's, and the
    stacked plain version with its counts is the one without them."""
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked_plain

    blocks, counts = _blocks(8)
    tiles_x = jtiling.num_tiles(IMG_W, IMG_H, 8)[0]
    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    counts_t = torch.tensor(counts, dtype=torch.int32)
    scalars = trk.scalar_vec(0.04, 0.0, torch.linspace(-0.03, 0.03, 5), torch.device("cpu"))
    geo = (8, tiles_x, IMG_H)
    mask = trk.sample_hit_mask(padded, counts_t, scalars, *geo)
    assert not (mask & ~trk.warp_hit_mask(padded, counts_t, scalars, *geo)[:, :, None]).any()
    fwd = trk.rasterize_fwd_plain(padded, counts_t, scalars, *geo)
    assert (fwd[:, :, 4] <= trk.T_EPS).any(), "some pixel must saturate"
    g_out = torch.randn(fwd.shape, generator=torch.Generator().manual_seed(1))
    got, work = bwd_stacked_plain(padded, counts_t, scalars, fwd, g_out, *geo, count_work=True)
    assert torch.equal(got, bwd_stacked_plain(padded, counts_t, scalars, fwd, g_out, *geo))
    assert work["missed_groups"] == 0
    assert 0 < work["hit_groups"] <= work["kept_groups"] < work["groups"]


def test_pack_param_table_matches_jax():
    proj, colors, opac, _ = _scene(8)
    want = np.asarray(j_pack(proj, colors, opac))
    tp = tproj.ProjectedGaussians(*(torch.tensor(np.array(f)) for f in proj))
    got = tcuda.pack_param_table(tp, torch.tensor(np.array(colors)), torch.tensor(np.array(opac)))
    assert got.shape == (want.shape[0], trk.PARAM_STRIDE)
    np.testing.assert_allclose(got[:, :trk.NPARAM].numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[:, trk.NPARAM:].any() and not got[-1].any()


@pytest.mark.parametrize("k_pad", [128, 256])
def test_seg_copy_plain_equals_pallas(k_pad):
    proj, colors, opac, lists = _scene(8)
    table = j_pack(proj, colors, opac)
    sp = jnp.concatenate([jnp.take(table, lists.sorted_ids, axis=0),
                          jnp.zeros((k_pad, table.shape[1]))])
    want = np.asarray(j_seg_copy(sp, lists.starts, k_pad, lists.starts.shape[0]))
    got = tseg.seg_copy(torch.tensor(np.array(sp)),
                        torch.tensor(np.array(lists.starts)), k_pad)
    np.testing.assert_array_equal(got.numpy(), want)
