"""The fetch pair's plain versions (`ops/cuda/tile_fetch.py`) on the CPU,
against the chain they replace and against the dense id table's route.

The binnings come from `rasterize.bin_tiles` on a small scene built so that
one tile is full (count K), some tiles are empty (count 0), and, with a
capped stream (max_total_entries > 0), some tiles' K-row windows cross the
stream's end. The forward's counted rows are bitwise the sorted stream's
windows (`seg_copy_plain(row_gather_plain(...))`) and the dense id table's
rows; the backward is bitwise a float32 sum in the order m = 0 .. M - 1,
within float32 rounding of the old gather-and-sum (bitwise where a Gaussian
has at most two landed entries), and zero on the pad row and on Gaussians
with no landed entry. The card tests (`tests/test_torch_cuda.py`) hold the
kernels to these plain versions.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import splat_tpu_torch.ops.cuda as kcuda
from splat_tpu_torch.cameras.cameras import Cameras
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.ops import rasterize, tiling
from splat_tpu_torch.ops.cuda.row_gather import row_gather_plain
from splat_tpu_torch.ops.cuda.seg_copy import seg_copy_plain
from splat_tpu_torch.ops.cuda.tile_fetch import (tile_fetch_bwd, tile_fetch_bwd_plain,
                                                 tile_fetch_fwd, tile_fetch_fwd_plain)

W, H = 48, 32
K = 16
N = 160
CASES = [(8, 0), (8, "half"), ((8, 4), 0), ((8, 4), "half")]


_spec = importlib.util.spec_from_file_location(
    "probe_tile_fetch_torch",
    Path(__file__).resolve().parents[1] / "scripts_dev" / "probe_tile_fetch_torch.py")
_probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_probe)
counted_rows = _probe.counted_rows    # the rows past each tile's count zeroed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(tile, cap):
    """The packed table and a binning: Gaussians in the left two thirds of
    the image, a cluster dense enough to fill a tile."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    means = rng.normal(size=(N, 3)) * [0.5, 0.5, 0.4] + [-0.5, 0.0, 4.0]
    means[:40] = [-0.4, 0.1, 3.5] + rng.normal(size=(40, 3)) * 0.05
    g = sf.GaussianParams(
        means=t(means), scales_log=t(rng.normal(size=(N, 3)) * 0.3 - 2.2),
        quats=t(rng.normal(size=(N, 4))), opacities_logit=t(rng.normal(size=N) + 1.0),
        features_dc=t(rng.normal(size=(N, 3)) * 0.5),
        features_rest=t(rng.normal(size=(N, 15, 3)) * 0.1), alive=torch.ones(N))
    params = sf.ModelParams(gaussians=g, background_logit=torch.zeros(3), camera_opt={},
                            velocity_opt={}, eval_camera_opt={}, eval_velocity_opt={})
    cam = Cameras(R_c2w=torch.eye(3)[None], p_c2w=torch.zeros((1, 3)),
                  fx=torch.tensor([40.0]), fy=torch.tensor([40.0]),
                  cx=torch.tensor([W / 2]), cy=torch.tensor([H / 2]), width=W, height=H,
                  lin_vel=torch.tensor([[0.3, -0.1, 0.2]]),
                  ang_vel=torch.tensor([[0.2, 0.4, -0.1]]),
                  exposure_time=torch.tensor([0.05]), rolling_shutter_time=torch.tensor([0.03]))
    cfg = sf.SplatfactoConfig(impl="torch", tile_size=tile, max_per_tile=K,
                              max_tiles_per_gaussian=16)
    motion = sf.camera_motion(params, cam, cfg)
    with torch.no_grad():
        proj, colors = sf.subframe_inputs(params, motion, cfg, 3, motion.eps[0])
        opac = torch.sigmoid(g.opacities_logit)
        args = (proj, opac, W, H, motion.eps, motion.rs_time, tile, K, 16)
        lists = rasterize.bin_tiles(*args)
        if cap == "half":
            real = int(lists.counts.sum() + lists.overflow)
            lists = rasterize.bin_tiles(*args, max_total_entries=real // 2)
        table = kcuda.pack_param_table(proj, colors, opac)
    return table, lists


@pytest.mark.parametrize("tile,cap", CASES)
def test_forward_counted_rows_are_the_chain_and_the_id_table(tile, cap):
    table, lists = _scene(tile, cap)
    counts, starts, ids = lists.counts, lists.starts, lists.sorted_ids
    l_cap = ids.shape[0]
    assert int(counts.max()) == K and bool((counts == 0).any())
    if cap:
        assert int(lists.entry_overflow) > 0 and bool((starts + K > l_cap).any())
    got = tile_fetch_fwd(table, ids, starts, counts, K)
    assert got.shape == (counts.shape[0], K, table.shape[1])
    chain = seg_copy_plain(row_gather_plain(table, ids, pad_rows=K), starts, K)
    assert torch.equal(counted_rows(got, counts), counted_rows(chain, counts))
    dense = rasterize.gather_tile_params(lists, table, K)
    assert torch.equal(counted_rows(got, counts), counted_rows(dense, counts))
    # the kernel's definition, row by row
    for t_ in range(counts.shape[0]):
        for j in range(int(counts[t_])):
            pos = int(starts[t_]) + j
            want = table[int(ids[pos])] if pos < l_cap else torch.zeros_like(table[0])
            assert torch.equal(got[t_, j], want)
    assert torch.equal(got, tile_fetch_fwd_plain(table, ids, starts, K))


def _old_gather_and_sum(g, entry_slots, n):
    d_slots = torch.cat([g.reshape(-1, g.shape[2]), g.new_zeros((1, g.shape[2]))])
    return row_gather_plain(d_slots, entry_slots).reshape(n, -1, g.shape[2]).sum(dim=1)


@pytest.mark.parametrize("tile,cap", CASES)
def test_backward_sums_each_gaussians_landed_slots(tile, cap):
    table, lists = _scene(tile, cap)
    n, n_tiles = table.shape[0] - 1, lists.counts.shape[0]
    gen = torch.Generator().manual_seed(11)
    g = torch.randn((n_tiles, K, table.shape[1]), generator=gen) * 10.0 ** torch.randint(
        -3, 3, (n_tiles, K, 1), generator=gen)
    # rows past a tile's count are never read: poison them
    past = torch.arange(K)[None, :] >= lists.counts.long()[:, None]
    g[past] = float("nan")
    slots = lists.entry_slots
    landed = (slots.reshape(n, -1) < n_tiles * K).sum(dim=1)
    assert int(landed.max()) >= 3 and bool((landed == 0).any())
    got = tile_fetch_bwd(g, slots, n + 1)
    assert got.shape == (n + 1, table.shape[1]) and bool(torch.isfinite(got).all())
    assert not got[n].any() and not got[:n][landed == 0].any()
    # bitwise a float32 sum in the order m = 0 .. M - 1, dropped slots skipped
    flat = g.reshape(-1, g.shape[2])
    seq = torch.zeros((n, g.shape[2]))
    for i in range(n):
        for s in slots.reshape(n, -1)[i].tolist():
            if s < n_tiles * K:
                seq[i] = seq[i] + flat[s]
    assert torch.equal(got[:n], seq)
    # the gather-and-sum it replaces: bitwise up to two landed entries, else
    # within float32 rounding of the float64 sum
    g0 = torch.where(past[:, :, None], torch.zeros(()), g)
    old = _old_gather_and_sum(g0, slots, n)
    few = landed <= 2
    assert torch.equal(got[:n][few], old[few])
    exact = _old_gather_and_sum(g0.double(), slots, n)
    scale = _old_gather_and_sum(g0.double().abs(), slots, n)
    bound = 2.0 * landed.double()[:, None] * 2.0 ** -24 * scale
    for x in (got[:n], old):
        assert bool(((x.double() - exact).abs() <= bound).all())
    assert torch.equal(got, tile_fetch_bwd_plain(g, slots, n + 1))


@pytest.mark.parametrize("tile,cap", CASES)
def test_landed_slots_are_the_counted_rows(tile, cap):
    """entry_slots maps the landed entries one to one onto the counted rows,
    so the backward reads no row past a count."""
    _, lists = _scene(tile, cap)
    n_tiles = lists.counts.shape[0]
    s = lists.entry_slots[lists.entry_slots < n_tiles * K].long()
    assert s.numel() == int(lists.counts.sum()) == s.unique().numel()
    assert bool(((s % K) < lists.counts.long()[s // K]).all())


@pytest.mark.parametrize("tile,cap", CASES)
def test_gather_table_gradient_is_the_pairs(tile, cap):
    """Through autograd on the CPU: the fetch's gradient is the plain
    backward of the counted rows' cotangent, and matches the dense id
    table's route (`_GatherDense`) within float32 rounding."""
    table, lists = _scene(tile, cap)
    n_tiles = lists.counts.shape[0]
    w = torch.randn((n_tiles, K, table.shape[1]), generator=torch.Generator().manual_seed(5))
    w = counted_rows(w, lists.counts)
    grads = []
    for fetch in (lambda t: kcuda.gather_table(t, lists, K),
                  lambda t: rasterize.gather_tile_params(lists, t, K)):
        leaf = table.clone().requires_grad_(True)
        (counted_rows(fetch(leaf), lists.counts) * w).sum().backward()
        grads.append(leaf.grad)
    assert torch.equal(grads[0], tile_fetch_bwd_plain(w, lists.entry_slots, table.shape[0]))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)
