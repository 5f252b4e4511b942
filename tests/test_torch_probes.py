"""The plain versions of the probe kernels against the JAX probe scripts.

Four of them are held against the expressions the scripts check themselves
with (`scripts_dev/probe_kernel_gather.py`, `probe_seg_dma.py`,
`probe_cumsum.py`), computed here with jax.numpy / numpy on the same seeded
numpy inputs at a small size: those scripts run at import and without
interpret mode, so they are not imported. `scripts_dev/probe_bwd_stacked.py`
guards its `main()`, so `bwd_stacked_plain` is held against the Pallas kernel
itself in interpret mode, and against the port's `rasterize_bwd_plain`.

Tolerances: the gather and the segment fetch move bits (exact); the scatter
adds each row's contributors in index order on both sides, but XLA may
associate its scatter-add otherwise (atol 1e-5 on sums of ~10 unit normals);
the exclusive cumulative sum against `np.cumsum(x, 0) - x` atol 1e-6 (values
~0.01, the subtraction rounds once more). `bwd_stacked_plain` per column:
within 1e-5 of max|want| + 1e-7 of `rasterize_bwd_plain` (both sum float32
terms, in another order; the stacked one takes its moment products in float64)
and within 2e-5 of max|want| + 1e-7 of the Pallas kernel, whose float32
moment matmuls expand (px - mx)^2 and cancel (the bound
`tests/test_torch_backward.py` holds `rasterize_bwd_plain` to against the
other Pallas backward kernels).
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import IMG_H, IMG_W
from test_torch_kernels import K as BLOCK_K
from test_torch_kernels import _blocks

from splat_tpu.ops import tiling as jtiling
from splat_tpu.ops.pallas.rasterize_kernels import rasterize_fwd_packed
from splat_tpu_torch.ops.cuda import rasterize_kernels as trk
from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked, bwd_stacked_plain, stacked_layout
from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum, chunk_cumsum_plain
from splat_tpu_torch.ops.cuda.row_gather import row_gather, row_gather_plain
from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, row_scatter_plain, scatter_plan
from splat_tpu_torch.ops.cuda.seg_copy import seg_copy_plain
from splat_tpu_torch.ops.cuda.seg_dma import seg_dma

T, K, N, P = 24, 32, 500, 16


def _gather_inputs():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, N, size=(T, K)).astype(np.int32)
    table = rng.normal(size=(N + 4, P)).astype(np.float32)
    g = rng.normal(size=(T, K, P)).astype(np.float32)
    return idx, table, g


@pytest.mark.parametrize("pad_rows", [0, 5])
def test_row_gather_plain_matches_probe_expression(pad_rows):
    idx, table, _ = _gather_inputs()
    if pad_rows:
        idx = idx.reshape(-1)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = row_gather(torch.tensor(table), torch.tensor(idx), pad_rows=pad_rows)
    if pad_rows:
        assert got.shape == (idx.shape[0] + pad_rows, P)
        assert not got[idx.shape[0]:].any()
        got_rows = got[:idx.shape[0]]
    else:
        assert got.shape == idx.shape + (P,)
        got_rows = got
    np.testing.assert_array_equal(got_rows.numpy(), want)
    assert torch.equal(got, row_gather_plain(torch.tensor(table), torch.tensor(idx), pad_rows))


def test_row_gather_wrapper_refuses_cpu_tensors_for_the_kernel():
    idx, table, _ = _gather_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        row_gather(torch.tensor(table), torch.tensor(idx), impl="cuda")
    with pytest.raises(ValueError, match="1-D"):
        row_gather(torch.tensor(table), torch.tensor(idx), pad_rows=3)


def test_row_scatter_plain_matches_probe_expression():
    idx, table, g = _gather_inputs()
    want = np.asarray(jnp.zeros(table.shape).at[jnp.asarray(idx).reshape(-1)].add(
        jnp.asarray(g).reshape(-1, P)))
    got = row_scatter(torch.tensor(idx), torch.tensor(g), table.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, row_scatter_plain(torch.tensor(idx), torch.tensor(g), table.shape[0]))
    assert np.abs(want).max() > 1
    with pytest.raises(ValueError, match="CUDA"):
        row_scatter(torch.tensor(idx), torch.tensor(g), table.shape[0], impl="cuda")


def test_scatter_plan_orders_contributors_as_the_sequential_loop():
    """What the kernel is handed: walking `order` between a row's offsets
    visits its contributors in ascending flat (t, j) position, and adding
    them in that order from zero gives the sequential loop's sums bit for
    bit (np.add.at is that loop)."""
    idx, table, g = _gather_inputs()
    n_rows = table.shape[0]
    idx[0, :4] = [-1, n_rows, n_rows + 7, 3]          # out of range: dropped
    order, offsets = scatter_plan(torch.tensor(idx), n_rows)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    assert offsets.shape == (n_rows + 1,)
    order, offsets = order.numpy(), offsets.numpy()
    flat, rows = idx.reshape(-1), g.reshape(-1, P)
    want = np.zeros((n_rows, P), np.float32)
    valid = (flat >= 0) & (flat < n_rows)
    np.add.at(want, flat[valid], rows[valid])
    got = np.zeros_like(want)
    for d in range(n_rows):
        seg = order[offsets[d]:offsets[d + 1]]
        assert (flat[seg] == d).all() and (np.diff(seg) > 0).all()
        for r in seg:
            got[d] += rows[r]
    np.testing.assert_array_equal(got, want)
    assert offsets[-1] - offsets[0] == valid.sum()


def _plan_indices(kind, n_rows, shape=(64, 40), seed=4):
    """Seeded int32 indices: uniform; half of them on one row; a few rows
    holding long runs; out of range (negative and >= n_rows) mixed in."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, size=shape).astype(np.int32)
    flat = idx.reshape(-1)
    if kind == "half_one_row":
        flat[rng.permutation(flat.size)[:flat.size // 2]] = n_rows // 3
    elif kind == "skewed":
        flat[:] = (rng.zipf(1.3, size=flat.size) - 1) % n_rows
    elif kind == "out_of_range":
        pick = rng.permutation(flat.size)[:flat.size // 5]
        flat[pick] = rng.choice([-1, -7, -2**31, n_rows, n_rows + 3, 2**31 - 1], size=pick.size)
    return idx


@pytest.mark.parametrize("kind,n_rows", [("uniform", 500), ("half_one_row", 500),
                                         ("skewed", 97), ("out_of_range", 500),
                                         ("out_of_range", 1)])
def test_scatter_plan_plain_is_the_stable_argsort(kind, n_rows):
    """What the plan kernels must reproduce bit for bit: `order` is numpy's
    stable argsort of the indices with every out-of-range one (negative or
    >= n_rows) taken as n_rows, so the dropped sources close it in ascending
    order, and `offsets` are that sorted key's left edges 0..n_rows."""
    idx = _plan_indices(kind, n_rows)
    flat = idx.reshape(-1)
    key = np.where((flat >= 0) & (flat < n_rows), flat, n_rows)
    want_order = np.argsort(key, kind="stable")
    want_offsets = np.searchsorted(key[want_order], np.arange(n_rows + 1), side="left")
    order, offsets = scatter_plan(torch.tensor(idx), n_rows)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(offsets.numpy(), want_offsets)
    if kind == "out_of_range":
        dropped = np.flatnonzero(key == n_rows)
        assert dropped.size > 0
        np.testing.assert_array_equal(order.numpy()[offsets[-1]:], dropped)
    # walking each segment in order from zero is the sequential loop, bit for bit
    rows = np.random.default_rng(5).normal(size=(flat.size, P)).astype(np.float32)
    loop = np.zeros((n_rows, P), np.float32)
    valid = key < n_rows
    np.add.at(loop, flat[valid], rows[valid])
    got = np.zeros_like(loop)
    for d in range(n_rows):
        for r in want_order[want_offsets[d]:want_offsets[d + 1]]:
            got[d] += rows[r]
    np.testing.assert_array_equal(got, loop)


@pytest.mark.parametrize("tps,align", [(1, 0), (4, 8), (8, 128)])
def test_seg_dma_plain_matches_probe_expression(tps, align):
    rng = np.random.default_rng(0)
    length = 900
    seg = rng.integers(0, 70, size=T)
    starts = np.minimum(np.concatenate([[0], np.cumsum(seg)[:-1]]), length - 1).astype(np.int32)
    src = rng.normal(size=(length + K, P)).astype(np.float32)
    pos = jnp.asarray(starts)[:, None] + jnp.arange(K, dtype=jnp.int32)[None, :]
    want = np.asarray(jnp.take(jnp.asarray(src), pos, axis=0))       # the probe's xla_gather
    got = seg_dma(torch.tensor(src), torch.tensor(starts), K, tps=tps, align=align)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, seg_copy_plain(torch.tensor(src), torch.tensor(starts), K))
    with pytest.raises(ValueError, match="CUDA"):
        seg_dma(torch.tensor(src), torch.tensor(starts), K, tps=tps, align=align, impl="cuda")


@pytest.mark.parametrize("variant", ["seq", "warp"])
def test_chunk_cumsum_plain_matches_probe_expression(variant):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 128, 40)) * 0.01).astype(np.float32)
    got = chunk_cumsum(torch.tensor(x), variant=variant)
    for t in range(x.shape[0]):
        want = np.cumsum(x[t], axis=0) - x[t]
        np.testing.assert_allclose(got[t].numpy(), want, rtol=0, atol=1e-6)
    assert not got[:, 0].any()
    assert torch.equal(got, chunk_cumsum_plain(torch.tensor(x)))
    with pytest.raises(ValueError, match="CUDA"):
        chunk_cumsum(torch.tensor(x), variant=variant, impl="cuda")
    with pytest.raises(ValueError, match="variant"):
        chunk_cumsum(torch.tensor(x), variant="roll")


def _jax_probe(name):
    """Import scripts_dev/<name>.py (a script whose main() is guarded)."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / "scripts_dev" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("tile_size,n_samples,rs,tps",
                         [(8, 1, 0.0, 1), (8, 3, 0.04, 2), ((16, 8), 3, 0.04, 1)])
def test_bwd_stacked_plain_matches_pallas_probe_and_rasterize_bwd_plain(
        tile_size, n_samples, rs, tps, monkeypatch):
    probe = _jax_probe("probe_bwd_stacked")
    blocks, counts = _blocks(tile_size)
    n_tiles = blocks.shape[0]
    assert n_tiles % tps == 0
    tiles_x = jtiling.num_tiles(IMG_W, IMG_H, tile_size)[0]
    eps = np.linspace(-0.5, 0.5, n_samples).astype(np.float32) * 0.06
    rows = jnp.asarray(blocks).transpose(0, 2, 1)                  # (T, 13, K)
    fwd = rasterize_fwd_packed(rows, jnp.asarray(counts), jnp.float32(rs), tile_size=tile_size,
                               tiles_x=tiles_x, img_h=IMG_H, eps=jnp.asarray(eps))
    g_out = np.zeros(fwd.shape, np.float32)
    g_out[:, :, :trk.NOUT] = np.random.default_rng(5).normal(size=g_out[:, :, :trk.NOUT].shape)
    jax_want = np.asarray(probe.bwd_stacked(
        rows, jnp.asarray(counts), jnp.float32(rs), fwd, jnp.asarray(g_out), tile_size, tiles_x,
        IMG_H, jnp.asarray(eps), tps)).transpose(0, 2, 1)          # (T, K, 13)

    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    args = (padded, torch.tensor(counts, dtype=torch.int32),
            trk.scalar_vec(rs, 0.0, torch.tensor(eps), torch.device("cpu")),
            torch.tensor(np.asarray(fwd)[:, :, :trk.NOUT]).contiguous(),
            torch.tensor(g_out[:, :, :trk.NOUT]).contiguous(), tile_size, tiles_x, IMG_H)
    got = bwd_stacked(*args)
    assert got.shape == (n_tiles, BLOCK_K, trk.PARAM_STRIDE)
    stacked_module = sys.modules[bwd_stacked_plain.__module__]
    sp = n_samples * int(np.prod(np.broadcast_to(tile_size, 2)))
    monkeypatch.setattr(stacked_module, "PLAIN_CHUNK", 32)
    monkeypatch.setattr(stacked_module, "PLAIN_PLANE_ELEMS", 5 * sp * 32)   # 5 tiles at a time
    assert torch.equal(got, bwd_stacked_plain(*args)), \
        "the chunk and tile-group sizes do not change the result"
    monkeypatch.undo()
    assert not got[:, :, trk.NPARAM - 1:].any(), "log-opacity and pad columns are zero"
    assert not got[0].any(), "the empty tile has no gradient"
    for n, c in zip(counts, got):
        assert not c[n:].any(), "slots past the count have no gradient"
    port_want = trk.rasterize_bwd_plain(*args).numpy()
    got = got.numpy()
    for col in range(trk.NPARAM - 1):
        for want, tol, what in ((port_want[:, :, col], 1e-5, "rasterize_bwd_plain"),
                                (jax_want[:, :, col], 2e-5, "the Pallas probe kernel")):
            scale = np.abs(want).max()
            assert scale > 0, col
            np.testing.assert_allclose(got[:, :, col], want, rtol=0, atol=tol * scale + 1e-7,
                                       err_msg=f"column {col} against {what}")


@pytest.mark.parametrize("npix", [256, 128, 64])
def test_stacked_layout_is_balanced_for_every_sample_count(npix):
    """The kernel's layout takes S = 1..16 at the three tile sizes: every
    thread owns the same 1 to 4 stacked rows, the block holds at most 1024
    threads in whole warps, and coefficient_passes counts the distinct pixel
    strips of each thread's strip-major groups (S when a thread owns one
    row; 2.0 at S = 5 and 16x16, 4 rows a thread)."""
    for n_samples in range(1, 17):
        rows, threads, passes = stacked_layout(n_samples, npix)
        assert 1 <= rows <= 4 and rows * threads == n_samples * npix, n_samples
        assert threads % 32 == 0 and threads <= 1024, n_samples
        strips = npix // 32
        own = [{g // n_samples for g in range(w, w + rows)}
               for w in range(0, n_samples * strips, rows)]
        assert passes == sum(map(len, own)) / strips, n_samples
        if rows == 1:
            assert passes == n_samples
    assert stacked_layout(5, 256) == (4, 320, 2.0)
    assert {stacked_layout(s, n).rows for s in range(1, 17) for n in (256, 128, 64)} == {1, 2, 3, 4}
    with pytest.raises(ValueError, match="rows a thread"):
        stacked_layout(5, 48)


def test_bwd_stacked_wrapper_refuses_cpu_tensors_for_the_kernel():
    blocks, counts = _blocks(8)
    padded = torch.nn.functional.pad(torch.tensor(blocks), (0, trk.PARAM_STRIDE - trk.NPARAM))
    planes = torch.zeros((blocks.shape[0], 1, trk.NOUT, 64))
    args = (padded, torch.tensor(counts, dtype=torch.int32),
            trk.scalar_vec(0.0, 0.0, None, torch.device("cpu")), planes, planes, 8, 6, IMG_H)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_stacked(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        bwd_stacked(*args, impl="pallas")
    assert bwd_stacked(*args, impl="torch").shape == padded.shape
