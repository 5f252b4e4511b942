"""The plain versions of the four probe kernels against the expressions the
JAX probe scripts check themselves with (`scripts_dev/probe_kernel_gather.py`,
`probe_seg_dma.py`, `probe_cumsum.py`), computed here with jax.numpy / numpy
on the same seeded numpy inputs at a small size. The probe scripts run at
import and without interpret mode, so they are not imported.

Tolerances: the gather and the segment fetch move bits (exact); the scatter
adds each row's contributors in index order on both sides, but XLA may
associate its scatter-add otherwise (atol 1e-5 on sums of ~10 unit normals);
the exclusive cumulative sum against `np.cumsum(x, 0) - x` atol 1e-6 (values
~0.01, the subtraction rounds once more).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
