#!/usr/bin/env python3
"""Probe: the fetch pair (`ops/cuda/csrc/tile_fetch.cu`) against its plain
versions and against the chain it replaces, at the training path's sizes.

    python3 scripts_dev/probe_tile_fetch_torch.py [--rows N] [--live FRACTION]
    python3 scripts_dev/probe_tile_fetch_torch.py --cell phone_mbrs.train [--seed N]

Inputs (`make_inputs`): the kernels' binning of `probe_bin_tiles_torch`'s
inputs (1920x1080, tile 16, M = 16, K = 2048; `live` < 1 is a depth slab's
receive buffer of `rows` rows), or with `--cell` camera 0's first anchor of
a benchmark cell's state; a seeded (N + 1, 16) table with a zero pad row,
and a seeded slot gradient (T, K, 16) whose rows past each tile's count are
NaN (no reader may touch them).

Questions: are the forward's counted rows bitwise its plain version's and
the chain's (`row_gather` over sorted_ids with K pad rows, then `seg_copy`),
is the backward bitwise its plain version, the same bits over two launches,
finite, and within float32 rounding of the chain's backward (a zero row
appended, `row_gather` over entry_slots, a sum over M; bitwise where a
Gaussian has at most two landed entries); and how long does each kernel
take beside its bytes' bound, its plain version and the chain?
Prints one JSON line. Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_PER_S = 3.35e12


def _bin_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_bin_tiles_torch", Path(__file__).resolve().parent / "probe_bin_tiles_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_inputs(dev, bin_inputs: dict, seed: int = 0) -> dict:
    """The kernels' binning of `bin_inputs` (`probe_bin_tiles_torch`'s
    keyword arguments), a seeded table and a seeded, tail-poisoned slot
    gradient."""
    from splat_tpu_torch.ops.cuda import bin_tiles
    from splat_tpu_torch.ops.cuda.rasterize_kernels import PARAM_STRIDE

    with torch.no_grad():
        lists, _, _ = bin_tiles.tile_lists(*_bin_probe()._args(bin_inputs))
        n, k = bin_inputs["means2d"].shape[0], bin_inputs["max_per_tile"]
        gen = torch.Generator(device=dev).manual_seed(seed)
        table = torch.randn((n + 1, PARAM_STRIDE), generator=gen, device=dev)
        table[n] = 0.0
        g = torch.randn((lists.counts.shape[0], k, PARAM_STRIDE), generator=gen, device=dev)
        past = torch.arange(k, device=dev)[None, :] >= lists.counts.long()[:, None]
        g[past] = float("nan")
    return {"table": table, "lists": lists, "k": k, "g": g}


def counted_rows(blocks: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """blocks with every row past its tile's count set to zero: the rows a
    compositor reads, for comparing two fetches, and what a compositor's
    plain version must be given (it reads the rows past a count with a zero
    weight)."""
    j = torch.arange(blocks.shape[1], device=blocks.device)
    keep = j[None, :] < counts.to(blocks.device).long()[:, None]
    return torch.where(keep[:, :, None], blocks, torch.zeros((), dtype=blocks.dtype,
                                                             device=blocks.device))


def _fwd_args(inp):
    lists = inp["lists"]
    return inp["table"], lists.sorted_ids, lists.starts, lists.counts, inp["k"]


def chain_fwd(inp):
    """The parent route's forward: the sorted stream, then each tile's window."""
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy

    lists = inp["lists"]
    return seg_copy(kcuda.sorted_stream(inp["table"], lists.sorted_ids, inp["k"]), lists.starts,
                    inp["k"])


def chain_bwd(g, entry_slots, n_rows):
    """The parent route's backward: a zero row appended, one row gathered for
    every candidate entry, the sum over M."""
    from splat_tpu_torch.ops.cuda.row_gather import row_gather

    width, n = g.shape[2], n_rows - 1
    d_slots = torch.cat([g.reshape(-1, width), g.new_zeros((1, width))])
    d_table = g.new_zeros((n_rows, width))
    d_table[:n] = row_gather(d_slots, entry_slots).reshape(n, -1, width).sum(dim=1)
    return d_table


def check(inp) -> dict:
    """The kernels against their plain versions and the chain; raises on a
    mismatch."""
    from splat_tpu_torch.ops.cuda import tile_fetch as tf

    lists, k = inp["lists"], inp["k"]
    table, g = inp["table"], inp["g"]
    n_rows, n_tiles = table.shape[0], lists.counts.shape[0]
    with torch.no_grad():
        before = (tf.tile_fetch_fwd.launches, tf.tile_fetch_bwd.launches)
        got = counted_rows(tf.tile_fetch_fwd(*_fwd_args(inp), impl="cuda"), lists.counts)
        again = counted_rows(tf.tile_fetch_fwd(*_fwd_args(inp), impl="cuda"), lists.counts)
        want = counted_rows(tf.tile_fetch_fwd_plain(table, lists.sorted_ids, lists.starts, k),
                               lists.counts)
        chain = counted_rows(chain_fwd(inp), lists.counts)
        if not (torch.equal(got, want) and torch.equal(got, chain) and torch.equal(got, again)):
            raise AssertionError("tile_fetch_fwd: counted rows differ from the plain version, "
                                 "the chain or the second launch")
        slots = lists.entry_slots
        d = tf.tile_fetch_bwd(g, slots, n_rows, impl="cuda")
        d2 = tf.tile_fetch_bwd(g, slots, n_rows, impl="cuda")
        d_plain = tf.tile_fetch_bwd_plain(g, slots, n_rows)
        if not (torch.equal(d, d2) and torch.equal(d, d_plain)):
            raise AssertionError("tile_fetch_bwd: not bitwise its plain version and repeatable")
        if not bool(torch.isfinite(d).all()):
            raise AssertionError("tile_fetch_bwd read a row past a tile's count")
        n = n_rows - 1
        landed = (slots.reshape(n, -1) < n_tiles * k).sum(dim=1) if n else slots.new_zeros(0)
        if d[n].any() or (n and d[:n][landed == 0].any()):
            raise AssertionError("tile_fetch_bwd: the pad row or an unlanded row is not zero")
        old = chain_bwd(g, slots, n_rows)
        few = torch.cat([landed <= 2, landed.new_ones(1, dtype=torch.bool)])
        if not torch.equal(d[few], old[few]):
            raise AssertionError("tile_fetch_bwd: differs from the chain where at most two "
                                 "entries land")
        scale = chain_bwd(g.abs(), slots, n_rows)
        m_landed = torch.cat([landed, landed.new_zeros(1)]).to(torch.float32)[:, None]
        excess = ((d - old).abs() - 2.0 * m_landed * 2.0 ** -24 * scale).max().item()
        if excess > 0:
            raise AssertionError(f"tile_fetch_bwd: beyond float32 rounding of the chain by "
                                 f"{excess:.3g}")
        launched = (tf.tile_fetch_fwd.launches - before[0], tf.tile_fetch_bwd.launches - before[1])
    return {"rows": n, "tiles": n_tiles, "k": k, "landed": int(lists.counts.sum()),
            "stream": int(lists.sorted_ids.shape[0]), "max_landed_a_gaussian": int(landed.max()),
            "bitwise_chain_rows": int(few.sum()) - 1, "launches": list(launched)}


def bytes_bound(inp) -> dict:
    """Each input read once and each output written once. Forward: each
    counted row's id and block row, the table row of each Gaussian with a
    counted row (once, though it lands in several tiles), and each tile's
    start and count. Backward: entry_slots, d_table and each landed slot's
    gradient row."""
    lists, table = inp["lists"], inp["table"]
    landed, width = int(lists.counts.sum()), table.shape[1] * 4
    n, n_slots = table.shape[0] - 1, lists.counts.shape[0] * inp["k"]
    distinct = int((lists.entry_slots.reshape(n, -1) < n_slots).any(dim=1).sum()) if n else 0
    return {"fwd": landed * (4 + width) + distinct * width + 8 * lists.counts.shape[0],
            "bwd": lists.entry_slots.numel() * 4 + table.shape[0] * width + landed * width}


def bench(inp, runs=10, reps=3) -> dict:
    """ms of each kernel, its plain version and the chain it replaces."""
    from splat_tpu_torch.ops.cuda import tile_fetch as tf
    from splat_tpu_torch.utils.profiling import time_cuda

    lists, k, table, g = inp["lists"], inp["k"], inp["table"], inp["g"]
    slots, n_rows = lists.entry_slots, table.shape[0]
    with torch.no_grad():
        out = {
            "fwd_ms": time_cuda(lambda: tf.tile_fetch_fwd(*_fwd_args(inp), impl="cuda"), runs,
                                reps),
            "fwd_plain_ms": time_cuda(
                lambda: tf.tile_fetch_fwd_plain(table, lists.sorted_ids, lists.starts, k), 3),
            "fwd_chain_ms": time_cuda(lambda: chain_fwd(inp), runs, reps),
            "bwd_ms": time_cuda(lambda: tf.tile_fetch_bwd(g, slots, n_rows, impl="cuda"), runs,
                                reps),
            "bwd_plain_ms": time_cuda(lambda: tf.tile_fetch_bwd_plain(g, slots, n_rows), 3),
            "bwd_chain_ms": time_cuda(lambda: chain_bwd(g, slots, n_rows), runs, reps)}
    nbytes = bytes_bound(inp)
    out.update({"fwd_bytes": nbytes["fwd"], "bwd_bytes": nbytes["bwd"],
                "fwd_bound_ms": nbytes["fwd"] / HBM_BYTES_PER_S * 1e3,
                "bwd_bound_ms": nbytes["bwd"] / HBM_BYTES_PER_S * 1e3})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--live", type=float, default=0.75)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cell", default=None, help="fetch a benchmark cell's binning instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_tile_fetch_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from splat_tpu_torch.utils.profiling import nvidia_smi

    dev = torch.device("cuda")
    bp = _bin_probe()
    bin_inputs = (bp.cell_inputs(dev, args.cell, args.seed) if args.cell
                  else bp.make_inputs(dev, rows=args.rows, live=args.live, seed=args.seed))
    inp = make_inputs(dev, bin_inputs, args.seed)
    res = {"card": nvidia_smi("name,power.limit"), **check(inp), **bench(inp)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
