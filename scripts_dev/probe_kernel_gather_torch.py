#!/usr/bin/env python3
"""Probe: row gather and scatter-accumulate by hand-written CUDA kernels, the
counterpart of `scripts_dev/probe_kernel_gather.py` at its shapes and seed.

    python3 scripts_dev/probe_kernel_gather_torch.py

Question: how fast do `row_gather` (out[t, j] = table[idx[t, j]]) and
`row_scatter` (acc[idx[t, j]] += g[t, j], in (t, j) order, no atomics; its
plan of the contributors' order made on the card too) move 64-byte rows,
beside PyTorch's indexing and `index_add_`? A (100,008, 16)
float32 table, 1024 x 512 int32 indices. Prints, for each kernel, whether it
is right and the ms per call of the kernel, its plain version and the library
call, with the card's name and power limit. Needs a CUDA device; exits
nonzero without one.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

T, K, N, P = 1024, 512, 100_000, 16
NPAD = ((N + 1 + 7) // 8) * 8
SCATTER_TOL = 1e-5      # of max|column|, against a float64 sum rounded to float32


def make_inputs(dev, t=T, k=K, n=N, p=P, seed=0):
    """The JAX probe's draws: idx (t, k) int32 in [0, n), a normal table of
    n padded to a multiple of 8 rows, normal rows g (t, k, p)."""
    rng = np.random.default_rng(seed)
    npad = ((n + 1 + 7) // 8) * 8
    idx = rng.integers(0, n, size=(t, k)).astype(np.int32)
    table = rng.normal(size=(npad, p)).astype(np.float32)
    g = rng.normal(size=(t, k, p)).astype(np.float32)
    return {"idx": torch.tensor(idx, device=dev), "table": torch.tensor(table, device=dev),
            "g": torch.tensor(g, device=dev)}


def check(inp) -> dict:
    """{"row_gather": max|err| (0: it moves bits), "row_scatter": the largest
    |kernel - float64 sum|, "row_scatter_share": that over max|column|};
    raises unless the gather is bitwise `table[idx]`, the plan kernels give
    `scatter_plan_plain`'s stable sort bit for bit, and the scatter is
    bitwise the sequential loop (`row_scatter_plain` on the CPU), with its
    plan made in the same call or handed in, and within SCATTER_TOL of the
    float64 sum."""
    from splat_tpu_torch.ops.cuda.row_gather import row_gather, row_gather_plain
    from splat_tpu_torch.ops.cuda.row_scatter import (row_scatter, row_scatter_plain,
                                                      scatter_plan, scatter_plan_plain)

    idx, table, g = inp["idx"], inp["table"], inp["g"]
    got = row_gather(table, idx, impl="cuda")
    if not torch.equal(got, row_gather_plain(table, idx)):
        raise RuntimeError("row_gather differs from table[idx]")
    n_rows, width = table.shape
    plan = scatter_plan(idx, n_rows, impl="cuda")
    want_plan = scatter_plan_plain(idx.cpu(), n_rows)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(plan, want_plan)):
        raise RuntimeError("scatter_plan kernels differ from the stable sort")
    acc = row_scatter(idx, g, n_rows, impl="cuda")
    if not torch.equal(acc, row_scatter(idx, g, n_rows, impl="cuda", plan=plan)):
        raise RuntimeError("row_scatter: a launch with the plan handed in differs")
    if not torch.equal(acc.cpu(), row_scatter_plain(idx.cpu(), g.cpu(), n_rows)):
        raise RuntimeError("row_scatter differs from the sequential loop")
    want = torch.zeros((n_rows, width), dtype=torch.float64, device=g.device).index_add_(
        0, idx.reshape(-1).long(), g.reshape(-1, width).double())
    err = (acc.double() - want).abs()
    share = (err.amax(dim=0) / want.abs().amax(dim=0)).max().item()
    if not share <= SCATTER_TOL:
        raise RuntimeError(f"row_scatter: {share:.3g} of max|column| from the float64 sum")
    return {"row_gather": 0.0, "row_scatter": err.max().item(), "row_scatter_share": share}


def bench(inp, runs=20, reps=10) -> dict:
    """ms per call: each kernel, its plain version and the library call,
    enqueued back to back (the 42 MB working sets then sit at the edge of the
    L2) and, as cold_ms, one at a time after the cache was overwritten; and
    the bytes each function must move (every input read once, every output
    written once; repeated table rows are read once)."""
    from splat_tpu_torch.ops.cuda.row_gather import row_gather, row_gather_plain
    from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, row_scatter_plain, scatter_plan
    from splat_tpu_torch.utils.profiling import time_cuda, time_cuda_cold

    idx, table, g = inp["idx"], inp["table"], inp["g"]
    n_rows, width = table.shape
    flat = idx.reshape(-1)
    rows = flat.numel()
    plan = scatter_plan(idx, n_rows, impl="cuda")
    zeros = torch.zeros_like(table)
    distinct = int(torch.unique(flat).numel())
    return {
        "row_gather": {
            "ms": time_cuda(lambda: row_gather(table, idx, impl="cuda"), runs, reps),
            "plain_ms": time_cuda(lambda: row_gather_plain(table, idx), runs, reps),
            "library_ms": time_cuda(lambda: torch.index_select(table, 0, flat), runs, reps),
            "cold_ms": time_cuda_cold(lambda: row_gather(table, idx, impl="cuda"), runs),
            "library_cold_ms": time_cuda_cold(lambda: torch.index_select(table, 0, flat), runs),
            "bytes": (rows + distinct) * width * 4 + rows * 4,
        },
        "row_scatter": {
            # the whole function: the plan kernels, then the sum
            "ms": time_cuda(lambda: row_scatter(idx, g, n_rows, impl="cuda"), runs, reps),
            "kernel_ms": time_cuda(lambda: row_scatter(idx, g, n_rows, impl="cuda", plan=plan),
                                   runs, reps),
            "plan_ms": time_cuda(lambda: scatter_plan(idx, n_rows, impl="cuda"), runs, reps),
            "plain_ms": time_cuda(lambda: row_scatter_plain(idx, g, n_rows), runs, reps),
            # float32 index_add_ on the card: atomics, in no fixed order
            "library_ms": time_cuda(
                lambda: zeros.zero_().index_add_(0, flat, g.reshape(-1, width)), runs, reps),
            "cold_ms": time_cuda_cold(lambda: row_scatter(idx, g, n_rows, impl="cuda"), runs),
            "kernel_cold_ms": time_cuda_cold(
                lambda: row_scatter(idx, g, n_rows, impl="cuda", plan=plan), runs),
            "library_cold_ms": time_cuda_cold(
                lambda: zeros.zero_().index_add_(0, flat, g.reshape(-1, width)), runs),
            "bytes": rows * width * 4 + rows * 4 + n_rows * width * 4,
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_kernel_gather_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.utils.profiling import nvidia_smi

    inp = make_inputs(torch.device("cuda"))
    errs = check(inp)
    print(f"A gather correct: True (bitwise); B scatter correct: True (plan bitwise the "
          f"stable sort, sums bitwise the sequential loop, {errs['row_scatter_share']:.3g} of "
          f"max|column| from the float64 sum)")
    res = bench(inp)
    a, b = res["row_gather"], res["row_scatter"]
    print(f"A row_gather {T}x{K} rows of {P} floats: {a['ms']:.4f} ms/call "
          f"(plain table[idx] {a['plain_ms']:.4f}, index_select {a['library_ms']:.4f}; "
          f"cold cache {a['cold_ms']:.4f}, index_select {a['library_cold_ms']:.4f}; "
          f"{a['bytes']} bytes)")
    print(f"B row_scatter: {b['ms']:.4f} ms/call with its plan (plan {b['plan_ms']:.4f}, sum "
          f"given the plan {b['kernel_ms']:.4f}; plain index_add_ {b['plain_ms']:.4f}, "
          f"index_add_ in place {b['library_ms']:.4f}; cold cache {b['cold_ms']:.4f}, sum "
          f"{b['kernel_cold_ms']:.4f}, index_add_ {b['library_cold_ms']:.4f}; {b['bytes']} bytes)")
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
