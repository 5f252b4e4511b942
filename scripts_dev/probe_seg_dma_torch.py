#!/usr/bin/env python3
"""Probe: per-tile segment fetch by asynchronous copies into shared memory,
the counterpart of `scripts_dev/probe_seg_dma.py` at its shapes and seed.

    python3 scripts_dev/probe_seg_dma_torch.py

Question: does staging `tps` tiles per thread block through shared memory
with `cp.async` (`seg_dma`), from each window's start or from a start floored
to `align` rows, beat the direct copy (`seg_copy`) or PyTorch's row gather?
T = 4096 tiles of K = 256 rows from an (800,000 + K, 16) float32 stream.
Prints whether each variant is bitwise right and its ms per call beside
`seg_copy`, the plain version and `index_select`, with the card's name and
power limit. Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

T, K, P = 4096, 256, 16
L = 800_000
VARIANTS = [(1, 0), (4, 0), (8, 0), (4, 8), (4, 32), (4, 128)]      # (tps, align)


def variant_name(tps: int, align: int) -> str:
    return f"tps={tps}" + (f" align={align}" if align else "")


def make_inputs(dev, t=T, k=K, p=P, length=L, seed=0):
    """The JAX probe's draws: sorted starts with segments averaging ~70 rows,
    a normal stream of length + k rows."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 140, size=t)
    starts = np.minimum(np.concatenate([[0], np.cumsum(seg)[:-1]]), length - 1).astype(np.int32)
    src = rng.normal(size=(length + k, p)).astype(np.float32)
    return {"sp": torch.tensor(src, device=dev), "starts": torch.tensor(starts, device=dev),
            "k_pad": k}


def check(inp, variants=VARIANTS) -> dict:
    """{variant: 0.0}; raises if a variant differs from the plain gather."""
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy_plain
    from splat_tpu_torch.ops.cuda.seg_dma import seg_dma

    sp, starts, k_pad = inp["sp"], inp["starts"], inp["k_pad"]
    want = seg_copy_plain(sp, starts, k_pad)
    for tps, align in variants:
        if not torch.equal(seg_dma(sp, starts, k_pad, tps=tps, align=align, impl="cuda"), want):
            raise RuntimeError(f"seg_dma {variant_name(tps, align)} differs from the plain gather")
    return {variant_name(*v): 0.0 for v in variants}


def bench(inp, runs=20, reps=10, variants=VARIANTS) -> dict:
    """ms per call of every variant, of seg_copy, the plain version and
    index_select, enqueued back to back, and (cold_ms, seg_copy_cold_ms) of
    the fastest variant and seg_copy one at a time after the cache was
    overwritten; and the bytes the function must move (each stream row a
    window covers read once, every output row written once)."""
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy, seg_copy_plain
    from splat_tpu_torch.ops.cuda.seg_dma import seg_dma
    from splat_tpu_torch.utils.profiling import time_cuda, time_cuda_cold

    sp, starts, k_pad = inp["sp"], inp["starts"], inp["k_pad"]
    n_tiles = starts.shape[0]
    pos = (starts.long()[:, None] + torch.arange(k_pad, device=sp.device)).reshape(-1)
    rows_read = int(torch.unique(pos).numel())
    out = {"variants": {}}
    for tps, align in variants:
        out["variants"][variant_name(tps, align)] = time_cuda(
            lambda: seg_dma(sp, starts, k_pad, tps=tps, align=align, impl="cuda"), runs, reps)
    out["ms"] = min(out["variants"].values())
    best = min(variants, key=lambda v: out["variants"][variant_name(*v)])
    out["best"] = variant_name(*best)
    out["cold_ms"] = time_cuda_cold(
        lambda: seg_dma(sp, starts, k_pad, tps=best[0], align=best[1], impl="cuda"), runs)
    out["seg_copy_cold_ms"] = time_cuda_cold(lambda: seg_copy(sp, starts, k_pad, impl="cuda"),
                                             runs)
    out["seg_copy_ms"] = time_cuda(lambda: seg_copy(sp, starts, k_pad, impl="cuda"), runs, reps)
    out["plain_ms"] = time_cuda(lambda: seg_copy_plain(sp, starts, k_pad), runs, reps)
    out["library_ms"] = time_cuda(lambda: torch.index_select(sp, 0, pos), runs, reps)
    out["bytes"] = (rows_read + n_tiles * k_pad) * sp.shape[1] * 4 + n_tiles * 4
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_seg_dma_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.utils.profiling import nvidia_smi

    inp = make_inputs(torch.device("cuda"))
    check(inp)
    print(f"all {len(VARIANTS)} seg_dma variants bitwise equal to the plain gather: True")
    res = bench(inp)
    print(f"A plain gather sp[starts + arange(K)] {res['plain_ms']:.4f} ms/call, index_select "
          f"{res['library_ms']:.4f}, seg_copy (direct copy) {res['seg_copy_ms']:.4f}; "
          f"{res['bytes']} bytes")
    for name, ms in res["variants"].items():
        print(f"B/C seg_dma {name:16s} {ms:.4f} ms/call")
    print(f"cold cache: seg_dma {res['best']} {res['cold_ms']:.4f} ms/call, seg_copy "
          f"{res['seg_copy_cold_ms']:.4f}")
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
