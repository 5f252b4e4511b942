#!/usr/bin/env python3
"""Probe: exclusive cumulative sum along the chunk axis by hand-written CUDA
kernels, the counterpart of `scripts_dev/probe_cumsum.py` at its shape and
seed.

    python3 scripts_dev/probe_cumsum_torch.py

Question: how close to the memory rate does the prefix along the 128 rows of
each (128, 1024) block run, walked in order by one thread per pixel column
("seq") or laid across a warp and scanned with shuffles ("warp"), beside
`torch.cumsum`? x is (512, 128, 1024) float32. Prints whether each variant is
right (against `np.cumsum(x, 0) - x` at the JAX probe's atol 1e-3, and at
1e-6 of the largest value) and the ms per call of each variant, the plain
version and `torch.cumsum(x, 1) - x`, with the card's name and power limit.
Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CHUNK, NPIX, T = 128, 1024, 512
VARIANTS = ("seq", "warp")
CHECK_BLOCKS = 8        # blocks held against numpy on the host


def make_inputs(dev, t=T, chunk=CHUNK, npix=NPIX, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, chunk, npix)) * 0.01).astype(np.float32)
    return {"x": torch.tensor(x, device=dev)}


def check(inp) -> dict:
    """{variant: max|err| against np.cumsum(x, 0) - x over the first
    blocks}; raises beyond atol 1e-3 (the JAX probe's bound), beyond 1e-6 of
    the largest value, or if a variant differs from the plain version on the
    card by more than 1e-6 of the largest value anywhere."""
    from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum, chunk_cumsum_plain

    x = inp["x"]
    host = x[:CHECK_BLOCKS].cpu().numpy()
    want = np.cumsum(host, axis=1) - host
    plain = chunk_cumsum_plain(x)
    scale = plain.abs().max().item()
    errs = {}
    for variant in VARIANTS:
        got = chunk_cumsum(x, variant=variant, impl="cuda")
        err = float(np.abs(got[:CHECK_BLOCKS].cpu().numpy() - want).max())
        everywhere = (got - plain).abs().max().item()
        if not (err <= 1e-3 and err <= 1e-6 * scale + 1e-9 and everywhere <= 1e-6 * scale):
            raise RuntimeError(f"chunk_cumsum {variant}: max|err| {err:.3g} against numpy, "
                               f"{everywhere:.3g} against the plain version (scale {scale:.3g})")
        errs[variant] = max(err, everywhere)
    return errs


def bench(inp, runs=10, reps=5) -> dict:
    """ms per call of both variants, the plain version and the library call,
    and the bytes the function must move (x read once, out written once)."""
    from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum, chunk_cumsum_plain
    from splat_tpu_torch.utils.profiling import time_cuda

    x = inp["x"]
    out = {"variants": {v: time_cuda(lambda v=v: chunk_cumsum(x, variant=v, impl="cuda"),
                                     runs, reps) for v in VARIANTS}}
    out["ms"] = min(out["variants"].values())
    out["plain_ms"] = time_cuda(lambda: chunk_cumsum_plain(x), runs, reps)
    out["library_ms"] = time_cuda(lambda: torch.cumsum(x, 1) - x, runs, reps)
    out["bytes"] = 2 * x.numel() * 4
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cumsum_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.utils.profiling import nvidia_smi

    inp = make_inputs(torch.device("cuda"))
    errs = check(inp)
    res = bench(inp)
    for variant in VARIANTS:
        print(f"chunk_cumsum {variant:5s} {res['variants'][variant]:8.4f} ms/pass  correct=True "
              f"(max|err| {errs[variant]:.3g})")
    print(f"plain (shifted torch.cumsum) {res['plain_ms']:.4f} ms/pass, torch.cumsum(x, 1) - x "
          f"{res['library_ms']:.4f}; {res['bytes']} bytes")
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
