#!/usr/bin/env python3
"""Probe: the compositor's backward with the blur samples stacked on the
pixel axis, the counterpart of `scripts_dev/probe_bwd_stacked.py` at its scene.

    python3 scripts_dev/probe_bwd_stacked_torch.py [--plain]

Question: does one thread per stacked (sample, pixel) row, S a run-time value
and `tps` tiles per thread block in turn (`bwd_stacked`), beat one thread per
pixel with the samples summed in registers (`rasterize_bwd`)? The probe's
scene: 100,000 Gaussians at 1024 x 1024, tile 16, K = 256, 8 tiles per
Gaussian, S = 5, rolling shutter 0.03 s. Prints each tps's error relative to
`rasterize_bwd` (max|diff| / max|reference|, as the JAX probe does) and its ms
per call beside `rasterize_bwd`'s, with the card's name and power limit; with
--plain the kernel is also held against `bwd_stacked_plain`. Needs a CUDA
device; exits nonzero without one.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N, RES, TILE, MPT, MTPG, S = 100_000, 1024, 16, 256, 8, 5
RS_TIME = 0.03
TPS = (8, 4, 2, 1)
# of max|plain| per column, and per column in each 64-slot batch; of each
# (tile, slot) row's max: the kernels sum over pixels in another order
TOL = {"column": 1e-5, "batch": 1e-5, "row": 1e-3}


def make_inputs(dev, n=N, res=RES, tile=TILE, k=MPT, mtpg=MTPG, n_samples=S, seed=0):
    """The JAX probe's scene and draws: the per-tile blocks (T, K, 16), the
    counts, the scalars, the forward output and a seeded cotangent."""
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import projection, tiling
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy

    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.7, 0.6, 1.2]) + np.array([0, 0, 4.0])
    scales = np.exp(rng.normal(size=(n, 3)) * 0.6) * 0.010
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    colors = rng.uniform(size=(n, 3))
    opac = rng.uniform(0.3, 0.95, size=(n,))

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    fx = res * 0.9
    with torch.no_grad():
        proj = projection.project_gaussians(
            f32(means), f32(scales), f32(q), torch.eye(3, device=dev), torch.zeros(3, device=dev),
            fx, fx, res / 2, res / 2, res, res, lin_vel=f32([0.4, -0.2, 0.1]),
            ang_vel=f32([0.05, 0.1, -0.02]))
        eps = torch.linspace(-0.5, 0.5, n_samples, device=dev) * 0.06
        pad = proj.pix_vels.abs().amax(dim=-1) * (0.03 + 0.5 * 0.03)
        lists = tiling.build_tile_lists(proj.means2d, proj.extents, proj.depths, proj.valid,
                                        res, res, tile, k, mtpg, radius_pad=pad)
        table = kcuda.pack_param_table(proj, f32(colors), f32(opac))
        blocks = seg_copy(kcuda.sorted_stream(table, lists.sorted_ids, k), lists.starts, k)
        tiles_x = tiling.num_tiles(res, res, tile)[0]
        scalars = rk.scalar_vec(RS_TIME, 0.0, eps, dev)
        fwd = rk.rasterize_fwd(blocks, lists.counts, RS_TIME, tile, tiles_x, res, eps=eps)
        g_out = f32(np.random.default_rng(1).normal(size=tuple(fwd.shape))) * 0.1
    return {"args": (blocks, lists.counts, scalars, fwd.contiguous(), g_out, tile, tiles_x, res)}


def shares(got: torch.Tensor, want: torch.Tensor, batch: int = 64) -> dict:
    """The largest |got - want| over the 12 gradient columns as a share of
    max|want| per column, per column within each `batch` slots, and per
    (tile, slot) row; an error where the scale is 0 counts as infinite."""
    err = (got[:, :, :12] - want[:, :, :12]).abs()
    ref = want[:, :, :12].abs()

    def share(e, m):
        r = e / m
        r[e == 0] = 0.0
        return r.max().item()

    return {"column": share(err.amax(dim=(0, 1)), ref.amax(dim=(0, 1))),
            "batch": max(share(err[:, j:j + batch].amax(dim=(0, 1)),
                               ref[:, j:j + batch].amax(dim=(0, 1)))
                         for j in range(0, got.shape[1], batch)),
            "row": share(err.amax(dim=2), ref.amax(dim=2))}


def check(inp, tps_list=TPS, plain: torch.Tensor | None = None) -> dict:
    """Every tps against `rasterize_bwd`'s kernel (and against `plain`, the
    stacked plain version's result, when given) within TOL, bitwise equal to
    the other tps (the sums do not depend on it) and over two launches.
    Returns {"max_abs_err", "relerr": {tps: max|diff| / max|reference|},
    "shares": against the reference kernel, "plain_shares"}."""
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked

    args = inp["args"]
    ref = rk.rasterize_bwd(*args, impl="cuda")
    out = {"relerr": {}, "shares": None, "plain_shares": None, "max_abs_err": 0.0}
    first = None
    for tps in tps_list:
        got = bwd_stacked(*args, tps=tps, impl="cuda")
        if not torch.equal(got, bwd_stacked(*args, tps=tps, impl="cuda")):
            raise RuntimeError(f"bwd_stacked tps={tps}: two launches differ")
        if first is None:
            first = got
            if got[:, :, 12:].any():
                raise RuntimeError("bwd_stacked: the log-opacity and pad columns are not zero")
            for name, want in (("shares", ref), ("plain_shares", plain)):
                if want is None:
                    continue
                out[name] = shares(got, want)
                for kind, tol in TOL.items():
                    if not out[name][kind] <= tol:
                        raise RuntimeError(
                            f"bwd_stacked vs {'rasterize_bwd' if want is ref else 'its plain version'}"
                            f": per-{kind} share {out[name][kind]:.3g} above {tol}")
            out["max_abs_err"] = (got - (ref if plain is None else plain)).abs().max().item()
        elif not torch.equal(got, first):
            raise RuntimeError(f"bwd_stacked tps={tps} differs from tps={tps_list[0]}")
        out["relerr"][tps] = ((got - ref).abs().max() / (ref.abs().max() + 1e-30)).item()
    return out


def bench(inp, runs=20, reps=10, tps_list=TPS) -> dict:
    """ms per call of `bwd_stacked` at every tps and of `rasterize_bwd`,
    enqueued back to back; "ms" is the fastest tps's ("best")."""
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked
    from splat_tpu_torch.utils.profiling import time_cuda

    args = inp["args"]
    out = {"tps": {tps: time_cuda(lambda: bwd_stacked(*args, tps=tps, impl="cuda"), runs, reps)
                   for tps in tps_list}}
    out["best"] = min(out["tps"], key=out["tps"].get)
    out["ms"] = out["tps"][out["best"]]
    out["rasterize_bwd_ms"] = time_cuda(lambda: rk.rasterize_bwd(*args, impl="cuda"), runs, reps)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bwd_stacked_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.ops.cuda import build
    from splat_tpu_torch.utils.profiling import nvidia_smi

    report = build.build(["bwd_stacked", "rasterize_bwd", "rasterize_fwd", "seg_copy",
                          "row_gather"])
    for line in report.get("bwd_stacked", {}).get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    inp = make_inputs(torch.device("cuda"))
    plain = None
    if "--plain" in sys.argv[1:]:
        from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked_plain
        plain = bwd_stacked_plain(*inp["args"])
    errs = check(inp, plain=plain)
    res = bench(inp)
    print(f"{'bwd current (per-pixel threads)':44s} {res['rasterize_bwd_ms']:8.4f} ms")
    for tps in TPS:
        label = f"bwd stacked tps={tps} (relerr {errs['relerr'][tps]:.2e})"
        print(f"{label:44s} {res['tps'][tps]:8.4f} ms")
    s = errs["shares"]
    print(f"against rasterize_bwd: per column {s['column']:.3g}, per column and 64-slot batch "
          f"{s['batch']:.3g}, per row {s['row']:.3g} of the scale's max; every tps bitwise equal, "
          f"two launches bitwise equal")
    if plain is not None:
        s = errs["plain_shares"]
        print(f"against bwd_stacked_plain: per column {s['column']:.3g}, per column and 64-slot "
              f"batch {s['batch']:.3g}, per row {s['row']:.3g}")
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
