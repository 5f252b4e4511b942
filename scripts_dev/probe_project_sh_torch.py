#!/usr/bin/env python3
"""Probe: the projection and SH kernel pair (`ops/cuda/csrc/project_sh.cu`)
against the plain route it replaces, at the training path's size.

    python3 scripts_dev/probe_project_sh_torch.py

Inputs: 2^20 Gaussian slots in front of a 1920x1080 camera (fx 1400), a
quarter of them dead (scales 3e-4, the rest in view or past its edges, some
behind the camera), SH degree 3 with the active degree 3, velocities on.
Questions: do the kernels compute what the plain route
(`projection.project_gaussians` and `sh_eval_switch`, and autograd through
them) computes, every output and every gradient (the camera's included),
and how long do they take beside their bytes' bound and the plain versions?
Prints one JSON line. Needs a CUDA device; exits nonzero without one.

Tolerances (`TOL`), |kernel - plain route| over max|plain route| of each
output or gradient: the two do the same float32 work in another order (the
plain route's 3x3 products and SH sum are cuBLAS calls, contracted into
FMAs; the kernels round every product) and the conics' and compensations'
determinant cancels, so the forward agrees to 5e-5 and each gradient to 1e-4
of its largest entry (on an H100 80GB HBM3: 8.4e-6 and 2.4e-5 at most).
radii, extents and valid are ceil() and comparisons of those values: radii
and extents may differ only where the value before ceil lies within float32
rounding (1e-5 relative) of an integer; valid only at the comparisons'
thresholds (counted). The backward is bitwise equal over two launches, and
the frozen Gaussians' camera-only backward equals the full one's camera
gradient. `hold_fwd` / `hold_bwd` hold a recorded launch against the plain
closed form (the kernels' own order) at the same TOL.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 1 << 20
W, H, FX = 1920, 1080, 1400.0
DEGREE = 3
TOL = {"forward": 5e-5, "gradient": 1e-4, "ceil_rel": 1e-5}
FWD_NAMES = ("means2d", "depths", "conics", "compensations", "pix_vels")
LEAVES = ("means", "scales_log", "quats", "features_dc", "features_rest")
CAMERA = ("R_c2w", "p_c2w", "lin_vel", "ang_vel")


def make_inputs(dev, n=N, seed=0):
    rng = np.random.default_rng(seed)
    k = (DEGREE + 1) ** 2
    z = rng.uniform(-1.0, 14.0, size=n)
    xy = rng.normal(size=(n, 2)) * np.maximum(z, 1.0)[:, None] * [0.45, 0.3]
    g = {"means": np.concatenate([xy, z[:, None]], axis=1),
         "scales_log": rng.normal(size=(n, 3)) * 0.6 - 4.0,
         "quats": rng.normal(size=(n, 4)),
         "features_dc": rng.normal(size=(n, 3)) * 0.6,
         "features_rest": rng.normal(size=(n, k - 1, 3)) * 0.2}
    dead = rng.random(n) < 0.25
    g["scales_log"][dead] = -8.0
    out = {name: torch.tensor(a, dtype=torch.float32, device=dev) for name, a in g.items()}
    from splat_tpu_torch.ops import se3
    out["R_c2w"] = se3.so3_exp(torch.tensor([0.02, -0.03, 0.01], device=dev))
    out["p_c2w"] = torch.tensor([0.1, -0.05, 0.2], device=dev)
    out["lin_vel"] = torch.tensor([0.4, -0.2, 0.3], device=dev)
    out["ang_vel"] = torch.tensor([0.3, 0.5, -0.2], device=dev)
    out["intr"] = tuple(torch.tensor(a, device=dev) for a in (FX, FX, W / 2, H / 2))
    cot = {"means2d": (n, 2), "depths": (n,), "conics": (n, 3), "compensations": (n,),
           "pix_vels": (n, 2), "colors": (n, 3)}
    out["cot"] = {name: torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                  for name, s in cot.items()}
    return out


def _leaves(inp, grad: bool):
    return {k: inp[k].detach().clone().requires_grad_(grad) for k in LEAVES + CAMERA}


def plain_route(x, degree=DEGREE):
    from splat_tpu_torch.models.splatfacto import sh_eval_switch
    from splat_tpu_torch.ops import projection

    fx, fy, cx, cy = x["intr"]
    R_cw = x["R_c2w"].T
    proj = projection.project_gaussians(
        x["means"], torch.exp(x["scales_log"]), x["quats"], R_cw,
        -torch.matmul(R_cw, x["p_c2w"]), fx, fy, cx, cy, W, H,
        lin_vel=x["lin_vel"], ang_vel=x["ang_vel"])
    dirs = x["means"] - x["p_c2w"]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
    coeffs = torch.cat([x["features_dc"][:, None, :], x["features_rest"]], dim=1)
    return proj, sh_eval_switch(degree, DEGREE, dirs, coeffs)


def kernel_route(x, degree=DEGREE):
    from splat_tpu_torch.ops.cuda.project_sh import project_sh

    fx, fy, cx, cy = x["intr"]
    return project_sh(x["means"], x["scales_log"], x["quats"], x["features_dc"],
                      x["features_rest"], x["R_c2w"], x["p_c2w"], fx, fy, cx, cy, W, H, degree,
                      lin_vel=x["lin_vel"], ang_vel=x["ang_vel"])


def _loss(proj, colors, cot):
    return (sum((getattr(proj, k) * cot[k]).sum() for k in FWD_NAMES)
            + (colors * cot["colors"]).sum())


def _grads(route, inp):
    x = _leaves(inp, True)
    x["intr"] = inp["intr"]
    proj, colors = route(x)
    names = LEAVES + CAMERA
    grads = torch.autograd.grad(_loss(proj, colors, inp["cot"]), [x[k] for k in names])
    return proj, colors, dict(zip(names, grads))


def _camera(inp):
    from splat_tpu_torch.ops.cuda import project_sh as ps

    return ps.camera_vector(inp["R_c2w"], inp["p_c2w"], inp["lin_vel"], inp["ang_vel"],
                            *inp["intr"])


def _ceil_inputs(means, scales_log, quats, cam, img_w=W, img_h=H):
    """The values radii and extents take the ceiling of, from the plain
    closed form's intermediates (the kernels' arithmetic)."""
    from splat_tpu_torch.ops.cuda import project_sh as ps

    t = ps._terms(means, scales_log, quats, cam, img_w, img_h, False)
    mid = 0.5 * (t.a_d + t.c_d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - t.det, min=0.01))
    return (3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)),
            3.0 * torch.sqrt(torch.clamp(torch.stack([t.a_d, t.c_d], -1), min=0.0)))


def _unexplained_ceil(want, got, pre_radii, pre_extents) -> dict:
    """radii / extents / valid mismatches between two projections, and how
    many of them lie away from an integer (which raises in the callers)."""
    near = lambda v: (v - torch.round(v)).abs() <= TOL["ceil_rel"] * v.abs().clamp(min=1.0)  # noqa: E731
    both = want.valid & got.valid
    counts, bad = {}, 0
    for name, pre, mask in (("radii", pre_radii, both), ("extents", pre_extents, both[:, None])):
        diff = getattr(want, name) != getattr(got, name)
        counts[name] = int(diff.sum())
        bad += int((diff & ~near(pre) & mask).sum())
    counts["valid"] = int((want.valid != got.valid).sum())
    return {"counts": counts, "unexplained": bad}


def hold_fwd(args, out) -> float:
    """A recorded launch of the forward kernel against the plain closed form
    on the same inputs at TOL; returns the worst share of max|plain|."""
    from splat_tpu_torch.ops.cuda import project_sh as ps
    from splat_tpu_torch.ops.projection import ProjectedGaussians

    want = ps.project_sh_fwd_plain(*args)
    worst = 0.0
    for i, (a, b) in enumerate(zip(want, out)):
        if i in (3, 6, 7):          # radii, valid, extents
            continue
        worst = max(worst, ((a - b).abs().max() / a.abs().max().clamp(min=1e-30)).item())
    pw, pg = ProjectedGaussians(*want[:8]), ProjectedGaussians(*out[:8])
    ceil = _unexplained_ceil(pw, pg, *_ceil_inputs(args[0], args[1], args[2], args[5],
                                                   args[7], args[8]))
    if worst > TOL["forward"] or ceil["unexplained"]:
        raise RuntimeError(f"project_sh_fwd against its plain version: {worst:.3g} of max|plain|,"
                           f" {ceil['unexplained']} ceil mismatches away from an integer")
    return worst


def hold_bwd(args, out) -> float:
    """A recorded launch of the backward kernels against the plain closed
    form on the same inputs and cotangents at TOL; returns the worst share."""
    from splat_tpu_torch.ops.cuda import project_sh as ps

    want = ps.project_sh_bwd_plain(*args)
    worst = 0.0
    for a, b in zip(want, out):
        if (a is None) != (b is None):
            raise RuntimeError("project_sh_bwd wrote another set of gradients than asked for")
        if a is not None and a.numel():
            worst = max(worst, ((a - b).abs().max() / a.abs().max().clamp(min=1e-30)).item())
    if not worst <= TOL["gradient"]:
        raise RuntimeError(f"project_sh_bwd against its plain version: {worst:.3g} of "
                           f"max|plain|")
    return worst


def check(inp) -> dict:
    """Every output and gradient of the kernels against the plain route, at
    TOL; radii / extents / valid mismatches counted and each explained; the
    backward bitwise over two launches. Raises on a failure; returns the
    errors and counts."""
    from splat_tpu_torch.ops.cuda import project_sh as ps

    with torch.no_grad():
        pp, cp = plain_route({**inp})
        pk, ck = kernel_route({**inp})
    errs, counts = {}, {}
    for name in FWD_NAMES:
        a, b = getattr(pp, name), getattr(pk, name)
        errs[name] = ((a - b).abs().max() / a.abs().max()).item()
    errs["colors"] = ((cp - ck).abs().max() / cp.abs().max()).item()
    ceil = _unexplained_ceil(pp, pk, *_ceil_inputs(inp["means"], inp["scales_log"],
                                                   inp["quats"], _camera(inp)))
    counts.update(ceil["counts"])
    if ceil["unexplained"]:
        raise RuntimeError(f"project_sh: {ceil['unexplained']} radii or extents differ away "
                           f"from an integer")
    for name, err in errs.items():
        if not err <= TOL["forward"]:
            raise RuntimeError(f"project_sh forward {name}: {err:.3g} of max|plain route|")

    _, _, g_plain = _grads(plain_route, inp)
    _, _, g_kernel = _grads(kernel_route, inp)
    _, _, g_again = _grads(kernel_route, inp)
    for name in g_plain:
        a, b = g_plain[name], g_kernel[name]
        err = ((a - b).abs().max() / a.abs().max()).item()
        errs[f"d_{name}"] = err
        if not err <= TOL["gradient"]:
            raise RuntimeError(f"project_sh gradient of {name}: {err:.3g} of max|plain route|")
        if not torch.equal(b, g_again[name]):
            raise RuntimeError(f"project_sh gradient of {name} differs between two launches")
    frozen = {k: inp[k] for k in LEAVES}
    x = {**frozen, **{k: inp[k].detach().clone().requires_grad_(True) for k in CAMERA},
         "intr": inp["intr"]}
    before = ps.project_sh_bwd.launches
    proj, colors = kernel_route(x)
    d_cam = torch.autograd.grad(_loss(proj, colors, inp["cot"]), [x[k] for k in CAMERA])
    for name, g in zip(CAMERA, d_cam):
        if not torch.equal(g, g_kernel[name]):
            raise RuntimeError(f"project_sh: the frozen Gaussians' camera gradient of {name} "
                               f"differs from the full backward's")
    counts["frozen_bwd_launches"] = ps.project_sh_bwd.launches - before
    return {"errs": errs, "mismatches": counts}


def bytes_moved(n=N, degree=DEGREE) -> dict:
    """Bytes the two functions must move: each input read once, each output
    written once (float32, valid a byte)."""
    rest = 3 * ((degree + 1) ** 2 - 1)
    inputs = 4 * n * (3 + 3 + 4 + 3 + rest)
    outputs = n * (4 * (2 + 1 + 3 + 1 + 1 + 2 + 2 + 3) + 1)
    cot = 4 * n * (2 + 1 + 3 + 1 + 2 + 3)
    return {"fwd": inputs + outputs, "bwd": 2 * inputs + cot}


def bench(inp, runs=20, reps=10) -> dict:
    """ms per call of each kernel, the plain versions (the module's closed
    form, and the plain route with autograd) and the bytes' bound at 3.35
    TB/s."""
    from splat_tpu_torch.ops.cuda import project_sh as ps
    from splat_tpu_torch.utils.profiling import time_cuda

    args = [inp[k] for k in LEAVES] + [_camera(inp), DEGREE, W, H, True]
    grads = tuple(inp["cot"][k] for k in (*FWD_NAMES, "colors"))
    out = {"fwd_ms": time_cuda(lambda: ps.project_sh_fwd(*args), runs, reps),
           "bwd_ms": time_cuda(lambda: ps.project_sh_bwd(*args, grads), runs, reps),
           "fwd_plain_ms": time_cuda(lambda: ps.project_sh_fwd_plain(*args), 3, 1),
           "bwd_plain_ms": time_cuda(lambda: ps.project_sh_bwd_plain(*args, grads), 3, 1)}

    def route_fwd_bwd(route):
        x = _leaves(inp, True)
        x["intr"] = inp["intr"]
        proj, colors = route(x)
        torch.autograd.grad(_loss(proj, colors, inp["cot"]), [x[k] for k in LEAVES + CAMERA])

    with torch.no_grad():
        out["route_fwd_ms"] = time_cuda(lambda: plain_route({**inp}), 5, 2)
    out["route_fwd_bwd_ms"] = time_cuda(lambda: route_fwd_bwd(plain_route), 5, 2)
    out["kernel_fwd_bwd_ms"] = time_cuda(lambda: route_fwd_bwd(kernel_route), 5, 2)
    b = bytes_moved()
    out["fwd_bound_ms"] = b["fwd"] / 3.35e12 * 1e3
    out["bwd_bound_ms"] = b["bwd"] / 3.35e12 * 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_project_sh_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from splat_tpu_torch.ops.cuda import build
    from splat_tpu_torch.utils.profiling import nvidia_smi

    report = build.build(["project_sh"])
    if "project_sh" in report:
        print(report["project_sh"]["log"][-3000:], flush=True)
    inp = make_inputs("cuda")
    res = check(inp)
    res["times"] = bench(inp)
    res["card"] = nvidia_smi("name,power.limit")
    res["n"] = N
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
