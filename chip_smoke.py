#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (splat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
  1. build the three CUDA kernels with nvcc (in parallel) and print the
     environment: card, power limit, torch / CUDA versions, TF32 flags;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (the binning of the first camera): seg_copy bitwise,
     the forward compositor at atol 1e-4 on rgb and T and 1e-3 on depth_acc
     (expf and summation order), the backward compositor on a seeded
     cotangent (pixel sums in another order) within 1e-5 of max|plain| per
     column and per column in each 64-slot batch, and 1e-3 of each row's
     max; each also at S = 1 and with 16x8 tiles;
  3. the render path: 4 cameras at 1024x1024 from a 100k-Gaussian model (the
     bench scene, random SH from a seed) through `render_camera` with the
     default config (5 fused blur samples, rolling shutter, SH degree 3,
     tile 16, K = 256, camera and velocity optimizers on), counting kernel
     launches, and the images checked (finite, not constant, equal to
     impl="torch"); then the render time per camera;
  4. the main path, training: targets rendered from a perturbed copy of the
     model; on one camera the loss and every leaf's gradient (and the
     means2d probe's) against the impl="torch" route (plain forward and
     backward over the dense id table: loss rtol 1e-5, each leaf within
     1e-3 * max|leaf gradient|) and bitwise equal over two evaluations; then
     20 `train_step`s from step 3000 cycling the 4 cameras, counting
     launches: everything finite, the loss falling, the backward kernel
     launched on every step; then the step time and peak memory;
  5. time each kernel, its plain version and a library yardstick on phase
     2's inputs, beside the least time the card could take;
  6. print the `kernels` JSON line (launches from the 20 training steps),
     the card's name and power limit as nvidia-smi gives them, and the
     result line.

Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_GAUSS = 100_000
RES = 1024
N_CAMERAS = 4
SEED = 0
TIMED_RUNS = 10
KERNEL_RUNS = 20
KERNEL_REPS = 10

# Peak rates of the card named by nvidia-smi (NVIDIA data sheets; the SXM
# part at its 700 W limit). FP32 and SFU rates come from the SM count and the
# card's maximum SM clock: 128 FP32 lanes (2 flops per FMA) and 16 SFU ops
# per SM per clock.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
# The compositors' operations, counted where this run's data needs them:
FLOPS_PER_PAIR = 5        # sigma and lo, for every live (Gaussian, pixel, sample)
FLOPS_PER_ROW_PIXEL = 23  # dx0, dy0 and the A, B coefficients, per live (Gaussian, pixel)
FLOPS_PER_ROW = 11        # the tile-local mean and the C coefficient, per live row
FWD_FLOPS_PER_HIT = 12    # alpha clamp, weight, 4 accumulates, T update, per compositing pair
# the backward's: alpha clamp, w, v, contrib, prefix, suffix, the 4 colour
# terms with their sums over samples and pixels, and T, per compositing pair;
# d_sigma, dx, dy and the 8 moments with their sums, per pair below the alpha
# clamp; the 16 output columns from the 12 sums, per live row
BWD_FLOPS_PER_HIT = 22
BWD_FLOPS_PER_SIGMA = 22
BWD_FLOPS_PER_ROW = FLOPS_PER_ROW + 17
# |kernel - plain| of the backward: per column, to the column's max|plain|;
# per column within each 64-slot batch, to that batch's max; per (tile, slot)
# row, to the row's max over its 12 columns (where a row's pixel sum cancels,
# the two summation orders differ by a few 1e-5 of the row's max)
BWD_TOL = {"column": 1e-5, "batch": 1e-5, "row": 1e-3}
TRAIN_STEPS = 20
TRAIN_START = 3000       # SH degree 3 from the start


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_scene(n, seed=0):
    """The bench scene (bench.py:make_scene), in numpy."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.7, 0.6, 1.2]) + np.array([0, 0, 4.0])
    scales = np.exp(rng.normal(size=(n, 3)) * 0.6) * 0.010
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    return means, scales, quats, colors, opac


def model_tree(seed=SEED):
    means, scales, quats, colors, opac = make_scene(N_GAUSS, seed)
    rng = np.random.default_rng(seed + 1)
    c0 = 0.28209479177387814
    f32 = np.float32
    return {
        "gaussians": {
            "means": means.astype(f32), "scales_log": np.log(scales).astype(f32),
            "quats": quats.astype(f32), "opacities_logit": np.log(opac / (1 - opac)).astype(f32),
            "features_dc": ((colors - 0.5) / c0).astype(f32),
            "features_rest": (rng.normal(size=(N_GAUSS, 15, 3)) * 0.05).astype(f32),
            "alive": np.ones(N_GAUSS, f32),
        },
        "background_logit": np.zeros(3, f32),
        "camera_opt": {"phi": (rng.normal(size=(N_CAMERAS, 3)) * 2e-3).astype(f32),
                       "dp": (rng.normal(size=(N_CAMERAS, 3)) * 5e-3).astype(f32)},
        "velocity_opt": {"dv": (rng.normal(size=(N_CAMERAS, 3)) * 0.02).astype(f32),
                         "dom": (rng.normal(size=(N_CAMERAS, 3)) * 0.01).astype(f32)},
    }


def camera_fields(seed=SEED):
    """Poses near identity (the scene sits at z ~ 4 in front), seeded."""
    rng = np.random.default_rng(seed + 2)
    rot = rng.normal(size=(N_CAMERAS, 3)) * 0.02
    R = []
    for w in rot:
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R.append(np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    f32 = np.float32
    ones = np.ones(N_CAMERAS, f32)
    return dict(
        R_c2w=np.stack(R).astype(f32), p_c2w=(rng.normal(size=(N_CAMERAS, 3)) * 0.05).astype(f32),
        fx=ones * 0.9 * RES, fy=ones * 0.9 * RES, cx=ones * RES / 2, cy=ones * RES / 2,
        width=RES, height=RES,
        lin_vel=np.tile(f32([0.4, -0.2, 0.1]), (N_CAMERAS, 1)),
        ang_vel=np.tile(f32([0.05, 0.1, -0.02]), (N_CAMERAS, 1)),
        exposure_time=ones * 0.06, rolling_shutter_time=ones * 0.03,
    )


def target_tree(seed=SEED):
    """The model with every mean moved by 0.01 and colours from another seed:
    what the targets are rendered from."""
    tree = model_tree(seed)
    g = dict(tree["gaussians"])
    rng = np.random.default_rng(seed + 7)
    g["means"] = g["means"] + np.float32(0.01)
    g["features_dc"] = ((rng.uniform(0.0, 1.0, size=(N_GAUSS, 3)) - 0.5)
                        / 0.28209479177387814).astype(np.float32)
    return dict(tree, gaussians=g)


def bwd_errors(got: torch.Tensor, want: torch.Tensor, batch: int = 64) -> dict:
    """The largest |kernel - plain| over the backward's 12 gradient columns as
    a share of max|plain| per column, per column within each batch of
    `batch` slots, and per (tile, slot) row. An error where the plain scale
    is 0 counts as infinite."""
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


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_cuda(fn, runs: int, reps: int = 1) -> float:
    """Median over `runs` of the ms per call of `reps` calls enqueued back to
    back between two CUDA events, after one warm-up. With reps > 1 the later
    calls queue up while the card runs the earlier ones (when the host
    enqueues faster than the card runs), so a short kernel's time carries the
    host's launch latency once in `reps` calls rather than in every one."""
    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2

    from splat_tpu_torch.engine import trainer
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.models import strategy
    from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
    from splat_tpu_torch.cameras import optimizers as cam_opt
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import rasterize, tiling
    from splat_tpu_torch.ops.cuda import build
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy, seg_copy_plain

    dev = torch.device("cuda")
    # phase 1: build and environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    t0 = time.perf_counter()
    report = build.build(["seg_copy", "rasterize_fwd", "rasterize_bwd"])
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(report) or 'cached'}")
    for name, r in report.items():
        info = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: {r['seconds']:.2f} s; " + " | ".join(info[:4]))
    card = nvidia_smi("name,power.limit")
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    print(f"env: {card}; {props.multi_processor_count} SMs, max SM clock {max_clock_mhz} MHz; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    name = torch.cuda.get_device_name(0)
    hbm = next((v for k, v in HBM_BYTES_PER_S.items() if k in name), None)
    check(hbm is not None, f"a memory rate for {name!r} in HBM_BYTES_PER_S")
    fp32_peak = props.multi_processor_count * 128 * 2 * max_clock_mhz * 1e6
    sfu_peak = props.multi_processor_count * 16 * max_clock_mhz * 1e6

    params = params_from_numpy(model_tree(), device=dev)
    cams = cameras_from_numpy(camera_fields(), device=dev)
    cfg = sf.SplatfactoConfig(
        camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
        camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True),
    )
    K = cfg.max_per_tile
    bg = sf.background_color(params, cfg)
    opac = torch.sigmoid(params.gaussians.opacities_logit) * params.gaussians.alive

    # phase 2: each kernel against its plain version at the main path's shapes
    def kernel_inputs(tile_size):
        motion = sf.camera_motion(params, cams[0], cfg)
        t_a = motion.eps.mean()
        proj, colors = sf.subframe_inputs(params, motion, cfg, cfg.sh_degree, t_a)
        eps = motion.eps - t_a
        lists = rasterize.bin_tiles(proj, opac, RES, RES, eps, motion.rs_time, tile_size,
                                    K, cfg.max_tiles_per_gaussian)
        sp = kcuda.sorted_stream(kcuda.pack_param_table(proj, colors, opac), lists.sorted_ids, K)
        return lists, sp, eps, motion.rs_time

    errs = {}
    with torch.no_grad():
        lists, sp, eps, rs = kernel_inputs(cfg.tile_size)
        blocks = seg_copy(sp, lists.starts, K, impl="cuda")
        check(torch.equal(blocks, seg_copy_plain(sp, lists.starts, K)), "seg_copy bitwise")
        errs["seg_copy"] = 0.0
        tiles_x = tiling.num_tiles(RES, RES, cfg.tile_size)[0]
        fwd_args = (blocks, lists.counts, rs, cfg.tile_size, tiles_x, RES)
        work = None
        for label, e in (("S=5", eps), ("S=1", None)):
            got = rk.rasterize_fwd(*fwd_args, eps=e, impl="cuda")
            want, w = rk.rasterize_fwd_plain(
                blocks, lists.counts, rk.scalar_vec(rs, 0.0, e, dev), cfg.tile_size,
                tiles_x, RES, count_work=True)
            work = work or w
            err_c = (got[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
            err_d = (got[:, :, 3] - want[:, :, 3]).abs().max().item()
            print(f"rasterize_fwd vs plain, tile 16, {label}: max|err| rgb/T {err_c:.3g}, "
                  f"depth {err_d:.3g}")
            check(err_c <= 1e-4 and err_d <= 1e-3, f"rasterize_fwd {label} within tolerance")
            errs["rasterize_fwd"] = max(errs.get("rasterize_fwd", 0.0), err_c, err_d)
        lists_r, sp_r, eps_r, rs_r = kernel_inputs((16, 8))
        blocks_r = seg_copy(sp_r, lists_r.starts, K, impl="cuda")
        check(torch.equal(blocks_r, seg_copy_plain(sp_r, lists_r.starts, K)),
              "seg_copy bitwise, 16x8 tiles")
        r_args = (blocks_r, lists_r.counts, rs_r, (16, 8), tiling.num_tiles(RES, RES, (16, 8))[0],
                  RES)
        got = rk.rasterize_fwd(*r_args, eps=eps_r, impl="cuda")
        want = rk.rasterize_fwd(*r_args, eps=eps_r, impl="torch")
        err_c = (got[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
        err_d = (got[:, :, 3] - want[:, :, 3]).abs().max().item()
        print(f"rasterize_fwd vs plain, tile 16x8, S=5: max|err| rgb/T {err_c:.3g}, "
              f"depth {err_d:.3g}")
        check(err_c <= 1e-4 and err_d <= 1e-3, "rasterize_fwd 16x8 within tolerance")
        errs["rasterize_fwd"] = max(errs["rasterize_fwd"], err_c, err_d)

        def check_bwd(label, blk, lst, e, tile, tx_, full_h):
            """The backward kernel against its plain version on a seeded
            cotangent; returns the inputs and the plain version's work."""
            scal = rk.scalar_vec(rs, 0.0, e, dev)
            fwd = rk.rasterize_fwd(blk, lst.counts, rs, tile, tx_, full_h, eps=e, impl="cuda")
            g_out = torch.randn(fwd.shape, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(SEED))
            args = (blk, lst.counts, scal, fwd, g_out, tile, tx_, full_h)
            got = rk.rasterize_bwd(*args, impl="cuda")
            want, w = rk.rasterize_bwd_plain(*args, count_work=True)
            check(not got[:, :, rk.NPARAM - 1:].any(), f"rasterize_bwd {label}: zero columns")
            shares = bwd_errors(got, want)
            err = (got - want).abs().max().item()
            errs["rasterize_bwd"] = max(errs.get("rasterize_bwd", 0.0), err)
            print(f"rasterize_bwd vs plain, {label}: max|err| {err:.3g}; as a share of "
                  f"max|plain| per column {shares['column']:.3g}, per column and 64-slot batch "
                  f"{shares['batch']:.3g}, per row {shares['row']:.3g}")
            for kind, tol in BWD_TOL.items():
                check(shares[kind] <= tol, f"rasterize_bwd {label}: per-{kind} share "
                      f"{shares[kind]:.3g} within {tol}")
            return args, w

        bwd_args, bwd_work = check_bwd("tile 16, S=5", blocks, lists, eps, cfg.tile_size,
                                       tiles_x, RES)
        check_bwd("tile 16, S=1", blocks, lists, None, cfg.tile_size, tiles_x, RES)
        check_bwd("tile 16x8, S=5", blocks_r, lists_r, eps_r, (16, 8), r_args[4], RES)
        del lists_r, sp_r, blocks_r, got, want

        # phase 3: the render path at full width, counting launches
        seg_copy.launches = 0
        rk.rasterize_fwd.launches = 0
        rk.rasterize_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = [sf.render_camera(params, cams[i], cfg, cfg.sh_degree, bg)
                  for i in range(N_CAMERAS)]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / N_CAMERAS
        render_launches = {"seg_copy": seg_copy.launches,
                           "rasterize_fwd": rk.rasterize_fwd.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"render path: {N_CAMERAS} cameras, launches {render_launches}, "
              f"first pass {first_ms:.1f} ms/camera, peak memory {peak_gib:.2f} GiB")
        for k, n in render_launches.items():
            check(n > 0, f"{k} launched on the render path")
        check(rk.rasterize_bwd.launches == 0, "no backward launched by a render")
        for i, out in enumerate(images):
            check(out.rgb.shape == (RES, RES, 3), f"camera {i} image shape")
            check(bool(torch.isfinite(out.rgb).all() and torch.isfinite(out.depth).all()),
                  f"camera {i} finite")
            check(out.rgb.std().item() > 1e-2, f"camera {i} not constant")
        ref = sf.render_camera(params, cams[0], dataclasses.replace(cfg, impl="torch"),
                               cfg.sh_degree, bg)
        diff = (images[0].rgb - ref.rgb).abs().max().item()
        print(f"camera 0 vs impl='torch': max|linear rgb diff| {diff:.3g}; "
              f"coverage mean alpha {images[0].alpha.mean().item():.3f}")
        check(diff <= 1e-3, "render matches the plain route")
        del images, ref

        def render_all():
            for i in range(N_CAMERAS):
                sf.render_camera(params, cams[i], cfg, cfg.sh_degree, bg)
        render_all()
        per_cam = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_all()
            torch.cuda.synchronize()
            per_cam.append((time.perf_counter() - t0) * 1e3 / N_CAMERAS)
        qs = statistics.quantiles(per_cam, n=4)
        print(f"render: median {statistics.median(per_cam):.3f} ms/camera over {TIMED_RUNS} "
              f"runs of {N_CAMERAS} cameras (quartiles {qs[0]:.3f} / {qs[2]:.3f}, "
              f"max {max(per_cam):.3f})")

    # phase 4: the main path, training at full width
    target = params_from_numpy(target_tree(), device=dev)
    with torch.no_grad():
        gts = [sf.gamma_encode(sf.render_camera(target, cams[i], cfg, cfg.sh_degree,
                                                sf.background_color(target, cfg)).rgb, cfg)
               for i in range(N_CAMERAS)]
    del target
    groups = trainer.param_groups(params)
    leaves = [(f"{label}[{i}]", p) for label, group in groups.items() for i, p in enumerate(group)]

    def loss_and_grads(c):
        """Camera 0's loss, and the gradient of every leaf and of the probe."""
        for _, p in leaves:
            p.grad = None
            p.requires_grad_(True)
        probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
        out = sf.render_camera(params, cams[0], c, cfg.sh_degree, sf.background_color(params, c),
                               means2d_probe=probe)
        loss, _ = sf.compute_losses(sf.gamma_encode(out.rgb, c), gts[0], params, c)
        loss.backward()
        return loss.detach(), [p.grad.clone() for _, p in leaves] + [probe.grad]

    loss_k, grads_k = loss_and_grads(cfg)
    loss_k2, grads_k2 = loss_and_grads(cfg)
    check(torch.equal(loss_k, loss_k2)
          and all(torch.equal(a, b) for a, b in zip(grads_k, grads_k2)),
          "the kernel route's loss and gradients are bitwise repeatable")
    loss_t, grads_t = loss_and_grads(dataclasses.replace(cfg, impl="torch"))
    loss_rel = abs(loss_k.item() - loss_t.item()) / abs(loss_t.item())
    print(f"gradients, camera 0: loss {loss_k.item():.6f} (kernel route) vs {loss_t.item():.6f} "
          f"(impl='torch'), rel diff {loss_rel:.3g}; two kernel-route evaluations bitwise equal")
    check(loss_rel <= 1e-5, "loss matches the plain route")
    for (leaf, _), a, b in zip(leaves + [("means2d_probe", None)], grads_k, grads_t):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        print(f"  d {leaf}: max|kernel - torch| {err:.3g}, max|grad| {scale:.3g}")
        check(err <= 1e-3 * scale, f"gradient of {leaf} matches the plain route")
    del grads_k, grads_k2, grads_t

    opt = trainer.Optimizer(params, trainer.TrainerConfig())
    state = strategy.init_strategy_state(N_GAUSS, seed=SEED, device=dev)
    for kern in (seg_copy, rk.rasterize_fwd, rk.rasterize_bwd):
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, n_visible = [], []
    for i in range(TRAIN_STEPS):
        loss, aux, state = trainer.train_step(params, opt, state, cfg, cams[i % N_CAMERAS],
                                              gts[i % N_CAMERAS], TRAIN_START + i)
        losses.append(loss)
        n_visible.append(aux["n_visible"])
    torch.cuda.synchronize()
    launches = {"seg_copy": seg_copy.launches, "rasterize_fwd": rk.rasterize_fwd.launches,
                "rasterize_bwd": rk.rasterize_bwd.launches}
    losses = torch.stack(losses).tolist()
    print(f"train: {TRAIN_STEPS} steps from step {TRAIN_START}, launches {launches}; losses "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; n_visible {[int(v) for v in n_visible[:N_CAMERAS]]}; "
          f"max grad_count {int(state.grad_count.max())}")
    for k, n in launches.items():
        check(n >= TRAIN_STEPS, f"{k} launched on every training step")
    check(all(np.isfinite(losses)), "training losses finite")
    check(all(bool(torch.isfinite(p).all()) for p in opt.params), "parameters finite")
    check(all(bool(torch.isfinite(v).all()) for st in opt.adam.state.values()
              for v in st.values() if torch.is_tensor(v)), "optimizer state finite")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, f"loss falls: mean of the last 4 steps {last:.5f} "
                        f"vs the first 4 {first:.5f}")
    step_ms = []
    for i in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(params, opt, state, cfg, cams[i % N_CAMERAS], gts[i % N_CAMERAS],
                           TRAIN_START + TRAIN_STEPS + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    qs = statistics.quantiles(step_ms, n=4)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step: median {statistics.median(step_ms):.3f} ms over {TIMED_RUNS} steps "
          f"after {TRAIN_STEPS} warm-up steps (quartiles {qs[0]:.3f} / {qs[2]:.3f}, "
          f"max {max(step_ms):.3f}); peak memory {train_peak_gib:.2f} GiB; loss "
          f"{first:.5f} -> {last:.5f} (mean of 4 steps)")
    for _, p in leaves:
        p.requires_grad_(False)

    with torch.no_grad():
        # phase 5: the kernels' times, on phase 2's inputs (the initial model)
        counts = lists.counts.long()
        n_tiles = counts.shape[0]
        npix = tiling.tile_wh(cfg.tile_size)[0] * tiling.tile_wh(cfg.tile_size)[1]
        n_s = eps.shape[0]
        landed = int(counts.sum())
        pairs_all = landed * npix * n_s
        print(f"binning: landed entries {landed}, tile overflow {int(lists.overflow)}, "
              f"clipped {int(lists.clipped)}, sorted stream {lists.sorted_ids.shape[0]}; "
              f"pairs sum_t min(count,K)*npix*S = {pairs_all}, "
              f"live pairs (before T <= 1e-4) = {work['live_pairs']}, compositing pairs "
              f"{work['hit_pairs']}, live (row, pixel) steps {work['live_row_pixels']}, "
              f"live rows {work['live_rows']}")

        pos = (lists.starts.long()[:, None] + torch.arange(K, device=dev)).reshape(-1)
        seg_ms = time_cuda(lambda: seg_copy(sp, lists.starts, K, impl="cuda"), KERNEL_RUNS,
                           KERNEL_REPS)
        seg_plain_ms = time_cuda(lambda: seg_copy_plain(sp, lists.starts, K), KERNEL_RUNS,
                                 KERNEL_REPS)
        seg_lib_ms = time_cuda(lambda: torch.index_select(sp, 0, pos), KERNEL_RUNS, KERNEL_REPS)
        # each stream row read once, though neighbouring tiles' windows overlap
        seg_rows_read = int(torch.unique(pos).numel())
        seg_bytes = (seg_rows_read + n_tiles * K) * sp.shape[1] * 4 + n_tiles * 4
        seg_bound = seg_bytes / hbm * 1e3

        fwd_ms = time_cuda(lambda: rk.rasterize_fwd(*fwd_args, eps=eps, impl="cuda"),
                           KERNEL_RUNS, KERNEL_REPS)
        fwd_plain_ms = time_cuda(lambda: rk.rasterize_fwd(*fwd_args, eps=eps, impl="torch"), 5)
        fwd_bytes = (work["live_rows"] * rk.PARAM_STRIDE * 4 + n_tiles * 4
                     + n_tiles * n_s * rk.NOUT * npix * 4)
        fwd_flops = (work["live_pairs"] * FLOPS_PER_PAIR + work["hit_pairs"] * FWD_FLOPS_PER_HIT
                     + work["live_row_pixels"] * FLOPS_PER_ROW_PIXEL
                     + work["live_rows"] * FLOPS_PER_ROW)
        fwd_times = {"bytes": fwd_bytes / hbm * 1e3,
                     "operations": max(fwd_flops / fp32_peak, work["hit_pairs"] / sfu_peak) * 1e3}
        fwd_bound_by = max(fwd_times, key=fwd_times.get)
        print(f"seg_copy: {seg_ms:.4f} ms (plain {seg_plain_ms:.4f}, index_select "
              f"{seg_lib_ms:.4f}, bound {seg_bound:.4f} ms from {seg_bytes} B: "
              f"{seg_rows_read} stream rows read, {n_tiles * K} written)")
        print(f"rasterize_fwd: {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}; bound "
              f"{fwd_times[fwd_bound_by]:.4f} ms by {fwd_bound_by}: {fwd_flops} flop at "
              f"{fp32_peak / 1e12:.1f} TFLOP/s, {work['hit_pairs']} exp at "
              f"{sfu_peak / 1e12:.2f} T/s, {fwd_bytes} B)")

        bwd_ms = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="cuda"), KERNEL_RUNS,
                           KERNEL_REPS)
        bwd_plain_ms = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="torch"), 3)
        bw = bwd_work
        bwd_bytes = (bw["live_rows"] * rk.PARAM_STRIDE * 4 + n_tiles * 4
                     + 2 * n_tiles * n_s * rk.NOUT * npix * 4 + n_tiles * K * rk.PARAM_STRIDE * 4)
        bwd_flops = (bw["live_pairs"] * FLOPS_PER_PAIR + bw["hit_pairs"] * BWD_FLOPS_PER_HIT
                     + bw["sigma_pairs"] * BWD_FLOPS_PER_SIGMA
                     + bw["live_row_pixels"] * FLOPS_PER_ROW_PIXEL
                     + bw["live_rows"] * BWD_FLOPS_PER_ROW)
        bwd_times = {"bytes": bwd_bytes / hbm * 1e3,
                     "operations": max(bwd_flops / fp32_peak, bw["hit_pairs"] / sfu_peak) * 1e3}
        bwd_bound_by = max(bwd_times, key=bwd_times.get)
        print(f"rasterize_bwd: {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}; bound "
              f"{bwd_times[bwd_bound_by]:.4f} ms by {bwd_bound_by}: {bwd_flops} flop at "
              f"{fp32_peak / 1e12:.1f} TFLOP/s from {bw['live_pairs']} live pairs, "
              f"{bw['hit_pairs']} compositing ({bw['sigma_pairs']} below the clamp), "
              f"{bw['live_row_pixels']} live (row, pixel) steps, {bw['live_rows']} live rows; "
              f"{bw['hit_pairs']} exp at {sfu_peak / 1e12:.2f} T/s; {bwd_bytes} B)")

    kernels = [
        {"name": "seg_copy", "route": "cuda", "source": "splat_tpu_torch/ops/cuda/csrc/seg_copy.cu",
         "replaces": "splat_tpu/ops/pallas/seg_copy.py:75", "launches": launches["seg_copy"],
         "max_abs_err": errs["seg_copy"], "ms": seg_ms, "plain_ms": seg_plain_ms,
         "bound_ms": seg_bound, "bound_by": "bytes", "library_ms": seg_lib_ms},
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/rasterize_fwd.cu",
         "replaces": "splat_tpu/ops/pallas/rasterize_kernels_gmajor.py:538",
         "launches": launches["rasterize_fwd"], "max_abs_err": errs["rasterize_fwd"],
         "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_times[fwd_bound_by],
         "bound_by": fwd_bound_by, "library_ms": None},
        {"name": "rasterize_bwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/rasterize_bwd.cu",
         "replaces": "splat_tpu/ops/pallas/rasterize_kernels.py:636",
         "launches": launches["rasterize_bwd"], "max_abs_err": errs["rasterize_bwd"],
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_times[bwd_bound_by],
         "bound_by": bwd_bound_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)  # as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
