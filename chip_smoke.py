#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (splat_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:
  1. build the eleven CUDA kernel libraries with nvcc (in parallel) and print
     the environment: card, power limit, torch / CUDA versions, TF32 flags;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (the binning of the first camera): seg_copy bitwise,
     the forward compositor at atol 1e-4 on rgb and T and 1e-3 on depth_acc
     (expf and summation order), the backward compositor on a seeded
     cotangent (pixel sums in another order) within 1e-5 of max|plain| per
     column and per column in each 64-slot batch, and 1e-3 of each row's
     max; each also at S = 1 and with 16x8 tiles, and both on the adversarial
     rows of `scripts_dev/probe_cull_torch.py` (S = 16, 16x16 and 16x8 tiles:
     fast motion, near-degenerate conics, opacities under the floor, rows
     grazing a warp's pixels), each bitwise equal over two launches, and the
     per-warp cull never clearing a group where a pair composites; the
     fetch pair (`scripts_dev/probe_tile_fetch_torch.py`) at camera 0's
     binning (tile 16 and 16x8) and on a depth slab's receive buffer of 2^23
     rows: the forward's counted rows bitwise its plain version and the
     chain it replaced, the backward bitwise its plain version and over two
     launches, reading no row past a count, within float32 rounding of the
     chain's gather-and-sum; row_gather bitwise at the chain's two shapes
     (the sorted ids over the parameter table, the entry slots over the slot
     gradients; off the training path) and at its probe's; seg_dma in
     both variants (tps 1, 4, 8; align 8, 32, 128) bitwise on the same
     stream; row_scatter within 1e-5 of max|column| of a float64 sum and
     bitwise repeatable, and chunk_cumsum in both variants, at their probes'
     shapes (`scripts_dev/probe_*_torch.py`); bwd_stacked at the backward
     compositor's inputs and bounds, against its own plain version (the
     stacked formulation) and against the rasterize_bwd kernel, bitwise equal
     over two launches and over tps; the projection and SH pair
     (`scripts_dev/probe_project_sh_torch.py`) against the plain route at
     2^20 slots, degree 3, velocities: every output within 5e-5 and every
     gradient (the camera's included) within 1e-4 of max|plain route|, the
     radii / extents mismatches each within float32 rounding of an integer
     before ceil, the backward bitwise equal over two launches and the
     frozen Gaussians' backward a camera-only launch; the binning kernels
     (`scripts_dev/probe_bin_tiles_torch.py`) against the plain route
     (impl "torch") at camera 0's binning (tile 16 and 16x8) and on a depth
     slab's receive buffer of 2^23 rows, 3/8 of them live: counts, starts,
     overflow, clipped, entry_overflow, entry_slots and the real count
     bitwise, sorted_ids bitwise below the real entries, two launches
     bitwise equal, tile_population equal;
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
     10 `train_step`s from step 3000 cycling the 4 cameras, counting
     launches: everything finite, the loss falling, the backward kernel
     launched on every step and the fetch pair once an anchor group (row_gather
     and seg_copy not at all); then the step time and
     peak memory;
  5. the training loop at full width: `Trainer.run` for 200 steps on the
     same 100k Gaussians with 4 train and 2 eval cameras rendered from the
     perturbed model, on a schedule short enough to reach every branch
     (refine every 40 steps, opacity reset every 2 refines, the eval-camera
     step every 5): it must cull and densify, reset the opacities and skip
     the paused refine, grow the capacity with Adam's moments carried, grow
     max_per_tile on the second over-tolerance probe and carry on at the new
     K (where the three compositing kernels are held against their plain
     versions again), keep every record finite, and end with a higher eval
     PSNR than it started with; prints the step time and peak memory;
  6. the four probe entry points (`scripts_dev/probe_kernel_gather_torch.py`,
     `probe_seg_dma_torch.py`, `probe_cumsum_torch.py`,
     `probe_bwd_stacked_torch.py`): their timing loops are the path that
     launches row_scatter, seg_dma, chunk_cumsum and bwd_stacked;
  7. time each kernel, its plain version and a library yardstick on phase
     2's inputs (the probes' inputs for the probe kernels; the projection
     pair also beside the plain route it replaces; the binning at camera 0
     and on the 2^23-row buffer beside the plain route and torch.sort of
     the culled-in entries' keys; the fetch pair at the same two binnings
     and at the benchmark cell phone_mbrs.train's camera 0, beside its plain
     versions and the chain it replaced), beside the least
     time the card could take (for the compositors the smaller of two counts:
     every live pixel of a tile, or only the (row, warp) groups where a pair
     composites; both printed, with the share of groups the cull keeps and
     ptxas's registers and spills);
  8. train a scene from disk at full width: `data.synthetic.generate_scene`
     writes a 1024x1024 scene directory (exposure and rolling shutter on,
     100,000 seed points), `cli.fit.main` trains it with the flagship flags
     (5 blur samples, rolling-shutter compensation, SO3xR3 pose and velocity
     optimisation, eval cameras optimised) on the default schedule for 300
     steps, every one on all 100,000 Gaussians, with an eval and a checkpoint
     at 100, 200 and 300. The parsed cameras and decoded frames are first held
     against the generator's own Gaussians, rendered through the trainer's
     eval path (at least 35 dB on a camera's own frame, 15 dB less on
     another's); the eval PSNR must rise by 0.5 dB; a fresh `Trainer` loads
     the middle checkpoint, runs to the end and is compared with the last
     checkpoint of the uninterrupted run (bitwise is expected; within 1e-6 it
     passes and says so); `cli.evaluate` reloads the last checkpoint and
     reproduces the PSNR in `metrics.json`; then two trainers carry that
     checkpoint on for 40 steps across two refines, one of them from the
     other's checkpoint taken before the first, and end in the same state;
     prints the decoder and its time per image, the generation time, steps
     per second, the checkpoint's size and its save and load times, and peak
     memory;
  9. the user's path at the synthetic suite's published width
     (`render_tools_phase`): `cli.generate_synthetic_suite` writes
     synthetic-mb/scene0 (512 px, 1500 Gaussians, 33 frames, 17 ground-truth
     blur samples) and prints its seconds per frame; `python -m
     splat_tpu_torch.cli.train --variants baseline,motion_blur --iters 300`
     trains both variants and renders their eval frames in subprocesses (rc
     0, the run tree, each metrics.json with a finite PSNR and its three time
     fields, one decodable, finite, non-constant `_pred` / `_gt` / `_depth`
     per eval frame, both rows found by `cli.parse_outputs`; steps/s per
     variant; each fit's four path kernels launched on every step); then, in
     this process, each path with the counts set to 0 just before it and
     read just after: `cli.render_video` (8 frames at 512 px that differ from
     the same path at `--blur_scale 0`; the forward kernels launched for
     every frame), the viewer (`/render` with exposure, rolling shutter and a
     crop box, `/export.ply` cropped to fewer vertices; the forward kernels
     launched for every render) and a 60-step `cli.fit --vis viewer` run that
     answers a render request while it trains (all four kernels on every
     step); `cli.export --min-opacity 0.005` (the PLY bitwise the trainer's
     alive, thresholded leaves) launches none. The kernels' own launches on
     three paths are recorded as the path made them (`KernelCapture`) and
     held against their plain versions at phase 2's tolerances (the
     projection pair among them, forward and backward): one more
     training step of the motion_blur run in this process (10 blur samples
     split into anchor groups at 512 px: each group size once, forward and
     backward), the first
     video frame (a path camera with simulated blur and rolling shutter) and
     the cropped viewer render; last,
     `ops.reference.render_reference` against the kernel route's `rasterize`
     (2,000 Gaussians at 256x256, rolling shutter 0.03 s, tile emulation):
     rgb, alpha, T and the alpha-weighted depth sum within 1e-5, the CPU
     test's tolerance;
 10. a phone capture's inputs at full width (`capture_phase`): phase 8's
     scene directory (1024x1024, 16 frames, 100,000 Gaussians) written as
     the external tools would have written it, the VIO's `transforms.json`
     (velocities, blur scores) and COLMAP's text model (PINHOLE camera,
     world-to-camera quaternions, the generator's Gaussian centres and
     colours as points3D.txt) in a world that is a similarity transform of
     the VIO's; then `run_colmap --text-model`, `combine`,
     `train_eval_split_by_blur_score`, `cli.fit` with `cli/train.py`'s
     flagship flags for colmap-sai-cli-vels-blur-scored (300 steps on all
     100,000 seed points) and `cli.evaluate` with LPIPS weights drawn from a
     seed. Gates: the merged poses map back to the generator's within 1e-4
     once the similarity is undone; the linear velocities equal s R times
     the VIO's in the merged world (angular ones carried as they are); the
     split keeps the least blurred frame of every eight; the generator's
     Gaussians, taken through the similarity and the parser's transform,
     render the parsed eval cameras at 35 dB against their decoded frames
     (15 dB less on another camera's); the four path
     kernels launch on every step of the fit; the eval PSNR rises 0.5 dB;
     one more step of the fit's trainer (outside the counted path) has its
     launches recorded and held against the plain versions at phase 2's
     tolerances (the compositors at S = 3 and 2, rolling shutter, 1024 px;
     the fetch pair bitwise); metrics.json has a finite lpips; LPIPS on the card within 1e-5 of the
     CPU's; `utils.trace_report` over a `torch.profiler` trace of five of
     the fit's steps lists the four path kernels. Prints each tool's
     seconds, steps/s, LPIPS's ms per eval image and the trace's table;
 11. the mesh (`mesh_phase`): the decompositions of `parallel/sharding.py`
     on the card in this process, each virtual rank in turn through the
     kernels, on phase 3's scene and camera 0: 4 row strips rendered with
     their row0 and joined, and an S = 4 exposure split 2 + 2 and summed,
     each against the full render within phase 2's 1e-4; 4 depth slabs
     composited apart (reduce=None) and merged with the over-operator,
     within T_EPS of a colour (a pixel's early stop: each slab composites on
     where the whole cloud stopped); the packed table's gradient of a
     seeded cotangent through the strips against the full image's within
     phase 2's per-column and per-row bounds (all at a K no tile fills);
     then `cli.fit --mesh.enabled True` on NCCL, one rank per visible card,
     on phase 8's scene and flags for 50 steps against the same fit without
     the mesh, in turns (single, mesh, mesh, single): the per-step loss's
     relative difference within 1e-4 in the median and 1e-3 at its largest,
     steps/s of all four, rank 0's launches (each path kernel on every
     step), and one more mesh step in this process recorded by
     `KernelCapture` and held against the plain versions;
 12. print the `kernels` JSON line (launches from the loop's 200 steps, and
     from the probes' timing loops for the four probe kernels; the launches of
     every driven path under `launches_by_path`), the card's name and power
     limit as nvidia-smi gives them, and the result line.

Needs a CUDA device; exits nonzero without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_GAUSS = 100_000
RES = 1024
N_CAMERAS = 4
N_EVAL_CAMERAS = 2
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
TRAIN_STEPS = 10
TRAIN_START = 3000       # SH degree 3 from the start
# the loop: a schedule short enough to reach every branch in LOOP_STEPS steps.
# Refines fall on steps 40, 80, 160 and 200: the one at 80 resets the
# opacities, the one at 120 is paused (4 train views + 40 steps have not
# passed), the one at 160 may not reset (no recovery window before the end).
LOOP_STEPS = 200
LOOP_SCHEDULE = dict(warmup_length=40, refine_every=40, reset_alpha_every=2,
                     sh_degree_interval=20, optimize_eval_cameras=True)
# alive share 0.977 at the start: the first densify fills the dead slots and
# the capacity doubles
LOOP_CAPACITY = 102_400
LOOP_SEED_POINTS = 20_000    # the seed cloud init_model sizes its scales from
# the scene trained from disk: 16 frames of which 2 (0 and 8) are eval frames;
# 100,000 small Gaussians (scale_mul: ~3 px on screen, a few tiles each), all
# of them seed points, so the trainer starts where the other phases do
FIT_FRAMES = 16
FIT_SCENE = dict(n_gaussians=N_GAUSS, n_frames=FIT_FRAMES, img_size=RES, exposure=0.06,
                 rolling_shutter=0.03, n_blur_samples=5, seed=SEED, n_seed_points=N_GAUSS,
                 trajectory="shake", scale_mul=0.15)
FIT_STEPS = 300
FIT_FLAGS = [
    "--max-num-iterations", str(FIT_STEPS), "--steps-per-eval", "100", "--steps-per-save", "100",
    "--seed", str(SEED), "--trainer.log-every", "50",
    "--pipeline.model.blur-samples", "5",
    "--pipeline.model.rolling-shutter-compensation", "True",
    "--pipeline.model.camera-optimizer.mode", "SO3xR3",
    "--pipeline.model.camera-velocity-optimizer.enabled", "True",
    "--pipeline.model.optimize-eval-cameras", "True",
    "--pipeline.model.initial-capacity", str(LOOP_CAPACITY),
    "nerfstudio-data", "--eval-mode", "interval", "--eval-interval", "8",
    "--orientation-method", "none"]
FIT_RESUME_FROM = 200
# on an NVIDIA H100 80GB HBM3 the generator's own Gaussians rendered on the
# parsed eval cameras read 43.6 dB against the decoded eval frames (16.1 against
# the other camera's frame, 17.8 for the initial model), and the eval PSNR
# rises 0.7 dB in 300 steps from a seed cloud whose position noise is three
# times a Gaussian's size
FIT_TRUTH_PSNR_DB = 35.0
FIT_PSNR_GAIN_DB = 0.5
REFINE_EVERY = 20            # of the two runs that carry the fit's checkpoint on
# phase 9: the suite's published width (cli/generate_synthetic_suite.py's
# defaults: 512 px, 1500 Gaussians, 33 frames, 17 ground-truth blur samples,
# seed 1000) and the synthetic parameter pack of cli/train.py (10 blur
# samples, gamma 2.2, cull scale 2.0, eval every 8th frame)
SUITE_RES = 512
SUITE_FRAMES = 33
SUITE_EVAL_FRAMES = 5            # frames 0, 8, 16, 24 and 32
MATRIX_STEPS = 300
MATRIX_VARIANTS = ("baseline", "motion_blur")
VIDEO_FPS, VIDEO_SECONDS = 8, 1
EXPORT_MIN_OPACITY = 0.005
VIEWER_RES = 256
LIVE_STEPS = 60
# the reference renderer against the kernel route: the tolerance of
# tests/test_torch_reference.py (rgb, alpha, T and the alpha-weighted depth
# sum within 1e-5)
REF_GAUSSIANS, REF_RES, REF_RS, REF_ATOL = 2000, 256, 0.03, 1e-5
# phase 10: phase 8's scene as a phone capture (COLMAP's world a similarity
# of the VIO's), through the real-capture tools and the flagship variant of
# cli/train.py for the colmap-sai-cli-vels-blur-scored dataset
CAPTURE_DATASET = "colmap-sai-cli-vels-blur-scored"
CAPTURE_FEATURES = {"motion_blur", "rolling_shutter", "pose_opt", "velocity_opt"}
CAPTURE_POSE_ATOL = 1e-4         # merged poses against the generator's, the similarity undone
CAPTURE_VEL_RTOL = 1e-6          # velocities in the merged world against s R (the VIO's)
LPIPS_RTOL = 1e-5                # LPIPS on the card against the CPU, one image pair
PROFILED_STEPS = 5
# phase 11: the mesh. Virtual ranks of each decomposition on bench-scene
# camera 0; the sharded fit against the single-device one on phase 8's scene
MESH_PARTS = 4                   # row strips and depth slabs
MESH_STEPS = 50
MESH_LOSS_REL = {"median": 1e-4, "max": 1e-3}


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


def camera_fields(seed=SEED, n=N_CAMERAS):
    """n poses near identity (the scene sits at z ~ 4 in front), seeded."""
    rng = np.random.default_rng(seed + 2)
    rot = rng.normal(size=(n, 3)) * 0.02
    R = []
    for w in rot:
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R.append(np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    f32 = np.float32
    ones = np.ones(n, f32)
    return dict(
        R_c2w=np.stack(R).astype(f32), p_c2w=(rng.normal(size=(n, 3)) * 0.05).astype(f32),
        fx=ones * 0.9 * RES, fy=ones * 0.9 * RES, cx=ones * RES / 2, cy=ones * RES / 2,
        width=RES, height=RES,
        lin_vel=np.tile(f32([0.4, -0.2, 0.1]), (n, 1)),
        ang_vel=np.tile(f32([0.05, 0.1, -0.02]), (n, 1)),
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


def window_ms(windows: list[tuple[float, int]]) -> list[float]:
    """Per-step ms of each of the trainer's synchronised windows (its
    `StepTimer.windows`: seconds from one sync to the next, and the steps
    between): the trainer waits for the card only at a window's end, so only
    a window's time is the time the work took."""
    return [sec * 1e3 / steps for sec, steps in windows]


def load_probe(name: str):
    """Import scripts_dev/<name>.py (a script, not a package module)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "scripts_dev" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Recorder:
    """Stands in for a kernel's wrapper (or the forward's launch) under the
    name the port calls it by: calls it and hands each call's arguments and
    result to `record`. `launches` reads and writes the wrapper's own count,
    so counting goes on as before."""

    def __init__(self, orig, record):
        self.orig, self.record = orig, record

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value

    def __call__(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        self.record(args, kwargs, out)
        return out


class KernelCapture:
    """Inside `with`: the inputs and the output of the first kernel launch of
    each path kernel for each shape key (the compositors by sample count and
    tile, the fetch pair by K, the projection pair by SH
    rows, velocities and, backward, the gradients asked for), copied as the
    driven path made them, from any host thread. `hold` then holds each
    against its plain version at phase 2's tolerances. Holding makes no
    launch."""

    def __init__(self, label: str):
        import threading
        self.label, self.records, self._lock = label, {}, threading.Lock()

    def _keep(self, key, args, kwargs, out):
        with self._lock:
            if key not in self.records:
                def copy(t):
                    if isinstance(t, (tuple, list)):
                        return type(t)(copy(x) for x in t)
                    return t.detach().clone() if torch.is_tensor(t) else t
                self.records[key] = ([copy(a) for a in args], dict(kwargs), copy(out))

    def __enter__(self):
        from splat_tpu_torch.device import use_kernel
        from splat_tpu_torch.ops import cuda as kcuda
        from splat_tpu_torch.ops.cuda import project_sh as ps
        from splat_tpu_torch.ops.cuda import rasterize_kernels as rk

        def on_fwd(args, kw, out):         # _launch_fwd: the kernel, always
            self._keep(("rasterize_fwd", args[2].shape[0] - 2, str(args[3])), args, kw, out)

        def on_bwd(args, kw, out):
            if use_kernel(kw.get("impl", "auto"), args[0]):
                self._keep(("rasterize_bwd", args[2].shape[0] - 2, str(args[5])), args, kw, out)

        def on_fetch_fwd(args, kw, out):
            if use_kernel(kw.get("impl", "auto"), args[0]):
                self._keep(("tile_fetch_fwd", args[4]), args, kw, out)

        def on_fetch_bwd(args, kw, out):
            if use_kernel(kw.get("impl", "auto"), args[0]):
                self._keep(("tile_fetch_bwd", args[0].shape[1]), args, kw, out)

        def on_sh_fwd(args, kw, out):      # the kernel, always
            self._keep(("project_sh_fwd", args[4].shape[1], args[9]), args, kw, out)

        def on_sh_bwd(args, kw, out):
            self._keep(("project_sh_bwd", args[4].shape[1], args[9], tuple(args[11])), args, kw,
                       out)

        self._patched = [(rk, "_launch_fwd", on_fwd), (rk, "rasterize_bwd", on_bwd),
                         (kcuda, "_tile_fetch_fwd", on_fetch_fwd),
                         (kcuda, "_tile_fetch_bwd", on_fetch_bwd),
                         (ps, "project_sh_fwd", on_sh_fwd), (ps, "project_sh_bwd", on_sh_bwd)]
        self._saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self._patched]
        for mod, name, record in self._patched:
            setattr(mod, name, _Recorder(getattr(mod, name), record))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        return False

    def kinds(self, name: str) -> list:
        """The shape keys recorded for kernel `name`."""
        return sorted(k[1:] for k in self.records if k[0] == name)

    def hold(self, stacked_shares) -> dict[str, float]:
        """Every record against its plain version: the fetch pair bitwise
        (the forward on each tile's counted rows); the forward compositor at
        atol 1e-4 on rgb and T and 1e-3 on depth_acc, its cull missing no
        compositing group; the backward within BWD_TOL of max|plain|; the
        projection pair against its plain closed form at
        scripts_dev/probe_project_sh_torch.py's TOL (as a share of
        max|plain|). The compositors' plain versions get the blocks' counted
        rows: the fetch kernel leaves the rows past a count unwritten, no
        kernel reads them, and a plain version reads them with a zero weight
        (0 * NaN is NaN). Returns max|err| by kernel."""
        from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
        from splat_tpu_torch.ops.cuda import tile_fetch as tf

        counted_rows = load_probe("probe_tile_fetch_torch").counted_rows

        errs, said = {}, []
        for key, (args, kw, got) in sorted(self.records.items(), key=str):
            name, what = key[0], f"{self.label}: {key[0]} {key[1:]}"
            if name in ("project_sh_fwd", "project_sh_bwd"):
                sh_probe = load_probe("probe_project_sh_torch")
                hold_fn = sh_probe.hold_fwd if name == "project_sh_fwd" else sh_probe.hold_bwd
                err = hold_fn(args, got)
                note = f"N {args[0].shape[0]}, {err:.3g} of max|plain|"
            elif name == "tile_fetch_fwd":
                table, ids, starts, counts, k = args
                check(torch.equal(counted_rows(got, counts), counted_rows(
                    tf.tile_fetch_fwd_plain(table, ids, starts, k), counts)),
                      f"{what} bitwise its plain version on the counted rows")
                err, note = 0.0, f"{tuple(got.shape)}, {int(counts.sum())} rows bitwise"
            elif name == "tile_fetch_bwd":
                check(torch.equal(got, tf.tile_fetch_bwd_plain(*args)),
                      f"{what} bitwise its plain version")
                err, note = 0.0, f"{tuple(got.shape)} bitwise"
            elif name == "rasterize_fwd":
                want, w = rk.rasterize_fwd_plain(counted_rows(args[0], args[1]), *args[1:],
                                                 count_work=True)
                err_c = (got[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
                err_d = (got[:, :, 3] - want[:, :, 3]).abs().max().item()
                check(err_c <= 1e-4 and err_d <= 1e-3, f"{what} within tolerance "
                      f"(rgb/T {err_c:.3g}, depth {err_d:.3g})")
                check(w["missed_groups"] == 0, f"{what}: the cull keeps every compositing group")
                err = max(err_c, err_d)
                note = (f"T {got.shape[0]}, K {args[0].shape[1]}, max|err| rgb/T {err_c:.3g} "
                        f"depth {err_d:.3g}, {w['hit_pairs']} compositing pairs")
            else:
                want = rk.rasterize_bwd_plain(counted_rows(args[0], args[1]), *args[1:])
                check(not got[:, :, rk.NPARAM - 1:].any(), f"{what}: zero columns")
                shares = stacked_shares(got, want)
                for kind, tol in BWD_TOL.items():
                    check(shares[kind] <= tol, f"{what}: per-{kind} share {shares[kind]:.3g} "
                          f"within {tol}")
                err = (got - want).abs().max().item()
                note = (f"T {got.shape[0]}, K {got.shape[1]}, max|err| {err:.3g}, per column "
                        f"{shares['column']:.3g} of max|plain|")
            errs[name] = max(errs.get(name, 0.0), err)
            said.append(f"{key[0]} {key[1:]}: {note}")
        print(f"{self.label}, the path's own launches against the plain versions: "
              + "; ".join(said))
        return errs


def _get(url: str, timeout: float = 120.0) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _ply_vertices(data: bytes) -> np.ndarray:
    """The vertex records of a binary little-endian float PLY, by property."""
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    props = [ln.split()[-1] for ln in lines if ln.startswith("property float")]
    check(len(body) == n * 4 * len(props), "the PLY body holds n records")
    return np.frombuffer(body, dtype=[(p, "<f4") for p in props], count=n)


def render_tools_phase(root: Path, reset_counts, stacked_shares) -> dict:
    """Phase 9: the user's path at the suite's published width. The suite
    generator writes scene0 of synthetic-mb; `python -m
    splat_tpu_torch.cli.train` trains the baseline and motion_blur variants
    for MATRIX_STEPS steps in its own subprocesses (each `fit` reports its
    process's kernel launches, counted from 0 at its start) and renders
    their eval frames; then, in this process, each with the counts set to 0
    just before it and read just after: a camera-path video of the
    motion_blur run, the viewer on that run, and a `fit --vis viewer` run
    answering a render request while it trains. The PLY export launches no
    kernel. The kernels' own launches on three of these paths are held
    against their plain versions (`KernelCapture`): one training step of the
    motion_blur run in this process (its anchor groups' sample counts at 512
    px), the first video frame (path camera, simulated blur, rolling
    shutter) and the cropped viewer render. Last, the reference renderer
    against the kernel route (a comparison: not counted). Returns the
    launches by path and max|err| by kernel."""
    import socket
    import subprocess
    import threading
    import urllib.error

    from splat_tpu_torch.cli import export as cli_export
    from splat_tpu_torch.cli import fit as cli_fit
    from splat_tpu_torch.cli import generate_synthetic_suite as cli_suite
    from splat_tpu_torch.cli import parse_outputs
    from splat_tpu_torch.cli import render_video as cli_video
    from splat_tpu_torch.cli import train as cli_train
    from splat_tpu_torch.cli import viewer as cli_viewer
    from splat_tpu_torch.cli.evaluate import load_trainer_from_config
    from splat_tpu_torch.data.png import decode_png, read_png
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import projection, rasterize
    from splat_tpu_torch.ops.reference import render_reference

    dev = torch.device("cuda")
    work = root / "_runs" / "chip_smoke_matrix"
    shutil.rmtree(work, ignore_errors=True)
    inputs, outputs = work / "inputs", work / "outputs"

    # 1. the suite's scene, rendered on the card
    t0 = time.perf_counter()
    cli_suite.main(["--input-dir", str(inputs), "--resolution", str(SUITE_RES), "--scenes", "1",
                    "--variants", "mb"])
    gen_s = time.perf_counter() - t0
    scene_dir = inputs / "synthetic-mb" / "scene0"
    meta = json.loads((scene_dir / "transforms.json").read_text())
    check(len(meta["frames"]) == SUITE_FRAMES and meta["w"] == meta["h"] == SUITE_RES,
          "the suite scene: 33 frames at 512 px")
    print(f"matrix: synthetic-mb/scene0 written in {gen_s:.2f} s "
          f"({gen_s / SUITE_FRAMES:.3f} s per frame, {SUITE_FRAMES} frames at {SUITE_RES} px, "
          f"exposure {meta['exposure_time']} s)")

    # 2. two variants of the matrix, each run a process of its own
    cmd = [sys.executable, "-m", "splat_tpu_torch.cli.train", "--dataset", "synthetic-mb",
           "--input-dir", str(inputs), "--output-dir", str(outputs),
           "--variants", ",".join(MATRIX_VARIANTS), "--iters", str(MATRIX_STEPS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
    train_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, "cli.train and its fit and render_model subprocesses end with rc 0")
    per_fit = [json.loads(ln.split(": ", 1)[1]) for ln in proc.stdout.splitlines()
               if ln.startswith("kernel launches: ")]
    check(len(per_fit) == len(MATRIX_VARIANTS), "each fit reports its kernel launches")
    for counts in per_fit:
        for k, n in counts.items():
            check(n >= MATRIX_STEPS, f"{k} launched on every step of a matrix run")
    matrix_launches = {k: sum(c[k] for c in per_fit) for k in per_fit[0]}
    runs = {}
    for variant in MATRIX_VARIANTS:
        run_root = outputs / "synthetic-mb" / variant / "scene0" / "splatfacto"
        stamps = list(run_root.iterdir())
        check(len(stamps) == 1, f"{variant}: one run under OUTPUT/DATASET/VARIANT/SESSION/splatfacto")
        run = runs[variant] = stamps[0]
        for name in ("config.json", "dataparser_transforms.json", "metrics.json",
                     "metrics_train.jsonl", f"checkpoints/step_{MATRIX_STEPS}/state.npz"):
            check((run / name).exists(), f"{variant}: {name}")
        m = json.loads((run / "metrics.json").read_text())
        check(np.isfinite(m["results"]["psnr"]) and all(
            np.isfinite(m[k]) for k in ("wall_clock_time_seconds", "train_time_seconds",
                                        "compile_time_seconds")),
              f"{variant}: a finite PSNR and the three time fields")
        steps = [json.loads(ln) for ln in (run / "metrics_train.jsonl").read_text().splitlines()]
        steps = [r for r in steps if "steps_per_s" in r]
        renders = run / "renders" / "eval"
        for i in range(SUITE_EVAL_FRAMES):
            pred, gt = read_png(renders / f"{i:05d}_pred.png"), read_png(renders / f"{i:05d}_gt.png")
            depth = np.load(renders / f"{i:05d}_depth.npy")
            check(pred.shape == gt.shape == (SUITE_RES, SUITE_RES, 3) and pred.std() > 0
                  and gt.std() > 0, f"{variant}: eval render {i} decodes and is not constant")
            check(read_png(renders / f"{i:05d}_depth.png").std() > 0
                  and np.isfinite(depth).any() and np.nanstd(depth[np.isfinite(depth)]) > 0,
                  f"{variant}: depth {i} finite and not constant")
        check(not (renders / f"{SUITE_EVAL_FRAMES:05d}_pred.png").exists(),
              f"{variant}: one render per eval frame")
        print(f"matrix: {variant}: psnr {m['results']['psnr']:.3f} dB, ssim "
              f"{m['results']['ssim']:.4f}; {MATRIX_STEPS / m['train_time_seconds']:.2f} steps/s "
              f"over the run, {statistics.median(r['steps_per_s'] for r in steps):.2f} in its "
              f"logged windows; wall {m['wall_clock_time_seconds']:.2f} s (the subprocess's)")
    rows = parse_outputs.find_and_parse_directories_containing_splatting_metrics(outputs)
    check(sorted(r["variant"] for r in rows) == sorted(MATRIX_VARIANTS)
          and all(r["dataset"] == "synthetic-mb" and r["session"] == "scene0" for r in rows),
          "parse_outputs finds both rows")
    print(f"matrix: cli.train {train_s:.2f} s for {len(MATRIX_VARIANTS)} runs and their renders; "
          f"launches {matrix_launches}")

    # 3.-5. render, export and view the motion_blur run, counting each path's launches
    mb_config = runs["motion_blur"] / "config.json"
    by_path, errs = {"matrix": matrix_launches}, {}

    def hold(capture, want_bwd: bool):
        names = ("rasterize_fwd", "tile_fetch_fwd", "project_sh_fwd")
        for name in names + (("rasterize_bwd", "tile_fetch_bwd", "project_sh_bwd") if want_bwd
                             else ()):
            check(capture.kinds(name), f"{capture.label}: {name} launched and recorded")
        for name, err in capture.hold(stacked_shares).items():
            errs[name] = max(errs.get(name, 0.0), err)

    reset_counts()
    t0 = time.perf_counter()
    video = {}
    for name, scale in (("video", "1"), ("video_sharp", "0")):
        argv = [str(work / name), "--load-config", str(mb_config), "--seconds",
                str(VIDEO_SECONDS), "--fps", str(VIDEO_FPS), "--blur_scale", scale]
        if name == "video":
            with KernelCapture("video (path camera, exposure and rolling shutter)") as path_cap:
                cli_video.main(argv)
        else:
            cli_video.main(argv)
        video[name] = [read_png(f) for f in sorted((work / name / "frames").glob("*.png"))]
        check(len(video[name]) == VIDEO_FPS * VIDEO_SECONDS
              and all(f.shape == (SUITE_RES, SUITE_RES, 3) and f.std() > 0 for f in video[name]),
              f"{name}: 8 frames at 512 px, none constant")
    video_s = time.perf_counter() - t0
    blur_diff = max(float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())
                    for a, b in zip(video["video"], video["video_sharp"]))
    check(blur_diff > 0.5, "the exposure shows: frames differ from the same path at blur_scale 0")
    by_path["video"] = kcuda.path_launches()
    n_frames = 2 * VIDEO_FPS * VIDEO_SECONDS
    for k in ("tile_fetch_fwd", "rasterize_fwd"):
        check(by_path["video"][k] >= n_frames, f"video: {k} launched for each of {n_frames} frames")
    hold(path_cap, want_bwd=False)

    n_export = cli_export.main(["--load-config", str(mb_config), "--output",
                                str(work / "model.ply"), "--min-opacity", str(EXPORT_MIN_OPACITY)])
    rec = _ply_vertices((work / "model.ply").read_bytes())
    _, loaded = load_trainer_from_config(mb_config)
    g = loaded.params.gaussians
    keep = ((g.alive > 0) & (torch.sigmoid(g.opacities_logit) >= EXPORT_MIN_OPACITY)).cpu().numpy()
    leaf = lambda t: t.detach().cpu().numpy()[keep]  # noqa: E731
    n_rest = g.features_rest.shape[1]
    rest_cm = np.transpose(leaf(g.features_rest), (0, 2, 1)).reshape(-1, 3 * n_rest)
    check(len(rec) == n_export == int(keep.sum()) > 0, "the PLY holds the alive, thresholded Gaussians")
    pairs = [(("x", "y", "z"), leaf(g.means)), (("scale_0", "scale_1", "scale_2"), leaf(g.scales_log)),
             (tuple(f"rot_{i}" for i in range(4)), leaf(g.quats)),
             (("opacity",), leaf(g.opacities_logit)[:, None]),
             (("f_dc_0", "f_dc_1", "f_dc_2"), leaf(g.features_dc)),
             (tuple(f"f_rest_{i}" for i in range(3 * n_rest)), rest_cm)]
    for names, want in pairs:
        got = np.stack([rec[n] for n in names], axis=1)
        check(np.array_equal(got, want), f"the PLY's {names[0]}.. bitwise the trainer's leaves")
    del g
    # one more training step of the motion_blur run, in this process (a
    # comparison, outside every counted path): its anchor groups' launches
    with KernelCapture("a motion_blur training step at 512 px") as step_cap:
        loaded.run(1)
    fwd_s = [k[0] for k in step_cap.kinds("rasterize_fwd")]
    bwd_s = [k[0] for k in step_cap.kinds("rasterize_bwd")]
    check(fwd_s == bwd_s and step_cap.kinds("tile_fetch_fwd") == step_cap.kinds("tile_fetch_bwd"),
          "the step's forward and backward compositors at the same sample counts, the fetch pair "
          "forward and backward at the same K")
    print(f"matrix: one motion_blur step in this process at {loaded.model_config.blur_samples} "
          f"blur samples in {loaded.model_config.blur_anchors} anchor groups: compositors at S in "
          f"{sorted(set(fwd_s))}")
    hold(step_cap, want_bwd=True)
    del loaded

    state = cli_viewer.ViewerState(mb_config, VIEWER_RES)
    server = cli_viewer.serve(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    reset_counts()
    try:
        t1 = time.perf_counter()
        img = decode_png(_get(f"{url}/render?yaw=0.5&pitch=0.3&r=3&exp=0.06&rs=0.03"))
        view_ms = (time.perf_counter() - t1) * 1e3
        with KernelCapture("viewer (crop box, exposure and rolling shutter)") as crop_cap:
            crop = decode_png(_get(f"{url}/render?yaw=0.5&pitch=0.3&r=3&exp=0.06&rs=0.03"
                                   "&cx0=0.2&cx1=0.8&cy0=0.2&cy1=0.8&cz0=0&cz1=1"))
        check(img.shape == crop.shape == (VIEWER_RES, VIEWER_RES, 3) and img.std() > 0
              and not np.array_equal(img, crop), "the viewer renders, and a crop box changes it")
        full = _ply_vertices(_get(f"{url}/export.ply"))
        small = _ply_vertices(_get(f"{url}/export.ply?cx0=0.25&cx1=0.75&cy0=0.25&cy1=0.75"
                                   "&cz0=0.25&cz1=0.75"))
        check(0 < len(small) < len(full), "a small crop exports fewer Gaussians")
    finally:
        server.shutdown()
        server.server_close()
    by_path["viewer"] = kcuda.path_launches()
    for k in ("tile_fetch_fwd", "rasterize_fwd"):
        check(by_path["viewer"][k] >= 2, f"viewer: {k} launched for each of 2 render requests")
    hold(crop_cap, want_bwd=False)

    with socket.socket() as sock:           # a free port for the live viewer
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _, mb_flags = cli_train.flags_to_variant_name_and_cmd({"motion_blur"}, "synthetic-mb", False)
    argv = ["splatfacto", "--data", str(scene_dir), "--output-dir", str(work / "live"),
            "--experiment-name", "live", "--max-num-iterations", str(LIVE_STEPS), "--vis", "viewer",
            "--viewer-port", str(port), *mb_flags, "nerfstudio-data", "--eval-mode", "interval",
            "--eval-interval", "8", "--orientation-method", "none"]
    done, seen = threading.Event(), []

    def look():
        while not done.is_set():
            try:
                png = _get(f"http://127.0.0.1:{port}/render?exp=0.06&rs=0.03", timeout=30)
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.01)
                continue
            seen.append((decode_png(png), done.is_set()))
            return

    looker = threading.Thread(target=look)
    reset_counts()
    looker.start()
    try:
        live_dir = cli_fit.main(argv)
    finally:
        done.set()
        looker.join(timeout=120)
    check(not looker.is_alive(), "the request thread ended")
    check(len(seen) == 1 and not seen[0][1] and seen[0][0].shape == (VIEWER_RES, VIEWER_RES, 3),
          "the live viewer answered a render request while fit trained")
    live = json.loads((live_dir / "metrics.json").read_text())
    check(np.isfinite(live["results"]["psnr"]), "the live-viewer run's PSNR is finite")
    by_path["live_fit"] = kcuda.path_launches()
    for k, n in by_path["live_fit"].items():
        check(n >= LIVE_STEPS, f"live fit: {k} launched on every one of {LIVE_STEPS} steps")
    print(f"render tools: video 2 x {VIDEO_FPS} frames at {SUITE_RES} px in {video_s:.2f} s "
          f"(mean |frame - sharp frame| up to {blur_diff:.2f} levels); export {n_export} of "
          f"{int(keep.size)} slots; viewer {view_ms:.1f} ms for a {VIEWER_RES} px render "
          f"({len(full)} -> {len(small)} Gaussians cropped); live run of {LIVE_STEPS} steps psnr "
          f"{live['results']['psnr']:.3f} dB; launches: video {by_path['video']}, viewer "
          f"{by_path['viewer']}, live fit {by_path['live_fit']}")

    # 6. the reference renderer against the kernel route (no blur)
    rng = np.random.default_rng(SEED + 9)
    means, scales, quats, colors, opac = make_scene(REF_GAUSSIANS, SEED + 9)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    fl = 0.9 * REF_RES
    proj = projection.project_gaussians(
        f32(means), f32(scales * 4.0), f32(quats), torch.eye(3, device=dev),
        torch.zeros(3, device=dev), fl, fl, REF_RES / 2, REF_RES / 2, REF_RES, REF_RES,
        lin_vel=f32([0.4, -0.2, 0.1]), ang_vel=f32([0.05, 0.1, -0.02]))
    bg = f32(rng.uniform(0, 1, 3))
    ref = render_reference(proj, f32(colors), f32(opac), REF_RES, REF_RES, bg,
                           rolling_shutter_time=REF_RS, chunk=64, tile_size=16,
                           max_tiles_per_gaussian=16)
    ker = rasterize.rasterize(proj, f32(colors), f32(opac), REF_RES, REF_RES, bg,
                              rolling_shutter_time=REF_RS, tile_size=16, max_per_tile=256,
                              max_tiles_per_gaussian=16, impl="cuda")
    ref_errs = {name: float((getattr(ker, name) - getattr(ref, name)).abs().max())
                for name in ("rgb", "alpha", "transmittance")}
    ref_errs["depth * alpha"] = float((ker.depth * ker.alpha - ref.depth * ref.alpha).abs().max())
    print(f"reference vs kernels: {REF_GAUSSIANS} Gaussians at {REF_RES}x{REF_RES}, rolling "
          f"shutter {REF_RS} s, coverage {float(ref.alpha.mean()):.3f}: max|diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in ref_errs.items()))
    check(float(ref.alpha.max()) > 0.5, "the reference scene covers pixels")
    check(all(v <= REF_ATOL for v in ref_errs.values()),
          f"the kernel route within {REF_ATOL} of the reference renderer")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": by_path, "errs": errs}


def fit_truth_table(t, means, scales, quats, truth) -> tuple[float, float]:
    """Render the generator's Gaussians (already in the trainer's world) on
    every eval camera of trainer t against every decoded eval frame: the
    least PSNR of a camera on its own frame and the most on another's. The
    trainer's model is put back afterwards."""
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.ops.ssim import psnr

    dev = t.params.gaussians.means.device
    cap_n, n = t.params.gaussians.alive.shape[0], means.shape[0]

    def padded(x, fill=0.0):
        out = torch.full((cap_n, *x.shape[1:]), fill, dtype=torch.float32, device=dev)
        out[:n] = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return out

    opac = truth["opacities"].detach().to(dev).clamp(1e-6, 1 - 1e-6)
    q = padded(quats)
    q[n:, 0] = 1.0
    initial = t.params
    t.params = initial._replace(
        gaussians=sf.GaussianParams(
            means=padded(means), scales_log=padded(np.log(scales), -8.0), quats=q,
            opacities_logit=padded(torch.log(opac / (1 - opac))),
            features_dc=padded((truth["colors"].detach().to(dev) - 0.5) / 0.28209479177387814),
            features_rest=torch.zeros_like(initial.gaussians.features_rest),
            alive=padded(torch.ones(n))),
        background_logit=torch.full((3,), -30.0, device=dev))      # the scene's black
    try:
        n_eval = len(t.eval_cams)
        table = [[float(psnr(t.render_eval(i), t._eval_imgs_dev[j])) for j in range(n_eval)]
                 for i in range(n_eval)]
    finally:
        t.params = initial
    return (min(table[i][i] for i in range(n_eval)),
            max(table[i][j] for i in range(n_eval) for j in range(n_eval) if i != j))


def mesh_phase(params, cams, cfg, work: Path, scene_dir: Path, reset_counts, stacked_shares,
               card: str) -> dict:
    """Phase 11: the mesh. (a) The decompositions of `parallel/sharding.py`
    on the card, in this process, each virtual rank in turn through the
    kernels: row strips (each with its `row0`) joined against the full
    image, a blur split (S = 4 as 2 + 2) summed against the blur mean, depth
    slabs composited apart and merged with the over-operator against the
    full render (within the early stop's T_EPS), and the gradient of a
    seeded cotangent through the strips against the full image's (the packed
    table's 12 gradient columns, at phase 2's bounds). (b) `cli.fit
    --mesh.enabled True` on NCCL at world = the visible cards, on phase 8's
    scene with its flags, for MESH_STEPS steps against the same `cli.fit`
    without the mesh, in turns: the loss trajectories, steps/s, the mesh
    path's launches (rank 0's), and one more mesh step in this process
    recorded by `KernelCapture` and held against the plain versions."""
    from splat_tpu_torch.cli import fit as cli_fit
    from splat_tpu_torch.data import dataparser, dataset
    from splat_tpu_torch.engine import config as run_config
    from splat_tpu_torch.engine import trainer
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import rasterize
    from splat_tpu_torch.ops.reference import T_EPS
    from splat_tpu_torch.parallel import sharding
    from splat_tpu_torch.parallel.collectives import Axis

    t_phase = time.perf_counter()
    one = Axis("gauss", 1, 0, (0,))            # a virtual rank holds the whole cloud
    cam = cams[0]
    # a depth-list capacity no tile fills: slabs hold fewer rows a tile than
    # the whole cloud, so a full tile would drop rows there and not here
    with torch.no_grad():
        fullest = int(sf.binning_counts(params, cam, cfg).max())
    cfg = dataclasses.replace(cfg, max_per_tile=max(cfg.max_per_tile,
                                                    1 << (fullest - 1).bit_length()))
    full_h, width = cam.height, cam.width
    strip_h = full_h // MESH_PARTS
    sh = cfg.sh_degree
    motion = sf.camera_motion(params, cam, cfg)
    bg = sf.background_color(params, cfg)
    g = params.gaussians
    opac = torch.sigmoid(g.opacities_logit) * g.alive
    eps = motion.eps
    t_a = eps.mean()
    kw = dict(rolling_shutter_time=motion.rs_time, tile_size=cfg.tile_size,
              max_per_tile=cfg.max_per_tile, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)
    errs = {}
    with torch.no_grad():
        full = sf.render_camera(params, cam, cfg, sh, bg).rgb
        strips = torch.cat([sharding._render_strip_linear(
            params, cam, cfg, sh, bg, strip_h, k * strip_h, (0, eps.shape[0]), one)[0]
            for k in range(MESH_PARTS)])
        errs["strips"] = (strips - full).abs().max().item()
        cfg4 = dataclasses.replace(cfg, blur_samples=4)
        full4 = sf.render_camera(params, cam, cfg4, sh, bg).rgb
        halves = [sharding._render_strip_linear(params, cam, cfg4, sh, bg, full_h, 0, (lo, lo + 2),
                                                one)[0] for lo in (0, 2)]
        errs["blur"] = (halves[0] + halves[1] - full4).abs().max().item()
        proj, colors = sf.subframe_inputs(params, motion, cfg, sh, t_a)
        table = kcuda.pack_param_table(proj, colors, opac)[:-1]
        rows = torch.cat([table, proj.extents], dim=1)
        slab, _ = sharding.slab_ids(table[:, 9], table[:, 8] > 0, MESH_PARTS, one)
        # one virtual rank holds the whole cloud, so its k-th send bucket is
        # all that slab k's rank receives in the exchange
        buckets, overflow = sharding.slab_buckets(rows, slab, MESH_PARTS, cfg.slab_slack)
        layers = []
        for k in range(MESH_PARTS):
            synth, col, op = sharding._from_rows(buckets[k], table.shape[1])
            layers.append(rasterize.rasterize_fused(synth, col, op, width, full_h,
                                                    torch.zeros_like(bg), eps=eps - t_a, **kw))
        rgb, T = sharding.over(torch.stack([o.rgb for o in layers]),
                               torch.stack([o.transmittance for o in layers]))
        whole = rasterize.rasterize_fused(proj, colors, opac, width, full_h, bg, eps=eps - t_a, **kw)
        errs["slabs"] = max((rgb + T[..., None] * bg - whole.rgb).abs().max().item(),
                            (T - whole.transmittance).abs().max().item())
        sizes = [int((buckets[k, :, 8] > 0).sum()) for k in range(MESH_PARTS)]
        overflow = int(overflow)
        # a pixel stops once its T falls to T_EPS; each slab starts at T = 1
        # and composites on past that point, by at most T_EPS of a colour
        slab_tol = T_EPS * max(1.0, colors.abs().max().item()) + 1e-6
    cot = torch.rand((full_h, width, 3), device=full.device,
                     generator=torch.Generator(device=full.device).manual_seed(SEED))

    def table_grad(row0, h):
        """The packed table's gradient of sum(cot * rgb) over the strip."""
        p_s, c_s = sf.subframe_inputs(params, motion, cfg, sh, t_a, row0=row0)
        rows_s = torch.cat([kcuda.pack_param_table(p_s, c_s, opac)[:-1], p_s.extents],
                           dim=1).detach().requires_grad_(True)
        synth, col, op = sharding._from_rows(rows_s, table.shape[1])
        out = rasterize.rasterize_fused(synth, col, op, width, h, bg, eps=eps - t_a,
                                        rs_full_height=full_h, rs_row_offset=row0,
                                        reduce="mean", **kw)
        (out.rgb * cot[row0:row0 + h]).sum().backward()
        return rows_s.grad[:, :table.shape[1]]

    want = table_grad(0, full_h)
    got = sum(table_grad(k * strip_h, strip_h) for k in range(MESH_PARTS))
    grad_shares = stacked_shares(got[None], want[None])
    errs["strip_grad"] = (got - want).abs().max().item()
    print(f"mesh: decompositions on the card at {width}x{full_h}, {g.means.shape[0]} Gaussians, "
          f"rolling shutter {float(motion.rs_time):.3f} s, K {cfg.max_per_tile} (the fullest "
          f"tile {fullest}): {MESH_PARTS} row strips of {strip_h} rows "
          f"max|err| {errs['strips']:.3g}; blur S = 4 as 2 + 2 max|err| {errs['blur']:.3g}; "
          f"{MESH_PARTS} depth slabs ({sizes} live rows in buckets of {buckets.shape[1]}, "
          f"{overflow} dropped) max|err| rgb/T {errs['slabs']:.3g} (the early "
          f"stop's bound {slab_tol:.3g}); the "
          f"strips' table gradient max|err| {errs['strip_grad']:.3g}, per column "
          f"{grad_shares['column']:.3g} and per row {grad_shares['row']:.3g} of max|full|; {card}")
    for what in ("strips", "blur"):
        check(errs[what] <= 1e-4, f"mesh: the {what} decomposition within phase 2's 1e-4")
    check(overflow == 0, "mesh: no slab bucket overflows")
    check(errs["slabs"] <= slab_tol, "mesh: the slabs within the early stop's bound")
    for kind in ("column", "row"):
        check(grad_shares[kind] <= BWD_TOL[kind],
              f"mesh: the strips' gradient per {kind} within {BWD_TOL[kind]}")
    del full, strips, full4, halves, layers, rgb, T, whole, want, got, rows, table, cot, buckets

    # (b) the sharded trainer through cli.fit
    head = FIT_FLAGS[:FIT_FLAGS.index("nerfstudio-data")]
    tail = FIT_FLAGS[FIT_FLAGS.index("nerfstudio-data"):]
    runs, wall = {}, {}
    mesh_flag = ["--mesh.enabled", "True"]
    # in turns, so that neither side has the warmer card
    for name, extra in (("single", []), ("mesh", mesh_flag), ("mesh_2", mesh_flag),
                        ("single_2", [])):
        argv = ["splatfacto", "--data", str(scene_dir), "--output-dir", str(work / "mesh_fits"),
                "--experiment-name", "mesh", "--timestamp", name, *head,
                "--max-num-iterations", str(MESH_STEPS), "--steps-per-eval", "0",
                "--steps-per-save", str(MESH_STEPS), "--trainer.log-every", "1", *extra, *tail]
        reset_counts()
        t0 = time.perf_counter()
        runs[name] = cli_fit.main(argv)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        if name == "mesh":
            # the mesh path's launches: rank 0's, from its metrics.json
            launches = json.loads((runs[name] / "metrics.json").read_text())["mesh"][
                "kernel_launches"]
    metrics = {k: json.loads((d / "metrics.json").read_text()) for k, d in runs.items()}
    losses = {k: [json.loads(line)["loss"] for line in (d / "metrics_train.jsonl")
                  .read_text().splitlines() if '"loss"' in line] for k, d in runs.items()}
    check(all(len(v) == MESH_STEPS for v in losses.values()), "both fits logged every step")
    a, b = np.asarray(losses["single"]), np.asarray(losses["mesh"])
    rel = np.abs(b - a) / np.abs(a)
    mesh_info = metrics["mesh"]["mesh"]
    rate = {k: MESH_STEPS / m["train_time_seconds"] for k, m in metrics.items()}
    print(f"mesh: cli.fit --mesh.enabled True on {mesh_info['backend']}, world "
          f"{mesh_info['world']} ({mesh_info['shape']}), {MESH_STEPS} steps on phase 8's scene "
          f"against the same fit without the mesh: loss relative difference median "
          f"{np.median(rel):.3g}, largest {rel.max():.3g} (step {int(rel.argmax()) + 1}); "
          f"steps/s {rate['mesh']:.3f} and {rate['mesh_2']:.3f} on the mesh, {rate['single']:.3f} "
          f"and {rate['single_2']:.3f} without (in the order single, mesh, mesh, single); wall "
          + ", ".join(f"{wall[k]:.1f}" for k in runs) + " s; eval psnr "
          f"{metrics['mesh']['results']['psnr']:.4f} and {metrics['single']['results']['psnr']:.4f}"
          f" dB; rank 0's launches {launches}; {card}")
    check(mesh_info["backend"] == "nccl" and mesh_info["world"] == torch.cuda.device_count(),
          "the mesh ran on NCCL with one rank per card")
    check(np.median(rel) <= MESH_LOSS_REL["median"] and rel.max() <= MESH_LOSS_REL["max"],
          f"the mesh's losses within {MESH_LOSS_REL} of the single-device fit's")
    for k, n in launches.items():
        check(n >= MESH_STEPS, f"mesh: {k} launched on every step")

    # one more step of the mesh trainer, in this process (a comparison, outside the counted path)
    run_cfg = run_config.load_config(runs["mesh"] / "config.json")
    scene = dataparser.parse_scene(run_cfg.data, run_cfg.dataparser)
    train_imgs, eval_imgs = dataset.load_scene_images(scene)
    mesh = sharding.make_mesh({})
    t = trainer.Trainer(scene, run_cfg.model,
                        dataclasses.replace(run_cfg.trainer, max_steps=MESH_STEPS + 1,
                                            seed=run_cfg.seed),
                        train_images=train_imgs, eval_images=eval_imgs, mesh=mesh)
    t.load_checkpoint(runs["mesh"] / "checkpoints" / f"step_{MESH_STEPS}")
    with KernelCapture("a mesh training step (world 1) at 1024 px") as cap:
        t.run(1)
    check(len(cap.kinds("rasterize_bwd")) > 0 and len(cap.kinds("tile_fetch_fwd")) > 0
          and cap.kinds("tile_fetch_fwd") == cap.kinds("tile_fetch_bwd"),
          "the mesh step's compositors and the fetch pair, forward and backward, recorded")
    errs.update(cap.hold(stacked_shares))
    del t
    shutil.rmtree(work / "mesh_fits", ignore_errors=True)
    print(f"mesh: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": errs}


def capture_phase(work: Path, scene_dir: Path, generated: dict, reset_counts,
                  stacked_shares) -> dict:
    """Phase 10: phase 8's scene as a phone capture. It writes what the
    external tools would have: the VIO's directory (`sai-cli`'s
    transforms.json with velocities and blur scores) and COLMAP's text model
    of the same frames and of the generator's Gaussian centres and colours,
    in a world that is a similarity transform of the VIO's. Then, each
    through its `main` as a user runs it: `run_colmap --text-model`,
    `combine`, `train_eval_split_by_blur_score`, `cli.fit` with the flagship
    flags for the blur-scored dataset (its launches counted from 0), and
    `cli.evaluate` with LPIPS weights drawn from a seed. One more step of
    the fit's trainer, outside every counted path, has its kernel launches
    recorded (`KernelCapture`) and held against the plain versions at the
    capture's own shapes (1024 px, the compositors at each anchor group's
    sample count, rolling shutter, pose and velocity optimisation). Last,
    five of the fit's steps under `torch.profiler`, ranked by
    `utils.trace_report`."""
    from splat_tpu_torch.cli import combine as cli_combine
    from splat_tpu_torch.cli import evaluate as cli_evaluate
    from splat_tpu_torch.cli import fit as cli_fit
    from splat_tpu_torch.cli import run_colmap as cli_run_colmap
    from splat_tpu_torch.cli import train as cli_train
    from splat_tpu_torch.cli import train_eval_split_by_blur_score as cli_split
    from splat_tpu_torch.data import dataparser, dataset, ply
    from splat_tpu_torch.engine import config as run_config
    from splat_tpu_torch.engine import trainer
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import lpips
    from splat_tpu_torch.utils import trace_report
    from splat_tpu_torch.utils.profiling import time_cuda

    cap = load_probe("synthetic_capture_torch")
    root = work / "capture"
    shutil.rmtree(root, ignore_errors=True)
    proc = root / "inputs-processed"
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    # the external tools' outputs
    sim = cap.similarity(SEED)
    vio = proc / "sai-cli" / "rec0"
    truth = generated["gaussians"]
    colours = np.round(np.clip(truth["colors"].detach().cpu().numpy(), 0.0, 1.0) * 255)
    timed("write_inputs", lambda: (
        cap.write_vio_dir(scene_dir, vio),
        cap.write_colmap_text(scene_dir, root / "colmap_text",
                              truth["means"].detach().cpu().numpy(), colours, sim)))
    # the tools, as a user runs them
    (colmap_dir,) = timed("run_colmap", lambda: cli_run_colmap.main(
        [str(vio), "--text-model", str(root / "colmap_text"), "--processed-prefix", str(proc)]))
    (vels,) = timed("combine", lambda: cli_combine.main(
        [str(colmap_dir), str(vio), "--processed-prefix", str(proc)]))
    (scored,) = timed("split", lambda: cli_split.main(
        ["colmap-sai-cli-vels", "all", "--processed-prefix", str(proc)]))
    check(scored == proc / CAPTURE_DATASET / "rec0", f"the split writes {CAPTURE_DATASET}")

    merged = json.loads((vels / "transforms.json").read_text())
    own = {Path(f["file_path"]).name: f
           for f in json.loads((scene_dir / "transforms.json").read_text())["frames"]}
    check(len(merged["frames"]) == FIT_FRAMES, "every frame merged")
    rot = cap.world_rotation(sim)
    pose_err, vel_err, ang_same = 0.0, 0.0, True
    for f in merged["frames"]:
        src = own[Path(f["file_path"]).name]
        c2w = np.asarray(src["transform_matrix"])
        pose_err = max(pose_err, float(np.abs(cap.vio_pose(f["transform_matrix"], sim)
                                              - c2w).max()))
        world = np.asarray(f["transform_matrix"])[:3, :3] @ f["camera_linear_velocity"]
        want = sim[0] * rot @ (c2w[:3, :3] @ src["camera_linear_velocity"])
        vel_err = max(vel_err, float(np.abs(world - want).max()
                                     / max(np.abs(want).max(), 1e-12)))
        ang_same &= f["camera_angular_velocity"] == src["camera_angular_velocity"]
    print(f"capture: similarity scale {sim[0]:.6f}; merged poses back in the generator's frame "
          f"within {pose_err:.3g}; linear velocities in the merged world against s R times the "
          f"VIO's within {vel_err:.3g} relative; angular velocities carried as they were: "
          f"{ang_same}")
    check(pose_err <= CAPTURE_POSE_ATOL, "the merged poses map back to the generator's")
    check(vel_err <= CAPTURE_VEL_RTOL and ang_same,
          "the velocities are rotated into COLMAP's world and scaled by its scale")
    frames = sorted(own.values(), key=lambda f: f["file_path"])
    want_eval = {"eval_" + Path(min(frames[i:i + 8], key=lambda f: f["motion_blur_score"])
                                ["file_path"]).name for i in range(0, len(frames), 8)}
    got_eval = {p.name for p in (scored / "images").glob("eval_*")}
    check(got_eval == want_eval and len(list((scored / "images").iterdir())) == FIT_FRAMES,
          "the split keeps the least blurred frame of every eight for eval")
    n_points = ply.read_ply(scored / "sparse_pc.ply")["xyz"].shape[0]
    check(n_points == N_GAUSS, "COLMAP's points become the seed cloud")

    # the fit, on the flagship flags of cli/train.py for this dataset
    name, flags = cli_train.flags_to_variant_name_and_cmd(CAPTURE_FEATURES, CAPTURE_DATASET,
                                                          False)
    argv = ["splatfacto", "--data", str(scored), "--output-dir", str(root / "outputs"),
            "--experiment-name", f"{CAPTURE_DATASET}/{name}/rec0", "--timestamp", "run",
            "--max-num-iterations", str(FIT_STEPS), "--steps-per-eval", str(FIT_STEPS // 3),
            "--steps-per-save", str(FIT_STEPS), "--seed", str(SEED), "--trainer.log-every", "50",
            "--pipeline.model.initial-capacity", str(LOOP_CAPACITY), *flags,
            "nerfstudio-data", "--eval-mode", cli_train.dataset_params(CAPTURE_DATASET)["eval_mode"]]
    cfg0 = run_config.parse_cli(argv)
    scene = dataparser.parse_scene(cfg0.data, cfg0.dataparser)
    train_imgs, eval_imgs = dataset.load_scene_images(scene)
    check(len(scene.eval_cameras) == len(want_eval) and scene.points_xyz.shape[0] == N_GAUSS,
          "the parsed capture: the eval frames by file name, every seed point")
    fresh = trainer.Trainer(scene, cfg0.model,
                            dataclasses.replace(cfg0.trainer, max_steps=FIT_STEPS, seed=cfg0.seed),
                            train_images=train_imgs, eval_images=eval_imgs)
    before = fresh.evaluate()["psnr"]

    # the data path's gate, as phase 8's: the generator's Gaussians taken into
    # COLMAP's world by the similarity, then through the parser's transform
    # (applied_transform and the orientation included) and scale, rendered on
    # the parsed eval cameras against the decoded eval frames
    s_, r_, t_ = sim
    tf = np.asarray(scene.transform, dtype=np.float64)
    turn = tf[:, :3] @ r_
    f64 = {k: truth[k].detach().cpu().double().numpy() for k in ("means", "scales", "quats")}
    means = ((s_ * f64["means"] @ r_.T + t_) @ tf[:, :3].T + tf[:, 3]) * scene.scale
    qw, q = cap.matrix_to_quat(turn), f64["quats"] / np.linalg.norm(f64["quats"], axis=1,
                                                                    keepdims=True)
    quats = np.concatenate([qw[0] * q[:, :1] - (q[:, 1:] @ qw[1:])[:, None],
                            qw[0] * q[:, 1:] + q[:, :1] * qw[1:] + np.cross(qw[1:], q[:, 1:])], 1)
    truth_table = fit_truth_table(fresh, means, f64["scales"] * s_ * scene.scale, quats, truth)
    print(f"capture: the generator's Gaussians through the similarity and the parsed eval cameras "
          f"against the decoded eval frames: psnr {truth_table[0]:.3f} dB on a camera's own frame "
          f"(the least), {truth_table[1]:.3f} on another's (the most); the initial model "
          f"{before:.3f}")
    check(truth_table[0] >= FIT_TRUTH_PSNR_DB and truth_table[1] <= truth_table[0] - 15.0,
          "the merged capture reproduces the generator's scene")
    os.environ.pop(lpips.ENV_VAR, None)
    reset_counts()
    run_dir = timed("fit", lambda: cli_fit.main(argv))
    torch.cuda.synchronize()
    launches = kcuda.path_launches()
    for k, n in launches.items():
        check(n >= FIT_STEPS, f"{k} launched on every step of the capture's fit")
    metrics = json.loads((run_dir / "metrics.json").read_text())
    records = [json.loads(line)
               for line in (run_dir / "metrics_train.jsonl").read_text().splitlines()]
    evals = [r["eval_psnr"] for r in records if "eval_psnr" in r]
    steps = [r for r in records if "loss" in r]
    check(all(r["n_alive"] == N_GAUSS for r in steps), f"every step on {N_GAUSS} Gaussians")
    print(f"capture: {name} ({cfg0.model.blur_samples} blur samples in "
          f"{fresh.model_config.blur_anchors} anchors) {FIT_STEPS} steps at "
          f"{FIT_STEPS / metrics['train_time_seconds']:.2f} steps/s with evals and the save, "
          f"{statistics.median(r['steps_per_s'] for r in steps):.2f} in the logged windows; "
          f"eval psnr {before:.3f} -> " + " -> ".join(f"{v:.3f}" for v in evals)
          + f" dB; launches {launches}")
    check(len(evals) == 3 and evals[-1] >= before + FIT_PSNR_GAIN_DB,
          f"the capture's eval PSNR rises by {FIT_PSNR_GAIN_DB} dB")

    # one step of the fit's trainer (a comparison, outside every counted
    # path, and the profiler's warm-up): its launches against the plain versions
    with KernelCapture("a capture fit step at 1024 px") as step_cap:
        fresh.run(1)
        torch.cuda.synchronize()
    for k in ("rasterize_fwd", "rasterize_bwd", "tile_fetch_fwd", "tile_fetch_bwd"):
        check(step_cap.kinds(k), f"{step_cap.label}: {k} launched and recorded")
    fwd_s = [k[0] for k in step_cap.kinds("rasterize_fwd")]
    bwd_s = [k[0] for k in step_cap.kinds("rasterize_bwd")]
    check(fwd_s == bwd_s and step_cap.kinds("tile_fetch_fwd") == step_cap.kinds("tile_fetch_bwd"),
          "the step's forward and backward compositors at the same sample counts, the fetch pair "
          "forward and backward at the same K")
    print(f"capture: one fit step at {fresh.model_config.blur_samples} blur samples in "
          f"{fresh.model_config.blur_anchors} anchor groups: compositors at S in "
          f"{sorted(set(fwd_s))}")
    errs = step_cap.hold(stacked_shares)

    # five of the fit's steps under the profiler, ranked by the trace report
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fresh.run(PROFILED_STEPS)
        torch.cuda.synchronize()
    trace_path = root / "fit_trace.json"
    prof.export_chrome_trace(str(trace_path))
    del fresh
    table = trace_report.report(trace_path, iters=PROFILED_STEPS, top=8)
    kernel_names = " ".join(k.name for k in trace_report.kernel_stats(
        trace_report.load_trace(trace_path)))
    print(f"capture: trace_report over {PROFILED_STEPS} of the fit's steps:\n{table}")
    for k in ("rasterize_bwd", "rasterize_fwd", "tile_fetch_fwd", "tile_fetch_bwd"):
        check(k in kernel_names, f"the trace report lists {k}")

    # LPIPS: cli.evaluate with weights drawn from a seed, and the card against the CPU
    weights_file = root / "lpips_alex.npz"
    np.savez(weights_file, **lpips.random_weights(SEED))
    os.environ[lpips.ENV_VAR] = str(weights_file)
    try:
        out = timed("evaluate", lambda: cli_evaluate.main(["--load-config",
                                                           str(run_dir / "config.json")]))
        metrics = json.loads((run_dir / "metrics.json").read_text())
        _, evaluator = cli_evaluate.load_trainer_from_config(run_dir / "config.json")
        pred, gt = evaluator.render_eval(0), evaluator._eval_imgs_dev[0]
        w = lpips.load_weights(pred.device)
        on_card = float(lpips.lpips_pair(pred, gt, w))
        on_cpu = float(lpips.lpips_pair(pred.cpu(), gt.cpu(), lpips.load_weights("cpu")))
        lpips_ms = time_cuda(lambda: lpips.lpips_pair(pred, gt, w), 5)
    finally:
        os.environ.pop(lpips.ENV_VAR, None)
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"capture: cli.evaluate psnr {out['results']['psnr']:.4f} ssim "
          f"{out['results']['ssim']:.4f} lpips {metrics['results'].get('lpips')} (random "
          f"weights); LPIPS of eval image 0 on the card ({pred.device}) {on_card!r}, on the CPU "
          f"{on_cpu!r} "
          f"(relative diff {rel:.3g}); {lpips_ms:.3f} ms per {RES}x{RES} eval image")
    check(np.isfinite(metrics["results"].get("lpips", np.nan)), "metrics.json has a finite lpips")
    check(rel <= LPIPS_RTOL, f"LPIPS on the card within {LPIPS_RTOL} of the CPU's")
    print("capture: seconds per tool: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    del evaluator
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "seconds": secs, "lpips_ms": lpips_ms, "errs": errs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2

    from splat_tpu_torch.engine import trainer
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.models import strategy
    from splat_tpu_torch.models.convert import (cameras_from_numpy, params_from_numpy,
                                                scene_from_numpy)
    from splat_tpu_torch.cameras import optimizers as cam_opt
    from splat_tpu_torch.ops import cuda as kcuda
    from splat_tpu_torch.ops import rasterize, tiling
    from splat_tpu_torch.ops.cuda import bin_tiles, build
    from splat_tpu_torch.ops.cuda import rasterize_kernels as rk
    from splat_tpu_torch.ops.cuda.bwd_stacked import bwd_stacked, bwd_stacked_plain, stacked_layout
    from splat_tpu_torch.ops.cuda.chunk_cumsum import chunk_cumsum
    from splat_tpu_torch.ops.cuda.project_sh import project_sh_bwd, project_sh_fwd
    from splat_tpu_torch.ops.cuda.row_gather import row_gather, row_gather_plain
    from splat_tpu_torch.ops.cuda.row_scatter import row_scatter, scatter_plan
    from splat_tpu_torch.ops.cuda.seg_copy import seg_copy, seg_copy_plain
    from splat_tpu_torch.ops.cuda.seg_dma import seg_dma
    from splat_tpu_torch.ops.cuda.tile_fetch import tile_fetch_bwd, tile_fetch_fwd
    from splat_tpu_torch.utils.profiling import nvidia_smi, time_cuda

    probes = {name: load_probe(name) for name in
              ("probe_kernel_gather_torch", "probe_seg_dma_torch", "probe_cumsum_torch",
               "probe_bwd_stacked_torch", "probe_project_sh_torch")}
    cull_probe = load_probe("probe_cull_torch")
    bin_probe = load_probe("probe_bin_tiles_torch")
    fetch_probe = load_probe("probe_tile_fetch_torch")
    ptxas_report = load_probe("time_compositors_torch").ptxas_report
    path_kernels = (tile_fetch_fwd, rk.rasterize_fwd, rk.rasterize_bwd, tile_fetch_bwd,
                    project_sh_fwd, project_sh_bwd, bin_tiles.tile_lists, bin_tiles.population)
    sh_probe = probes.pop("probe_project_sh_torch")
    # off the path since the fetch pair replaced their chain: zeroed with the
    # path's counters, so a path's count of them reads that path alone
    chain_kernels = (seg_copy, row_gather)
    probe_kernels = (row_scatter, scatter_plan, seg_dma, chunk_cumsum, bwd_stacked)
    stacked_probe = probes["probe_bwd_stacked_torch"]

    def reset_counts():
        for kern in path_kernels + chain_kernels + probe_kernels:
            kern.launches = 0

    def state_difference(a_dir: Path, b_dir: Path) -> tuple[list[str], float]:
        """The arrays of two checkpoints' `state.npz` that are not bitwise
        equal, and the worst difference as a share of its array's max."""
        with np.load(a_dir / "state.npz") as a, np.load(b_dir / "state.npz") as b:
            check(sorted(a.files) == sorted(b.files), "both checkpoints hold the same arrays")
            differing, worst = [], 0.0
            for key in a.files:
                if not np.array_equal(a[key], b[key]):
                    differing.append(key)
                    if a[key].dtype.kind == "f" and a[key].shape == b[key].shape:
                        scale = max(float(np.abs(a[key]).max()), 1e-30)
                        worst = max(worst, float(np.abs(a[key] - b[key]).max()) / scale)
                    else:
                        worst = float("inf")
        return differing, worst

    def said(differing: list[str], worst: float) -> str:
        return ("every array bitwise equal" if not differing else
                f"NOT bitwise: {len(differing)} arrays differ, the worst by {worst:.3g} of its "
                f"max ({differing[:6]})")

    def fit_phase() -> dict:
        """Phase 8: a scene directory written, parsed and decoded (held
        against the generator's own Gaussians), trained by `cli.fit`, resumed
        from its middle checkpoint, re-evaluated by `cli.evaluate`, and resumed
        once more across a refine."""
        from splat_tpu_torch.cli import evaluate as cli_evaluate
        from splat_tpu_torch.cli import fit as cli_fit
        from splat_tpu_torch.data import dataparser, dataset, synthetic
        from splat_tpu_torch.engine import config as run_config
        from splat_tpu_torch.ops.ssim import psnr

        work = Path(__file__).resolve().parent / "_runs" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        scene_dir = work / "scene"
        t0 = time.perf_counter()
        generated = synthetic.generate_scene(scene_dir, **FIT_SCENE)
        gen_s = time.perf_counter() - t0
        n_png = len(list((scene_dir / "images").iterdir()))
        png_mb = sum(f.stat().st_size for f in (scene_dir / "images").iterdir()) / 2**20
        print(f"fit: scene of {n_png} frames at {RES}x{RES} ({FIT_SCENE['n_gaussians']} Gaussians, "
              f"{FIT_SCENE['n_seed_points']} seed points) written in {gen_s:.2f} s "
              f"({gen_s / n_png:.3f} s per frame; PNGs {png_mb:.1f} MiB)")
        check(n_png == FIT_FRAMES, "every frame written")

        argv = ["splatfacto", "--data", str(scene_dir), "--output-dir", str(work / "outputs"),
                "--experiment-name", "chip_smoke", "--timestamp", "run", *FIT_FLAGS]
        cfg0 = run_config.parse_cli(argv)
        scene = dataparser.parse_scene(cfg0.data, cfg0.dataparser)
        n_eval = len(scene.eval_cameras)
        check(n_eval >= 2 and scene.train_cameras.width == RES
              and scene.points_xyz.shape[0] == N_GAUSS, "the parsed scene: 2 eval frames, full width")
        train_imgs, eval_imgs = dataset.load_scene_images(scene)
        n_img = len(train_imgs) + len(eval_imgs)
        decode_s = train_imgs.decode_seconds + eval_imgs.decode_seconds
        t0 = time.perf_counter()
        by_png = dataset.ImageCache(scene.eval_paths, decoder="png")
        png_s = (time.perf_counter() - t0) / len(by_png)
        check(np.abs(by_png.images - eval_imgs.images).max() < 1e-6, "the decoders agree")
        print(f"fit: {n_img} images decoded by {train_imgs.decoder!r} in {decode_s:.3f} s "
              f"({decode_s / n_img * 1e3:.1f} ms per image); png.py {png_s * 1e3:.1f} ms per image")
        # a fresh trainer, as `fit` builds it: the model before training, and
        # later the one that resumes
        tc = dataclasses.replace(cfg0.trainer, max_steps=FIT_STEPS, seed=cfg0.seed)
        resumed = trainer.Trainer(scene, cfg0.model, tc, train_images=train_imgs,
                                  eval_images=eval_imgs)
        check(resumed.params.gaussians.alive.shape[0] == LOOP_CAPACITY
              and int(resumed.params.gaussians.alive.sum()) == N_GAUSS, "the initial model")
        before = resumed.evaluate()

        # the data path's gate: the generator's own Gaussians, taken through
        # the parser's transform and scale, rendered by the trainer's eval path
        # on the parsed eval cameras, against every decoded eval frame. A frame
        # matches its own camera far better than the initial model does, and no
        # other camera: wrong pose or velocity conventions, a wrong transform,
        # scale, intrinsics, split or decode would all show here.
        truth = generated["gaussians"]
        rot = torch.tensor(scene.transform[:, :3], dtype=torch.float32, device=dev)
        shift = torch.tensor(scene.transform[:, 3], dtype=torch.float32, device=dev)
        check(torch.equal(rot, torch.eye(3, device=dev)), "orientation none: the transform only shifts")

        def padded(x, fill=0.0):
            out = torch.full((LOOP_CAPACITY, *x.shape[1:]), fill, dtype=torch.float32, device=dev)
            out[:N_GAUSS] = x.to(dev)
            return out

        opac = truth["opacities"].clamp(1e-6, 1 - 1e-6)
        quats = padded(truth["quats"])
        quats[N_GAUSS:, 0] = 1.0
        initial = resumed.params
        resumed.params = initial._replace(
            gaussians=sf.GaussianParams(
                means=padded((truth["means"].to(dev) + shift) * scene.scale),
                scales_log=padded(torch.log(truth["scales"] * scene.scale), -8.0),
                quats=quats, opacities_logit=padded(torch.log(opac / (1 - opac))),
                features_dc=padded((truth["colors"] - 0.5) / 0.28209479177387814),
                features_rest=torch.zeros_like(initial.gaussians.features_rest),
                alive=padded(torch.ones(N_GAUSS))),
            background_logit=torch.full((3,), -30.0, device=dev))      # the scene's black
        frames = torch.as_tensor(eval_imgs.images, device=dev)
        table = [[float(psnr(render, frames[j])) for j in range(n_eval)]
                 for render in (resumed.render_eval(i) for i in range(n_eval))]
        resumed.params = initial
        own = min(table[i][i] for i in range(n_eval))
        other = max(table[i][j] for i in range(n_eval) for j in range(n_eval) if i != j)
        print(f"fit: the generator's Gaussians through the parsed eval cameras against the decoded "
              f"eval frames: psnr {own:.3f} dB on a camera's own frame (the least), {other:.3f} on "
              f"another's (the most); the initial model {before['psnr']:.3f}")
        check(own >= FIT_TRUTH_PSNR_DB and other <= own - 15.0,
              f"the parsed cameras and decoded frames reproduce the generator's scene "
              f"(>= {FIT_TRUTH_PSNR_DB} dB, 15 dB over another camera's frame)")

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_dir = cli_fit.main(argv)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = kcuda.path_launches()
        fit_peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for k, n in fit_launches.items():
            check(n >= FIT_STEPS, f"{k} launched on every step of the fit path")
        for name in ("config.json", "dataparser_transforms.json", "metrics_train.jsonl",
                     "metrics.json"):
            check((run_dir / name).exists(), f"{name} written")
        metrics = json.loads((run_dir / "metrics.json").read_text())
        check(set(metrics) == {"experiment_name", "method_name", "checkpoint", "results",
                               "wall_clock_time_seconds", "compile_time_seconds",
                               "train_time_seconds"}, "metrics.json keys")
        check({"psnr", "ssim"} <= set(metrics["results"]), "metrics.json results")
        check(set(json.loads((run_dir / "dataparser_transforms.json").read_text()))
              == {"transform", "scale"}, "dataparser_transforms.json keys")
        saved_cfg = run_config.load_config(run_dir / "config.json")
        check(saved_cfg.data == str(scene_dir) and saved_cfg.model.blur_samples == 5,
              "config.json loads")
        records = [json.loads(line)
                   for line in (run_dir / "metrics_train.jsonl").read_text().splitlines()]
        evals = [r for r in records if "eval_psnr" in r]
        steps = [r for r in records if "loss" in r]
        check([r["step"] for r in evals] == [100, 200, 300], "evals at 100, 200 and 300")
        check(all(np.isfinite(v) for r in records for v in r.values()), "every record finite")
        check(all(r["n_alive"] == N_GAUSS for r in steps),
              f"all {FIT_STEPS} steps ran on {N_GAUSS} Gaussians")
        ckpts = sorted((run_dir / "checkpoints").iterdir(), key=lambda d: int(d.name[5:]))
        check([d.name for d in ckpts] == ["step_100", "step_200", "step_300"], "three checkpoints")
        ckpt_mb = sum(f.stat().st_size for f in ckpts[-1].iterdir()) / 2**20
        psnrs = [before["psnr"]] + [r["eval_psnr"] for r in evals]
        print(f"fit: {FIT_STEPS} steps in {fit_s:.2f} s with 3 evals and 3 checkpoints "
              f"({FIT_STEPS / metrics['train_time_seconds']:.2f} steps/s over the training loop "
              f"with its evals and saves, {statistics.median(r['steps_per_s'] for r in steps):.2f} "
              f"in the logged windows of train steps); "
              f"launches {fit_launches}; peak memory {fit_peak_gib:.2f} GiB; eval psnr "
              + " -> ".join(f"{v:.3f}" for v in psnrs) + f" dB; compile "
              f"{metrics['compile_time_seconds']:.2f} s; checkpoint {ckpt_mb:.1f} MiB")
        last_meta = json.loads((ckpts[-1] / "meta.json").read_text())
        print("fit: step time by logged window (p50 ms, alive): "
              + ", ".join(f"{r['step']}: {r['step_ms_p50']:.2f} ({r['n_alive']})" for r in steps)
              + f"; at the end capacity {last_meta['capacity']}, max_per_tile "
              f"{last_meta['max_per_tile']}, tile overflow share {last_meta['tile_overflow_frac']}")
        check(psnrs[-1] >= psnrs[0] + FIT_PSNR_GAIN_DB
              and abs(metrics["results"]["psnr"] - psnrs[-1]) <= 1e-6,
              f"eval PSNR rises by {FIT_PSNR_GAIN_DB} dB over the fit")

        # resume: the fresh trainer takes the middle checkpoint and runs to the end
        t0 = time.perf_counter()
        resumed.load_checkpoint(run_dir / "checkpoints" / f"step_{FIT_RESUME_FROM}")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(resumed.step == FIT_RESUME_FROM, "the checkpoint's step")
        resumed.run(FIT_STEPS - FIT_RESUME_FROM)
        t0 = time.perf_counter()
        again = resumed.save_checkpoint(work / "resumed" / f"step_{resumed.step}")
        save_s = time.perf_counter() - t0
        differing, worst = state_difference(ckpts[-1], again)
        print(f"fit: resumed from step {FIT_RESUME_FROM} (load {load_s:.3f} s, save {save_s:.3f} s);"
              f" against the uninterrupted run's last checkpoint: " + said(differing, worst))
        check(worst <= 1e-6, "the resumed run's state within 1e-6 of the uninterrupted run's")
        check(resumed.refine_events == [], "no refine inside the fit: the width stayed whole")
        del resumed

        # the second reader of a checkpoint: cli.evaluate on the run's config.json
        out = cli_evaluate.main(["--load-config", str(run_dir / "config.json"),
                                 "--output-path", str(work / "eval.json")])
        diff = abs(out["results"]["psnr"] - metrics["results"]["psnr"])
        print(f"fit: cli.evaluate reloaded step {out['checkpoint_step']}: psnr "
              f"{out['results']['psnr']:.4f} dB against metrics.json's "
              f"{metrics['results']['psnr']:.4f} (diff {diff:.3g})")
        check(out["checkpoint_step"] == FIT_STEPS and diff <= 1e-4,
              "cli.evaluate reproduces metrics.json's PSNR")

        # resume across refines: two trainers carry the fit's last checkpoint
        # on, on a schedule that refines every REFINE_EVERY steps from here;
        # one runs through, the other starts from the first one's checkpoint
        # taken before the first refine
        span = 2 * REFINE_EVERY
        mc = dataclasses.replace(cfg0.model, warmup_length=FIT_STEPS, refine_every=REFINE_EVERY)
        tc = dataclasses.replace(tc, max_steps=FIT_STEPS + span)
        through = trainer.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs)
        through.load_checkpoint(ckpts[-1])
        through.run(REFINE_EVERY // 2)
        middle = through.save_checkpoint(work / "refine" / "through" / f"step_{through.step}")
        through.run(span - REFINE_EVERY // 2)
        end = through.save_checkpoint(work / "refine" / "through" / f"step_{through.step}")
        joined = trainer.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs)
        joined.load_checkpoint(middle)
        joined.run(span - REFINE_EVERY // 2)
        differing, worst = state_difference(
            end, joined.save_checkpoint(work / "refine" / "joined" / f"step_{joined.step}"))
        events = through.refine_events
        print(f"fit: carried on from step {FIT_STEPS} to {through.step} with refines at "
              f"{[e['step'] for e in events]} (culled {[e['n_culled'] for e in events]}, split + "
              f"cloned {[e['n_split'] + e['n_cloned'] for e in events]}), and again from step "
              f"{FIT_STEPS + REFINE_EVERY // 2}'s checkpoint: " + said(differing, worst)
              + f"; {int(through.params.gaussians.alive.sum())} alive and eval psnr "
              f"{through.evaluate()['psnr']:.3f} dB at the end")
        check([e["step"] for e in events] == [FIT_STEPS + REFINE_EVERY, FIT_STEPS + span]
              and joined.refine_events == events, "both runs refined twice, alike")
        check(events[0]["n_culled"] > 0, "the first refine culled")
        check(worst <= 1e-6, "the run resumed before a refine within 1e-6 of the one that ran through")
        del through, joined
        for sub in ("outputs", "resumed", "refine"):
            shutil.rmtree(work / sub, ignore_errors=True)
        return {"launches": fit_launches, "work": work, "scene_dir": scene_dir,
                "generated": generated}

    dev = torch.device("cuda")
    # phase 1: build and environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul off")
    t0 = time.perf_counter()
    report = build.build(["seg_copy", "rasterize_fwd", "rasterize_bwd", "row_gather",
                          "row_scatter", "seg_dma", "chunk_cumsum", "bwd_stacked", "project_sh",
                          "bin_tiles", "tile_fetch"])
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(report) or 'cached'}")
    for name, r in report.items():
        info = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: {r['seconds']:.2f} s; " + " | ".join(info[:4]))
    compositor_ptxas = {name: ptxas_report(report[name]["log"]) if name in report else "cached"
                        for name in ("rasterize_fwd", "rasterize_bwd")}
    # bwd_stacked at S = 5 in its default layout for 16x16 tiles; row_scatter's
    # sum for rows of a multiple of 4 floats and its plan kernels
    stacked_rows = stacked_layout(5, 256).rows
    probe_ptxas = {
        f"bwd_stacked<5, {stacked_rows}>": ptxas_report(report["bwd_stacked"]["log"],
                                                        f"ILi5ELi{stacked_rows}E")
        if "bwd_stacked" in report else "cached",
        "row_scatter": {**ptxas_report(report["row_scatter"]["log"], "row_scatter_vec4"),
                        **ptxas_report(report["row_scatter"]["log"], "plan_")}
        if "row_scatter" in report else "cached",
        "project_sh_fwd<3>": ptxas_report(report["project_sh"]["log"], "fwd_kernelILi3E")
        if "project_sh" in report else "cached",
        "project_sh_bwd<3>": ptxas_report(report["project_sh"]["log"], "bwd_kernelILi3E")
        if "project_sh" in report else "cached",
        "bin_tiles count": ptxas_report(report["bin_tiles"]["log"], "count_kernel")
        if "bin_tiles" in report else "cached",
        "bin_tiles sort": ptxas_report(report["bin_tiles"]["log"], "sort_kernel")
        if "bin_tiles" in report else "cached",
        "tile_fetch": ptxas_report(report["tile_fetch"]["log"], "tile_fetch_")
        if "tile_fetch" in report else "cached"}
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
    def kernel_inputs(tile_size, model=params, k_pad=K):
        """Camera 0's binning of `model` and its sorted parameter stream
        (through the row_gather kernel)."""
        g = model.gaussians
        op = torch.sigmoid(g.opacities_logit) * g.alive
        motion = sf.camera_motion(model, cams[0], cfg)
        t_a = motion.eps.mean()
        proj, colors = sf.subframe_inputs(model, motion, cfg, cfg.sh_degree, t_a)
        eps = motion.eps - t_a
        lists = rasterize.bin_tiles(proj, op, RES, RES, eps, motion.rs_time, tile_size,
                                    k_pad, cfg.max_tiles_per_gaussian)
        if model is params:
            bin_inputs[tile_size] = bin_probe.from_projection(
                proj, op, eps, motion.rs_time, RES, RES, tile_size, k_pad,
                cfg.max_tiles_per_gaussian)
        table = kcuda.pack_param_table(proj, colors, op)
        sp = kcuda.sorted_stream(table, lists.sorted_ids, k_pad)
        check(torch.equal(sp, row_gather_plain(table, lists.sorted_ids, k_pad)),
              f"row_gather bitwise over the parameter table, K = {k_pad}")
        return lists, sp, eps, motion.rs_time, table

    errs = {}
    bin_inputs = {}
    with torch.no_grad():
        lists, sp, eps, rs, table = kernel_inputs(cfg.tile_size)
        blocks = seg_copy(sp, lists.starts, K, impl="cuda")
        check(torch.equal(blocks, seg_copy_plain(sp, lists.starts, K)), "seg_copy bitwise")
        errs["seg_copy"] = 0.0
        tiles_x = tiling.num_tiles(RES, RES, cfg.tile_size)[0]
        fwd_args = (blocks, lists.counts, rs, cfg.tile_size, tiles_x, RES)
        work = None
        for label, e in (("S=5", eps), ("S=1", None)):
            got = rk.rasterize_fwd(*fwd_args, eps=e, impl="cuda")
            check(torch.equal(got, rk.rasterize_fwd(*fwd_args, eps=e, impl="cuda")),
                  f"rasterize_fwd {label}: two launches bitwise equal")
            want, w = rk.rasterize_fwd_plain(
                blocks, lists.counts, rk.scalar_vec(rs, 0.0, e, dev), cfg.tile_size,
                tiles_x, RES, count_work=True)
            work = work or w
            err_c = (got[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
            err_d = (got[:, :, 3] - want[:, :, 3]).abs().max().item()
            print(f"rasterize_fwd vs plain, tile 16, {label}: max|err| rgb/T {err_c:.3g}, "
                  f"depth {err_d:.3g}")
            check(err_c <= 1e-4 and err_d <= 1e-3, f"rasterize_fwd {label} within tolerance")
            check(w["missed_groups"] == 0, f"the cull keeps every compositing group, {label}")
            errs["rasterize_fwd"] = max(errs.get("rasterize_fwd", 0.0), err_c, err_d)
        def fetch_inputs(lst, tbl, k_pad):
            """The fetch probe's inputs on a binning: a seeded slot gradient
            with NaN past each tile's count (no reader may touch them)."""
            g = torch.randn((lst.counts.shape[0], k_pad, rk.PARAM_STRIDE), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 5))
            g[torch.arange(k_pad, device=dev)[None, :] >= lst.counts.long()[:, None]] = np.nan
            return {"table": tbl, "lists": lst, "k": k_pad, "g": g}

        def check_fetch(label, inp):
            r = fetch_probe.check(inp)
            errs["tile_fetch_fwd"] = errs["tile_fetch_bwd"] = 0.0
            print(f"tile_fetch, {label}: {r['landed']} counted rows of {r['tiles']} tiles at K = "
                  f"{r['k']} bitwise the plain version and the chain (stream {r['stream']} rows); "
                  f"the backward over {r['rows']} rows bitwise its plain version and over two "
                  f"launches, bitwise the chain's on {r['bitwise_chain_rows']} rows (at most two "
                  f"landed entries; most a Gaussian: {r['max_landed_a_gaussian']}), within "
                  f"float32 rounding elsewhere")
            return r

        fetch_cam = fetch_inputs(lists, table, K)
        check_fetch("camera 0, tile 16", fetch_cam)
        lists_r, sp_r, eps_r, rs_r, table_r = kernel_inputs((16, 8))
        check_fetch("camera 0, tile 16x8", fetch_inputs(lists_r, table_r, K))
        blocks_r = seg_copy(sp_r, lists_r.starts, K, impl="cuda")
        check(torch.equal(blocks_r, seg_copy_plain(sp_r, lists_r.starts, K)),
              "seg_copy bitwise, 16x8 tiles")
        r_args = (blocks_r, lists_r.counts, rs_r, (16, 8), tiling.num_tiles(RES, RES, (16, 8))[0],
                  RES)
        got = rk.rasterize_fwd(*r_args, eps=eps_r, impl="cuda")
        check(torch.equal(got, rk.rasterize_fwd(*r_args, eps=eps_r, impl="cuda")),
              "rasterize_fwd 16x8: two launches bitwise equal")
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
            check(torch.equal(got, rk.rasterize_bwd(*args, impl="cuda")),
                  f"rasterize_bwd {label}: two launches bitwise equal")
            want, w = rk.rasterize_bwd_plain(*args, count_work=True)
            check(not got[:, :, rk.NPARAM - 1:].any(), f"rasterize_bwd {label}: zero columns")
            shares = stacked_probe.shares(got, want)
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
        # both compositors on the adversarial rows of the cull's probe
        for tile in (cfg.tile_size, (16, 8)):
            r = cull_probe.check(cull_probe.make_inputs(dev, tile))
            errs["rasterize_fwd"] = max(errs["rasterize_fwd"], r["fwd_rgb_T"], r["fwd_depth"])
            errs["rasterize_bwd"] = max(errs["rasterize_bwd"], r["bwd_max_abs_err"])
            w = r["work"]
            print(f"adversarial rows, tile {tile}, S=16: rasterize_fwd max|err| rgb/T "
                  f"{r['fwd_rgb_T']:.3g}, depth {r['fwd_depth']:.3g}; rasterize_bwd "
                  f"{r['bwd_column_share']:.3g} of max|plain| per column; both bitwise equal over "
                  f"two launches; the cull keeps {w['kept_groups']} of {w['warp_groups']} live "
                  f"(row, warp) groups, every one of the {w['hit_groups']} that composite")
        # bwd_stacked on the backward compositor's inputs (4096 tiles, K = 256,
        # S = 5: 1280 stacked rows on 1024 threads), held to its bounds against
        # its own plain version and against the rasterize_bwd kernel
        stacked_plain = bwd_stacked_plain(*bwd_args)
        stacked_errs = stacked_probe.check({"args": bwd_args}, plain=stacked_plain)
        errs["bwd_stacked"] = stacked_errs["max_abs_err"]
        for label, sh in (("plain", stacked_errs["plain_shares"]),
                          ("rasterize_bwd kernel", stacked_errs["shares"])):
            print(f"bwd_stacked vs {label}, tile 16, S=5: as a share of the scale's max per "
                  f"column {sh['column']:.3g}, per column and 64-slot batch {sh['batch']:.3g}, "
                  f"per row {sh['row']:.3g}")
        print(f"bwd_stacked: max|err| vs plain {errs['bwd_stacked']:.3g}; tps "
              f"{list(stacked_errs['relerr'])} bitwise equal, two launches bitwise equal")
        del lists_r, sp_r, blocks_r, table_r, got, want, stacked_plain

        # row_gather at the backward's shape: the slot gradients (T * K rows
        # and the zero row of dropped entries) at the binning's entry slots
        d_slots = torch.randn((lists.counts.shape[0] * K + 1, rk.PARAM_STRIDE), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 3))
        entry_slots = lists.entry_slots.contiguous()
        check(torch.equal(row_gather(d_slots, entry_slots, impl="cuda"),
                          row_gather_plain(d_slots, entry_slots)),
              "row_gather bitwise over the slot gradients")
        errs["row_gather"] = 0.0
        # seg_dma in both variants on the main path's stream
        dma_variants = probes["probe_seg_dma_torch"].VARIANTS
        for tps, align in dma_variants:
            check(torch.equal(seg_dma(sp, lists.starts, K, tps=tps, align=align, impl="cuda"),
                              blocks), f"seg_dma tps={tps} align={align} bitwise")
        errs["seg_dma"] = 0.0
        # the probe kernels at their probes' shapes
        probe_inputs = {name: mod.make_inputs(dev) for name, mod in probes.items()}
        stacked_probe.check(probe_inputs["probe_bwd_stacked_torch"])    # at the probe's scene
        gather_errs = probes["probe_kernel_gather_torch"].check(
            probe_inputs["probe_kernel_gather_torch"])
        errs["row_scatter"] = gather_errs["row_scatter"]
        probes["probe_seg_dma_torch"].check(probe_inputs["probe_seg_dma_torch"])
        cumsum_errs = probes["probe_cumsum_torch"].check(probe_inputs["probe_cumsum_torch"])
        errs["chunk_cumsum"] = max(cumsum_errs.values())
        # the binning kernels against the plain route, under their contract: at
        # camera 0's binning (tile 16 and 16x8) and on a depth slab's receive
        # buffer (2^23 rows, 3/8 of them live, in four buckets)
        bin_res = {f"camera 0, tile {t}": bin_probe.check(inp) for t, inp in bin_inputs.items()}
        slab_inputs = bin_probe.make_inputs(dev, rows=1 << 23, live=0.375)
        bin_res["2^23 rows, 3/8 live"] = bin_probe.check(slab_inputs)
        fetch_slab = fetch_probe.make_inputs(dev, slab_inputs, SEED + 6)
        check_fetch("2^23 rows, 3/8 live", fetch_slab)
        for label, r in bin_res.items():
            print(f"bin_tiles vs the plain route, {label}: {r['real']} real entries of "
                  f"{r['live_rows']} live rows, {r['landed']} landed, sorted_ids compared at "
                  f"{r['compared']}; long tiles {r['long_tiles']} (largest tile {r['max_tile_real']}"
                  f"); two launches bitwise equal, tile_population equal")
        # the projection and SH pair against the plain route at 2^20 slots
        sh_inputs = sh_probe.make_inputs(dev)
    sh_res = sh_probe.check(sh_inputs)
    fwd_keys = sh_probe.FWD_NAMES + ("colors",)
    errs["project_sh_fwd"] = max(sh_res["errs"][k] for k in fwd_keys)
    errs["project_sh_bwd"] = max(v for k, v in sh_res["errs"].items() if k.startswith("d_"))
    print(f"project_sh vs the plain route at {sh_probe.N} slots (degree {sh_probe.DEGREE}, "
          f"velocities): forward {errs['project_sh_fwd']:.3g} of max|plain| at most, gradients "
          f"{errs['project_sh_bwd']:.3g} ({sh_res['errs']}); mismatches {sh_res['mismatches']}, "
          f"each within float32 rounding of an integer before ceil; the backward bitwise equal "
          f"over two launches")
    check(sh_res["mismatches"]["frozen_bwd_launches"] == 1,
          "the frozen Gaussians' backward launched once, for the camera alone")
    with torch.no_grad():
        print(f"row_gather bitwise (parameter table {tuple(sp.shape)}, slot gradients "
              f"{entry_slots.numel()} rows, probe shape); seg_dma bitwise in "
              f"{len(dma_variants)} variants (main path and probe streams); row_scatter "
              f"{gather_errs['row_scatter_share']:.3g} of max|column| from the float64 sum, "
              f"two launches bitwise equal; chunk_cumsum max|err| "
              + ", ".join(f"{k} {v:.3g}" for k, v in cumsum_errs.items()))

        # phase 3: the render path at full width, counting launches
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = [sf.render_camera(params, cams[i], cfg, cfg.sh_degree, bg)
                  for i in range(N_CAMERAS)]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / N_CAMERAS
        by_path = {"render": kcuda.path_launches()}
        render_launches = {k: v for k, v in by_path["render"].items()
                           if k not in ("rasterize_bwd", "tile_fetch_bwd", "project_sh_bwd")}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"render path: {N_CAMERAS} cameras, launches {render_launches}, "
              f"first pass {first_ms:.1f} ms/camera, peak memory {peak_gib:.2f} GiB")
        for k, n in render_launches.items():
            check(n > 0, f"{k} launched on the render path")
        check(rk.rasterize_bwd.launches == tile_fetch_bwd.launches == project_sh_bwd.launches == 0,
              "no backward launched by a render")
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
    eval_fields = camera_fields(SEED + 11, N_EVAL_CAMERAS)
    eval_cams = cameras_from_numpy(eval_fields, device=dev)

    def target_image(cam):
        out = sf.render_camera(target, cam, cfg, cfg.sh_degree, sf.background_color(target, cfg))
        return sf.gamma_encode(out.rgb, cfg)

    with torch.no_grad():
        gts = [target_image(cams[i]) for i in range(N_CAMERAS)]
        eval_gts = [target_image(eval_cams[i]) for i in range(N_EVAL_CAMERAS)]
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
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, n_visible = [], []
    for i in range(TRAIN_STEPS):
        loss, aux, state = trainer.train_step(params, opt, state, cfg, cams[i % N_CAMERAS],
                                              gts[i % N_CAMERAS], TRAIN_START + i)
        losses.append(loss)
        n_visible.append(aux["n_visible"])
    torch.cuda.synchronize()
    step_launches = by_path["train"] = kcuda.path_launches()
    losses = torch.stack(losses).tolist()
    print(f"train: {TRAIN_STEPS} steps from step {TRAIN_START}, launches {step_launches}; losses "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; n_visible {[int(v) for v in n_visible[:N_CAMERAS]]}; "
          f"max grad_count {int(state.grad_count.max())}")
    for k, n in step_launches.items():
        check(n >= TRAIN_STEPS, f"{k} launched on every training step")
    check(step_launches["tile_fetch_fwd"] == step_launches["tile_fetch_bwd"]
          == step_launches["bin_tiles"],
          "the fetch pair launched once a binning (an anchor group), forward and backward")
    check(seg_copy.launches == row_gather.launches == 0,
          "the training step launches neither row_gather nor seg_copy")
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

    # phase 5: the training loop at full width, through Trainer.run
    tree = model_tree()
    scene, train_imgs, eval_imgs = scene_from_numpy(dict(
        train_cameras=camera_fields(), eval_cameras=eval_fields,
        train_images=torch.stack(gts).cpu().numpy(),
        eval_images=torch.stack(eval_gts).cpu().numpy(),
        points_xyz=tree["gaussians"]["means"][:LOOP_SEED_POINTS], points_rgb=None), device=dev)
    loop_cfg = dataclasses.replace(cfg, initial_capacity=LOOP_CAPACITY, **LOOP_SCHEDULE)
    loop_tc = trainer.TrainerConfig(max_steps=LOOP_STEPS, seed=SEED, log_every=10)
    t0 = time.perf_counter()
    loop = trainer.Trainer(scene, loop_cfg, loop_tc, train_images=train_imgs,
                           eval_images=eval_imgs)
    with torch.no_grad():     # the initial model: the bench scene in the first N_GAUSS slots
        for field, value in tree["gaussians"].items():
            getattr(loop.params.gaussians, field)[:N_GAUSS].copy_(
                torch.as_tensor(value, device=dev))
    check(loop.params.gaussians.alive.shape[0] == LOOP_CAPACITY
          and int(loop.params.gaussians.alive.sum()) == N_GAUSS, "the loop's initial model")
    fullest = []
    probe_counts = loop._probe_counts

    def recording_probe(cam):
        counts = probe_counts(cam)
        fullest.append(int(counts.max()))
        return counts

    loop._probe_counts = recording_probe
    before = loop.evaluate()
    print(f"loop: trainer ready in {time.perf_counter() - t0:.1f} s; capacity {LOOP_CAPACITY}, "
          f"{N_CAMERAS} train and {N_EVAL_CAMERAS} eval cameras, blur anchors "
          f"{loop.model_config.blur_anchors}; eval before: psnr {before['psnr']:.3f} dB, "
          f"ssim {before['ssim']:.4f}")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history = loop.run(LOOP_STEPS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = by_path["loop"] = kcuda.path_launches()
    chain_launches = {"seg_copy": seg_copy.launches, "row_gather": row_gather.launches}
    check(not any(chain_launches.values()),
          f"the training loop launches neither seg_copy nor row_gather: {chain_launches}")
    loop_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    after = loop.evaluate()
    events = loop.refine_events
    for e in events:
        print(f"  refine at step {e['step']}: culled {e['n_culled']}, split {e['n_split']}, "
              f"cloned {e['n_cloned']}, alive {e['n_alive']}; capacity {e['capacity']}"
              f"{' (grew)' if e['grew'] else ''}, max_per_tile {e['max_per_tile']}"
              f"{' (adapted)' if e['adapted'] else ''}{', opacity reset' if e['reset'] else ''}")
    for rec in history:
        print(f"  step {rec['step']}: loss {rec['loss']:.5f}, n_alive {rec['n_alive']}, "
              f"tile_overflow_frac {rec.get('tile_overflow_frac')}, "
              f"step_ms_p50 {rec['step_ms_p50']:.2f}")
    n_eval_steps = len(range(0, LOOP_STEPS, loop_tc.eval_opt_every))
    print(f"loop: {LOOP_STEPS} steps in {loop_s:.2f} s, launches {launches} "
          f"({n_eval_steps} eval-camera steps); fullest tile at the probes {fullest}; "
          f"peak memory {loop_peak_gib:.2f} GiB; eval after: psnr {after['psnr']:.3f} dB, "
          f"ssim {after['ssim']:.4f}")
    windows = window_ms(loop.timer.windows)
    spans = {"steps 1-40": windows[:4], "41-80": windows[4:8], "81-200": windows[8:],
             "all": windows}
    for label, w in spans.items():
        qs = statistics.quantiles(w, n=4)
        print(f"  step time, {label}: median {statistics.median(w):.3f} ms "
              f"(quartiles {qs[0]:.3f} / {qs[2]:.3f}) over {len(w)} windows of "
              f"{loop_tc.sync_every} steps")
    check([e["step"] for e in events] == [40, 80, 160, 200],
          "refines at 40, 80, 160 and 200: the one at 120 is paused after the reset")
    check([e["reset"] for e in events] == [False, True, False, False],
          "one opacity reset, at step 80; none at 160 without a recovery window")
    check(any(e["n_culled"] > 0 for e in events)
          and any(e["n_split"] + e["n_cloned"] > 0 for e in events),
          "refines culled and densified")
    check(any(e["n_culled"] > 0 and e["n_split"] + e["n_cloned"] > 0 for e in events),
          "one refine both culled and densified")
    grown = [e for e in events if e["grew"]]
    check(bool(grown) and grown[0]["capacity"] == 2 * LOOP_CAPACITY, "the capacity doubled")
    capacity = events[-1]["capacity"]
    gauss = loop.params.gaussians
    check(all(getattr(gauss, f).shape[0] == capacity for f in gauss._fields)
          and loop.strat_state.grad_accum.shape[0] == capacity, "every leaf at the new capacity")
    for leaf in loop.optimizer.gaussian_leaves():
        state = loop.optimizer.adam.state[leaf]
        check(state["exp_avg"].shape == leaf.shape and float(state["step"]) == LOOP_STEPS
              and bool(torch.isfinite(state["exp_avg"]).all())
              and bool(state["exp_avg"][:N_GAUSS].any()),
              "Adam's moments carried across the growth")
    check(loop.optimizer.schedule.last_epoch == LOOP_STEPS, "the decays' count carried")
    by_step = {rec["step"]: rec for rec in history}
    grow_step = grown[0]["step"]
    check(grow_step < LOOP_STEPS
          and by_step[grow_step + 10]["loss"] < 2 * by_step[grow_step]["loss"],
          "training carries on across the growth and the loss does not jump")
    check(all(np.isfinite(v) for rec in history for v in rec.values()), "every record finite")
    check(all(bool(torch.isfinite(p).all()) for p in loop.optimizer.params), "parameters finite")
    check(len(fullest) == len(events) and not events[0]["adapted"] and events[1]["adapted"],
          "max_per_tile grows on the second over-tolerance probe")
    new_k = K
    while new_k < fullest[1] and new_k < loop_tc.max_tile_capacity:
        new_k *= 2
    new_k = min(new_k, loop_tc.max_tile_capacity)
    check(events[1]["max_per_tile"] == new_k > K and loop.model_config.max_per_tile >= new_k,
          f"max_per_tile grew to {new_k}, the power of two at or above the fullest tile "
          f"({fullest[1]}), capped by {loop_tc.max_tile_capacity}")
    check(by_step[LOOP_STEPS]["tile_overflow_frac"] is not None, "the tile probe is recorded")
    for k, n in launches.items():
        # each refine's tile probe projects through the step's own kernel
        n_probes = len(events) if k == "project_sh_fwd" else 0
        check(n == LOOP_STEPS + n_eval_steps + n_probes,
              f"{k} launched once on each of the loop's train and eval-camera steps"
              + (f" and once on each of its {n_probes} tile probes" if n_probes else ""))
    check(all(float(v.detach().abs().sum()) > 0 for v in loop.params.eval_camera_opt.values()),
          "the eval cameras' corrections moved")
    check(after["psnr"] > before["psnr"], f"eval PSNR rises: {before['psnr']:.3f} -> "
                                          f"{after['psnr']:.3f} dB")
    with torch.no_grad():    # the three compositing kernels at the grown K, trained model
        k2 = loop.model_config.max_per_tile
        lists2, sp2, eps2, _, table2 = kernel_inputs(cfg.tile_size, loop.params, k2)
        blocks2 = seg_copy(sp2, lists2.starts, k2, impl="cuda")
        check(torch.equal(blocks2, seg_copy_plain(sp2, lists2.starts, k2)),
              f"seg_copy bitwise at K = {k2}")
        check_fetch(f"the trained model, K = {k2}", fetch_inputs(lists2, table2, k2))
        got = rk.rasterize_fwd(blocks2, lists2.counts, rs, cfg.tile_size, tiles_x, RES, eps=eps2,
                               impl="cuda")
        want = rk.rasterize_fwd(blocks2, lists2.counts, rs, cfg.tile_size, tiles_x, RES,
                                eps=eps2, impl="torch")
        err_c = (got[:, :, [0, 1, 2, 4]] - want[:, :, [0, 1, 2, 4]]).abs().max().item()
        err_d = (got[:, :, 3] - want[:, :, 3]).abs().max().item()
        print(f"after the loop, K = {k2}: fullest tile {int(lists2.counts.max())}, landed "
              f"{int(lists2.counts.sum())}, overflow {int(lists2.overflow)}; rasterize_fwd vs "
              f"plain max|err| rgb/T {err_c:.3g}, depth {err_d:.3g}")
        check(err_c <= 1e-4 and err_d <= 1e-3, f"rasterize_fwd at K = {k2} within tolerance")
        check_bwd(f"tile 16, S=5, K = {k2}", blocks2, lists2, eps2, cfg.tile_size, tiles_x, RES)
        del lists2, sp2, blocks2, table2, got, want
    del loop, scene, train_imgs, eval_imgs

    # phase 6: the probe entry points' timing loops (the path of the probe kernels)
    with torch.no_grad():
        reset_counts()
        gather_res = probes["probe_kernel_gather_torch"].bench(
            probe_inputs["probe_kernel_gather_torch"], KERNEL_RUNS, KERNEL_REPS)
        dma_res = probes["probe_seg_dma_torch"].bench(
            probe_inputs["probe_seg_dma_torch"], KERNEL_RUNS, KERNEL_REPS)
        cumsum_res = probes["probe_cumsum_torch"].bench(probe_inputs["probe_cumsum_torch"], 5, 5)
        stacked_res = stacked_probe.bench(probe_inputs["probe_bwd_stacked_torch"], 5, 5)
        torch.cuda.synchronize()
    probe_launches = {"row_scatter": row_scatter.launches, "scatter_plan": scatter_plan.launches,
                      "seg_dma": seg_dma.launches, "chunk_cumsum": chunk_cumsum.launches,
                      "bwd_stacked": bwd_stacked.launches}
    print("bwd_stacked, probe scene: " + ", ".join(
        f"tps={t} {ms:.4f}" for t, ms in stacked_res["tps"].items())
        + f" ms; rasterize_bwd {stacked_res['rasterize_bwd_ms']:.4f} ms")
    print(f"probes: launches {probe_launches}")
    for k, n in probe_launches.items():
        check(n > 0, f"{k} launched by its probe")
    del probe_inputs

    with torch.no_grad():
        # phase 7: the kernels' times, on phase 2's inputs (the initial model)
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

        # row_gather at the chain's two shapes (the training path's before the
        # fetch pair): the sorted ids over the parameter table (with the K pad
        # rows), the entry slots over the slot gradients. Bytes: every output
        # row written, the ids read, and each distinct source row read once
        # (the sources fit the L2).
        def gather_times(src, ids, pad):
            n = ids.numel()
            nbytes = ((n + pad + int(torch.unique(ids).numel())) * src.shape[1] + n) * 4
            return {"ms": time_cuda(lambda: row_gather(src, ids, impl="cuda", pad_rows=pad),
                                    KERNEL_RUNS, KERNEL_REPS),
                    "plain_ms": time_cuda(lambda: row_gather_plain(src, ids, pad), KERNEL_RUNS,
                                          KERNEL_REPS),
                    "library_ms": time_cuda(lambda: torch.index_select(src, 0, ids), KERNEL_RUNS,
                                            KERNEL_REPS),
                    "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "rows": n}

        gather_fwd = gather_times(table, lists.sorted_ids.contiguous(), K)
        gather_bwd = gather_times(d_slots, entry_slots, 0)
        for label, r in (("parameter table", gather_fwd), ("slot gradients", gather_bwd)):
            print(f"row_gather, {label}, {r['rows']} rows: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, index_select {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ms from {r['bytes']} B)")
        a = gather_res["row_gather"]
        print(f"row_gather, probe shape: {a['ms']:.4f} ms (plain {a['plain_ms']:.4f}, "
              f"index_select {a['library_ms']:.4f}; cold cache {a['cold_ms']:.4f}, "
              f"index_select {a['library_cold_ms']:.4f}; bound {a['bytes'] / hbm * 1e3:.4f} ms "
              f"from {a['bytes']} B)")
        b = gather_res["row_scatter"]
        print(f"row_scatter, probe shape: {b['ms']:.4f} ms with its plan on the card (plan "
              f"{b['plan_ms']:.4f}, sum given the plan {b['kernel_ms']:.4f}; plain "
              f"{b['plain_ms']:.4f}, index_add_ {b['library_ms']:.4f}; cold cache {b['cold_ms']:.4f}, "
              f"sum {b['kernel_cold_ms']:.4f}, index_add_ {b['library_cold_ms']:.4f}; bound "
              f"{b['bytes'] / hbm * 1e3:.4f} ms from {b['bytes']} B)")
        print(f"seg_dma, probe shape: " + ", ".join(f"{k} {v:.4f}"
                                                     for k, v in dma_res["variants"].items())
              + f" ms; seg_copy {dma_res['seg_copy_ms']:.4f}, plain {dma_res['plain_ms']:.4f}, "
              f"index_select {dma_res['library_ms']:.4f}; cold cache {dma_res['best']} "
              f"{dma_res['cold_ms']:.4f}, seg_copy {dma_res['seg_copy_cold_ms']:.4f}; bound "
              f"{dma_res['bytes'] / hbm * 1e3:.4f} ms from {dma_res['bytes']} B")
        print(f"chunk_cumsum, probe shape: " + ", ".join(
            f"{k} {v:.4f}" for k, v in cumsum_res["variants"].items())
            + f" ms; plain {cumsum_res['plain_ms']:.4f}, torch.cumsum(x, 1) - x "
            f"{cumsum_res['library_ms']:.4f}, bound {cumsum_res['bytes'] / hbm * 1e3:.4f} ms "
            f"from {cumsum_res['bytes']} B")

        fwd_ms = time_cuda(lambda: rk.rasterize_fwd(*fwd_args, eps=eps, impl="cuda"),
                           KERNEL_RUNS, KERNEL_REPS)
        fwd_plain_ms = time_cuda(lambda: rk.rasterize_fwd(*fwd_args, eps=eps, impl="torch"), 5)
        def compositor_bound(w, flops_per_hit, flops_per_row, extra_flops, nbytes):
            """The least time for a compositor's work, counted two ways:
            every live pixel of a live tile row ("pixel": the old count), or
            only the (row, warp) groups where some pair composites ("warp":
            the least any warp-granular design does). Each is the larger of
            the bytes and the operations (FP32 flops, or the exps on the
            special-function units); the bound is the smaller count's."""
            out = {}
            for gran, pairs, row_pixels in (("pixel", "live_pairs", "live_row_pixels"),
                                            ("warp", "warp_live_pairs", "warp_live_row_pixels")):
                flops = (w[pairs] * FLOPS_PER_PAIR + w["hit_pairs"] * flops_per_hit + extra_flops
                         + w[row_pixels] * FLOPS_PER_ROW_PIXEL + w["live_rows"] * flops_per_row)
                times = {"bytes": nbytes / hbm * 1e3,
                         "operations": max(flops / fp32_peak, w["hit_pairs"] / sfu_peak) * 1e3}
                by = max(times, key=times.get)
                out[gran] = {"ms": times[by], "by": by, "flops": flops}
            out["bound"] = min(out["pixel"], out["warp"], key=lambda r: r["ms"])
            return out

        def said_bound(b):
            return (f"bound {b['bound']['ms']:.4f} ms by {b['bound']['by']} (warp-granular count "
                    f"{b['warp']['flops']} flop, {b['warp']['ms']:.4f} ms; pixel-granular "
                    f"{b['pixel']['flops']} flop, {b['pixel']['ms']:.4f} ms)")

        fwd_bytes = (work["live_rows"] * rk.PARAM_STRIDE * 4 + n_tiles * 4
                     + n_tiles * n_s * rk.NOUT * npix * 4)
        fwd_b = compositor_bound(work, FWD_FLOPS_PER_HIT, FLOPS_PER_ROW, 0, fwd_bytes)
        keep_share = work["kept_groups"] / max(work["warp_groups"], 1)
        print(f"seg_copy: {seg_ms:.4f} ms (plain {seg_plain_ms:.4f}, index_select "
              f"{seg_lib_ms:.4f}, bound {seg_bound:.4f} ms from {seg_bytes} B: "
              f"{seg_rows_read} stream rows read, {n_tiles * K} written)")
        print(f"rasterize_fwd: {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}; {said_bound(fwd_b)}; "
              f"at {fp32_peak / 1e12:.1f} TFLOP/s, {work['hit_pairs']} exp at "
              f"{sfu_peak / 1e12:.2f} T/s, {fwd_bytes} B)")
        print(f"the cull at camera 0's binning: {work['warp_groups']} (row, warp) groups with a "
              f"live pixel, {work['kept_groups']} kept ({keep_share:.4f}), {work['hit_groups']} "
              f"composite ({work['hit_groups'] / max(work['warp_groups'], 1):.4f}); live pairs "
              f"{work['live_pairs']}, in composing groups {work['warp_live_pairs']}; live (row, "
              f"pixel) steps {work['live_row_pixels']}, in composing groups "
              f"{work['warp_live_row_pixels']}; a warp runs the compositing step "
              f"{work['hit_warp_samples']} times ((row, warp, sample) with a hit), "
              f"{work['hit_pairs'] / max(32 * work['hit_warp_samples'], 1):.4f} of its lanes "
              f"compositing there")
        for kname, rep_ in compositor_ptxas.items():
            print(f"ptxas, {kname} at S=5: {rep_}")

        bwd_ms = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="cuda"), KERNEL_RUNS,
                           KERNEL_REPS)
        bwd_plain_ms = time_cuda(lambda: rk.rasterize_bwd(*bwd_args, impl="torch"), 3)
        bw = bwd_work
        bwd_bytes = (bw["live_rows"] * rk.PARAM_STRIDE * 4 + n_tiles * 4
                     + 2 * n_tiles * n_s * rk.NOUT * npix * 4 + n_tiles * K * rk.PARAM_STRIDE * 4)
        bwd_b = compositor_bound(bw, BWD_FLOPS_PER_HIT, BWD_FLOPS_PER_ROW,
                                 bw["sigma_pairs"] * BWD_FLOPS_PER_SIGMA, bwd_bytes)
        print(f"rasterize_bwd: {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}; {said_bound(bwd_b)}; "
              f"at {fp32_peak / 1e12:.1f} TFLOP/s from {bw['live_pairs']} live pairs, "
              f"{bw['hit_pairs']} compositing ({bw['sigma_pairs']} below the clamp), "
              f"{bw['live_row_pixels']} live (row, pixel) steps, {bw['live_rows']} live rows; "
              f"{bw['hit_pairs']} exp at {sfu_peak / 1e12:.2f} T/s; {bwd_bytes} B)")

        # bwd_stacked on the same inputs: the fastest tps of the probe's loop.
        # It computes rasterize_bwd's function, so its least time is
        # rasterize_bwd's. Its mapping does more than that count: a thread
        # forms the sigma coefficients once per distinct pixel strip of its
        # rows, and the per-sample cull keeps (row, strip, sample) groups.
        best_tps = stacked_res["best"]
        stacked_ms = time_cuda(lambda: bwd_stacked(*bwd_args, tps=best_tps, impl="cuda"),
                               KERNEL_RUNS, KERNEL_REPS)
        _, stacked_work = bwd_stacked_plain(*bwd_args, count_work=True)
        stacked_plain_ms = time_cuda(lambda: bwd_stacked_plain(*bwd_args), 2)
        check(stacked_work["missed_groups"] == 0,
              "the per-sample cull keeps every (row, strip, sample) group that composites")
        rows_a_thread, _, coefficient_passes = stacked_layout(n_s, npix)
        stacked_extra_flops = int(bw["live_row_pixels"] * FLOPS_PER_ROW_PIXEL
                                  * (coefficient_passes - 1))
        print(f"bwd_stacked: {stacked_ms:.4f} ms at tps={best_tps}, {rows_a_thread} rows a thread "
              f"(plain {stacked_plain_ms:.4f}; bound {bwd_b['bound']['ms']:.4f} ms by "
              f"{bwd_b['bound']['by']}, rasterize_bwd's: the same function of the same inputs; "
              f"its mapping forms the sigma coefficients {coefficient_passes:.3f} times per pixel, "
              f"{stacked_extra_flops} flop beyond that count, "
              f"{stacked_extra_flops / fp32_peak * 1e3:.4f} ms at the peak rate)")
        print(f"bwd_stacked's per-sample cull: {stacked_work['groups']} (row, strip, sample) groups "
              f"with a live row, {stacked_work['kept_groups']} kept "
              f"({stacked_work['kept_groups'] / max(stacked_work['groups'], 1):.4f}), "
              f"{stacked_work['hit_groups']} composite (the forward's {work['hit_warp_samples']} "
              f"compositing steps), {stacked_work['missed_groups']} culled that composite")
        for kname, rep_ in probe_ptxas.items():
            print(f"ptxas, {kname}: {rep_}")
        del bwd_args, fwd_args, blocks, sp, table, d_slots
    sh_times = sh_probe.bench(sh_inputs, KERNEL_RUNS, KERNEL_REPS)
    del sh_inputs
    bin_times = {f"camera 0, tile {cfg.tile_size}": bin_probe.bench(bin_inputs[cfg.tile_size]),
                 "2^23 rows, 3/8 live": bin_probe.bench(slab_inputs)}
    for label, bt in bin_times.items():
        print(f"bin_tiles, {label}: {bt['ms']:.4f} ms a binning (bound {bt['bound_ms']:.4f} ms "
              f"by bytes from {bt['bytes']} B; the plain route {bt['plain_ms']:.4f}; torch.sort "
              f"of the culled-in entries' int64 keys {bt['library_ms']:.4f})")
    del slab_inputs, bin_inputs
    # the fetch pair also at the benchmark cell's own camera 0 (its trainer set
    # up as perfbench/run.py sets it up; checked before it is timed)
    fetch_bench = fetch_probe.make_inputs(dev, bin_probe.cell_inputs(dev, "phone_mbrs.train",
                                                                     SEED), SEED + 7)
    with torch.no_grad():
        check_fetch("phone_mbrs.train's camera 0", fetch_bench)
    fetch_times = {"phone_mbrs.train's camera 0": fetch_probe.bench(fetch_bench),
                   f"camera 0, tile {cfg.tile_size}": fetch_probe.bench(fetch_cam),
                   "2^23 rows, 3/8 live": fetch_probe.bench(fetch_slab)}
    for label, ft in fetch_times.items():
        print(f"tile_fetch, {label}: forward {ft['fwd_ms']:.4f} ms (bound {ft['fwd_bound_ms']:.4f} "
              f"ms by bytes from {ft['fwd_bytes']} B; plain {ft['fwd_plain_ms']:.4f}; the chain "
              f"it replaced, row_gather and seg_copy, {ft['fwd_chain_ms']:.4f}), backward "
              f"{ft['bwd_ms']:.4f} ms (bound {ft['bwd_bound_ms']:.4f} from {ft['bwd_bytes']} B; "
              f"plain {ft['bwd_plain_ms']:.4f}; the chain, cat, row_gather and sum, "
              f"{ft['bwd_chain_ms']:.4f})")
    del fetch_cam, fetch_slab, fetch_bench
    print(f"project_sh at {sh_probe.N} slots, degree {sh_probe.DEGREE}, velocities: forward "
          f"{sh_times['fwd_ms']:.4f} ms (bound {sh_times['fwd_bound_ms']:.4f} ms by bytes; plain "
          f"closed form {sh_times['fwd_plain_ms']:.4f}; the plain route "
          f"{sh_times['route_fwd_ms']:.4f}), backward {sh_times['bwd_ms']:.4f} ms (bound "
          f"{sh_times['bwd_bound_ms']:.4f}; plain closed form {sh_times['bwd_plain_ms']:.4f}); "
          f"forward and backward through autograd: kernels {sh_times['kernel_fwd_bwd_ms']:.4f} "
          f"ms, the plain route {sh_times['route_fwd_bwd_ms']:.4f} ms")

    fit = fit_phase()
    tools = render_tools_phase(Path(__file__).resolve().parent, reset_counts,
                               stacked_probe.shares)
    for kname, err in tools["errs"].items():
        errs[kname] = max(errs[kname], err)
    t0 = time.perf_counter()
    capture = capture_phase(fit["work"], fit["scene_dir"], fit["generated"], reset_counts,
                            stacked_probe.shares)
    for kname, err in capture["errs"].items():
        errs[kname] = max(errs[kname], err)
    print(f"capture: phase 10 took {time.perf_counter() - t0:.1f} s")
    mesh = mesh_phase(params, cams, cfg, fit["work"], fit["scene_dir"], reset_counts,
                      stacked_probe.shares, card)
    for kname, err in mesh["errs"].items():
        if kname in errs:
            errs[kname] = max(errs[kname], err)
    shutil.rmtree(fit["work"], ignore_errors=True)

    # seg_copy and row_gather are off the path (the fetch pair replaced their
    # chain): their launches are the loop's (phase 5), 0
    kernels = [
        {"name": "seg_copy", "route": "cuda", "source": "splat_tpu_torch/ops/cuda/csrc/seg_copy.cu",
         "replaces": "splat_tpu/ops/pallas/seg_copy.py:75", "launches": chain_launches["seg_copy"],
         "max_abs_err": errs["seg_copy"], "ms": seg_ms, "plain_ms": seg_plain_ms,
         "bound_ms": seg_bound, "bound_by": "bytes", "library_ms": seg_lib_ms},
        {"name": "rasterize_fwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/rasterize_fwd.cu",
         "replaces": "splat_tpu/ops/pallas/rasterize_kernels_gmajor.py:538",
         # the same function in the TPU's other memory layouts; here one layout, (T, K, 16)
         "covers": ["splat_tpu/ops/pallas/rasterize_kernels.py:586",
                    "splat_tpu/ops/pallas/rasterize_kernels_gmajor.py:428"],
         "launches": launches["rasterize_fwd"], "max_abs_err": errs["rasterize_fwd"],
         "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_b["bound"]["ms"],
         "bound_by": fwd_b["bound"]["by"], "library_ms": None,
         # the bound counted over every live pixel of a tile (before the cull)
         "pixel_bound_ms": fwd_b["pixel"]["ms"], "cull_keep_share": keep_share},
        {"name": "rasterize_bwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/rasterize_bwd.cu",
         "replaces": "splat_tpu/ops/pallas/rasterize_kernels.py:636",
         "covers": ["splat_tpu/ops/pallas/rasterize_kernels_gmajor.py:482"],
         "launches": launches["rasterize_bwd"], "max_abs_err": errs["rasterize_bwd"],
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_b["bound"]["ms"],
         "bound_by": bwd_b["bound"]["by"], "library_ms": None,
         "pixel_bound_ms": bwd_b["pixel"]["ms"], "cull_keep_share": keep_share},
        # the chain's forward gather (the sorted ids over the parameter table)
        {"name": "row_gather", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/row_gather.cu",
         "replaces": "scripts_dev/probe_kernel_gather.py:59",
         "launches": chain_launches["row_gather"],
         "max_abs_err": errs["row_gather"], "ms": gather_fwd["ms"],
         "plain_ms": gather_fwd["plain_ms"], "bound_ms": gather_fwd["bound_ms"],
         "bound_by": "bytes", "library_ms": gather_fwd["library_ms"]},
        # the probe kernels, at their probes' shapes; launches from the probes' timing loops
        {"name": "row_scatter", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/row_scatter.cu",
         "replaces": "scripts_dev/probe_kernel_gather.py:90",
         "launches": probe_launches["row_scatter"], "max_abs_err": errs["row_scatter"],
         # the whole function, its plan made on the card; the sum given a plan; the plan
         "ms": b["ms"], "kernel_ms": b["kernel_ms"], "plan_ms": b["plan_ms"],
         "plan_launches": probe_launches["scatter_plan"], "plain_ms": b["plain_ms"],
         "bound_ms": b["bytes"] / hbm * 1e3, "bound_by": "bytes", "library_ms": b["library_ms"]},
        {"name": "seg_dma", "route": "cuda", "source": "splat_tpu_torch/ops/cuda/csrc/seg_dma.cu",
         "replaces": "scripts_dev/probe_seg_dma.py:96", "launches": probe_launches["seg_dma"],
         "max_abs_err": errs["seg_dma"], "ms": dma_res["ms"], "plain_ms": dma_res["plain_ms"],
         "bound_ms": dma_res["bytes"] / hbm * 1e3, "bound_by": "bytes",
         "library_ms": dma_res["library_ms"]},
        {"name": "chunk_cumsum", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/chunk_cumsum.cu",
         "replaces": "scripts_dev/probe_cumsum.py:42", "launches": probe_launches["chunk_cumsum"],
         "max_abs_err": errs["chunk_cumsum"], "ms": cumsum_res["ms"],
         "plain_ms": cumsum_res["plain_ms"], "bound_ms": cumsum_res["bytes"] / hbm * 1e3,
         "bound_by": "bytes", "library_ms": cumsum_res["library_ms"]},
        # at the backward compositor's inputs; no single PyTorch call computes it
        {"name": "bwd_stacked", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/bwd_stacked.cu",
         "replaces": "scripts_dev/probe_bwd_stacked.py:198",
         "launches": probe_launches["bwd_stacked"], "max_abs_err": errs["bwd_stacked"],
         "ms": stacked_ms, "plain_ms": stacked_plain_ms,
         "bound_ms": bwd_b["bound"]["ms"], "bound_by": bwd_b["bound"]["by"],
         "library_ms": None, "coefficient_passes": coefficient_passes,
         "rows_a_thread": rows_a_thread, "kept_groups": stacked_work["kept_groups"],
         "hit_groups": stacked_work["hit_groups"]},
        # no Pallas kernel: the JAX package leaves projection and SH to XLA;
        # at 2^20 slots, degree 3, velocities; plain_ms the closed form's,
        # route_ms the plain route's (what the kernels replace)
        {"name": "project_sh_fwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/project_sh.cu", "replaces": None,
         "launches": launches["project_sh_fwd"], "max_abs_err": errs["project_sh_fwd"],
         "ms": sh_times["fwd_ms"], "plain_ms": sh_times["fwd_plain_ms"],
         "route_ms": sh_times["route_fwd_ms"], "bound_ms": sh_times["fwd_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "project_sh_bwd", "route": "cuda",
         "source": "splat_tpu_torch/ops/cuda/csrc/project_sh.cu", "replaces": None,
         "launches": launches["project_sh_bwd"], "max_abs_err": errs["project_sh_bwd"],
         "ms": sh_times["bwd_ms"], "plain_ms": sh_times["bwd_plain_ms"],
         "route_fwd_bwd_ms": sh_times["route_fwd_bwd_ms"],
         "kernel_fwd_bwd_ms": sh_times["kernel_fwd_bwd_ms"], "bound_ms": sh_times["bwd_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        # a binning at camera 0 (count, scan, scatter, sort and their PyTorch
        # ops); plain_ms the plain route's, library_ms torch.sort of the
        # culled-in entries' keys; the lists bitwise the plain route's
        {"name": "bin_tiles", "route": "cuda", "source": "splat_tpu_torch/ops/cuda/csrc/bin_tiles.cu",
         "replaces": None, "launches": launches["bin_tiles"], "max_abs_err": 0.0,
         **{k: bin_times[f"camera 0, tile {cfg.tile_size}"][k]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}, "bound_by": "bytes"},
        # the fetch pair at phone_mbrs.train's camera 0; chain_ms the chain it
        # replaced (row_gather and seg_copy; cat, row_gather and the sum over
        # M); the same at this run's camera 0 and on the depth slab's buffer
        *({"name": f"tile_fetch_{d}", "route": "cuda",
           "source": "splat_tpu_torch/ops/cuda/csrc/tile_fetch.cu",
           "replaces": ["splat_tpu/ops/pallas/seg_copy.py:75",
                        "scripts_dev/probe_kernel_gather.py:59"],
           "launches": launches[f"tile_fetch_{d}"], "max_abs_err": errs[f"tile_fetch_{d}"],
           "ms": ft[f"{d}_ms"], "plain_ms": ft[f"{d}_plain_ms"],
           "chain_ms": ft[f"{d}_chain_ms"], "bound_ms": ft[f"{d}_bound_ms"],
           "bound_by": "bytes", "library_ms": None,
           **{at: {k: fetch_times[label][f"{d}_{k}"]
                   for k in ("ms", "plain_ms", "chain_ms", "bound_ms")}
              for at, label in (("at_camera_0", f"camera 0, tile {cfg.tile_size}"),
                                ("at_2_23_rows", "2^23 rows, 3/8 live"))}}
          for d in ("fwd", "bwd")
          for ft in [fetch_times["phone_mbrs.train's camera 0"]]),
    ]
    by_path["fit"] = fit["launches"]
    by_path.update(tools["launches"])
    by_path["capture"] = capture["launches"]
    by_path["mesh"] = mesh["launches"]
    for kern in kernels:
        if kern["name"] in launches:
            kern["launches_by_path"] = {path: counts[kern["name"]]
                                        for path, counts in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(card)  # as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives it
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
