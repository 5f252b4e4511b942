#!/usr/bin/env python3
"""Where a render's or a train step's time goes on the card: torch.profiler
over the port's paths (chip_smoke.py's scene, model and config), one CUDA
device.

    python3 scripts_dev/profile_render_torch.py [--train | --fit] [--out outputs/render_trace.json]
        [--report]

Without --train it profiles a render of the 4 cameras; with --train, 4
`train_step`s (one per camera, from step 3000, after 8 warm-up steps) on
chip_smoke.py's targets; with --fit, 4 steps of `Trainer.run` (after 12
warm-up steps) on chip_smoke.py's scene directory (written to a temporary
directory, parsed and configured by its `cli.fit` flags). Prints the wall time per camera (or step) of the
profiled window, the device's busy share (the sum of every kernel's device
time over wall time; everything runs on one stream, so kernels do not
overlap), the kernels with the most device time and the ops with the most
host time, and writes a Chrome trace. With --report it also prints
`splat_tpu_torch.utils.trace_report`'s table of that trace (kernels ranked
by device time per camera or step, the busy share and the idle gaps).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="outputs/render_trace.json")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--train", action="store_true", help="profile train steps, not renders")
    ap.add_argument("--fit", action="store_true",
                    help="profile Trainer.run steps on the scene directory of chip_smoke.py")
    ap.add_argument("--report", action="store_true",
                    help="print utils.trace_report's table of the trace written to --out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_render_torch: needs a CUDA device", file=sys.stderr)
        return 2
    from splat_tpu_torch.cameras import optimizers as cam_opt
    from splat_tpu_torch.engine import trainer
    from splat_tpu_torch.models import splatfacto as sf
    from splat_tpu_torch.models import strategy
    from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
    from splat_tpu_torch.utils.profiling import nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = params_from_numpy(chip_smoke.model_tree(), device=dev)
    cams = cameras_from_numpy(chip_smoke.camera_fields(), device=dev)
    cfg = sf.SplatfactoConfig(
        camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
        camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True),
    )
    bg = sf.background_color(params, cfg)
    n = chip_smoke.N_CAMERAS

    if args.fit:
        from splat_tpu_torch.data import dataparser, synthetic
        from splat_tpu_torch.engine import config as run_config

        scene_dir = Path(tempfile.mkdtemp()) / "scene"
        synthetic.generate_scene(scene_dir, **dict(chip_smoke.FIT_SCENE, n_frames=9))
        run = run_config.parse_cli(["--data", str(scene_dir), *chip_smoke.FIT_FLAGS])
        fit_trainer = trainer.Trainer(
            dataparser.parse_scene(run.data, run.dataparser), run.model,
            dataclasses.replace(run.trainer, max_steps=run.max_num_iterations, seed=run.seed))
        fit_trainer.run(8)      # with the two passes below: 12 warm-up steps

        def run_all():
            fit_trainer.run(n)
    elif args.train:
        target = params_from_numpy(chip_smoke.target_tree(), device=dev)
        with torch.no_grad():
            gts = [sf.gamma_encode(sf.render_camera(target, cams[i], cfg, cfg.sh_degree,
                                                    sf.background_color(target, cfg)).rgb, cfg)
                   for i in range(n)]
        del target
        opt = trainer.Optimizer(params, trainer.TrainerConfig())
        state = [strategy.init_strategy_state(chip_smoke.N_GAUSS, device=dev)]
        step = [chip_smoke.TRAIN_START]

        def run_all():
            for i in range(n):
                _, _, state[0] = trainer.train_step(params, opt, state[0], cfg, cams[i], gts[i],
                                                    step[0])
                step[0] += 1
    else:
        def run_all():
            with torch.no_grad():
                for i in range(n):
                    sf.render_camera(params, cams[i], cfg, cfg.sh_degree, bg)

    for _ in range(2):
        run_all()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_all()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    # device-side events only: an aten op also reports its kernels' time. A
    # record_function range (Adam's "Optimizer.step#Adam.step") shows up on
    # the device too, spanning its kernels; it has a host event of the same
    # name, which no kernel has, so those are left out
    host_keys = {e.key for e in avgs if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host_keys]
    device_us = sum(e.self_device_time_total for e in kernels)
    host_ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    print(f"card: {nvidia_smi('name,power.limit')}")
    unit = "step" if args.train or args.fit else "camera"
    print(f"profiled: {n} {unit}s, wall {wall_us / n / 1e3:.3f} ms/{unit}, device busy "
          f"{device_us / n / 1e3:.3f} ms/{unit} = {device_us / wall_us:.1%} of wall; "
          f"{host_ops / n:.0f} aten op calls/{unit}, "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/{unit}")
    print(f"top {args.top} kernels by device time (ms per {unit}, calls per {unit}):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"  {e.self_device_time_total / n / 1e3:9.4f}  {e.count / n:7.1f}  {e.key[:90]}")
    print(f"top {args.top} by host self time (ms per {unit}, calls per {unit}):")
    for e in sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:args.top]:
        print(f"  {e.self_cpu_time_total / n / 1e3:9.4f}  {e.count / n:7.1f}  {e.key[:90]}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.out)
    print(f"trace: {args.out}")
    if args.report:
        from splat_tpu_torch.utils import trace_report

        print(trace_report.report(args.out, iters=n, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
