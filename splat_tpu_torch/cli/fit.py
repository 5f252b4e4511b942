#!/usr/bin/env python
"""Single training run, the `ns-train splatfacto` equivalent (port of `cli/fit.py`).

Usage (the JAX package's command contract, flag for flag):
  python -m splat_tpu_torch.cli.fit splatfacto --data <scene_dir> \
      --output-dir data/outputs --experiment-name synthetic-mb/cozyroom \
      --max-num-iterations 20000 \
      --pipeline.model.blur-samples 10 \
      --pipeline.model.camera-optimizer.mode SO3xR3 \
      --pipeline.model.camera-velocity-optimizer.enabled True \
      nerfstudio-data --eval-mode interval --eval-interval 8

It runs on the CUDA device; `--device cpu` runs the plain PyTorch path.
Writes the same output-directory contract:
  OUTPUT_DIR/EXPERIMENT/splatfacto/TIMESTAMP/{config.json,
  dataparser_transforms.json, checkpoints/step_N/, metrics_train.jsonl,
  metrics.json}
`--vis viewer` serves the live viewer (`cli/viewer.py`) on --viewer-port
while it trains: the loop publishes a snapshot of the Gaussians to it after
every logged window and every chunk, and the viewer closes when the run
ends. The run's last lines give the kernel launches of the process and the
eval metrics.

`--mesh.enabled True` trains on the `(data, gauss, blur, tile)` mesh of
`parallel/sharding.py` (`--mesh.data`, `--mesh.gauss`, `--mesh.blur`,
`--mesh.tile`; 0 = auto-filled by `resolve_mesh`), one rank per device: on
CUDA one worker per visible card (NCCL needs a card per rank), on the CPU as
many ranks as `torchrun --nproc-per-node N` starts (gloo). Rank 0 writes the
run directory; metrics.json then also holds the mesh, the backend and rank
0's kernel launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from ..engine import config as cfg_mod

    cfg = cfg_mod.parse_cli(argv)
    if not cfg.data:
        raise SystemExit("--data is required")
    if not cfg.mesh.enabled:
        return _run(0, 1, cfg.device, cfg, None)

    import datetime
    import math

    from ..data import dataparser as dp
    from ..parallel import launch, sharding

    if not cfg.timestamp:       # every rank writes to the same run directory
        cfg = dataclasses.replace(
            cfg, timestamp=datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S"))
    n_dev = launch.ranks_available(cfg.device)
    img_h = dp.parse_scene(cfg.data, cfg.dataparser).train_cameras.height
    shape = sharding.resolve_mesh(cfg.mesh, cfg.model, img_h, n_dev)
    world = math.prod(shape.values())
    backend = "nccl" if cfg.device.startswith("cuda") else "gloo"
    print("mesh: " + " x ".join(f"{k}={v}" for k, v in shape.items())
          + f"  ({world} of {n_dev} devices, {backend})", flush=True)
    launch.launch(_run, world, args=(cfg, shape), device=cfg.device)
    return cfg.run_dir()


def _run(rank, world, device, cfg, shape):
    """One rank of the run (the only one without a mesh): parse the scene,
    build the trainer and train; rank 0 writes the run directory."""
    from ..data import dataparser as dp
    from ..data import dataset as ds
    from ..engine import config as cfg_mod
    from ..engine import trainer as tr

    mesh = None
    if shape is not None:
        from ..parallel import sharding

        mesh = sharding.make_mesh(shape)
    run_dir = cfg.run_dir()
    scene = dp.parse_scene(cfg.data, cfg.dataparser)
    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        cfg_mod.save_config(cfg, run_dir / "config.json")
        dp.save_dataparser_transforms(run_dir / "dataparser_transforms.json", scene)

    tc = cfg.trainer
    # --max-num-iterations (the reference's flag) and --trainer.max-steps are
    # aliases; whichever was changed from its default wins so neither is a
    # silent no-op.
    n_iter = cfg.max_num_iterations
    if n_iter == type(cfg)().max_num_iterations and tc.max_steps != type(tc)().max_steps:
        n_iter = tc.max_steps
    cfg = dataclasses.replace(cfg, max_num_iterations=n_iter)
    tc = dataclasses.replace(tc, max_steps=n_iter, seed=cfg.seed)
    train_images, eval_images = ds.load_scene_images(scene)
    n_images = len(train_images) + len(eval_images)
    if rank == 0:
        print(f"images: {n_images} decoded by {train_images.decoder!r} in "
              f"{train_images.decode_seconds + eval_images.decode_seconds:.2f} s", flush=True)
    trainer = tr.Trainer(scene, cfg.model, tc, train_images=train_images,
                         eval_images=eval_images, device=device, mesh=mesh)

    with contextlib.ExitStack() as stack:
        viewer_state = None
        if "viewer" in (cfg.vis or ""):
            # live-training browser viewer (ns-train --vis viewer equivalent); it
            # renders the snapshots the loop publishes, never the live leaves. On
            # a mesh every rank gathers the Gaussians and rank 0 serves them.
            from . import viewer as viewer_mod

            with trainer.global_view():
                if rank == 0:
                    viewer_state = viewer_mod.ViewerState.from_trainer(cfg, trainer, res=256)
            if viewer_state is not None:
                server = viewer_mod.serve(viewer_state, port=cfg.viewer_port)
                stack.callback(server.server_close)     # the viewer lives as long as the run
                stack.callback(server.shutdown)
        return _train(cfg, trainer, run_dir, viewer_state)


def _train(cfg, trainer, run_dir, viewer_state):
    """`main`'s training loop, evals, checkpoints and metrics.json; publishes
    to `viewer_state` (None: no viewer) between steps. On a mesh every rank
    trains, evaluates and checkpoints, and rank 0 alone writes and prints.
    Returns run_dir."""
    from ..engine import config as cfg_mod
    from ..ops import cuda as kcuda
    from ..ops.cuda import build

    mesh = trainer.mesh
    lead = mesh is None or mesh.rank == 0
    viewing = "viewer" in (cfg.vis or "")
    log_path = run_dir / "metrics_train.jsonl"
    # the clock and the build count start together: a kernel built before
    # this point is in neither the wall time nor the compile time
    t0 = time.time()
    built_before = build.build_seconds

    tb_writer = None
    if "tensorboard" in (cfg.vis or "") and lead:
        # standard-format scalar export (reference --vis=tensorboard); zero-dep
        # tfevents writer, consumable by any tensorboard-compatible dashboard
        from ..utils.tbevents import TBEventWriter

        tb_writer = TBEventWriter(run_dir / "tensorboard")

    def publish():
        if viewing:
            with trainer.global_view():
                if viewer_state is not None:
                    viewer_state.publish(trainer)

    def cb(rec):
        publish()
        if not lead:
            return
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if tb_writer is not None:
            tb_writer.add_scalars(
                [(f"train/{k}", float(v)) for k, v in rec.items()
                 if k != "step" and isinstance(v, (int, float))],
                step=rec["step"],
            )
            tb_writer.flush()
        print(
            f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
            f"alive {rec['n_alive']}  {rec['wall_s']:.0f}s",
            flush=True,
        )

    steps_done = 0
    next_eval = cfg.steps_per_eval
    last_saved_model_cfg = cfg.model

    def persist_config_if_grown():
        # adaptive tile capacity may grow max_per_tile mid-run; the manifest
        # must track it IMMEDIATELY (not only at exit) so mid-run checkpoints
        # of a later-crashed run reload at the grown capacity instead of
        # silently re-dropping the deepest tile entries
        nonlocal cfg, last_saved_model_cfg
        if trainer.model_config != last_saved_model_cfg:
            cfg = dataclasses.replace(cfg, model=trainer.model_config)
            if lead:
                cfg_mod.save_config(cfg, run_dir / "config.json")
            last_saved_model_cfg = trainer.model_config

    while steps_done < cfg.max_num_iterations:
        chunk = min(
            cfg.steps_per_save,
            cfg.max_num_iterations - steps_done,
            max(next_eval - steps_done, 1) if cfg.steps_per_eval > 0 else 1 << 30,
        )
        trainer.run(chunk, progress_cb=cb)
        steps_done += chunk
        publish()
        persist_config_if_grown()
        if cfg.steps_per_eval > 0 and steps_done >= next_eval:
            m = trainer.evaluate()
            next_eval += cfg.steps_per_eval
            if lead:
                rec = {"step": trainer.step, **{f"eval_{k}": v for k, v in m.items()}}
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                if tb_writer is not None:
                    tb_writer.add_scalars(
                        [(f"eval/{k}", float(v)) for k, v in m.items()],
                        step=trainer.step,
                    )
                    tb_writer.flush()
                print(f"eval @ {trainer.step}: {m}", flush=True)
        if steps_done % cfg.steps_per_save == 0 or steps_done >= cfg.max_num_iterations:
            trainer.save_checkpoint(run_dir / "checkpoints" / f"step_{trainer.step}")

    wall = time.time() - t0
    persist_config_if_grown()
    metrics = trainer.evaluate()
    if not lead:
        return run_dir
    # the kernels' nvcc builds inside the timed window are its compile time
    # (0.0 on the CPU, and when the process has built them before)
    compile_s = build.build_seconds - built_before
    out = {
        "experiment_name": cfg.experiment_name,
        "method_name": cfg.method_name,
        "checkpoint": str(run_dir / "checkpoints" / f"step_{trainer.step}"),
        "results": metrics,
        "wall_clock_time_seconds": wall,
        "compile_time_seconds": compile_s,
        "train_time_seconds": wall - compile_s,
    }
    if mesh is not None:
        import torch.distributed as dist

        out["mesh"] = {"shape": mesh.shape, "world": mesh.world,
                       "backend": dist.get_backend() if dist.is_initialized() else None,
                       "kernel_launches": kcuda.path_launches()}
    (run_dir / "metrics.json").write_text(json.dumps(out, indent=2))
    print("kernel launches: " + json.dumps(kcuda.path_launches()), flush=True)
    print(json.dumps(out["results"]))
    return run_dir


if __name__ == "__main__":
    main()
