"""Traffic of kind "train": a trainer resumed mid-run, stepped by
`Trainer.run` in whole chunks of `sync_every` steps until the window closes.

Set-up builds the trainer through the program's public entry points (the
scene from arrays, `Trainer`, the variant's configuration from its command
line), puts the resumed state in it (the Gaussians and camera corrections
the benchmark made from the seed, the step count and the learning-rate
schedule), sets the per-tile capacity by the trainer's own rule over the
probe of `probe_cameras` train cameras drawn from the seed, and then drives
that same trainer through its
first `check_steps` steps (the refine at their end included), recording what
`correct` compares, and on to a whole chunk boundary (the warm-up). The
window follows. After it, the trainer is freed and the reference
(`perfbench/reference`) runs the same first steps from the same inputs.

The mix file (perfbench/traffic/<name>.json) sets `start_step`,
`check_steps`, `warmup_steps`, `probe_cameras`, `trace_steps`, the refine
phase of the traced stretch (`trace_phase`) and `work_cameras`, the cameras
the work of the traced stretch is counted on.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from .. import harness, scene

ADAM_BETA1 = 0.9


def _inputs(config: dict, seed: int, device, frame_indices=None, eval_indices=()):
    """The benchmark's inputs for this configuration: cameras (host arrays),
    target frames (device: every frame, or the train frames at
    `frame_indices` and the eval frames at `eval_indices`), the Gaussian
    leaves and the camera corrections."""
    sc = config["scene"]
    tr, ev = scene.split(sc)
    cams = {"train": scene.cameras(sc, tr), "eval": scene.cameras(sc, ev, sharp=sc["eval_sharp"])}
    gamma = float(config["gamma"])
    imgs = None
    if frame_indices is None:
        imgs = {k: scene.frames(sc, cams[k], seed, gamma, device) for k in ("train", "eval")}
    else:
        imgs = {"train": scene.frames(sc, cams["train"], seed, gamma, device, frame_indices)}
        if eval_indices:
            imgs["eval"] = scene.frames(sc, cams["eval"], seed, gamma, device, eval_indices)
    gauss = scene.gaussians(sc, seed, device)
    corr = {"train": scene.corrections(len(tr), seed, device, stream=3),
            "eval": scene.corrections(len(ev), seed, device, stream=4)}
    return cams, imgs, gauss, corr


def _host(x: torch.Tensor) -> np.ndarray:
    """A device tensor on the host."""
    return x.cpu().numpy()


class Run:
    """One cell's trainer and what set-up and the window recorded."""

    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        from splat_tpu_torch.engine.trainer import Trainer
        from splat_tpu_torch.models import splatfacto as sf
        from splat_tpu_torch.models.convert import named_leaves, scene_from_numpy

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        marks = [time.perf_counter()]
        cams, imgs, gauss, corr = _inputs(config, seed, device)
        tree = {"train_cameras": cams["train"], "eval_cameras": cams["eval"],
                "train_images": _host(imgs["train"]), "eval_images": _host(imgs["eval"]),
                # a small seed cloud for the trainer's initialisation, which the
                # resumed state then overwrites
                "points_xyz": _host(gauss["means"][gauss["alive"] > 0][:512]),
                "points_rgb": None}
        del imgs
        parsed, train_imgs, eval_imgs = scene_from_numpy(tree, device=device)
        del tree
        model_cfg, tc = harness.program_configs(config, seed, device)
        model_cfg = dataclasses.replace(model_cfg, initial_capacity=config["scene"]["capacity"])
        marks.append(time.perf_counter())
        tr = Trainer(parsed, model_cfg, tc, train_images=train_imgs, eval_images=eval_imgs,
                     device=device)
        marks.append(time.perf_counter())
        # the resumed state: the benchmark's Gaussians and corrections, the
        # step count and the schedule's count
        leaves = named_leaves(tr.params)
        with torch.no_grad():
            for f, v in gauss.items():
                leaves[f"gaussians.{f}"].copy_(v)
            for split, prefix in (("train", ""), ("eval", "eval_")):
                for group, keys in (("camera_opt", ("phi", "dp")),
                                    ("velocity_opt", ("dv", "dom"))):
                    for k in keys:
                        if f"{prefix}{group}.{k}" in leaves:
                            leaves[f"{prefix}{group}.{k}"].copy_(corr[split][k])
        del gauss, corr
        start = int(mix["start_step"])
        tr.step = start
        tr.optimizer.set_count(start)
        # the per-tile capacity the trainer's rule reaches on this state
        cfg = tr.model_config
        with torch.no_grad():
            counts = [sf.binning_counts(tr.params, tr.train_cams[i], cfg).cpu().numpy()
                      for i in harness.probe_cameras(len(tr.train_cams), seed,
                                                     int(mix["probe_cameras"]))]
        k = harness.tile_capacity(counts, cfg.max_per_tile, tc.tile_overflow_tol,
                                  tc.max_tile_capacity)
        tr.model_config = dataclasses.replace(cfg, max_per_tile=k)
        self.trainer = tr
        marks.append(time.perf_counter())
        self.recorded = self._check_steps()
        marks.append(time.perf_counter())
        # warm-up: on to the next whole chunk boundary, through every shape
        # the window takes (the eval-camera step included)
        chunk = tc.sync_every
        warm = int(mix["warmup_steps"])
        warm += (-(tr.step + warm)) % chunk
        tr.run(warm)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        marks.append(time.perf_counter())
        self.notes = {"max_per_tile": k, "blur_anchors": tr.model_config.blur_anchors,
                      "check_refines": self.recorded["refines"],
                      "setup_phases_s": dict(zip(("inputs", "trainer", "state_and_probe",
                                                  "check_steps", "warmup"),
                                                 np.diff(marks).tolist()))}

    def _check_steps(self) -> dict:
        """The first steps through the window's own call, recording each
        step's loss, the first gradient of every leaf (from Adam's first
        moment after one step) and every leaf's change over the steps."""
        from splat_tpu_torch.models.convert import named_leaves

        tr = self.trainer
        n = int(self.mix["check_steps"])
        before = {k: v.detach().clone() for k, v in named_leaves(tr.params).items()
                  if k != "gaussians.alive"}
        tc = tr.trainer_config
        tr.trainer_config = dataclasses.replace(tc, log_every=1)
        tr.run(1)
        names = {id(v): k for k, v in named_leaves(tr.params).items()}
        grad = {}
        for group in tr.optimizer.adam.param_groups:
            for p in group["params"]:
                st = tr.optimizer.adam.state.get(p)
                if st:
                    grad[names[id(p)]] = float(torch.linalg.norm(st["exp_avg"])) / (1 - ADAM_BETA1)
        tr.run(n - 1)
        tr.trainer_config = tc
        if tr.eval_optimizer is not None:
            # the eval leaves' first gradient, from their own Adam after its
            # first step (an eval-camera step among the checked steps)
            names = {id(v): k for k, v in named_leaves(tr.params).items()}
            for p in tr.eval_optimizer.leaves:
                st = tr.eval_optimizer.adam.state.get(p)
                if st and int(st["step"]) == 1:
                    grad[names[id(p)]] = float(torch.linalg.norm(st["exp_avg"])) / (1 - ADAM_BETA1)
        losses = [float(r["loss"]) for r in tr.history[-n:]]
        after = named_leaves(tr.params)
        change = {}
        for k, v in before.items():
            a = after[k].detach()
            if a.shape != v.shape:     # the capacity grew: compare the grown leaf
                a = a[: v.shape[0]]
            change[k] = float(torch.linalg.norm(a - v))
        del before
        refines = [dict(e) for e in tr.refine_events]
        return {"loss": losses, "grad": grad, "change": change, "refines": refines}

    # ------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool, profile) -> dict:
        """Chunks of `sync_every` steps until `seconds` have passed. With
        `trace`, the stretch of `trace_steps` steps that starts at the first
        chunk boundary at `trace_phase` steps past a multiple of
        refine_every (so that it holds a refine) runs under `profile`."""
        tr = self.trainer
        chunk = tr.trainer_config.sync_every
        refine = tr.model_config.refine_every
        dev = torch.device(self.device)
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        steps, traced, chunk_s = 0, None, []
        first_step = tr.step
        n_refines0 = len(tr.refine_events)
        t0 = time.perf_counter()
        while True:
            tc0 = time.perf_counter()
            if (trace and traced is None and tr.step % refine == self.mix["trace_phase"]):
                n_tr = int(self.mix["trace_steps"])
                s0 = tr.step
                from splat_tpu_torch.models.convert import named_leaves
                state = {k: _host(v.detach()) for k, v in named_leaves(tr.params).items()}
                sync()
                with profile() as prof:
                    ts = time.perf_counter()
                    tr.run(n_tr)
                    sync()
                    t_traced = time.perf_counter() - ts
                traced = {"prof": prof, "start": s0, "steps": n_tr, "wall_s": t_traced,
                          "state": state}
                steps += n_tr
            else:
                tr.run(chunk)
                sync()
                steps += chunk
                chunk_s.append(time.perf_counter() - tc0)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (traced is not None or not trace):
                break
            if trace and elapsed > seconds + 120:
                raise RuntimeError("the traced stretch was never reached")
        finite = all(bool(torch.isfinite(v).all()) for v in tr.params.gaussians)
        losses = [r["loss"] for r in tr.history if r["step"] > first_step]
        failed = steps if not finite else sum(1 for x in losses if not np.isfinite(x))
        return {"steps": steps, "seconds": elapsed, "failed": failed, "traced": traced,
                "refines": tr.refine_events[n_refines0:],
                # the unprofiled chunks alone: steps and seconds, and the
                # least, quartiles and most of a chunk's seconds
                "timed_steps": chunk * len(chunk_s), "timed_s": sum(chunk_s),
                "chunk_s": [min(chunk_s), *statistics.quantiles(chunk_s, n=4), max(chunk_s)]
                if len(chunk_s) > 1 else chunk_s}

    def free(self) -> dict:
        """Drop the program's state; returns what the per-layer readers need
        of it (the configuration the window ran)."""
        tr = self.trainer
        info = {"max_per_tile": tr.model_config.max_per_tile,
                "blur_anchors": tr.model_config.blur_anchors,
                "n_train": len(tr.train_cams), "n_eval": len(tr.eval_cams),
                "eval_opt_every": tr.trainer_config.eval_opt_every,
                "eval_opt": tr.eval_optimizer is not None,
                "n_params": sum(p.numel() for p in tr.optimizer.params)}
        del self.trainer, tr
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return info


# ------------------------------------------------------------------ the reference
def reference_run(config: dict, mix: dict, seed: int, device, tf32: bool = False) -> dict:
    """The reference's first `check_steps` steps from the same inputs: each
    step's loss, the first step's gradient norm of every leaf, every leaf's
    change. tf32: the control, the same computed with TF32 matrix products
    and convolutions."""
    from ..reference import model as rm
    from ..reference import train as rt

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _reference_run(rm, rt, config, mix, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _ref_cameras(rm, cams: dict, device) -> "rm.Cameras":
    f32 = dict(dtype=torch.float32, device=device)
    n = len(cams["fx"])
    return rm.Cameras(**{k: torch.as_tensor(cams[k], **f32) for k in (
        "R_c2w", "p_c2w", "fx", "fy", "cx", "cy", "lin_vel", "ang_vel", "exposure_time",
        "rolling_shutter_time")}, width=cams["width"], height=cams["height"],
        cam_idx=torch.arange(n, device=device))


def _eval_steps(config: dict, cfg, tc: dict, start: int, n: int) -> dict[int, int]:
    """The steps among `n` from `start` after which the trainer takes an
    eval-camera step, each with its eval camera (`Trainer.run`: every
    `eval_opt_every` steps, camera (step // eval_opt_every) mod the eval
    cameras' count)."""
    if not cfg.optimize_eval_cameras or cfg.camera_optimizer.mode == "off":
        return {}
    n_eval = len(scene.split(config["scene"])[1])
    every = tc["eval_opt_every"]
    return {s: (s // every) % n_eval for s in range(start, start + n) if s % every == 0}


def _reference_run(rm, rt, config, mix, seed, device):
    cfg, tc = harness.reference_configs(config, seed)
    sc = config["scene"]
    start, n = int(mix["start_step"]), int(mix["check_steps"])
    tr_idx, _ = scene.split(sc)
    order = harness.camera_order(len(tr_idx), seed, start, n)
    eval_at = _eval_steps(config, cfg, tc, start, n)
    cams_np, imgs, gauss, corr = _inputs(config, seed, device, frame_indices=order,
                                         eval_indices=list(eval_at.values()))
    cams = _ref_cameras(rm, cams_np["train"], device)
    eval_cams = _ref_cameras(rm, cams_np["eval"], device)
    cfg = dataclasses.replace(cfg, blur_anchors=rm.resolve_blur_anchors(cfg, cams))
    g = rm.GaussianParams(**gauss)
    n_train = len(tr_idx)

    def corrections(split):
        cam = ({"phi": corr[split]["phi"], "dp": corr[split]["dp"]}
               if cfg.camera_optimizer.mode != "off" else {})
        vel = ({"dv": corr[split]["dv"], "dom": corr[split]["dom"]}
               if cfg.camera_velocity_optimizer.enabled else {})
        return cam, vel

    cam_opt, vel_opt = corrections("train")
    ev_cam, ev_vel = corrections("eval") if cfg.optimize_eval_cameras else ({}, {})
    params = rm.ModelParams(g, torch.zeros(3, device=device), cam_opt, vel_opt, ev_cam, ev_vel)
    with torch.no_grad():
        counts = [rm.binning_counts(params, cams[i], cfg).cpu().numpy()
                  for i in harness.probe_cameras(n_train, seed, int(mix["probe_cameras"]))]
    k = harness.tile_capacity(counts, cfg.max_per_tile, tc["tile_overflow_tol"],
                              tc["max_tile_capacity"])
    cfg = dataclasses.replace(cfg, max_per_tile=k)
    before = {name: v.detach().clone() for name, v in rt.leaves(params).items()}
    adam = rt.Adam()
    accum = {"grad_accum": torch.zeros(g.alive.shape, device=device),
             "grad_count": torch.zeros(g.alive.shape, dtype=torch.int32, device=device)}
    split_gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    losses, grad = [], {}
    eval_imgs = dict(zip(eval_at.values(), imgs.get("eval", [])))
    for j in range(n):
        step = start + j
        loss, grads = rt.train_step(params, adam, accum, cfg, tc, cams[order[j]], imgs["train"][j],
                                    step)
        losses.append(float(loss))
        if j == 0:
            grad = {name: float(torch.linalg.norm(v)) for name, v in grads.items()}
        if step in eval_at:
            ei = eval_at[step]
            _, grads = rt.eval_opt_step(params, adam, cfg, tc, eval_cams[ei], eval_imgs[ei], step)
            # the eval leaves' first gradient: that of their optimizer's first step
            grad.update({name: float(torch.linalg.norm(v)) for name, v in grads.items()
                         if name not in grad})
        step += 1
        if step % cfg.refine_every == 0 and cfg.warmup_length <= step:
            params, _ = rt.refine_boundary(params, adam, accum, cfg, tc, step, split_gen)
    after = rt.leaves(params)
    change = {}
    for name, v in before.items():
        a = after[name]
        change[name] = float(torch.linalg.norm(a[: v.shape[0]] - v))
    return {"loss": losses, "grad": grad, "change": change, "k": k}


def compare(program: dict, reference: dict) -> dict[str, float]:
    """The numbers `correct` holds to their limits: the largest relative gap
    of a step's loss; the worst leaf's gap of the first gradient's norm; and
    the worst leaf's gap of the change over the steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    loss = max(abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p) else float("inf")
               for p, r in zip(program["loss"], reference["loss"]))
    grad, _ = harness.worst_leaf_gap(program["grad"], reference["grad"])
    med = statistics.median(reference["grad"].values())
    moved = {k for k, v in reference["grad"].items() if v >= 1e-3 * med}
    change, _ = harness.worst_leaf_gap(program["change"], reference["change"], moved)
    return {"loss": loss, "grad": grad, "change": change}


def traced_work(config: dict, mix: dict, seed: int, device, res: dict, info: dict) -> dict:
    """The work of the traced stretch, counted on the state at its start for
    a seeded subset of its cameras (`work_cameras` train cameras and one
    eval camera where the stretch holds eval-camera steps) and scaled by its
    steps: the compositors' least seconds and the whole steps' operations.
    Also the operations of an average step (a train step and, every
    `eval_opt_every` steps, an eval-camera step)."""
    from ..reference import model as rm
    from ..yardstick import work as wk

    tr_res = res["traced"]
    cfg, tc = harness.reference_configs(config, seed)
    cfg = dataclasses.replace(cfg, max_per_tile=info["max_per_tile"],
                              blur_anchors=info["blur_anchors"])
    state = {k: torch.as_tensor(v).to(device) for k, v in tr_res["state"].items()}
    g = rm.GaussianParams(**{f: state[f"gaussians.{f}"] for f in rm.GaussianParams._fields})

    def group(prefix):
        return {k.split(".", 1)[1]: v for k, v in state.items() if k.startswith(prefix + ".")}

    params = rm.ModelParams(g, state["background_logit"], group("camera_opt"),
                            group("velocity_opt"), group("eval_camera_opt"),
                            group("eval_velocity_opt"))
    sc = config["scene"]
    tr_idx, ev_idx = scene.split(sc)
    start, s0, n = int(mix["start_step"]), tr_res["start"], tr_res["steps"]
    order = harness.camera_order(len(tr_idx), seed, start, s0 + n - start)[s0 - start:]
    rng = np.random.default_rng(int(seed) % (2**63) + 2)
    picked = rng.choice(sorted(set(order)), size=min(int(mix["work_cameras"]), len(set(order))),
                        replace=False)
    train_cams = _ref_cameras(rm, scene.cameras(sc, tr_idx), device)
    sh_deg = rm.active_sh_degree(cfg, s0)
    per_train = [wk.camera_work(params, train_cams[int(i)], cfg, sh_deg) for i in picked]
    eval_steps = [s for s in range(s0, s0 + n) if info["eval_opt"]
                  and s % info["eval_opt_every"] == 0]
    per_eval = []
    if eval_steps:
        eval_cams = _ref_cameras(rm, scene.cameras(sc, ev_idx, sharp=sc["eval_sharp"]), device)
        ei = (eval_steps[0] // info["eval_opt_every"]) % info["n_eval"]
        per_eval = [wk.camera_work(params, eval_cams[ei], cfg, sh_deg, is_eval=True)]
    npx = sc["width"] * sc["height"]

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows) if rows else 0.0

    comp_train = mean(per_train, "fwd_s") + mean(per_train, "bwd_s")
    comp_eval = mean(per_eval, "fwd_s") + mean(per_eval, "bwd_s")
    f_train = sum(wk.step_flops(r, npx, info["n_params"]) for r in per_train) / len(per_train)
    f_eval = (sum(wk.step_flops(r, npx, 0, train=False) for r in per_eval) / len(per_eval)
              if per_eval else 0.0)
    every = info["eval_opt_every"] if info["eval_opt"] else 0
    return {
        "compositing_s": n * comp_train + len(eval_steps) * comp_eval,
        "flops_per_step": f_train + (f_eval / every if every else 0.0),
        "cameras": [int(i) for i in picked], "eval_steps": len(eval_steps),
        "per_train": per_train, "per_eval": per_eval,
    }


def end_to_end(res: dict) -> dict[str, float]:
    """steps_per_s: every step the window completed over its wall time, which
    ends in a synchronise."""
    return {"steps_per_s": res["steps"] / res["seconds"]}


def attempted(res: dict) -> tuple[int, int]:
    return res["steps"], res["failed"]


def check(config: dict, mix: dict, seed: int, device, program: dict,
          res: dict) -> dict[str, float]:
    """The reference's first steps against the program's (`compare`)."""
    return compare(program, reference_run(config, mix, seed, device))
