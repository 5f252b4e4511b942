"""Traffic of kind "view": a closed loop of novel-view frames, each
`splat_tpu_torch.cli.render_video.render_frame` of the configuration's
resumed state, one after the other along a seeded smooth path near the
training cameras (the same path in every run; the seed picks where on it
the loop starts), for as long as the window lasts.

The frames are rendered as the viewer renders them by default: sharp
(`blur_samples` 0, no exposure, no readout), the per-tile capacity that
training reached on this state. A frame ends when its clipped image is on
the host, which is what `render_frame` returns, so every frame is timed on
its own by the host's clock, from the call to the image: the latencies of
all the window's frames are the samples of its percentiles.

After the window, the reference renders `check_frames` path frames drawn
from the seed, and their largest pixel difference from the program's first
render of them in the window is what `correct` compares.

The mix file sets `path_frames`, `path_seed`, `warmup_frames`,
`check_frames`, `trace_frames` and the path's `jitter` (world units).
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from .. import harness, scene


def path_cameras(config: dict, mix: dict) -> dict:
    """The path: `path_frames` poses along the capture's orbit at times
    spread over it, moved off the trajectory by a smooth offset of `jitter`
    world units (drawn from `path_seed`, so every run's frames are the same
    set); no motion, exposure or readout."""
    sc = config["scene"]
    n = int(mix["path_frames"])
    rng = np.random.default_rng(int(mix["path_seed"]))
    phase = rng.uniform(0, 2 * np.pi, size=(2, 3))
    t0 = rng.uniform(0, sc["trajectory"]["orbit_period"])
    span = sc["frame_dt"] * (sc["n_train"] + sc["n_eval"])
    traj = sc["trajectory"]
    out = {k: [] for k in ("R_c2w", "p_c2w")}
    for j in range(n):
        u = j / n
        t = t0 + u * span
        off = mix["jitter"] * (np.sin(2 * np.pi * u + phase[0]) + 0.5 * np.sin(6 * np.pi * u + phase[1]))
        m = scene.pose_gl(t, traj, off)
        out["R_c2w"].append(m[:3, :3] * scene._FLIP)
        out["p_c2w"].append(m[:3, 3])
    cams = {k: np.asarray(v) for k, v in out.items()}
    for k in ("fx", "fy", "cx", "cy"):
        cams[k] = np.full(n, float(sc[k]))
    for k in ("lin_vel", "ang_vel"):
        cams[k] = np.zeros((n, 3))
    cams["exposure_time"] = np.zeros(n)
    cams["rolling_shutter_time"] = np.zeros(n)
    cams["width"], cams["height"] = int(sc["width"]), int(sc["height"])
    return cams


def check_indices(mix: dict, seed: int) -> list[int]:
    """The path frames `correct` compares, drawn from the seed."""
    rng = np.random.default_rng(int(seed) % (2**63) + 1)
    return sorted(rng.choice(int(mix["path_frames"]), size=int(mix["check_frames"]),
                             replace=False).tolist())


class Run:
    """The program's state, the path, and what the window recorded."""

    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        from splat_tpu_torch.cli.render_video import render_frame
        from splat_tpu_torch.models import splatfacto as sf
        from splat_tpu_torch.models.convert import cameras_from_numpy

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        sc = config["scene"]
        tr, _ = scene.split(sc)
        model_cfg, tc = harness.program_configs(config, seed, device)
        gauss = scene.gaussians(sc, seed, device)
        corr = scene.corrections(len(tr), seed, device, stream=3)
        g = sf.GaussianParams(**gauss)
        params = sf.ModelParams(
            g, torch.zeros(3, device=device),
            {k: corr[k] for k in ("phi", "dp")} if model_cfg.camera_optimizer.mode != "off" else {},
            {k: corr[k] for k in ("dv", "dom")} if model_cfg.camera_velocity_optimizer.enabled
            else {}, {}, {})
        train_cams = cameras_from_numpy(scene.cameras(sc, tr), device)
        train_cams = dataclasses.replace(
            train_cams, cam_idx=torch.arange(len(train_cams), device=train_cams.fx.device))
        model_cfg = dataclasses.replace(model_cfg,
                                        blur_anchors=sf.resolve_blur_anchors(model_cfg, train_cams))
        with torch.no_grad():
            counts = [sf.binning_counts(params, train_cams[i], model_cfg).cpu().numpy()
                      for i in harness.probe_cameras(len(train_cams), seed,
                                                     int(mix["probe_cameras"]))]
        k = harness.tile_capacity(counts, model_cfg.max_per_tile, tc.tile_overflow_tol,
                                  tc.max_tile_capacity)
        # the viewer's render configuration (cli/viewer.py: no exposure)
        self.cfg = dataclasses.replace(model_cfg, max_per_tile=k, blur_samples=0,
                                       rolling_shutter_compensation=True)
        self.k = k
        self.sh_deg = int(sf.active_sh_degree(self.cfg, int(mix["state_step"])))
        self.params = params
        path = path_cameras(config, mix)
        cams = cameras_from_numpy(path, device)
        self.cams = [cams[i] for i in range(len(cams))]
        # where on the path the loop starts, drawn from the seed
        self.start = int(np.random.default_rng(int(seed) % (2**63) + 4).integers(len(self.cams)))
        self.render = render_frame
        self.check_at = check_indices(mix, seed)
        for i in range(int(mix["warmup_frames"])):
            self.render(self.params, self.cams[i % len(self.cams)], self.cfg, self.sh_deg)
        self.notes = {"max_per_tile": k}

    def window(self, seconds: float, trace: bool, profile) -> dict:
        """Frames one after the other until `seconds` have passed, each timed
        from its call to its image; with `trace`, `trace_frames` frames after
        the window under `profile`."""
        n_path = len(self.cams)
        kept: dict[int, np.ndarray] = {}
        lat, failed, j = [], 0, self.start
        t0 = now = time.perf_counter()
        while now - t0 < seconds:
            i = j % n_path
            img = self.render(self.params, self.cams[i], self.cfg, self.sh_deg)
            t = time.perf_counter()
            lat.append(t - now)
            now = t
            if img is None or img.shape != (self.cams[i].height, self.cams[i].width, 3):
                failed += 1
            elif i in self.check_at and i not in kept:
                kept[i] = img.copy()
                now = time.perf_counter()     # the copy is the check's, not the frame's
            j += 1
        frames = len(lat)
        elapsed = now - t0
        for i in self.check_at:       # a sampled frame the window never reached
            if i not in kept:
                kept[i] = self.render(self.params, self.cams[i], self.cfg, self.sh_deg)
        traced = None
        if trace:
            n_tr = int(self.mix["trace_frames"])
            with profile() as prof:
                ts = time.perf_counter()
                for t in range(n_tr):
                    self.render(self.params, self.cams[(j + t) % n_path], self.cfg, self.sh_deg)
                wall = time.perf_counter() - ts
            traced = {"prof": prof, "frames": n_tr, "wall_s": wall, "start": j % n_path}
        return {"frames": frames, "seconds": elapsed, "failed": failed, "latency_s": lat,
                "kept": kept, "traced": traced}

    def free(self) -> dict:
        info = {"max_per_tile": self.k, "sh_degree": self.sh_deg}
        del self.params, self.cams
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return info


def reference_frames(config: dict, mix: dict, seed: int, device, indices,
                     tf32: bool = False) -> dict[int, np.ndarray]:
    """The reference's render of the path frames `indices`: the plain route
    over the same inputs, gamma-encoded and clipped as `render_frame` does.
    tf32: the control."""
    from ..reference import model as rm
    from .train import _ref_cameras

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        cfg, tc = harness.reference_configs(config, seed)
        sc = config["scene"]
        tr, _ = scene.split(sc)
        g = rm.GaussianParams(**scene.gaussians(sc, seed, device))
        corr = scene.corrections(len(tr), seed, device, stream=3)
        train_params = rm.ModelParams(
            g, torch.zeros(3, device=device),
            {k: corr[k] for k in ("phi", "dp")} if cfg.camera_optimizer.mode != "off" else {},
            {k: corr[k] for k in ("dv", "dom")} if cfg.camera_velocity_optimizer.enabled
            else {}, {}, {})
        train_cams = _ref_cameras(rm, scene.cameras(sc, tr), device)
        with torch.no_grad():
            counts = [rm.binning_counts(train_params, train_cams[i], cfg).cpu().numpy()
                      for i in harness.probe_cameras(len(tr), seed, int(mix["probe_cameras"]))]
        k = harness.tile_capacity(counts, cfg.max_per_tile, tc["tile_overflow_tol"],
                                  tc["max_tile_capacity"])
        cfg = dataclasses.replace(cfg, max_per_tile=k, blur_samples=0,
                                  rolling_shutter_compensation=True)
        params = rm.ModelParams(g, torch.zeros(3, device=device), {}, {}, {}, {})
        cams = _ref_cameras(rm, path_cameras(config, mix), device)
        cams = dataclasses.replace(cams, cam_idx=torch.zeros_like(cams.cam_idx))
        sh_deg = rm.active_sh_degree(cfg, int(mix["state_step"]))
        out = {}
        with torch.no_grad():
            for i in indices:
                bg = rm.background_color(params, cfg)
                rgb = rm.render_camera(params, cams[i], cfg, sh_deg, bg).rgb
                out[i] = np.clip(rm.gamma_encode(rgb, cfg).cpu().numpy(), 0, 1)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def compare(program: dict[int, np.ndarray], reference: dict[int, np.ndarray]) -> dict:
    """The largest absolute pixel difference over the sampled frames."""
    worst = 0.0
    for i, ref in reference.items():
        img = program.get(i)
        if img is None or img.shape != ref.shape:
            return {"pixel": float("inf")}
        d = float(np.max(np.abs(img.astype(np.float64) - ref)))
        worst = max(worst, d if np.isfinite(d) else float("inf"))
    return {"pixel": worst}


def end_to_end(res: dict) -> dict[str, float]:
    """ms_p50 and ms_p95: the median and the 95th percentile of the latencies
    of all the window's frames."""
    lat = sorted(res["latency_s"])
    q = statistics.quantiles(lat, n=100, method="inclusive") if len(lat) > 1 else lat * 99
    return {"ms_p50": statistics.median(lat) * 1e3, "ms_p95": q[94] * 1e3}


def attempted(res: dict) -> tuple[int, int]:
    return res["frames"], res["failed"]


def check(config: dict, mix: dict, seed: int, device, program,
          res: dict) -> dict[str, float]:
    """The reference's render of the sampled path frames against the
    program's first render of them in the window (`compare`)."""
    ref = reference_frames(config, mix, seed, device, sorted(res["kept"]))
    return compare(res["kept"], ref)
