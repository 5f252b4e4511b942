"""Traffic of kind "train_mesh": kind "train" on a mesh of the cell's chips,
one rank per card, as `splat_tpu_torch.cli.fit --mesh.enabled True` trains
(`parallel.sharding`: `init_distributed`, `resolve_mesh` over the
configuration's `mesh_flags`, `make_mesh`, then `Trainer(mesh=...)`).

This process is rank 0; it starts the other ranks (spawned processes, one
card each, meeting at a `file://` rendezvous under TMPDIR; a rank whose
peers are gone stops after `TIMEOUT_S`). Every rank builds
its trainer alike from the seed and takes the resumed state's own shard, the
per-tile capacity from the probe's counts summed over the shards, the
checked first steps and the warm-up; then rank 0 drives the window in chunks
and tells the other ranks how many steps each chunk holds. Steps per second
are rank 0's (every step ends in a collective, so the ranks move together),
and the traced stretch is rank 0's profile.

After the window every rank frees its trainer and the others exit; the
reference (`perfbench/reference/blocked.py`: the frozen plain reference
computed in blocks of Gaussians) then runs the same first steps from the
same inputs on one card, TF32 off, and `correct` compares them as kind
"train" does, and holds `slab_dropped`, the rows the depth slabs dropped
over the run, to its limit.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import math
import multiprocessing
import os
import statistics
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from .. import harness
from . import train as single

# how long a rank waits for its peers (the rendezvous, a collective, an exit)
TIMEOUT_S = 300


def _program_configs(config: dict, seed: int, device):
    """The program's (SplatfactoConfig, TrainerConfig, MeshConfig) from the
    variant's flags and the mesh flags."""
    from splat_tpu_torch.engine.config import parse_cli

    run = parse_cli(["splatfacto", *config["flags"], *config.get("extra_flags", []),
                     *config["mesh_flags"]])
    tc = dataclasses.replace(run.trainer, max_steps=run.max_num_iterations, seed=seed)
    model = dataclasses.replace(run.model, initial_capacity=config["scene"]["capacity"])
    return model, tc, run.mesh


def _start(rank: int, world: int, init: str, device_type: str) -> torch.device:
    """This rank's device and its process group (`sharding.init_distributed`'s
    backends, with a timeout: a rank whose peer has died stops instead of
    waiting on)."""
    dev = torch.device(device_type)
    if device_type != "cuda":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")     # every rank is on this host
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    torch.distributed.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                         init_method=init, world_size=world, rank=rank,
                                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


class _Rank:
    """One rank's trainer, set up as kind "train" sets up its own."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from splat_tpu_torch.engine.trainer import Trainer
        from splat_tpu_torch.models import splatfacto as sf
        from splat_tpu_torch.models.convert import named_leaves, scene_from_numpy
        from splat_tpu_torch.parallel import sharding

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        marks = [time.perf_counter()]
        cams, imgs, gauss, corr = single._inputs(config, seed, device)
        tree = {"train_cameras": cams["train"], "eval_cameras": cams["eval"],
                "train_images": single._host(imgs["train"]),
                "eval_images": single._host(imgs["eval"]),
                "points_xyz": single._host(gauss["means"][gauss["alive"] > 0][:512]),
                "points_rgb": None}
        del imgs
        parsed, train_imgs, eval_imgs = scene_from_numpy(tree, device=device)
        del tree
        model_cfg, tc, mesh_cfg = _program_configs(config, seed, device)
        shape = sharding.resolve_mesh(mesh_cfg, model_cfg, config["scene"]["height"],
                                      torch.distributed.get_world_size())
        self.mesh = mesh = sharding.make_mesh(shape)
        marks.append(time.perf_counter())
        tr = Trainer(parsed, model_cfg, tc, train_images=train_imgs, eval_images=eval_imgs,
                     device=device, mesh=mesh)
        marks.append(time.perf_counter())
        leaves = named_leaves(tr.params)
        with torch.no_grad():
            for f, v in gauss.items():
                leaves[f"gaussians.{f}"].copy_(sharding.shard_rows(mesh, v))
            for split, prefix in (("train", ""), ("eval", "eval_")):
                for group, keys in (("camera_opt", ("phi", "dp")),
                                    ("velocity_opt", ("dv", "dom"))):
                    for k in keys:
                        if f"{prefix}{group}.{k}" in leaves:
                            leaves[f"{prefix}{group}.{k}"].copy_(corr[split][k])
        del gauss, corr, leaves
        gc.collect()
        start = int(mix["start_step"])
        tr.step = start
        tr.optimizer.set_count(start)
        cfg = tr.model_config
        gauss_axis = mesh.axes["gauss"]
        with torch.no_grad():
            counts = [sharding.reduce_(sf.binning_counts(tr.params, tr.train_cams[i], cfg),
                                       gauss_axis).cpu().numpy()
                      for i in harness.probe_cameras(len(tr.train_cams), seed,
                                                     int(mix["probe_cameras"]))]
        k = harness.tile_capacity(counts, cfg.max_per_tile, tc.tile_overflow_tol,
                                  tc.max_tile_capacity)
        tr.model_config = dataclasses.replace(cfg, max_per_tile=k)
        self.trainer = tr
        marks.append(time.perf_counter())
        self.recorded = self._check_steps()
        marks.append(time.perf_counter())
        chunk = tc.sync_every
        warm = int(mix["warmup_steps"])
        warm += (-(tr.step + warm)) % chunk
        tr.run(warm)
        _sync(device)
        marks.append(time.perf_counter())
        self.notes = {"max_per_tile": k, "blur_anchors": tr.model_config.blur_anchors,
                      "mesh": shape, "check_refines": self.recorded["refines"],
                      "setup_phases_s": dict(zip(("inputs", "trainer", "state_and_probe",
                                                  "check_steps", "warmup"),
                                                 np.diff(marks).tolist()))}

    def _norms(self, tensors: dict[str, torch.Tensor]) -> dict[str, float]:
        """Each tensor's norm over the whole mesh: the Gaussian leaves' shards
        summed over the gauss axis, the replicated leaves as they are."""
        from splat_tpu_torch.parallel import sharding

        names = sorted(tensors)
        sq = torch.stack([torch.linalg.norm(tensors[k].double()) ** 2 for k in names])
        sharded = torch.tensor([k.startswith("gaussians.") for k in names], device=sq.device)
        total = sharding.reduce_(torch.where(sharded, sq, 0.0), self.mesh.axes["gauss"])
        sq = torch.where(sharded, total, sq)
        return {k: math.sqrt(v) for k, v in zip(names, sq.tolist())}

    def _check_steps(self) -> dict:
        """Kind "train"'s checked first steps on the mesh: the losses, every
        leaf's first gradient (Adam's first moment after one step) and every
        leaf's change, the norms over the whole capacity axis."""
        from splat_tpu_torch.models.convert import named_leaves

        tr = self.trainer
        n = int(self.mix["check_steps"])
        before = {k: v.detach().clone() for k, v in named_leaves(tr.params).items()
                  if k != "gaussians.alive"}
        tc = tr.trainer_config
        tr.trainer_config = dataclasses.replace(tc, log_every=1)
        tr.run(1)
        names = {id(v): k for k, v in named_leaves(tr.params).items()}
        moments = {}
        for group in tr.optimizer.adam.param_groups:
            for p in group["params"]:
                st = tr.optimizer.adam.state.get(p)
                if st:
                    moments[names[id(p)]] = st["exp_avg"]
        grad = {k: v / (1 - single.ADAM_BETA1) for k, v in self._norms(moments).items()}
        tr.run(n - 1)
        tr.trainer_config = tc
        if tr.eval_optimizer is not None:
            names = {id(v): k for k, v in named_leaves(tr.params).items()}
            moments = {}
            for p in tr.eval_optimizer.leaves:
                st = tr.eval_optimizer.adam.state.get(p)
                if st and int(st["step"]) == 1:
                    moments[names[id(p)]] = st["exp_avg"]
            grad.update({k: v / (1 - single.ADAM_BETA1) for k, v in self._norms(moments).items()})
        losses = [float(r["loss"]) for r in tr.history[-n:]]
        after = named_leaves(tr.params)
        change = self._norms({k: after[k].detach()[: v.shape[0]] - v for k, v in before.items()})
        del before
        return {"loss": losses, "grad": grad, "change": change,
                "refines": [dict(e) for e in tr.refine_events]}

    def free(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank_main(rank: int, world: int, init: str, device_type: str, config: dict, mix: dict,
               seed: int, orders) -> None:
    """Ranks 1 and on: set up as rank 0 does, then run each chunk rank 0
    announces (None: the window is over)."""
    try:
        dev = _start(rank, world, init, device_type)
        r = _Rank(config, mix, seed, dev)
        while (n := orders.get()) is not None:
            r.trainer.run(n)
        r.free()
        torch.distributed.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise


class Run:
    """Rank 0's trainer, the other ranks' processes, and what set-up and the
    window recorded."""

    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        # the program's slab counters and shard-local refine: a program
        # without them cannot run this cell (it would gather the whole scene
        # on every card at every refine)
        from splat_tpu_torch.parallel.sharding import refine_shard  # noqa: F401
        from splat_tpu_torch.utils.profiling import SlabCounters  # noqa: F401

        self.config, self.mix, self.seed = config, mix, seed
        dev = torch.device(device)
        world = int(cell["chips"])
        if dev.type == "cuda":
            from splat_tpu_torch.ops.cuda import build

            # one build before the ranks start, which then load it
            build.build(sorted(p.stem for p in build.CSRC.glob("*.cu")))
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench_mesh_")
        init = (Path(self._tmp.name) / "rendezvous").as_uri()
        ctx = multiprocessing.get_context("spawn")
        self._orders, self._procs = [], []
        for rank in range(1, world):
            q = ctx.Queue()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, world, init, dev.type, config, mix, seed, q))
            p.start()
            self._orders.append(q)
            self._procs.append(p)
        self.device = _start(0, world, init, dev.type)
        self._rank = _Rank(config, mix, seed, self.device)
        self.trainer = self._rank.trainer
        self.recorded = self._rank.recorded
        self.notes = self._rank.notes

    def _run(self, n: int) -> None:
        """n steps on every rank."""
        dead = [p.pid for p in self._procs if not p.is_alive()]
        if dead:
            raise RuntimeError(f"mesh ranks {dead} have exited")
        for q in self._orders:
            q.put(n)
        self.trainer.run(n)

    def window(self, seconds: float, trace: bool, profile) -> dict:
        """Kind "train"'s window, each chunk on every rank; the traced
        stretch's slab counts ride with it (`slab`)."""
        tr = self.trainer
        chunk = tr.trainer_config.sync_every
        refine = tr.model_config.refine_every
        sync = lambda: _sync(self.device)  # noqa: E731
        steps, traced, chunk_s = 0, None, []
        first_step = tr.step
        n_refines0 = len(tr.refine_events)
        slab_taken = []
        t0 = time.perf_counter()
        while True:
            tc0 = time.perf_counter()
            if trace and traced is None and tr.step % refine == self.mix["trace_phase"]:
                n_tr = int(self.mix["trace_steps"])
                s0, e0 = tr.step, len(tr.refine_events)
                slab_taken.append(tr.slab_counters.take())
                sync()
                with profile() as prof:
                    ts = time.perf_counter()
                    self._run(n_tr)
                    sync()
                    t_traced = time.perf_counter() - ts
                last = tr.slab_counters.take()
                slab_taken.append(last)
                traced = {"prof": prof, "start": s0, "steps": n_tr, "wall_s": t_traced,
                          "slab": _slab_sums(tr.refine_events[e0:], last)}
                steps += n_tr
            else:
                self._run(chunk)
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
        slab_taken.append(tr.slab_counters.take())
        dropped = (sum(int(e.get("slab_dropped", 0)) for e in tr.refine_events)
                   + sum(c["dropped"] for c in slab_taken))
        return {"steps": steps, "seconds": elapsed, "failed": failed, "traced": traced,
                "refines": tr.refine_events[n_refines0:], "slab_dropped": dropped,
                "timed_steps": chunk * len(chunk_s), "timed_s": sum(chunk_s),
                "chunk_s": [min(chunk_s), *statistics.quantiles(chunk_s, n=4),
                            max(chunk_s)] if len(chunk_s) > 1 else chunk_s}

    def free(self) -> dict:
        """Every rank drops its trainer, the other ranks exit; returns what
        the per-layer readers need (kind "train"'s, and the sizes of the
        leaves each train and eval-camera step sums over the mesh)."""
        from splat_tpu_torch.models.convert import named_leaves

        tr = self.trainer
        leaves = named_leaves(tr.params)
        info = {"max_per_tile": tr.model_config.max_per_tile,
                "blur_anchors": tr.model_config.blur_anchors,
                "n_train": len(tr.train_cams), "n_eval": len(tr.eval_cams),
                "eval_opt_every": tr.trainer_config.eval_opt_every,
                "eval_opt": tr.eval_optimizer is not None,
                "n_params": sum(p.numel() for p in tr.optimizer.params),
                "mesh": dict(self._rank.mesh.shape),
                "width": tr.eval_cams.width, "height": tr.eval_cams.height,
                "blur_samples": max(tr.model_config.blur_samples, 1),
                "replicated_floats": sum(v.numel() for k, v in leaves.items()
                                         if not k.startswith(("gaussians.", "eval_"))),
                "eval_floats": sum(v.numel() for k, v in leaves.items()
                                   if k.startswith("eval_"))}
        del tr, leaves
        for q in self._orders:
            q.put(None)
        self._rank.free()
        del self.trainer, self._rank
        # every rank tears its process group down at once (NCCL's teardown
        # waits for the peers), then the other ranks exit
        torch.distributed.destroy_process_group()
        deadline = time.perf_counter() + TIMEOUT_S
        for p in self._procs:
            p.join(max(deadline - time.perf_counter(), 0.0))
            if p.is_alive():
                p.terminate()
        self._tmp.cleanup()
        gc.collect()
        return info


def _slab_sums(events: list[dict], rest: dict) -> dict:
    """The slab counts of a stretch: its refine events' and what the
    counters held at its end."""
    keys = ("trades", "rows", "sent", "dropped")
    out = {k: sum(int(e.get(f"slab_{k}", 0)) for e in events) + rest[k] for k in keys}
    out["fullest"] = (sum(e.get("slab_fullest", 0.0) * e.get("slab_trades", 0) for e in events)
                      + rest["fullest"])
    return out


# ------------------------------------------------------------------ the reference
def reference_run(config: dict, mix: dict, seed: int, device, tf32: bool = False) -> dict:
    """Kind "train"'s reference run with the blocked render and probe
    (`reference/blocked.py`) in place of the whole-scene ones."""
    from ..reference import blocked
    from ..reference import model as rm
    from ..reference import train as rt

    rm_b = types.SimpleNamespace(**{**vars(rm), "binning_counts": blocked.binning_counts})
    rt_b = types.SimpleNamespace(**{**vars(rt), "train_step": blocked.train_step,
                                    "eval_opt_step": blocked.eval_opt_step})
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return single._reference_run(rm_b, rt_b, config, mix, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def check(config: dict, mix: dict, seed: int, device, program: dict,
          res: dict) -> dict[str, float]:
    """Kind "train"'s comparison against the blocked reference, and the
    rows the depth slabs dropped."""
    return {**single.compare(program, reference_run(config, mix, seed, device)),
            "slab_dropped": float(res["slab_dropped"])}


end_to_end = single.end_to_end
attempted = single.attempted
