"""Carry weights, cameras, a scene and training state across from the JAX
package as numpy arrays.

`params_from_numpy` takes a model as a nested dict of numpy arrays in the
field names of the JAX `ModelParams` / `GaussianParams` (a JAX caller gets it
with `jax.tree.map(np.asarray, params._asdict())` plus `gaussians._asdict()`),
and `cameras_from_numpy` a dict of the JAX `Cameras` fields.
`scene_from_numpy` builds a `ParsedScene` and its two image stacks,
`strategy_state_from_numpy` the densification accumulators, and
`optimizer_state_from_numpy` loads Adam's moments and update count (optax's
`mu`, `nu` and `count`, by leaf name) into an `Optimizer`.
`trainer_state_from_numpy` loads the state dict of a JAX checkpoint into a
`Trainer`, so a model trained by the JAX package is evaluated or continued
here. None needs JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..cameras.cameras import Cameras
from ..data.dataparser import ParsedScene
from ..data.dataset import ImageCache
from ..device import resolve_device
from .splatfacto import GaussianParams, ModelParams
from .strategy import StrategyState, init_strategy_state

_OPT_GROUPS = ("camera_opt", "velocity_opt", "eval_camera_opt", "eval_velocity_opt")


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)


def params_from_numpy(tree: Mapping[str, Any], device=None) -> ModelParams:
    """{"gaussians": {means, scales_log, quats, opacities_logit, features_dc,
    features_rest, alive}, "background_logit", "camera_opt", "velocity_opt",
    "eval_camera_opt", "eval_velocity_opt"} of numpy arrays -> ModelParams."""
    dev = resolve_device(device)
    g = tree["gaussians"]
    gauss = GaussianParams(**{f: _f32(g[f], dev) for f in GaussianParams._fields})
    groups = {k: {name: _f32(v, dev) for name, v in dict(tree.get(k) or {}).items()}
              for k in _OPT_GROUPS}
    return ModelParams(gaussians=gauss,
                       background_logit=_f32(tree["background_logit"], dev), **groups)


def cameras_from_numpy(fields: Mapping[str, Any], device=None) -> Cameras:
    """{R_c2w, p_c2w, fx, fy, cx, cy, width, height, and optionally lin_vel,
    ang_vel, exposure_time, rolling_shutter_time, cam_idx} -> Cameras."""
    dev = resolve_device(device)
    kw = {k: (_f32(v, dev) if k != "cam_idx" else torch.tensor(np.asarray(v), device=dev).long())
          for k, v in fields.items()
          if k not in ("width", "height") and v is not None}
    return Cameras(width=int(fields["width"]), height=int(fields["height"]), **kw)


def named_leaves(params: ModelParams) -> dict[str, torch.Tensor]:
    """Every leaf of the model by dotted name ("gaussians.means",
    "background_logit", "camera_opt.phi", ...), `alive` included."""
    out = {f"gaussians.{f}": getattr(params.gaussians, f) for f in GaussianParams._fields}
    out["background_logit"] = params.background_logit
    for group in _OPT_GROUPS:
        out.update({f"{group}.{k}": v for k, v in getattr(params, group).items()})
    return out


def scene_from_numpy(tree: Mapping[str, Any], device=None
                     ) -> tuple[ParsedScene, ImageCache, ImageCache]:
    """{"train_cameras", "eval_cameras": dicts as `cameras_from_numpy` takes,
    "train_images", "eval_images": (N, H, W, 3) float arrays in [0, 1],
    "points_xyz", "points_rgb": the seed cloud or None, and optionally
    "train_paths", "eval_paths", "transform", "scale", "metadata"} ->
    (ParsedScene, train ImageCache, eval ImageCache)."""
    train = ImageCache.from_arrays(tree["train_images"], tree.get("train_paths"))
    evals = ImageCache.from_arrays(tree["eval_images"], tree.get("eval_paths"))
    xyz, rgb = tree.get("points_xyz"), tree.get("points_rgb")
    scene = ParsedScene(
        train_cameras=cameras_from_numpy(tree["train_cameras"], device),
        eval_cameras=cameras_from_numpy(tree["eval_cameras"], device),
        train_paths=train.paths, eval_paths=evals.paths,
        train_indices=np.arange(len(train)), eval_indices=np.arange(len(evals)),
        points_xyz=None if xyz is None else np.asarray(xyz, np.float32),
        points_rgb=None if rgb is None else np.asarray(rgb),
        transform=np.asarray(tree.get("transform", np.eye(4)[:3]), np.float32),
        scale=float(tree.get("scale", 1.0)), metadata=dict(tree.get("metadata") or {}))
    return scene, train, evals


def strategy_state_from_numpy(grad_accum, grad_count, seed: int = 0, device=None) -> StrategyState:
    """The densification accumulators of a JAX `StrategyState`; the split
    generator is seeded anew (JAX's PRNG key has no counterpart)."""
    dev = resolve_device(device)
    state = init_strategy_state(len(grad_accum), seed, device=dev)
    return state._replace(
        grad_accum=_f32(grad_accum, dev),
        grad_count=torch.tensor(np.asarray(grad_count, dtype=np.int32), device=dev))


def optimizer_state_from_numpy(optimizer, params: ModelParams, mu: Mapping[str, Any],
                               nu: Mapping[str, Any], count: int) -> None:
    """Put `optimizer` (an `engine.trainer.Optimizer` over `params`) in the
    state of an optax optimizer after `count` updates: mu and nu hold Adam's
    first and second moments by `named_leaves` name, for every trainable leaf
    that has been updated; the exponential decays resume at `count`."""
    adam = optimizer.adam
    for name, leaf in named_leaves(params).items():
        if name not in mu:
            continue
        adam.state[leaf] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _f32(mu[name], leaf.device),
            "exp_avg_sq": _f32(nu[name], leaf.device),
        }
    optimizer.set_count(int(count))


@torch.no_grad()
def trainer_state_from_numpy(trainer, tree: Mapping[str, Any]) -> None:
    """Load the state dict of a JAX `Trainer.save_checkpoint` (as numpy
    arrays) into `trainer`, an `engine.trainer.Trainer` built on the same
    scene and configuration.

    tree: {"gaussians": {...}, "background_logit", "camera_opt",
    "velocity_opt", "eval_camera_opt", "eval_velocity_opt", "step"} and
    optionally "opt_state" and "eval_opt_state", each flattened to {"mu":
    {leaf name: array}, "nu": {...}, "count": int} by `named_leaves` name (as
    `optimizer_state_from_numpy` takes them), "strat_state": {"grad_accum",
    "grad_count"} and "sampling": {"cam_order", "last_reset_step"}. The model
    adapts to the stored capacity. JAX's PRNG keys (the sampling key, the
    strategy key) have no counterpart: this trainer's generators stay as they
    were seeded from `TrainerConfig.seed`, so a continued run draws its own
    camera order and split offsets from there."""
    stored_cap = int(np.asarray(tree["gaussians"]["means"]).shape[0])
    if stored_cap != trainer.params.gaussians.alive.shape[0]:
        trainer._resize_gaussians(stored_cap)
    source = params_from_numpy(tree, device="cpu")
    mine = named_leaves(trainer.params)
    for name, value in named_leaves(source).items():
        if name not in mine:
            raise ValueError(f"the checkpoint holds {name}, which this trainer's "
                             "configuration does not")
        if mine[name].shape != value.shape:
            raise ValueError(f"{name} is {tuple(value.shape)} in the checkpoint, "
                             f"{tuple(mine[name].shape)} here")
        mine[name].copy_(value)
    trainer.step = int(tree["step"])
    if tree.get("opt_state") is not None:
        o = tree["opt_state"]
        optimizer_state_from_numpy(trainer.optimizer, trainer.params, o["mu"], o["nu"],
                                   int(o["count"]))
    if tree.get("eval_opt_state") is not None and trainer.eval_optimizer is not None:
        o = tree["eval_opt_state"]
        for name, leaf in mine.items():
            if name in o["mu"]:
                trainer.eval_optimizer.adam.state[leaf] = {
                    "step": torch.tensor(float(o["count"]), dtype=torch.float32),
                    "exp_avg": _f32(o["mu"][name], leaf.device),
                    "exp_avg_sq": _f32(o["nu"][name], leaf.device)}
    if tree.get("strat_state") is not None:
        s = tree["strat_state"]
        trainer.strat_state = trainer.strat_state._replace(
            grad_accum=_f32(s["grad_accum"], trainer.device),
            grad_count=torch.tensor(np.asarray(s["grad_count"], dtype=np.int32),
                                    device=trainer.device))
    trainer._order = None
    sampling = tree.get("sampling") or {}
    if "cam_order" in sampling and not (np.asarray(sampling["cam_order"]) < 0).any():
        trainer._order = [int(i) for i in np.asarray(sampling["cam_order"])]
    lrs = int(sampling.get("last_reset_step", -1))
    trainer._last_reset_step = lrs if lrs >= 0 else -(10**9)
    trainer._pyramid.clear()
