"""The reference training loop: the semantics of `splat_tpu_torch/engine/trainer.py`
at commit 49129b2 (`train_step`, the per-group Adam with its exponential
decays, the eval-camera step, the refine boundary, capacity growth), written
plainly over `model.py`. Adam is the single-tensor update of
`torch.optim.Adam` (eps 1e-15), written out here so that nothing of the
program's optimizer is shared. It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from . import model as m

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
GAUSSIAN_GROUPS = ("means", "scales", "quats", "opacities", "features_dc", "features_rest")
# group -> (leaf names in ModelParams terms, trainer-config keys of the initial
# and final learning rate)
GROUPS = {
    "means": (["gaussians.means"], "lr_means", "lr_means_final"),
    "scales": (["gaussians.scales_log"], "lr_scales", None),
    "quats": (["gaussians.quats"], "lr_quats", None),
    "opacities": (["gaussians.opacities_logit"], "lr_opacities", None),
    "features_dc": (["gaussians.features_dc"], "lr_features_dc", None),
    "features_rest": (["gaussians.features_rest"], "lr_features_rest", None),
    "background": (["background_logit"], "lr_background", None),
    "camera_opt": (["camera_opt.dp", "camera_opt.phi"], "lr_camera_opt", "lr_camera_opt_final"),
    "velocity_opt": (["velocity_opt.dom", "velocity_opt.dv"], "lr_velocity_opt",
                     "lr_velocity_opt_final"),
}


def leaves(params: m.ModelParams) -> dict[str, torch.Tensor]:
    """Every trainable leaf by dotted name (`alive` is never trained)."""
    out = {f"gaussians.{f}": getattr(params.gaussians, f)
           for f in m.GaussianParams._fields if f != "alive"}
    out["background_logit"] = params.background_logit
    for group in ("camera_opt", "velocity_opt", "eval_camera_opt", "eval_velocity_opt"):
        for k, v in getattr(params, group).items():
            out[f"{group}.{k}"] = v
    return out


class Adam:
    """Adam over named leaves, one learning rate a leaf, updated in place."""

    def __init__(self):
        self.state: dict[str, dict] = {}

    @torch.no_grad()
    def update(self, name: str, leaf: torch.Tensor, grad: torch.Tensor, lr: float) -> None:
        st = self.state.setdefault(name, {"step": 0, "m": torch.zeros_like(leaf),
                                          "v": torch.zeros_like(leaf)})
        st["step"] += 1
        st["m"].lerp_(grad, 1 - BETA1)
        st["v"].mul_(BETA2).addcmul_(grad, grad.conj(), value=1 - BETA2)
        bias1 = 1 - BETA1 ** st["step"]
        bias2_sqrt = math.sqrt(1 - BETA2 ** st["step"])
        denom = (st["v"].sqrt() / bias2_sqrt).add_(ADAM_EPS)
        leaf.addcdiv_(st["m"], denom, value=-lr / bias1)


def group_lr(tc: dict, group: str, count: int) -> float:
    """The group's learning rate at update count `count`:
    init * (final / init) ** (count / max_steps)."""
    _, k_init, k_final = GROUPS[group]
    init = tc[k_init]
    final = tc[k_final] if k_final else init
    return init * (final / init) ** (count / tc["max_steps"])


def train_step(params: m.ModelParams, adam: Adam, accum: dict, config: m.SplatfactoConfig,
               tc: dict, camera: m.Cameras, gt: torch.Tensor, step: int):
    """One step of `engine/trainer.py:train_step`; returns (loss, grads by
    leaf name). `accum` holds the densification statistics, updated here."""
    sh_deg = m.active_sh_degree(config, step)
    named = leaves(params)
    for t in named.values():
        t.requires_grad_(True)
        t.grad = None
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    bg = m.background_color(params, config)
    out = m.render_camera(params, camera, config, sh_deg, bg, means2d_probe=probe)
    loss, _ = m.compute_losses(m.gamma_encode(out.rgb, config), gt, params, config)
    loss.backward()
    grads = {}
    for group, (names, _, _) in GROUPS.items():
        lr = group_lr(tc, group, step)
        for name in names:
            leaf = named.get(name)
            if leaf is None or leaf.grad is None:
                continue
            grads[name] = leaf.grad.detach().clone()
            adam.update(name, leaf, leaf.grad, lr)
    with torch.no_grad():
        visible = torch.linalg.norm(probe.grad, dim=-1) > 0
        norm = torch.linalg.norm(probe.grad, dim=-1) * (max(camera.width, camera.height) * 0.5)
        accum["grad_accum"] = accum["grad_accum"] + torch.where(visible, norm, 0.0)
        accum["grad_count"] = accum["grad_count"] + visible.to(torch.int32)
    for t in named.values():
        t.requires_grad_(False)
        t.grad = None
    return loss.detach(), grads


EVAL_GROUPS = ("eval_camera_opt", "eval_velocity_opt")


def eval_opt_step(params: m.ModelParams, adam: Adam, config: m.SplatfactoConfig, tc: dict,
                  camera: m.Cameras, gt: torch.Tensor, step: int):
    """One step of `engine/trainer.py:eval_opt_step`: the eval camera's pose
    and velocity corrections, and nothing else, take one Adam step at the
    constant `lr_camera_opt` on the loss of the eval camera's render. Returns
    (loss, grads by leaf name)."""
    named = {f"{group}.{k}": v for group in EVAL_GROUPS
             for k, v in getattr(params, group).items()}
    for t in named.values():
        t.requires_grad_(True)
        t.grad = None
    bg = m.background_color(params, config)
    out = m.render_camera(params, camera, config, m.active_sh_degree(config, step), bg,
                          is_eval_camera=True)
    loss, _ = m.compute_losses(m.gamma_encode(out.rgb, config), gt, params, config)
    loss.backward()
    grads = {}
    for name, leaf in named.items():
        if leaf.grad is None:
            continue
        grads[name] = leaf.grad.detach().clone()
        adam.update(name, leaf, leaf.grad, tc["lr_camera_opt"])
    for t in named.values():
        t.requires_grad_(False)
        t.grad = None
    return loss.detach(), grads


@torch.no_grad()
def refine_boundary(params: m.ModelParams, adam: Adam, accum: dict, config: m.SplatfactoConfig,
                    tc: dict, step: int, generator: torch.Generator) -> tuple[m.ModelParams, dict]:
    """The trainer's refine at boundary `step`: cull and densify, Adam's
    moments zeroed at the changed slots, the capacity doubled past
    `grow_threshold`, the opacities reset on schedule (no reset pause is
    pending in the reference's runs). Returns (params, counts)."""
    g = params.gaussians
    noise = (torch.randn(g.means.shape, generator=generator, device=g.means.device),
             torch.randn(g.means.shape, generator=generator, device=g.means.device))
    state = m.StrategyState(accum["grad_accum"], accum["grad_count"], generator)
    new_g, state, changed, info = m.refine(g, state, step, config, noise)
    accum["grad_accum"], accum["grad_count"] = state.grad_accum, state.grad_count
    for f in m.GaussianParams._fields:
        st = adam.state.get(f"gaussians.{f}")
        if st:
            mask = changed.reshape((-1,) + (1,) * (st["m"].ndim - 1))
            st["m"].masked_fill_(mask, 0.0)
            st["v"].masked_fill_(mask, 0.0)
    params = params._replace(gaussians=new_g)
    cap = new_g.alive.shape[0]
    if float(new_g.alive.sum()) / cap > tc["grow_threshold"] and cap < tc["max_capacity"]:
        new_cap = min(cap * 2, tc["max_capacity"])
        params = params._replace(gaussians=m.grow_capacity(new_g, new_cap))
        for f in m.GaussianParams._fields:
            st = adam.state.get(f"gaussians.{f}")
            if st:
                for k in ("m", "v"):
                    st[k] = torch.cat([st[k], st[k].new_zeros((new_cap - cap,)
                                                              + tuple(st[k].shape[1:]))])
        for k in ("grad_accum", "grad_count"):
            accum[k] = torch.nn.functional.pad(accum[k], (0, new_cap - cap))
    n_ref = step // config.refine_every
    if (config.reset_alpha_every > 0 and n_ref % config.reset_alpha_every == 0
            and step < config.stop_split_at):
        reset_val = m._logit(min(config.cull_alpha_thresh * 2.0, 0.99))
        params.gaussians.opacities_logit.clamp_(max=reset_val)
    return params, {k: int(v) for k, v in info.items()}
