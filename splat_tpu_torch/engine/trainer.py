"""One training step of the method (port of `splat_tpu/engine/trainer.py`'s
`TrainerConfig` learning rates, `param_labels`, `build_optimizer` and
`_train_step_body`).

`Optimizer` makes one Adam parameter group per label of the JAX
package's `param_labels` (eps 1e-15, the splatfacto 1.1.0 learning rates),
with the continuous exponential decay of `optax.exponential_decay` on the
means and the camera and velocity corrections: lr(c) = init * (final /
init) ** (c / max_steps) at the optimizer's update count c before the
update, so the first update uses init. `alive` is in no group (the JAX
package's `set_to_zero`). `train_step` renders, takes the loss and its
gradients, updates the parameters in place and accumulates the
densification statistics. The eval-camera step, refine and reset schedule,
capacity growth, progressive resolution, checkpoints and the `train()` loop
come with the trainer slice.
"""
from __future__ import annotations

import dataclasses

import torch

from ..cameras.cameras import Cameras
from ..models import splatfacto as sf
from ..models import strategy as st


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_steps: int = 20000
    # per-group learning rates (splatfacto 1.1.0)
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 1.25e-4
    lr_opacities: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_background: float = 5e-3
    lr_camera_opt: float = 6e-4
    lr_camera_opt_final: float = 6e-5
    lr_velocity_opt: float = 1e-3
    lr_velocity_opt_final: float = 1e-4


def param_groups(params: sf.ModelParams) -> dict[str, list[torch.Tensor]]:
    """The trainable leaves by label, as the JAX package's `param_labels`
    (without "frozen": `alive` is never updated). Empty groups are left out."""
    g = params.gaussians
    groups = {
        "means": [g.means], "scales": [g.scales_log], "quats": [g.quats],
        "opacities": [g.opacities_logit], "features_dc": [g.features_dc],
        "features_rest": [g.features_rest], "background": [params.background_logit],
        "camera_opt": list(params.camera_opt.values()),
        "velocity_opt": list(params.velocity_opt.values()),
        "eval_camera_opt": list(params.eval_camera_opt.values()),
        "eval_velocity_opt": list(params.eval_velocity_opt.values()),
    }
    return {k: v for k, v in groups.items() if v}


class Optimizer:
    """Per-group Adam with the exponential decays, over the trainable leaves,
    which it marks requires_grad. A leaf that got no gradient is left as it
    is; optax's zero-gradient update leaves it so only while the leaf has
    never had a gradient (Adam's first moment still zero), which holds for
    the eval-camera groups, the only leaves without one in a train step."""

    def __init__(self, params: sf.ModelParams, tc: TrainerConfig):
        groups = param_groups(params)
        lr = {"means": (tc.lr_means, tc.lr_means_final),
              "features_dc": tc.lr_features_dc, "features_rest": tc.lr_features_rest,
              "opacities": tc.lr_opacities, "scales": tc.lr_scales, "quats": tc.lr_quats,
              "background": tc.lr_background,
              "camera_opt": (tc.lr_camera_opt, tc.lr_camera_opt_final),
              "velocity_opt": (tc.lr_velocity_opt, tc.lr_velocity_opt_final),
              "eval_camera_opt": (tc.lr_camera_opt, tc.lr_camera_opt_final),
              "eval_velocity_opt": (tc.lr_velocity_opt, tc.lr_velocity_opt_final)}
        self.params = [p for leaves in groups.values() for p in leaves]
        for p in self.params:
            p.requires_grad_(True)
        adam_groups, decays = [], []
        for name, leaves in groups.items():
            init, final = lr[name] if isinstance(lr[name], tuple) else (lr[name], lr[name])
            adam_groups.append({"params": leaves, "lr": init, "name": name})
            decays.append(lambda c, r=final / init: r ** (c / tc.max_steps))
        self.adam = torch.optim.Adam(adam_groups, eps=1e-15)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adam, decays)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()
        self.schedule.step()    # the next update's learning rates


def train_step(params: sf.ModelParams, optimizer: Optimizer, strat_state: st.StrategyState,
               config: sf.SplatfactoConfig, camera: Cameras, gt: torch.Tensor, step: int,
               generator: torch.Generator | None = None):
    """One step: render with the means2d probe, gamma, losses, backward,
    Adam, densification statistics. Updates `params` in place (its leaves
    are the optimizer's) and returns (loss, aux, strat_state); aux holds the
    loss terms and n_visible, the Gaussians whose probe gradient is nonzero.
    generator feeds background_color "random"."""
    sh_deg = sf.active_sh_degree(config, step)
    optimizer.zero_grad()
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    # the background from the differentiated params: "auto" learns it
    bg = sf.background_color(params, config, generator)
    out = sf.render_camera(params, camera, config, sh_deg, bg, means2d_probe=probe)
    loss, aux = sf.compute_losses(sf.gamma_encode(out.rgb, config), gt, params, config)
    loss.backward()
    optimizer.step()
    visible = torch.linalg.norm(probe.grad, dim=-1) > 0
    strat_state = st.accumulate_grads(strat_state, probe.grad, visible, camera.width,
                                      camera.height)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["n_visible"] = visible.sum()
    return loss.detach(), aux, strat_state
