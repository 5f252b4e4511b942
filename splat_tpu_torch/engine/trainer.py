"""The training loop of the method (port of `splat_tpu/engine/trainer.py`:
`TrainerConfig`, the per-group optimizer, `train_step`, the eval-camera step
and `Trainer` with `run`, `evaluate` and `render_eval`, on one device or on
a mesh).

`Optimizer` makes one Adam parameter group per label of the JAX
package's `param_labels` (eps 1e-15, the splatfacto 1.1.0 learning rates),
with the continuous exponential decay of `optax.exponential_decay` on the
means and the camera and velocity corrections: lr(c) = init * (final /
init) ** (c / max_steps) at the optimizer's update count c before the
update, so the first update uses init. `alive` is in no group (the JAX
package's `set_to_zero`). `train_step` renders, takes the loss and its
gradients, updates the parameters in place and accumulates the
densification statistics.

`Trainer.run` cycles the train cameras in a shuffled epoch order, takes an
eval-camera step (a second, constant-rate Adam over the eval pose and
velocity corrections with the scene frozen) every `eval_opt_every` steps,
and at refine boundaries culls and densifies (`models/strategy.py`), zeroes
the Adam moments of the refreshed slots, doubles the capacity when the alive
share passes `grow_threshold` (moments and schedule counts carried over),
probes the unclamped per-tile populations to grow `max_per_tile` or
`max_total_entries`, and resets the opacities on schedule. The host reads
device values only at refine and log boundaries. Random draws (camera order,
split offsets, the random background) come from `torch.Generator`s seeded
with `TrainerConfig.seed`. Each refine's event carries binning's counts over
the steps since the last one (`utils/profiling.BinningCounters`), and the
loop's phases and the step's layers open `utils/profiling.span`s.

A checkpoint is a directory `step_N/` holding `state.npz` (numpy arrays under
flat dotted keys, no pickled objects) and `meta.json`: every model leaf, the
step, Adam's `exp_avg`, `exp_avg_sq` and `step` per leaf and the decays' count,
the eval optimizer's state, the strategy accumulators, and the sampling stream
(the three generators' states, the epoch order, the last reset step, the
tile-overflow streak, binning's counts since the last refine), so save ->
fresh trainer -> load -> run continues the trajectory of an uninterrupted run
bit for bit. The JAX package's Orbax trees are not read here
(`models.convert.trainer_state_from_numpy` takes one as numpy arrays).

With a `mesh` (`parallel/sharding.py`, one process per rank) the step goes
through `sharded_train_step` and the eval-camera step through
`sharded_eval_opt_step`; each rank of the data axis takes its own camera of
a batch that every rank draws alike from the same generator (the cursor
advances per camera), and the eval renders go through `sharded_render`. On
a gauss-sharded mesh the refine block works on each rank's shard: cull,
densify and the opacity reset elementwise, the new Gaussians placed over the
shards by `sharding.refine_shard` (the gathered refine's state, bitwise),
the growth check on the alive count summed over the shards, the tile probe's
per-tile counts summed over them. A growth itself and the checkpoints run on
the global view (`global_view`): the Gaussian shards, their Adam moments and
the strategy accumulators gathered, the same code run on every rank, then
sharded again. A checkpoint holds the global state (rank 0 writes it, every
rank reads it), so mesh and single-device runs load each other's. On a slab
mesh the refine's event also carries the slabs' counts since the last one
(`utils/profiling.SlabCounters`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..cameras.cameras import Cameras
from ..data.dataparser import ParsedScene
from ..data.dataset import ImageCache, load_scene_images
from ..device import resolve_device
from ..models import splatfacto as sf
from ..models import strategy as st
from ..models.convert import named_leaves
from ..ops import lpips as lpips_mod
from ..ops.ssim import psnr as psnr_fn
from ..ops.ssim import ssim as ssim_fn
from ..parallel import sharding
from ..utils import profiling
from ..utils.profiling import StepTimer, span


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_steps: int = 20000
    seed: int = 42
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
    # schedule
    eval_opt_every: int = 5            # eval-camera step cadence
    grow_threshold: float = 0.9        # grow the capacity when the alive share exceeds this
    max_capacity: int = 1 << 21
    checkpoint_every: int = 5000
    log_every: int = 100
    # wait for the device only every k steps, so the host runs ahead of it;
    # the step times are those of the windows between two waits
    sync_every: int = 10
    # the JAX package runs this many steps per dispatch through lax.scan, the
    # same step sequence; this package dispatches eagerly, so the field is
    # accepted and the steps run one by one
    scan_steps: int = 1
    # JAX buffer donation; no counterpart here (updates are in place)
    donate_buffers: bool = True
    # adaptive per-tile depth-list capacity: at refine boundaries, probe the
    # unclamped per-tile populations on the last trained camera; when the
    # dropped share exceeds tile_overflow_tol on two probes in a row, grow
    # model.max_per_tile by doubling up to max_tile_capacity
    adapt_tile_capacity: bool = True
    tile_overflow_tol: float = 0.002   # share of all entries dropped
    max_tile_capacity: int = 2048


# the per-Gaussian groups: their leaves' leading size is the capacity
GAUSSIAN_GROUPS = ("means", "scales", "quats", "opacities", "features_dc", "features_rest")


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

    def set_count(self, count: int) -> None:
        """Resume the exponential decays at update count `count`."""
        sched = self.schedule
        sched.last_epoch = int(count)
        for group, base, decay in zip(self.adam.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * decay(int(count))
        sched._last_lr = [group["lr"] for group in self.adam.param_groups]

    def gaussian_leaves(self):
        for group in self.adam.param_groups:
            if group["name"] in GAUSSIAN_GROUPS:
                yield from group["params"]

    @torch.no_grad()
    def remap(self, new_leaves: dict[torch.Tensor, torch.Tensor],
              moments: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Swap leaves for new ones (`new_leaves` maps each old leaf to its
        successor), each of Adam's moments taken through `moments`; the step
        counts, the groups' learning rates and the schedule's count stay."""
        for group in self.adam.param_groups:
            for i, old in enumerate(group["params"]):
                new = new_leaves.get(old)
                if new is None:
                    continue
                new.requires_grad_(True)
                group["params"][i] = new
                state = self.adam.state.pop(old, None)
                if state:
                    for key in ("exp_avg", "exp_avg_sq"):
                        state[key] = moments(state[key])
                    self.adam.state[new] = state
        self.params = [new_leaves.get(p, p) for p in self.params]

    def grow(self, new_leaves: dict[torch.Tensor, torch.Tensor]) -> None:
        """Swap per-Gaussian leaves for their grown copies (port of
        `grow_opt_state`): `new_leaves` maps each old leaf to its padded
        successor. Adam's moments move to the new leaf padded with zeros."""
        cap = next(iter(new_leaves.values())).shape[0]
        self.remap(new_leaves, lambda m: torch.cat(
            [m, m.new_zeros((cap - m.shape[0],) + tuple(m.shape[1:]))]))

    @torch.no_grad()
    def zero_slots(self, changed: torch.Tensor) -> None:
        """Zero Adam's moments at the refreshed Gaussian slots (port of
        `zero_gaussian_opt_slots`; splatfacto resets the optimizer state of
        duplicated and split parameters). changed: (capacity,) bool."""
        for leaf in self.gaussian_leaves():
            state = self.adam.state.get(leaf)
            if not state:
                continue
            mask = changed.reshape((-1,) + (1,) * (leaf.ndim - 1))
            for key in ("exp_avg", "exp_avg_sq"):
                state[key].masked_fill_(mask, 0.0)


def train_step(params: sf.ModelParams, optimizer: Optimizer, strat_state: st.StrategyState,
               config: sf.SplatfactoConfig, camera: Cameras, gt: torch.Tensor, step: int,
               generator: torch.Generator | None = None):
    """One step: render with the means2d probe, gamma, losses, backward,
    Adam, densification statistics. Updates `params` in place (its leaves
    are the optimizer's) and returns (loss, aux, strat_state); aux holds the
    loss terms and n_visible, the Gaussians whose probe gradient is nonzero.
    generator feeds background_color "random"."""
    sh_deg = sf.active_sh_degree(config, step)
    with span("splat.optimizer"):
        optimizer.zero_grad()
    probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
    # the background from the differentiated params: "auto" learns it
    bg = sf.background_color(params, config, generator)
    out = sf.render_camera(params, camera, config, sh_deg, bg, means2d_probe=probe)
    with span("splat.loss"):
        loss, aux = sf.compute_losses(sf.gamma_encode(out.rgb, config), gt, params, config)
    loss.backward()
    with span("splat.optimizer"):
        optimizer.step()
        visible = torch.linalg.norm(probe.grad, dim=-1) > 0
        strat_state = st.accumulate_grads(strat_state, probe.grad, visible, camera.width,
                                          camera.height)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["n_visible"] = visible.sum()
    return loss.detach(), aux, strat_state


class EvalOptimizer:
    """The eval cameras' own Adam (constant `lr_camera_opt`, eps 1e-15) over
    the eval pose and velocity corrections: the JAX package's
    `optax.adam(tc.lr_camera_opt, eps=1e-15)` over {"cam", "vel"}."""

    def __init__(self, params: sf.ModelParams, tc: TrainerConfig):
        self.leaves = (list(params.eval_camera_opt.values())
                       + list(params.eval_velocity_opt.values()))
        for p in self.leaves:
            p.requires_grad_(True)
        self.adam = torch.optim.Adam(self.leaves, lr=tc.lr_camera_opt, eps=1e-15)


def eval_opt_step(params: sf.ModelParams, eval_optimizer: EvalOptimizer,
                  config: sf.SplatfactoConfig, camera: Cameras, gt: torch.Tensor, step: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Optimise the eval cameras' pose and velocity corrections without
    touching the scene (port of `make_eval_opt_step`): every other leaf is
    detached, the gradient is taken with respect to the eval leaves only, and
    only they are updated, in place. Returns the loss."""
    g = params.gaussians
    frozen = params._replace(
        gaussians=sf.GaussianParams(*(t.detach() for t in g)),
        background_logit=params.background_logit.detach(),
        camera_opt={k: v.detach() for k, v in params.camera_opt.items()},
        velocity_opt={k: v.detach() for k, v in params.velocity_opt.items()})
    bg = sf.background_color(frozen, config, generator)
    out = sf.render_camera(frozen, camera, config, sf.active_sh_degree(config, step), bg,
                           is_eval_camera=True)
    with span("splat.loss"):
        loss, _ = sf.compute_losses(sf.gamma_encode(out.rgb, config), gt, frozen, config)
    grads = torch.autograd.grad(loss, eval_optimizer.leaves, allow_unused=True)
    with span("splat.optimizer"):
        for p, grad in zip(eval_optimizer.leaves, grads):
            p.grad = grad
        eval_optimizer.adam.step()
        eval_optimizer.adam.zero_grad(set_to_none=True)
    return loss.detach()


@dataclasses.dataclass
class Trainer:
    """Train one scene (port of the JAX package's `Trainer`).

    scene: the parsed cameras and seed cloud; train_images, eval_images: the
    two image stacks, in the order of the scene's cameras (None: decoded from
    the scene's image paths). The model and every image live on `device`
    (CUDA unless "cpu" is asked for). mesh: this rank's `sharding.Mesh`
    (every rank builds its Trainer alike), None for one device."""

    scene: ParsedScene
    model_config: sf.SplatfactoConfig
    trainer_config: TrainerConfig = TrainerConfig()
    train_images: ImageCache | None = None
    eval_images: ImageCache | None = None
    device: str | torch.device | None = None
    mesh: Any = None

    def __post_init__(self):
        if self.train_images is None or self.eval_images is None:
            self.train_images, self.eval_images = load_scene_images(self.scene)
        self.device = dev = resolve_device(self.device)
        cfg, tc = self.model_config, self.trainer_config
        self.params = sf.init_model(
            self.scene.points_xyz, self.scene.points_rgb, len(self.scene.train_cameras),
            len(self.scene.eval_cameras), cfg, seed=tc.seed, device=dev)
        # per-camera parameters are routed by position within the split
        self.train_cams = self._localize(self.scene.train_cameras)
        self.eval_cams = self._localize(self.scene.eval_cameras)
        if cfg.blur_anchors == 0:
            cfg = dataclasses.replace(
                cfg, blur_anchors=sf.resolve_blur_anchors(cfg, self.train_cams))
            self.model_config = cfg
        self.optimizer = Optimizer(self.params, tc)
        self.strat_state = st.init_strategy_state(
            self.params.gaussians.alive.shape[0], tc.seed, device=dev)
        self.data_batch = 1 if self.mesh is None else self.mesh.shape["data"]
        if self.mesh is not None:
            self.params, self.strat_state = sharding.shard_train_state(
                self.mesh, self.params, self.optimizer, self.strat_state)
        self.eval_optimizer = (EvalOptimizer(self.params, tc)
                               if cfg.optimize_eval_cameras and self.params.eval_camera_opt
                               else None)
        self._eval_imgs_dev = torch.as_tensor(self.eval_images.images).to(dev)
        self._sampler = torch.Generator().manual_seed(tc.seed)        # camera order (host)
        self._bg_generator = torch.Generator(device=dev).manual_seed(tc.seed)
        self._order: list[int] | None = None
        self._pyramid: dict[int, tuple[Cameras, torch.Tensor]] = {}
        self._probe_cam: Cameras | None = None
        self._overflow_streak = 0
        self._tile_overflow_frac: float | None = None
        self._entry_stream_pressure: float | None = None
        self.step = 0
        self._last_reset_step = -(10**9)
        self.history: list[dict] = []
        # one record per refine: the counts, whether the capacity or the tile
        # capacity grew and the opacities were reset at that boundary, and
        # binning's counts over the steps since the last refine
        self.refine_events: list[dict] = []
        self.timer = StepTimer(device=dev)
        self.binning_counters = profiling.BinningCounters()
        self.slab_counters = profiling.SlabCounters()
        self._binning_rates: dict[str, float] = {}

    def _localize(self, cams: Cameras) -> Cameras:
        fields = {k: getattr(cams, k).to(self.device) for k in Cameras._tensor_fields}
        fields["cam_idx"] = torch.arange(len(cams), dtype=torch.int64, device=self.device)
        return Cameras(width=cams.width, height=cams.height, **fields)

    # ------------------------------------------- adaptive tile capacity
    def _probe_counts(self, cam: Cameras) -> np.ndarray:
        """The unclamped per-tile populations of `cam`, on the host (on a
        gauss-sharded mesh summed over the shards: counts over a partition
        of the Gaussians add)."""
        with torch.no_grad():
            counts = sf.binning_counts(self.params, cam, self.model_config)
            if self._gauss_sharded():
                counts = sharding.reduce_(counts, self.mesh.axes["gauss"])
            return counts.cpu().numpy()

    def _maybe_adapt_tile_capacity(self) -> bool:
        """Grow max_per_tile (doubling) when the probe shows the binning
        dropping more than tile_overflow_tol of its entries on two probes in
        a row, and max_total_entries when the landed entries pass 80 % of it.
        Nothing downstream caches either: the kernels take K per launch and
        every binning rebuilds its lists."""
        tc, cfg = self.trainer_config, self.model_config
        cam = self._probe_cam
        if not tc.adapt_tile_capacity or cam is None:
            return False
        counts = self._probe_counts(cam).astype(np.int64)
        total = max(int(counts.sum()), 1)
        over = int(np.maximum(counts - cfg.max_per_tile, 0).sum())
        self._tile_overflow_frac = over / total

        # the sorted stream's cap drops whole high-tile-id segments, so it
        # must never bind: grow it at 80 % pressure, whatever max_per_tile does
        grew_stream = False
        if cfg.max_total_entries > 0:
            landed = int(np.minimum(counts, cfg.max_per_tile).sum())
            self._entry_stream_pressure = landed / cfg.max_total_entries
            if landed > 0.8 * cfg.max_total_entries:
                new_cap = cfg.max_total_entries
                while landed > 0.8 * new_cap:
                    new_cap *= 2
                cfg = dataclasses.replace(cfg, max_total_entries=new_cap)
                self.model_config = cfg
                grew_stream = True

        if cfg.max_per_tile >= tc.max_tile_capacity:
            return grew_stream
        if over <= tc.tile_overflow_tol * total:
            self._overflow_streak = 0
            return grew_stream
        self._overflow_streak += 1
        if self._overflow_streak < 2:
            return grew_stream
        need = int(counts.max())
        new_k = cfg.max_per_tile
        while new_k < need and new_k < tc.max_tile_capacity:
            new_k *= 2
        new_k = min(new_k, tc.max_tile_capacity)
        if new_k == cfg.max_per_tile:
            return grew_stream
        self.model_config = dataclasses.replace(cfg, max_per_tile=new_k)
        self._overflow_streak = 0
        return True

    # ---------------------------------------------- progressive resolution
    def _resolution_level(self) -> int:
        cfg = self.model_config
        if cfg.num_downscales <= 0:
            return 0
        return max(0, cfg.num_downscales - self.step // cfg.resolution_schedule)

    def _level_data(self, level: int) -> tuple[Cameras, torch.Tensor]:
        """(cameras, images) at resolution level `level` (downscale 2^level),
        cached; the image stacks stay on the device. Level k crops to a
        multiple of d = 2^k, takes the d x d box mean (once, on the host, in
        the JAX package's arithmetic) and divides the intrinsics by d."""
        if level not in self._pyramid:
            imgs, cams = self.train_images.images, self.train_cams
            if level > 0:
                d = 1 << level
                h, w = imgs.shape[1] // d * d, imgs.shape[2] // d * d
                imgs = imgs[:, :h, :w].reshape(
                    imgs.shape[0], h // d, d, w // d, d, 3).mean(axis=(2, 4))
                scaled = {k: getattr(cams, k) / d for k in ("fx", "fy", "cx", "cy")}
                cams = dataclasses.replace(cams, width=cams.width // d,
                                           height=cams.height // d, **scaled)
            self._pyramid[level] = (cams, torch.as_tensor(imgs).to(self.device))
        return self._pyramid[level]

    # ------------------------------------------------------------ schedule
    def _maybe_grow(self) -> bool:
        """Double the capacity when the alive share passes grow_threshold.
        Every per-Gaussian leaf is replaced by a padded copy; Adam's moments
        and the schedule counts move with it, and the strategy state is
        padded (its generator is kept). On a gauss-sharded mesh the check
        reads the alive count summed over the shards, and a growth runs on
        the global view."""
        cap = self._capacity()
        tc = self.trainer_config
        if self._n_alive() / cap <= tc.grow_threshold or cap >= tc.max_capacity:
            return False
        new_cap = min(cap * 2, tc.max_capacity)
        with self.global_view():
            g = self.params.gaussians
            grown = st.grow_capacity(sf.GaussianParams(*(t.detach() for t in g)), new_cap)
            self.optimizer.grow({getattr(g, f): getattr(grown, f)
                                 for f in sf.GaussianParams._fields if f != "alive"})
            self.params = self.params._replace(gaussians=grown)
            self.strat_state = st.grow_strategy_state(self.strat_state, new_cap)
        return True

    def _next_camera_index(self, n_train: int) -> int:
        """The next train camera in the shuffled epoch order: a new
        permutation whenever the step count reaches a multiple of n_train."""
        return self._next_camera_indices(n_train, 1)[0]

    def _next_camera_indices(self, n_train: int, count: int) -> list[int]:
        """`count` consecutive draws of the shuffled epoch order (the mesh's
        camera batch), the cursor advancing per camera: a new permutation
        whenever the cursor reaches a multiple of n_train."""
        out = []
        for j in range(count):
            i = (self.step * count + j) % n_train
            if i == 0 or self._order is None:
                self._order = torch.randperm(n_train, generator=self._sampler).tolist()
            out.append(int(self._order[i]))
        return out

    @contextlib.contextmanager
    def global_view(self):
        """Inside, `params`, the optimizer and the strategy state hold the
        whole capacity axis on every rank of a gauss-sharded mesh (gathered
        on entry, sharded again on exit, whatever capacity they then have);
        elsewhere they always do."""
        if self.mesh is None or self.mesh.shape["gauss"] == 1:
            yield
            return
        self.params, self.strat_state = sharding.gather_train_state(
            self.mesh, self.params, self.optimizer, self.strat_state)
        try:
            yield
        finally:
            self.params, self.strat_state = sharding.shard_train_state(
                self.mesh, self.params, self.optimizer, self.strat_state)

    def _gauss_sharded(self) -> bool:
        return self.mesh is not None and self.mesh.shape["gauss"] > 1

    def _capacity(self) -> int:
        """The whole capacity axis's length (every shard's slots)."""
        cap = self.params.gaussians.alive.shape[0]
        return cap * self.mesh.shape["gauss"] if self.mesh is not None else cap

    def _n_alive(self) -> int:
        n = self.params.gaussians.alive.sum()
        if self.mesh is not None:
            n = sharding.reduce_(n.clone(), self.mesh.axes["gauss"])
        return int(n)

    def _split_noise(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """The two standard-normal samples a refine's splits use."""
        gen = self.strat_state.generator
        return (torch.randn(shape, generator=gen, device=self.device),
                torch.randn(shape, generator=gen, device=self.device))

    def _refine_gaussians(self) -> dict:
        """Cull and densify in place; returns the refine's counts. On a
        gauss-sharded mesh each rank refines its shard (`refine_shard`)
        with the whole capacity's split noise."""
        g = self.params.gaussians
        noise = self._split_noise((self._capacity(), 3))
        if self._gauss_sharded():
            new_g, self.strat_state, changed, info = sharding.refine_shard(
                self.mesh, g, self.strat_state, self.step, self.model_config, noise)
        else:
            new_g, self.strat_state, changed, info = st.refine(
                g, self.strat_state, self.step, self.model_config, noise)
        self.optimizer.zero_slots(changed)
        with torch.no_grad():
            for old, new in zip(g, new_g):
                old.copy_(new)
        return {k: int(v) for k, v in info.items()}

    @contextlib.contextmanager
    def _step_scope(self, name: str):
        """One step of `run` under the span `name`, its binnings and slab
        trades counted."""
        with profiling.counting(self.binning_counters, self.slab_counters), span(name):
            yield

    def _binning_event(self) -> dict:
        """Binning's counts since the last refine, for its event (on a
        gauss-sharded mesh the entries summed over the shards, which bin
        parts of one camera's binning; `binnings` counts that camera's); the
        rates the next history records carry."""
        c = self.binning_counters.take()
        if self._gauss_sharded():
            keys = ("candidates", "real", "landed", "long_tiles")
            sums = sharding.reduce_(torch.tensor([c[k] for k in keys], dtype=torch.int64,
                                                 device=self.device), self.mesh.axes["gauss"])
            c.update(zip(keys, sums.tolist()))
        if c["binnings"] > 0:
            self._binning_rates = {
                "binning_yield": round(c["real"] / max(c["candidates"], 1), 6),
                "landed_per_binning": round(c["landed"] / c["binnings"], 1),
                "long_tiles_per_binning": round(c["long_tiles"] / c["binnings"], 3)}
        return {"binnings": c["binnings"], "binning_candidates": c["candidates"],
                "binning_real": c["real"], "binning_landed": c["landed"],
                "binning_long_tiles": c["long_tiles"]}

    def _slab_event(self) -> dict:
        """The depth slabs' counts since the last refine (rank 0's trades;
        `slab_dropped` over the gauss axis), for a slab mesh's refine event."""
        c = self.slab_counters.take()
        return {"slab_trades": c["trades"], "slab_rows": c["rows"], "slab_sent": c["sent"],
                "slab_dropped": c["dropped"],
                "slab_fullest": c["fullest"] / c["trades"] if c["trades"] else 0.0,
                "refine_rows_moved": c["moved"]}

    def _refine_boundary(self, reset_pause: int) -> dict:
        """The refine block at a refine boundary: cull and densify, the
        growth check, the tile probe, the opacity reset on schedule.
        Returns its event."""
        tc = self.trainer_config
        with span("splat.refine"), profiling.counting(None, self.slab_counters):
            event = {"step": self.step, **self._refine_gaussians()}
            event["grew"] = self._maybe_grow()
            event["adapted"] = self._maybe_adapt_tile_capacity()
            cfg = self.model_config
            n_ref = self.step // cfg.refine_every
            # never reset without a recovery window before the run ends:
            # the model would be evaluated with every opacity clamped
            can_recover = self.step + reset_pause <= tc.max_steps
            event["reset"] = bool(cfg.reset_alpha_every > 0 and n_ref % cfg.reset_alpha_every == 0
                                  and self.step < cfg.stop_split_at and can_recover)
            if event["reset"]:
                g = self.params.gaussians
                with torch.no_grad():
                    g.opacities_logit.copy_(st.reset_opacity(g, cfg).opacities_logit)
                self._last_reset_step = self.step
            event.update(capacity=self._capacity(), max_per_tile=cfg.max_per_tile,
                         max_total_entries=cfg.max_total_entries, **self._binning_event())
            if self._gauss_sharded() and cfg.gauss_shard_mode == "slab":
                event.update(self._slab_event())
        return event

    def run(self, max_steps: int | None = None, progress_cb: Callable | None = None):
        """Train for max_steps more steps (default trainer_config.max_steps);
        returns the history, one record per log_every steps."""
        tc = self.trainer_config
        n_train = len(self.train_cams)
        steps = max_steps if max_steps is not None else tc.max_steps
        t0 = time.time()
        for it in range(steps):
            # the timer's windows run sync to sync from the run's first step
            self.timer.start(fresh=it == 0)
            cfg = self.model_config
            level_cams, level_imgs = self._level_data(self._resolution_level())
            if self.mesh is None:
                ci = self._next_camera_index(n_train)
                cam, gt = level_cams[ci], level_imgs[ci]
                self._probe_cam = cam
                with self._step_scope("splat.train_step"):
                    loss, _aux, self.strat_state = train_step(
                        self.params, self.optimizer, self.strat_state, cfg, cam, gt, self.step,
                        self._bg_generator)
            else:
                batch = self._next_camera_indices(n_train, self.data_batch)
                ci = batch[self.mesh.coords["data"]]
                self._probe_cam = level_cams[batch[0]]
                with self._step_scope("splat.train_step"):
                    loss, _aux, self.strat_state = sharding.sharded_train_step(
                        self.mesh, self.params, self.optimizer, self.strat_state, cfg,
                        level_cams[ci], level_imgs[ci], self.step, self._bg_generator)
            self.timer.stop(sync=((self.step + 1) % tc.sync_every == 0 or it + 1 == steps
                                  or (self.step + 1) % cfg.refine_every == 0))

            # eval-camera optimisation, the scene frozen
            if (self.eval_optimizer is not None and self.step % tc.eval_opt_every == 0
                    and len(self.eval_cams) > 0):
                d = self.data_batch
                ei = ((self.step // tc.eval_opt_every) * d) % len(self.eval_cams)
                if self.mesh is not None:
                    ei = (ei + self.mesh.coords["data"]) % len(self.eval_cams)
                with self._step_scope("splat.eval_camera_step"):
                    if self.mesh is None:
                        eval_opt_step(self.params, self.eval_optimizer, cfg, self.eval_cams[ei],
                                      self._eval_imgs_dev[ei], self.step, self._bg_generator)
                    else:
                        sharding.sharded_eval_opt_step(
                            self.mesh, self.params, self.eval_optimizer, cfg,
                            self.eval_cams[ei], self._eval_imgs_dev[ei], self.step,
                            self._bg_generator)

            self.step += 1

            # refinement pauses after each opacity reset until every train
            # view has been seen again (splatfacto 1.1.0's guard), so the
            # reset opacities are not judged before they settle
            reset_pause = n_train + cfg.refine_every
            if (self.step % cfg.refine_every == 0 and cfg.warmup_length <= self.step
                    and self.step - self._last_reset_step > reset_pause):
                self.refine_events.append(self._refine_boundary(reset_pause))

            if it + 1 == steps:
                self.timer.finish()
            if self.step % tc.log_every == 0 or self.step == steps:
                # the record reads the loss, a wait for the device: the timer's
                # window closes there too
                self.timer.lap()
                rec = {
                    "step": self.step,
                    "loss": float(loss),
                    "n_alive": self._n_alive(),
                    "wall_s": time.time() - t0,
                    **self.timer.summary(last_n=tc.log_every),
                }
                if self._tile_overflow_frac is not None:
                    rec["tile_overflow_frac"] = round(self._tile_overflow_frac, 6)
                if self._entry_stream_pressure is not None:
                    rec["entry_stream_pressure"] = round(self._entry_stream_pressure, 4)
                rec.update(self._binning_rates)
                self.history.append(rec)
                if progress_cb:
                    progress_cb(rec)
        return self.history

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def render_eval(self, idx: int) -> torch.Tensor:
        """Eval camera idx rendered with its learned corrections: the
        gamma-encoded (H, W, 3) image clipped to [0, 1] (gamma 1 renders are
        unbounded above and would corrupt the SSIM statistics).

        The eval background draws nothing: a "random" background has no eval
        colour (the JAX trainer's eval render passes no key and refuses it),
        and drawing one would move the training stream's generator."""
        cfg = self.model_config
        if cfg.background_color == "random":
            raise ValueError("render_eval: background_color='random' has no eval background; "
                             "evaluate with 'black', 'white' or 'auto'")
        bg = sf.background_color(self.params, cfg)
        if self.mesh is None:
            rgb = sf.render_camera(self.params, self.eval_cams[idx], cfg,
                                   sf.active_sh_degree(cfg, self.step), bg,
                                   is_eval_camera=True).rgb
        else:
            rgb = sharding.sharded_render(self.mesh, self.params, self.eval_cams[idx], cfg,
                                          self.step, bg, is_eval=True)
        return torch.clamp(sf.gamma_encode(rgb, cfg), 0.0, 1.0)

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Mean PSNR and SSIM over the eval cameras, and LPIPS when its
        weights file is configured (`ops/lpips.py`; the key is left out
        without one, and any other failure of the metric raises)."""
        weights = lpips_mod.load_weights(self.device)
        metrics = {"psnr": [], "ssim": []} | ({"lpips": []} if weights is not None else {})
        for i in range(len(self.eval_cams)):
            pred, gt = self.render_eval(i), self._eval_imgs_dev[i]
            metrics["psnr"].append(float(psnr_fn(pred, gt)))
            metrics["ssim"].append(float(ssim_fn(pred, gt)))
            if weights is not None:
                metrics["lpips"].append(float(lpips_mod.lpips_pair(pred, gt, weights)))
        return {k: float(np.mean(v)) for k, v in metrics.items() if v}

    # ------------------------------------------------------------ checkpoint
    def _group_keys(self) -> dict[str, list[str]]:
        """The leaf names of every optional state group of this trainer: what
        a checkpoint's groups are compared with before they are applied."""
        p = self.params
        groups = {g: sorted(getattr(p, g)) for g in ("camera_opt", "velocity_opt",
                                                     "eval_camera_opt", "eval_velocity_opt")}
        names = {id(leaf): name for name, leaf in named_leaves(p).items()}
        groups["opt_state"] = sorted(names[id(leaf)] for leaf in self.optimizer.params)
        if self.eval_optimizer is not None:
            groups["eval_opt_state"] = sorted(names[id(leaf)]
                                              for leaf in self.eval_optimizer.leaves)
        groups["strat_state"] = ["grad_accum", "grad_count"]
        groups["sampling"] = ["background", "cam_order", "sampler", "split"]
        return groups

    def save_checkpoint(self, path: str | Path) -> Path:
        """Write the full training state to the directory `path`: the model,
        both optimizers (Adam's moments and step per leaf, the decays' count),
        the strategy accumulators and the sampling stream, as `state.npz`
        (flat dotted keys, plain arrays) and `meta.json`. On a mesh every
        rank calls it: rank 0 writes the global state, and the call returns
        on every rank once the files are there."""
        path = Path(path)
        if self.mesh is None:
            return self._write_checkpoint(path)
        with self.global_view():
            if self.mesh.rank == 0:
                self._write_checkpoint(path)
        if self.mesh.world > 1:
            torch.distributed.barrier()
        return path

    def _write_checkpoint(self, path: Path) -> Path:
        path.mkdir(parents=True, exist_ok=True)
        leaves = named_leaves(self.params)
        names = {id(leaf): name for name, leaf in leaves.items()}
        arrays = {name: leaf.detach().cpu().numpy() for name, leaf in leaves.items()}

        def adam_arrays(prefix, adam, params):
            for leaf in params:
                state = adam.state.get(leaf)
                if state:
                    for key in ("exp_avg", "exp_avg_sq", "step"):
                        arrays[f"{prefix}.{names[id(leaf)]}.{key}"] = (
                            state[key].detach().cpu().numpy())

        adam_arrays("opt_state", self.optimizer.adam, self.optimizer.params)
        if self.eval_optimizer is not None:
            adam_arrays("eval_opt_state", self.eval_optimizer.adam, self.eval_optimizer.leaves)
        arrays["strat_state.grad_accum"] = self.strat_state.grad_accum.cpu().numpy()
        arrays["strat_state.grad_count"] = self.strat_state.grad_count.cpu().numpy()
        arrays["sampling.sampler"] = self._sampler.get_state().numpy()
        arrays["sampling.background"] = self._bg_generator.get_state().cpu().numpy()
        arrays["sampling.split"] = self.strat_state.generator.get_state().cpu().numpy()
        n_train = len(self.train_cams)
        arrays["sampling.cam_order"] = np.asarray(
            self._order if self._order is not None else np.full(n_train, -1), np.int32)
        cfg = self.model_config
        meta = {
            "format": 1, "step": self.step, "capacity": int(self.params.gaussians.alive.shape[0]),
            "groups": self._group_keys(),
            "schedule_count": int(self.optimizer.schedule.last_epoch),
            "last_reset_step": self._last_reset_step if self._last_reset_step > -(10**9) else -1,
            "overflow_streak": self._overflow_streak,
            "tile_overflow_frac": self._tile_overflow_frac,
            "entry_stream_pressure": self._entry_stream_pressure,
            "max_per_tile": cfg.max_per_tile, "max_total_entries": cfg.max_total_entries,
            "binning_counts": self.binning_counters.read(),
            "binning_rates": self._binning_rates,
        }
        np.savez(path / "state.npz", **arrays)
        (path / "meta.json").write_text(json.dumps(meta, indent=2))
        return path

    def _resize_gaussians(self, capacity: int) -> None:
        """Bring the model to a checkpoint's capacity (either direction) with
        a fresh optimizer and strategy state, as the JAX trainer re-inits
        them; the checkpoint's own state is applied afterwards."""
        g = sf.GaussianParams(*(t.detach() for t in self.params.gaussians))
        if capacity > g.alive.shape[0]:
            g = st.grow_capacity(g, capacity)
        else:
            g = sf.GaussianParams(*(leaf[:capacity].clone() for leaf in g))
        self.params = self.params._replace(gaussians=g)
        self.optimizer = Optimizer(self.params, self.trainer_config)
        self.strat_state = st.init_strategy_state(capacity, self.trainer_config.seed,
                                                  device=self.device)

    def load_checkpoint(self, path: str | Path) -> None:
        """Restore a checkpoint written by `save_checkpoint`. The model adapts
        to the stored capacity. An optional group (camera or velocity
        corrections, either optimizer's state, the strategy state, the
        sampling stream) whose leaf names differ from this trainer's
        configuration is skipped with one message and the current state kept;
        the model itself is never skipped. A checkpoint without a sampling
        group re-derives the epoch cursor and the last reset step from the
        schedule. On a mesh every rank reads the global state and keeps its
        shard."""
        with self.global_view():
            self._read_checkpoint(Path(path))

    @torch.no_grad()
    def _read_checkpoint(self, path: Path) -> None:
        meta = json.loads((path / "meta.json").read_text())
        if meta.get("format", 1) != 1:
            raise ValueError(f"{path}: checkpoint format {meta['format']}, this package reads 1")
        with np.load(path / "state.npz", allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
        stored_cap = int(arrays["gaussians.means"].shape[0])
        if stored_cap != self.params.gaussians.alive.shape[0]:
            self._resize_gaussians(stored_cap)
        mine, stored = self._group_keys(), meta.get("groups", {})
        discarded = sorted(k for k in set(mine) | set(stored)
                           if k in stored and sorted(stored[k]) != mine.get(k))
        if discarded:
            print("load_checkpoint: feature-set mismatch — keeping current "
                  f"state for group(s) {discarded} (stored "
                  "structure differs from this trainer's config)", flush=True)
        keep = {k for k in stored if k not in discarded}
        leaves = named_leaves(self.params)
        for name, leaf in leaves.items():
            group = name.split(".")[0]
            if group not in ("gaussians", "background_logit") and group not in keep:
                continue
            value = torch.as_tensor(arrays[name])
            if value.shape != leaf.shape:
                raise ValueError(f"{path}: {name} is {tuple(value.shape)}, this trainer's is "
                                 f"{tuple(leaf.shape)}")
            leaf.copy_(value)
        self.step = int(meta["step"])

        def load_adam(prefix, adam, params):
            names = {id(leaf): name for name, leaf in leaves.items()}
            for leaf in params:
                key = f"{prefix}.{names[id(leaf)]}"
                if f"{key}.step" not in arrays:
                    adam.state.pop(leaf, None)
                    continue
                adam.state[leaf] = {
                    "step": torch.tensor(arrays[f"{key}.step"]),
                    "exp_avg": torch.tensor(arrays[f"{key}.exp_avg"], device=leaf.device),
                    "exp_avg_sq": torch.tensor(arrays[f"{key}.exp_avg_sq"], device=leaf.device)}

        if "opt_state" in keep:
            load_adam("opt_state", self.optimizer.adam, self.optimizer.params)
            self.optimizer.set_count(int(meta["schedule_count"]))
        if "eval_opt_state" in keep and self.eval_optimizer is not None:
            load_adam("eval_opt_state", self.eval_optimizer.adam, self.eval_optimizer.leaves)
        if "strat_state" in keep:
            self.strat_state = self.strat_state._replace(
                grad_accum=torch.tensor(arrays["strat_state.grad_accum"], device=self.device),
                grad_count=torch.tensor(arrays["strat_state.grad_count"], device=self.device))
        if "sampling" in keep:
            self._sampler.set_state(torch.tensor(arrays["sampling.sampler"]))
            self._bg_generator.set_state(torch.tensor(arrays["sampling.background"]))
            self.strat_state.generator.set_state(torch.tensor(arrays["sampling.split"]))
            order = arrays["sampling.cam_order"]
            self._order = None if (order < 0).any() else [int(i) for i in order]
            lrs = int(meta["last_reset_step"])
            self._last_reset_step = lrs if lrs >= 0 else -(10**9)
            self._overflow_streak = int(meta.get("overflow_streak", 0))
            self._tile_overflow_frac = meta.get("tile_overflow_frac")
            self._entry_stream_pressure = meta.get("entry_stream_pressure")
            self.binning_counters.restore(meta.get("binning_counts", {}))
            self._binning_rates = meta.get("binning_rates", {})
        else:
            # params-only checkpoint: the epoch order is drawn anew at the next
            # step, and the most recent opacity reset follows from the schedule
            # so the post-reset refine pause is kept
            self._order = None
            cfg = self.model_config
            interval = cfg.refine_every * max(cfg.reset_alpha_every, 1)
            if cfg.reset_alpha_every > 0 and self.step >= interval:
                self._last_reset_step = (self.step // interval) * interval
        # the adaptive capacities the run had grown to (the run's config.json
        # tracks them too; a checkpoint loaded on its own must not re-drop
        # the deepest tile entries)
        cfg = self.model_config
        self.model_config = dataclasses.replace(
            cfg, max_per_tile=max(cfg.max_per_tile, int(meta.get("max_per_tile", 0))),
            max_total_entries=max(cfg.max_total_entries, int(meta.get("max_total_entries", 0))))
        self._pyramid.clear()
