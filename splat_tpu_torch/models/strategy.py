"""Densification, culling and capacity growth at a fixed capacity (port of
`splat_tpu/models/strategy.py`).

Every train step adds, for each Gaussian that contributed, the norm of its
screen-space positional gradient (the gradient of `render_camera`'s
`means2d_probe`, in pixels) scaled by max(W, H) / 2 to splatfacto's
NDC-scaled units, and counts the step. `refine` consumes these every
`refine_every` steps: it culls transparent and oversized Gaussians, clones
the small and splits the large ones whose mean gradient passes the
threshold, and writes the new Gaussians into dead slots, the r-th candidate
into the r-th dead slot (a stable argsort of the alive mask). Shapes never
change and nothing is read back to the host; `grow_capacity` pads the arrays
when the trainer sees the alive share pass its threshold.

The split positions are random. The JAX package draws them from its PRNG key
inside `refine`; here the caller draws the two (C, 3) normal samples (from
`StrategyState.generator`, or from anywhere else: a test hands both packages
the same numbers) and passes them in.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops import se3
from .splatfacto import GaussianParams, SplatfactoConfig, _logit


class StrategyState(NamedTuple):
    grad_accum: torch.Tensor       # (C,) accumulated NDC-scale screen-gradient norms
    grad_count: torch.Tensor       # (C,) int32 steps each Gaussian was visible
    generator: torch.Generator     # split sampling


def init_strategy_state(capacity: int, seed: int = 0, device=None) -> StrategyState:
    dev = resolve_device(device)
    return StrategyState(
        grad_accum=torch.zeros((capacity,), device=dev),
        grad_count=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
    )


def accumulate_grads(state: StrategyState, means2d_grad: torch.Tensor,
                     visible: torch.Tensor, img_w: int, img_h: int) -> StrategyState:
    """means2d_grad (C, 2) pixel-space probe gradient; visible (C,) bool."""
    norm = torch.linalg.norm(means2d_grad, dim=-1) * (max(img_w, img_h) * 0.5)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visible, norm, 0.0),
        grad_count=state.grad_count + visible.to(torch.int32),
    )


def grow_strategy_state(state: StrategyState, new_capacity: int) -> StrategyState:
    """Pad the accumulators to a grown capacity and keep the generator, so a
    growth does not rewind the split sampling."""
    pad = new_capacity - state.grad_accum.shape[0]
    if pad <= 0:
        return state
    return state._replace(
        grad_accum=torch.nn.functional.pad(state.grad_accum, (0, pad)),
        grad_count=torch.nn.functional.pad(state.grad_count, (0, pad)),
    )


def _rank_match_scatter(params: GaussianParams, new_vals: GaussianParams,
                        want_new: torch.Tensor) -> tuple[GaussianParams, torch.Tensor]:
    """Write new_vals[i], for each i with want_new[i], into a dead slot: the
    r-th wanted candidate goes to the r-th dead slot, and candidates beyond
    the dead slots are dropped. Returns (params, filled slot mask).

    Accepted candidates have distinct targets; every other row is sent to an
    extra row C that is cut off again, so no write depends on a mask's count
    and nothing accumulates."""
    capacity = params.alive.shape[0]
    alive_b = params.alive > 0.5
    dead_slots = torch.argsort(alive_b.to(torch.uint8), stable=True)    # dead first
    n_dead = capacity - alive_b.sum()
    cand_rank = torch.cumsum(want_new.to(torch.int32), dim=0) - 1
    ok = want_new & (cand_rank < n_dead)
    target = dead_slots[torch.clamp(cand_rank, 0, capacity - 1).long()]
    safe_target = torch.where(ok, target, capacity)

    def scatter(dst, src):
        buf = torch.cat([dst, dst[:1]], dim=0)
        buf[safe_target] = src
        return buf[:capacity]

    out = GaussianParams(*(scatter(getattr(params, f), getattr(new_vals, f))
                           for f in GaussianParams._fields))
    filled = scatter(torch.zeros_like(alive_b), torch.ones_like(alive_b))
    return out, filled


@torch.no_grad()
def refine(params: GaussianParams, state: StrategyState, step: int, config: SplatfactoConfig,
           noise: tuple[torch.Tensor, torch.Tensor]):
    """One cull + densify pass (port of `make_refine`'s `_refine`).

    noise: two (C, 3) standard-normal samples, the split offsets of the new
    copy and of the original. Returns (params, state with the accumulators
    zeroed, changed, info): `changed` marks the slots whose parameters are
    new (filled, split originals, culled), whose Adam moments the trainer
    zeroes; `info` holds n_culled, n_split, n_cloned and n_alive as 0-dim
    tensors (no host sync here)."""
    eps, eps2 = noise
    scales = torch.exp(params.scales_log)
    opac = torch.sigmoid(params.opacities_logit)
    alive_b = params.alive > 0.5
    max_scale = scales.amax(dim=-1)

    cull = alive_b & (opac < config.cull_alpha_thresh)
    if step > config.warmup_length:
        cull = cull | (alive_b & (max_scale > config.cull_scale_thresh))
    alive_b = alive_b & ~cull

    avg_grad = state.grad_accum / torch.clamp(state.grad_count, min=1)
    do_densify = config.warmup_length <= step < config.stop_split_at
    high = alive_b & (avg_grad > config.densify_grad_thresh)
    if not do_densify:
        high = torch.zeros_like(high)
    big = max_scale > config.densify_size_thresh
    split_mask = high & big
    clone_mask = high & ~big

    # trim the candidates to the dead slots up front, so a split whose new
    # copy cannot be placed leaves its original as it is
    want = split_mask | clone_mask
    n_dead = params.alive.shape[0] - alive_b.sum()
    cand_rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    placeable = want & (cand_rank < n_dead)
    split_mask = split_mask & placeable
    clone_mask = clone_mask & placeable

    # split: a new position sampled from the Gaussian, both copies shrunk
    R = se3.quat_to_rotmat(se3.quat_normalize(params.quats))
    shrink = math.log(1.6)
    split_col = split_mask[:, None]
    shrunk = torch.where(split_col, params.scales_log - shrink, params.scales_log)
    offset = torch.einsum("nij,nj->ni", R, eps * scales)
    new_vals = params._replace(
        means=torch.where(split_col, params.means + offset, params.means),
        scales_log=shrunk, alive=torch.ones_like(params.alive))
    offset2 = torch.einsum("nij,nj->ni", R, eps2 * scales)
    params = params._replace(
        means=torch.where(split_col, params.means + offset2, params.means),
        scales_log=shrunk, alive=alive_b.to(params.alive.dtype))

    params, filled = _rank_match_scatter(params, new_vals, split_mask | clone_mask)
    changed = filled | split_mask | cull
    info = {"n_culled": cull.sum(), "n_split": split_mask.sum(),
            "n_cloned": clone_mask.sum(), "n_alive": (params.alive > 0.5).sum()}
    new_state = state._replace(grad_accum=torch.zeros_like(state.grad_accum),
                               grad_count=torch.zeros_like(state.grad_count))
    return params, new_state, changed, info


@torch.no_grad()
def reset_opacity(params: GaussianParams, config: SplatfactoConfig) -> GaussianParams:
    """Clamp the opacities to twice the cull threshold (splatfacto 1.1.0's
    reset value): low enough that transient blobs must earn opacity again,
    high enough that the next refine does not cull everything. The trainer
    pauses refinement for num_train_images + refine_every steps afterwards."""
    reset_val = _logit(min(config.cull_alpha_thresh * 2.0, 0.99))
    return params._replace(opacities_logit=torch.clamp(params.opacities_logit, max=reset_val))


@torch.no_grad()
def grow_capacity(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """Pad every array to new_capacity with dead Gaussians (scales_log -8,
    identity quaternions, opacities_logit -10, alive 0)."""
    cap = params.alive.shape[0]
    pad = new_capacity - cap
    if pad <= 0:
        return params

    def pad_arr(a, fill=0.0):
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)], dim=0)

    quats = pad_arr(params.quats)
    quats[cap:, 0] = 1.0
    return GaussianParams(
        means=pad_arr(params.means), scales_log=pad_arr(params.scales_log, -8.0), quats=quats,
        opacities_logit=pad_arr(params.opacities_logit, -10.0),
        features_dc=pad_arr(params.features_dc), features_rest=pad_arr(params.features_rest),
        alive=pad_arr(params.alive))
