"""Densification statistics (port of the state and accumulation half of
`splat_tpu/models/strategy.py`).

Every train step adds, for each Gaussian that contributed, the norm of its
screen-space positional gradient (the gradient of `render_camera`'s
`means2d_probe`, in pixels) scaled by max(W, H) / 2 to splatfacto's
NDC-scaled units, and counts the step. The refine, opacity-reset and
capacity-growth steps that consume these come with the trainer slice; the
`torch.Generator` here takes the place of the JAX PRNG key their split
sampling draws from.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device


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
